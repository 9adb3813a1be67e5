// Fused multi-head attention backward for Hopper (sm_90a).
//
// Replaces crct_tpu/ops/attention.py::_bwd_kernel (the Pallas TPU kernel).
// With s = q k^T * scale + mask, P = softmax(s), keep the dropout multipliers
// (0 or 1/(1 - rate), the forward's murmur3 hash regenerated from the same
// seed) and out = (P * keep) v, it returns, for the cotangent g of out,
//   dv = (P * keep)^T g ;  dP = (g v^T) * keep ;
//   ds = P * (dP - sum_j dP * P) ;  dq = ds k * scale ;  dk = ds^T q * scale
// with fp32 scores, softmax and sums, stored in the input dtype (fp32 or bf16).
//
// What bounds it on an H100: the five products of the formulas (the q k^T
// recompute, g v^T, dv, dq, dk) are 10*B*H*Lq*Lk*D FLOP; at the flagship
// text shape with B = 80 rows (H 16, Lq = Lk = 124, D 48) that is 9.4 GFLOP,
// 0.14 ms at the 67 TFLOP/s fp32 CUDA-core peak, against ~214 MB of q, k, v,
// g, mask, dq, dk and dv in fp32, 0.064 ms at 3.35 TB/s: operations bound it.
//
// Design (simple and right first): one block per (batch, head), so the sums
// over query rows (dk, dv) and over keys (dq) stay inside one block and need
// no float atomics: the result is deterministic. Two phases, split by a block
// barrier:
//   A. one warp per query row, as in the forward kernel: with K and V of the
//      head staged in shared memory as fp32, the lanes compute the row's
//      scores and g.v products into per-warp row buffers; warp shuffles give
//      the row's max, sum and delta = sum_j dP * P; the row of ds gives dq.
//      The row statistics (max, sum, delta) go to a scratch buffer.
//   B. one warp per key row: with Q, G and the row statistics staged, the
//      lanes recompute P, keep, dP and ds down the key's column (the same
//      scores, added in the same order as in phase A), and the warp
//      accumulates dv and dk lane-strided over D.
// This recomputes q.k and g.v once more than the formulas need (14 instead of
// 10 units of B*H*Lq*Lk*D FLOP) but holds no [Lq, Lk] tile. Rows are at stride
// D + 1 in shared memory, so lanes reading different rows hit different banks.
// Operands too large for shared memory (large D, Lq or Lk) are streamed in
// tiles. Left for later: tensor cores (wgmma), TMA loads, bf16 staging.

#include "attention_common.cuh"

namespace {

using namespace attn;

// floats of dynamic shared memory each phase needs for a tile of `rows`
__host__ __device__ inline size_t phase_a_floats(int rows, int Lk, int D) {
  return 2 * (size_t)rows * (D + 1) + (size_t)kWarps * 2 * (D + Lk);
}
__host__ __device__ inline size_t phase_b_floats(int rows, int D) {
  return 2 * (size_t)rows * (D + 1) + 3 * (size_t)rows
         + (size_t)kWarps * 2 * (D + rows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const T* __restrict__ g, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ stats, int H, int Lq, int Lk, int D,
                     int Lm, float scale, float rate, float keep_scale,
                     uint32_t seed, int hb, int tile_a, int tile_b) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;

  const T* qh = q + (size_t)bh * Lq * D;
  const T* kh = k + (size_t)bh * Lk * D;
  const T* vh = v + (size_t)bh * Lk * D;
  const T* gh = g + (size_t)bh * Lq * D;
  const float* mb = mask + (size_t)b * Lm * Lk;
  float* st = stats + (size_t)bh * Lq * 3;  // per query row: max, sum, delta
  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;

  // ---- phase A: one warp per query row -> row statistics and dq ----------
  {
    const bool resident = tile_a >= Lk;
    float* sk = smem;
    float* sv = sk + (size_t)tile_a * ld;
    float* myq = sv + (size_t)tile_a * ld + warp * 2 * D;
    float* myg = myq + D;
    float* myp = sv + (size_t)tile_a * ld + kWarps * 2 * D + warp * 2 * Lk;
    float* myd = myp + Lk;
    if (resident) {
      stage(sk, kh, 0, Lk, D, ld);
      stage(sv, vh, 0, Lk, D, ld);
      __syncthreads();
    }
    // loop bounds are the same for every thread of the block, so the
    // barriers of the streamed path are reached by all warps
    for (int r0 = 0; r0 < Lq; r0 += kWarps) {
      const int r = r0 + warp;
      const bool active = r < Lq;
      if (active) {
        for (int d = lane; d < D; d += 32) {
          myq[d] = to_f32(qh[(size_t)r * D + d]);
          myg[d] = to_f32(gh[(size_t)r * D + d]);
        }
      }
      __syncwarp();

      // scores s_j = q . k_j * scale + mask and products g . v_j
      const float* mrow = mb + (Lm == 1 ? 0 : (size_t)r * Lk);
      for (int t0 = 0; t0 < Lk; t0 += tile_a) {
        const int n = min(tile_a, Lk - t0);
        const float* kt = resident ? sk + (size_t)t0 * ld : sk;
        const float* vt = resident ? sv + (size_t)t0 * ld : sv;
        if (!resident) {
          __syncthreads();
          stage(sk, kh, t0, n, D, ld);
          stage(sv, vh, t0, n, D, ld);
          __syncthreads();
        }
        if (active) {
          for (int j = lane; j < n; j += 32) {
            myp[t0 + j] = dot(myq, kt + j * ld, D) * scale + mrow[t0 + j];
            myd[t0 + j] = dot(myg, vt + j * ld, D);
          }
        }
      }
      __syncwarp();

      // P (as in the forward kernel), dP = (g.v) * keep, delta, then ds
      if (active) {
        float m = -CUDART_INF_F;
        for (int j = lane; j < Lk; j += 32) m = fmaxf(m, myp[j]);
        m = warp_max(m);
        float l = 0.f;
        for (int j = lane; j < Lk; j += 32) {
          const float e = expf(myp[j] - m);
          myp[j] = e;
          l += e;
        }
        l = warp_sum(l);
        float delta = 0.f;
        for (int j = lane; j < Lk; j += 32) {
          const float p = myp[j] / l;
          const float dp = dropout ? myd[j] * drop.keep(r, j, rate, keep_scale) : myd[j];
          myp[j] = p;
          myd[j] = dp;
          delta = fmaf(dp, p, delta);
        }
        delta = warp_sum(delta);
        for (int j = lane; j < Lk; j += 32) myd[j] = myp[j] * (myd[j] - delta);
        if (lane == 0) {
          st[(size_t)r * 3 + 0] = m;
          st[(size_t)r * 3 + 1] = l;
          st[(size_t)r * 3 + 2] = delta;
        }
      }
      __syncwarp();

      // dq = (sum_j ds_j k_j) * scale, lanes strided over D
      float acc[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
      for (int t0 = 0; t0 < Lk; t0 += tile_a) {
        const int n = min(tile_a, Lk - t0);
        const float* kt = resident ? sk + (size_t)t0 * ld : sk;
        if (!resident) {
          __syncthreads();
          stage(sk, kh, t0, n, D, ld);
          __syncthreads();
        }
        if (active) {
          for (int j = 0; j < n; ++j) {
            const float ds = myd[t0 + j];
            const float* kj = kt + j * ld;
#pragma unroll
            for (int c = 0; c < kMaxChunks; ++c) {
              const int d = lane + 32 * c;
              if (d < D) acc[c] = fmaf(ds, kj[d], acc[c]);
            }
          }
        }
      }
      if (active) {
        T* out = dq + ((size_t)bh * Lq + r) * D;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int d = lane + 32 * c;
          if (d < D) store(out + d, acc[c] * scale);
        }
      }
      __syncwarp();
    }
  }
  // the statistics in global memory and the reuse of shared memory
  __syncthreads();

  // ---- phase B: one warp per key row -> dv and dk ------------------------
  {
    const bool resident = tile_b >= Lq;
    float* sq = smem;
    float* sg = sq + (size_t)tile_b * ld;
    float* sst = sg + (size_t)tile_b * ld;
    float* myk = sst + 3 * (size_t)tile_b + warp * 2 * D;
    float* myv = myk + D;
    float* mypd = sst + 3 * (size_t)tile_b + kWarps * 2 * D + warp * 2 * tile_b;
    float* myds = mypd + tile_b;
    auto stage_rows = [&](int t0, int n) {
      stage(sq, qh, t0, n, D, ld);
      stage(sg, gh, t0, n, D, ld);
      for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
        sst[i] = st[(size_t)t0 * 3 + i];
    };
    if (resident) {
      stage_rows(0, Lq);
      __syncthreads();
    }
    for (int c0 = 0; c0 < Lk; c0 += kWarps) {
      const int j = c0 + warp;
      const bool active = j < Lk;
      if (active) {
        for (int d = lane; d < D; d += 32) {
          myk[d] = to_f32(kh[(size_t)j * D + d]);
          myv[d] = to_f32(vh[(size_t)j * D + d]);
        }
      }
      __syncwarp();
      const float mkey = (active && Lm == 1) ? mb[j] : 0.f;

      float accv[kMaxChunks], acck[kMaxChunks];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) accv[c] = acck[c] = 0.f;
      for (int t0 = 0; t0 < Lq; t0 += tile_b) {
        const int n = min(tile_b, Lq - t0);
        const float* qt = resident ? sq + (size_t)t0 * ld : sq;
        const float* gt = resident ? sg + (size_t)t0 * ld : sg;
        const float* tt = resident ? sst + 3 * (size_t)t0 : sst;
        if (!resident) {
          __syncthreads();
          stage_rows(t0, n);
          __syncthreads();
        }
        if (active) {
          // the column of (P * keep) and ds for query rows t0 .. t0 + n
          for (int i = lane; i < n; i += 32) {
            const int r = t0 + i;
            const float s = dot(qt + i * ld, myk, D) * scale
                            + (Lm == 1 ? mkey : mb[(size_t)r * Lk + j]);
            const float p = expf(s - tt[3 * i]) / tt[3 * i + 1];
            const float kp = dropout ? drop.keep(r, j, rate, keep_scale) : 1.f;
            const float dp = dot(gt + i * ld, myv, D) * kp;
            mypd[i] = p * kp;
            myds[i] = p * (dp - tt[3 * i + 2]);
          }
        }
        __syncwarp();
        if (active) {
          for (int i = 0; i < n; ++i) {
            const float pd = mypd[i];
            const float ds = myds[i];
            const float* qi = qt + i * ld;
            const float* gi = gt + i * ld;
#pragma unroll
            for (int c = 0; c < kMaxChunks; ++c) {
              const int d = lane + 32 * c;
              if (d < D) {
                accv[c] = fmaf(pd, gi[d], accv[c]);
                acck[c] = fmaf(ds, qi[d], acck[c]);
              }
            }
          }
        }
        __syncwarp();
      }
      if (active) {
        T* outv = dv + ((size_t)bh * Lk + j) * D;
        T* outk = dk + ((size_t)bh * Lk + j) * D;
#pragma unroll
        for (int c = 0; c < kMaxChunks; ++c) {
          const int d = lane + 32 * c;
          if (d < D) {
            store(outv + d, accv[c]);
            store(outk + d, acck[c] * scale);
          }
        }
      }
      __syncwarp();
    }
  }
}

// The largest tile of rows (at most L) whose phase fits in shared memory;
// 0 if not even one row fits.
template <typename F>
int fit_rows(int L, F floats) {
  const size_t budget = kMaxSmem / sizeof(float);
  if (floats(L) <= budget) return L;
  int lo = 0, hi = L;  // floats(lo) fits, floats(hi) does not
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (floats(mid) <= budget) lo = mid; else hi = mid;
  }
  return (lo >= 1 && floats(lo) <= budget) ? lo : 0;
}

// The rows per tile of each phase and the dynamic shared memory of a
// launch; smem is 0 when not even one row of a phase fits.
struct Layout {
  int tile_a, tile_b;
  size_t smem;
};

Layout layout(int Lq, int Lk, int D) {
  const int tile_a = fit_rows(Lk, [&](int n) { return phase_a_floats(n, Lk, D); });
  const int tile_b = fit_rows(Lq, [&](int n) { return phase_b_floats(n, D); });
  if (tile_a < 1 || tile_b < 1) return {tile_a, tile_b, 0};
  const size_t a = phase_a_floats(tile_a, Lk, D);
  const size_t b = phase_b_floats(tile_b, D);
  return {tile_a, tile_b, (a > b ? a : b) * sizeof(float)};
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, void* dq, void* dk, void* dv, void* stats, int B,
           int H, int Lq, int Lk, int D, int Lm, float scale, float rate,
           float keep_scale, int seed, int hb, cudaStream_t stream) {
  const Layout l = layout(Lq, Lk, D);
  if (l.smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.smem);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_kernel<T><<<B * H, kThreads, l.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(stats), H, Lq, Lk, D, Lm, scale,
      rate, keep_scale, (uint32_t)seed, hb, l.tile_a, l.tile_b);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/g/dq
// [B,H,Lq,D], k/v/dk/dv [B,H,Lk,D] in that dtype, mask [B,1,Lm,Lk] float32
// with Lm in {1, Lq}, stats a float32 scratch of B*H*Lq*3. Returns the CUDA
// error code of the launch (0 = launched).
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* g, void* dq,
                             void* dk, void* dv, void* stats, int dtype,
                             int B, int H, int Lq, int Lk, int D, int Lm,
                             float scale, float rate, float keep_scale,
                             int seed, int hb, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, g, dq, dk, dv, stats, B, H, Lq, Lk, D,
                         Lm, scale, rate, keep_scale, seed, hb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, g, dq, dk, dv, stats, B, H, Lq,
                                 Lk, D, Lm, scale, rate, keep_scale, seed, hb,
                                 s);
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory one block of a launch at (Lq, Lk, D) takes
// (0: the shape does not fit).
extern "C" int attention_bwd_smem(int Lq, int Lk, int D) {
  if (Lq < 1 || Lk < 1 || D < 1 || D > kMaxD) return 0;
  return (int)layout(Lq, Lk, D).smem;
}

// Blocks of a launch at (Lq, Lk, D) that one SM holds at once, as the CUDA
// occupancy calculator gives them from the kernel's registers and shared
// memory (dtype as in attention_bwd); a negative CUDA error code on failure.
extern "C" int attention_bwd_blocks_per_sm(int Lq, int Lk, int D, int dtype) {
  const int smem = attention_bwd_smem(Lq, Lk, D);
  if (smem == 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const void* fn = dtype == 0 ? (const void*)attention_bwd_kernel<float>
                              : (const void*)attention_bwd_kernel<__nv_bfloat16>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
