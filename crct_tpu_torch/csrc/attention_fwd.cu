// Fused multi-head attention forward for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces crct_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel):
//   out = (softmax(q k^T / sqrt(D) + mask) * keep / (1 - rate)) v
// with fp32 scores, softmax and accumulators, the output stored in the input
// dtype (fp32 or bf16). With round_p (bf16 only) it computes the JAX
// package's default XLA path instead (crct_tpu/models/layers.py:61-64):
// P normalised in fp32 and rounded to bf16, the kept ones divided in bf16
// by bf16(1 - rate), then P v. It writes optionally the rows' log-sum-exp
// lse = m + log(sum_j exp(s_j - m)) as fp32 [B, H, Lq], which the backward
// kernel (attention_bwd.cu) takes instead of recomputing the row statistics.
// The dropout keep mask is the JAX kernel's murmur3 counter hash, bit for
// bit: the same int seed gives the same mask.
//
// What bounds it on an H100: 4*B*H*Lq*Lk*D FLOP against q, k, v, the mask
// and out read or written once. At the flagship text shape (B 240, H 16,
// Lq = Lk = 124, D 48) that is 11.3 GFLOP and 366 MB in fp32 (0.169 ms at
// the 67 TFLOP/s fp32 rate, 0.109 ms at 3.35 TB/s: operations bound the
// fp32 row), and 183 MB in bf16 (0.055 ms of bytes, 0.011 ms at 989
// TFLOP/s: bytes bound the bf16 row).
//
// Design: a block of W <= 8 warps takes 16 W query rows of one (batch,
// head), each warp a 16-row slab. Q of the block and one tile of up to 128
// keys of K and V at a time (all keys at the flagship shapes) are staged in
// shared memory in the input dtype with
// 16-byte cp.async copies, into rows padded so that the fragment loads are
// free of bank conflicts. Both products run on the tensor cores (mma.sync;
// see attention_common.cuh for the precision of each dtype): S = Q K^T
// into registers (bf16 m16n8k16 for bf16 inputs, 3xTF32 m16n8k8 for fp32),
// 32 keys at a time, then an online softmax in log2 units (row max and sum
// with quad shuffles, the keep bit hashed from each accumulator's row and
// column), then O += P V with P taken from the S accumulators as they lie
// (bf16 hi + lo against V's fragments from ldmatrix.trans for bf16 inputs,
// 3xTF32 for fp32). Registers are capped for two blocks of 8 warps
// an SM, so one block's loads overlap another's products.
//
// round_p: the online softmax multiplies the unnormalised exp(s - m) into V
// and divides at the end, but the JAX path rounds the normalised P. So this
// instance takes two passes over the key tiles, the first for the rows' max
// and sum only (S = Q K^T, no V), the second for P = exp(s - m) / sum,
// rounded, and O += P V in one bf16 product (no low part). With one key tile
// (Lk <= 128, every flagship shape) K and V are staged once for both passes.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBK = 128;         // keys per staged tile, at most
constexpr int kSub = 8 * kFlush;  // keys per step of the online softmax
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int DT, bool ROUND>
__global__ void __launch_bounds__(256, 2)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                     int Lk, int D, int Lm, float scale, float rate,
                     float keep_scale, float keep_rcp, uint32_t seed, int hb, int bk,
                     int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  static_assert(!(ROUND && SPLIT), "the rounding mode is bf16's");
  constexpr int Dp = 8 * DT;
  constexpr int ld = row_stride<T>(Dp);
  extern __shared__ __align__(16) unsigned char smem[];
  const int BQ = 16 * (blockDim.x >> 5);
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = reinterpret_cast<T*>(smem + region<T>((size_t)BQ * ld));
  T* sV = sK + bk * ld;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, Lq - q0);
  const T* kh = k + (size_t)bh * Lk * D;
  const T* vh = v + (size_t)bh * Lk * D;
  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;

  stage_tile(sQ, q + ((size_t)bh * Lq + q0) * D, nq, BQ, D, Dp, ld, vec);

  const int r0 = 16 * warp;                 // the warp's slab in the tile
  const int row[2] = {q0 + r0 + gr, q0 + r0 + gr + 8};
  const float* mrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    mrow[i] = mask + ((size_t)b * Lm + (Lm == 1 ? 0 : min(row[i], Lq - 1))) * Lk;

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float inv[2] = {1.f, 1.f};  // ROUND: 1 / the rows' sums, after the first pass
  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

  const int ntiles = (Lk + bk - 1) / bk;
  for (int it = 0; it < (ROUND ? 2 : 1) * ntiles; ++it) {
    const bool stats = ROUND && it < ntiles;  // the first pass of ROUND
    const int kt0 = (it % ntiles) * bk;
    const int nk = min(bk, Lk - kt0);
    if (ROUND && it == ntiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = quad_sum(l[i]);
        inv[i] = 1.f / l[i];
      }
    }
    if (it == 0 || ntiles > 1) {
      if (it > 0) __syncthreads();         // the last tile is consumed
      stage_tile(sK, kh + (size_t)kt0 * D, nk, bk, D, Dp, ld, vec);
      stage_tile(sV, vh + (size_t)kt0 * D, nk, bk, D, Dp, ld, vec);
      cp_async_wait_all();
      __syncthreads();
    }

    // the staged tile in sub-tiles of kSub keys (fewer live registers)
    for (int sub = 0; sub < nk; sub += kSub) {
      const int NT = min(kSub / 8, (nk - sub + 7) >> 3);  // 8-key tiles with keys
      const T* sKs = sK + sub * ld;
      const T* sVs = sV + sub * ld;

      // S = Q K^T for the warp's 16 rows and the sub-tile's keys
      float s[kSub / 8][4];
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if constexpr (SPLIT) {
#pragma unroll
        for (int kk = 0; kk < DT; ++kk) {
          const FragA a = load_a<SPLIT>(sQ, ld, r0, 8 * kk, lane);
#pragma unroll
          for (int nt = 0; nt < kSub / 8; ++nt)
            if (nt < NT) mma<SPLIT>(s[nt], a, load_b_rows<SPLIT>(sKs, ld, 8 * nt, 8 * kk, lane));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DT / 2; ++kk) {
          const Frag16A a = load_a16(sQ, ld, r0, 16 * kk, lane);
#pragma unroll
          for (int nt = 0; nt < kSub / 8; ++nt)
            if (nt < NT) mma_bf16(s[nt], a, load_b16_rows(sKs, ld, 8 * nt, 16 * kk, lane));
        }
      }

      // scores in log2 units, the running max, the rescale of what came before
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = kt0 + sub + 8 * nt + 2 * tq + e;
          const bool in = nt < NT && j < Lk;
          const float m0 = in ? mrow[0][j] : 0.f;
          const float m1 = in ? (Lm == 1 ? m0 : mrow[1][j]) : 0.f;
          s[nt][e] = in ? (s[nt][e] * scale + m0) * kLog2e : -CUDART_INF_F;
          s[nt][2 + e] = in ? (s[nt][2 + e] * scale + m1) * kLog2e : -CUDART_INF_F;
          mx[0] = fmaxf(mx[0], s[nt][e]);
          mx[1] = fmaxf(mx[1], s[nt][2 + e]);
        }
      }
      if (!ROUND || stats) {
        float corr[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mnew = fmaxf(m[i], quad_max(mx[i]));
          corr[i] = exp2f(m[i] - mnew);    // 0 on the first sub-tile
          m[i] = mnew;
          l[i] *= corr[i];
        }
        if constexpr (!ROUND) {
#pragma unroll
          for (int dt = 0; dt < DT; ++dt)
#pragma unroll
            for (int c = 0; c < 4; ++c) o[dt][c] *= corr[c >> 1];
        }
      }
      if (stats) {
        // the first pass: the rows' running sums alone
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) l[c >> 1] += exp2f(s[nt][c] - m[c >> 1]);
        continue;
      }

      // probabilities, then the keep mask: ROUND normalised and rounded to
      // bf16, the kept ones divided in bf16 by bf16(1 - rate); else
      // unnormalised (their sum kept) times keep / (1 - rate)
#pragma unroll
      for (int nt = 0; nt < kSub / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = kt0 + sub + 8 * nt + 2 * tq + (c & 1);
          float p = exp2f(s[nt][c] - m[c >> 1]);
          if constexpr (ROUND) {
            p = round_bf16(p * inv[c >> 1]);
            if (dropout)
              p = drop.keep(row[c >> 1], j, rate, keep_scale) != 0.f ? round_bf16(p * keep_rcp)
                                                                    : 0.f;
          } else {
            l[c >> 1] += p;
            if (dropout) p *= drop.keep(row[c >> 1], j, rate, keep_scale);
          }
          s[nt][c] = p;
        }
      }

      // O += P V, P straight from the S accumulators; kFlush k-steps of
      // 8 keys at a time summed apart and then added
      if constexpr (SPLIT) {
        FragA pa[kSub / 8];
#pragma unroll
        for (int nt = 0; nt < kSub / 8; ++nt)
          if (nt < NT) pa[nt] = a_from_c<SPLIT>(s[nt]);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
          for (int nt0 = 0; nt0 < kSub / 8; nt0 += kFlush) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int nt = nt0; nt < nt0 + kFlush; ++nt)
              if (nt < NT) mma<SPLIT>(t, pa[nt], load_b_perm<SPLIT>(sVs, ld, 8 * nt, 8 * dt, lane));
#pragma unroll
            for (int c = 0; c < 4; ++c) o[dt][c] += t[c];
          }
        }
      } else if constexpr (ROUND) {
        // P, bf16 already, in one product; V's fragments by ldmatrix.trans
        Frag16A pb[kSub / 16];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          if (2 * kk < NT) pb[kk] = a16_from_c_bf16(s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
#pragma unroll
          for (int kk0 = 0; kk0 < kSub / 16; kk0 += kFlush / 2) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = kk0; kk < kk0 + kFlush / 2; ++kk) {
              if (2 * kk < NT) {
                Frag16B b0, b1;
                load_b16_trans(sVs, ld, 16 * kk, 8 * dt, lane, b0, b1);
                mma_bf16(t0, pb[kk], b0);
                mma_bf16(t1, pb[kk], b1);
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              o[dt][c] += t0[c];
              o[dt + 1][c] += t1[c];
            }
          }
        }
      } else {
        // P in bf16 hi + lo, V's fragments by ldmatrix.trans
        Frag16A ph[kSub / 16], pl[kSub / 16];
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          if (2 * kk < NT) a16_from_c(s[2 * kk], s[2 * kk + 1], ph[kk], pl[kk]);
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
#pragma unroll
          for (int kk0 = 0; kk0 < kSub / 16; kk0 += kFlush / 2) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = kk0; kk < kk0 + kFlush / 2; ++kk) {
              if (2 * kk < NT) {
                Frag16B b0, b1;
                load_b16_trans(sVs, ld, 16 * kk, 8 * dt, lane, b0, b1);
                mma_bf16x2(t0, ph[kk], pl[kk], b0);
                mma_bf16x2(t1, ph[kk], pl[kk], b1);
              }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              o[dt][c] += t0[c];
              o[dt + 1][c] += t1[c];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if constexpr (!ROUND) l[i] = quad_sum(l[i]);   // ROUND: summed already
    if (row[i] >= Lq) continue;
    // ROUND: P was normalised before P V
    const float inv = ROUND ? 1.f : 1.f / l[i];
    T* orow = out + ((size_t)bh * Lq + row[i]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = 8 * dt + 2 * tq;
      if (d < D) store2(orow, d, D, o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv);
    }
    if (lse != nullptr && tq == 0)
      lse[(size_t)bh * Lq + row[i]] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// warps per block: one 16-row slab each, up to 8
int warps_for(int Lq) { return Lq >= 128 ? 8 : (Lq + 15) / 16; }

// keys per staged tile: all of them, in whole sub-tiles, up to kBK
int key_tile(int Lk) { return Lk >= kBK ? kBK : (Lk + kSub - 1) / kSub * kSub; }

template <typename T>
size_t smem_bytes(int W, int bk, int D) {
  const int ld = row_stride<T>(8 * head_tiles(D));
  return region<T>((size_t)16 * W * ld) + region<T>((size_t)2 * bk * ld);
}

template <typename T, int DT, bool ROUND>
int launch_dt(const T* q, const T* k, const T* v, const float* mask, T* out,
              float* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
              float rate, float keep_scale, float keep_rcp, int seed, int hb,
              cudaStream_t stream) {
  const int W = warps_for(Lq);
  const int bk = key_tile(Lk);
  const size_t smem = smem_bytes<T>(W, bk, D);
  // raise the instantiation's shared-memory limit once on each device (the
  // limit is a device's), to the most any launch needs (every launch stays
  // within kMaxSmem)
  static unsigned long long raised = 0;  // bit d: raised on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !(raised & (1ull << dev))) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<T, DT, ROUND>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised |= 1ull << dev;
  }
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid(B * H, (Lq + 16 * W - 1) / (16 * W));
  attention_fwd_kernel<T, DT, ROUND><<<grid, 32 * W, smem, stream>>>(
      q, k, v, mask, out, lse, H, Lq, Lk, D, Lm, scale, rate, keep_scale, keep_rcp,
      (uint32_t)seed, hb, bk, vec);
  return (int)cudaGetLastError();
}

template <typename T, bool ROUND>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, void* lse, int B, int H, int Lq, int Lk, int D, int Lm,
           float scale, float rate, float keep_scale, float keep_rcp, int seed, int hb,
           cudaStream_t stream) {
#define CRCT_FWD(DT)                                                               \
  return launch_dt<T, DT, ROUND>(                                                  \
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
      static_cast<const float*>(mask), static_cast<T*>(out), static_cast<float*>(lse), \
      B, H, Lq, Lk, D, Lm, scale, rate, keep_scale, keep_rcp, seed, hb, stream)
  switch (head_tiles(D)) {
    case 4: CRCT_FWD(4);
    case 6: CRCT_FWD(6);
    case 8: CRCT_FWD(8);
    default: CRCT_FWD(16);
  }
#undef CRCT_FWD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/out [B,H,Lq,D],
// k/v [B,H,Lk,D] in that dtype, mask [B,1,Lm,Lk] float32 with Lm in {1, Lq},
// lse float32 [B,H,Lq] or null (not written). keep_scale is the fp32
// 1 / (1 - rate), keep_rcp the fp32 1 / bf16(1 - rate); round_p (bf16
// only: in fp32 the two modes are one function) rounds P as the JAX default
// path does. Returns the CUDA error code of the launch (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse, int dtype,
                             int B, int H, int Lq, int Lk, int D, int Lm,
                             float scale, float rate, float keep_scale, float keep_rcp,
                             int seed, int hb, int round_p, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm, scale,
                                rate, keep_scale, keep_rcp, seed, hb, s);
  if (dtype == 1 && round_p)
    return launch<__nv_bfloat16, true>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm,
                                       scale, rate, keep_scale, keep_rcp, seed, hb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm,
                                        scale, rate, keep_scale, keep_rcp, seed, hb, s);
  return (int)cudaErrorInvalidValue;
}
