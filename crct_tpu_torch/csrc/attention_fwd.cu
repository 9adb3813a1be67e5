// Fused multi-head attention forward for Hopper (sm_90a).
//
// Replaces crct_tpu/ops/attention.py::_fwd_kernel (the Pallas TPU kernel):
//   out = (softmax(q k^T / sqrt(D) + mask) * keep / (1 - rate)) v
// with fp32 scores, a max-subtracted fp32 softmax, fp32 probabilities all the
// way through P.V, and the output stored in the input dtype (fp32 or bf16).
// The optional dropout keep mask is the JAX kernel's murmur3 counter hash,
// bit for bit: the same int seed gives the same mask.
//
// What bounds it on an H100: at the flagship shapes the work per (batch, head)
// is tiny (text: 124 x 124 scores over D = 48), so at B = 240 rows in fp32 a
// text launch does 4*B*H*Lq*Lk*D ~ 11.3 GFLOP and must move q, k, v and out,
// ~366 MB: 0.17 ms at the 67 TFLOP/s fp32 CUDA-core peak against 0.11 ms at
// 3.35 TB/s, so operations bound it.
//
// Design (simple and right first): one block per (batch, head). K and V of
// that head are staged once in shared memory as fp32 (row stride D + 1, so
// lanes reading different keys hit different banks), and one warp works on
// one query row at a time: lane-strided scores into a per-warp row buffer,
// warp-shuffle max and sum, then P.V lane-strided over D. When K and V do not
// both fit in shared memory (large D and Lk), they are streamed in tiles for
// every group of rows instead. Left for later: tensor cores (wgmma), TMA
// loads, several rows per warp and a bf16 staging of K and V.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     T* __restrict__ out, int H, int Lq, int Lk, int D, int Lm,
                     float scale, float rate, float keep_scale, uint32_t seed,
                     int hb, int tile, int resident) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;

  float* sk = smem;
  float* sv = resident ? sk + (size_t)Lk * ld : sk;
  float* sq = (resident ? sv + (size_t)Lk * ld : sk + (size_t)tile * ld);
  float* sp = sq + kWarps * D;
  float* myq = sq + warp * D;
  float* myp = sp + warp * Lk;

  const T* qh = q + (size_t)bh * Lq * D;
  const T* kh = k + (size_t)bh * Lk * D;
  const T* vh = v + (size_t)bh * Lk * D;
  T* oh = out + (size_t)bh * Lq * D;
  const float* mb = mask + (size_t)b * Lm * Lk;

  const DropoutStream drop(seed, b, h, H, hb);

  if (resident) {
    stage(sk, kh, 0, Lk, D, ld);
    stage(sv, vh, 0, Lk, D, ld);
    __syncthreads();
  }

  // the bounds of both loops are the same for every thread of the block, so
  // the barriers of the streamed path are reached by all warps
  for (int r0 = 0; r0 < Lq; r0 += kWarps) {
    const int r = r0 + warp;
    const bool active = r < Lq;
    if (active) {
      for (int d = lane; d < D; d += 32) myq[d] = to_f32(qh[(size_t)r * D + d]);
    }
    __syncwarp();

    // scores s_j = (q . k_j) * scale + mask
    const float* mrow = mb + (Lm == 1 ? 0 : (size_t)r * Lk);
    for (int t0 = 0; t0 < Lk; t0 += tile) {
      const int n = min(tile, Lk - t0);
      const float* kt = sk;
      if (resident) {
        kt = sk + (size_t)t0 * ld;
      } else {
        __syncthreads();
        stage(sk, kh, t0, n, D, ld);
        __syncthreads();
      }
      if (active) {
        for (int j = lane; j < n; j += 32)
          myp[t0 + j] = dot(myq, kt + j * ld, D) * scale + mrow[t0 + j];
      }
    }
    __syncwarp();

    // probabilities, kept in fp32, with the dropout keep mask applied
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
      for (int j = lane; j < Lk; j += 32) {
        float p = myp[j] / l;
        if (rate > 0.f) p = p * drop.keep(r, j, rate, keep_scale);
        myp[j] = p;
      }
    }
    __syncwarp();

    // out = P . V, lanes strided over D
    float acc[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) acc[c] = 0.f;
    for (int t0 = 0; t0 < Lk; t0 += tile) {
      const int n = min(tile, Lk - t0);
      const float* vt = sv;
      if (resident) {
        vt = sv + (size_t)t0 * ld;
      } else {
        __syncthreads();
        stage(sk, vh, t0, n, D, ld);
        __syncthreads();
      }
      if (active) {
        for (int j = 0; j < n; ++j) {
          const float p = myp[t0 + j];
          const float* vj = vt + j * ld;
#pragma unroll
          for (int c = 0; c < kMaxChunks; ++c) {
            const int d = lane + 32 * c;
            if (d < D) acc[c] = fmaf(p, vj[d], acc[c]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        const int d = lane + 32 * c;
        if (d < D) store(oh + (size_t)r * D + d, acc[c]);
      }
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* out, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
           float rate, float keep_scale, int seed, int hb, cudaStream_t stream) {
  const size_t fixed = (size_t)kWarps * (D + Lk) * sizeof(float);
  const size_t row = (size_t)(D + 1) * sizeof(float);
  int resident = fixed + 2 * (size_t)Lk * row <= (size_t)kMaxSmem;
  int tile = Lk;
  size_t smem = fixed + 2 * (size_t)Lk * row;
  if (!resident) {
    if (fixed + row > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    tile = (int)((kMaxSmem - fixed) / row);
    if (tile > Lk) tile = Lk;
    smem = fixed + (size_t)tile * row;
  }
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(out), H, Lq, Lk, D, Lm, scale, rate, keep_scale,
      (uint32_t)seed, hb, tile, resident);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/out [B,H,Lq,D],
// k/v [B,H,Lk,D] in that dtype, mask [B,1,Lm,Lk] float32 with Lm in {1, Lq}.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, int dtype, int B,
                             int H, int Lq, int Lk, int D, int Lm, float scale,
                             float rate, float keep_scale, int seed, int hb,
                             void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, out, B, H, Lq, Lk, D, Lm, scale, rate,
                         keep_scale, seed, hb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, out, B, H, Lq, Lk, D, Lm,
                                 scale, rate, keep_scale, seed, hb, s);
  return (int)cudaErrorInvalidValue;
}
