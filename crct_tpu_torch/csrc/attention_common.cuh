// Device helpers shared by the attention kernels (attention_fwd.cu and
// attention_bwd.cu): fp32/bf16 loads and stores, warp reductions, staging of
// a head's rows in shared memory, and the dropout hash of the JAX kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kMaxChunks = kMaxD / 32;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// crct_tpu/ops/attention.py::_uniform_hash at iota position (i0, i1, i2):
// U[0,1) from the murmur3 finalizer, in wrapping uint32 arithmetic.
__device__ __forceinline__ float uniform_hash(uint32_t seed, uint32_t i0,
                                              uint32_t i1, uint32_t i2) {
  uint32_t h = i0 * 0x9E3779B9u;
  h ^= i1 * 0x85EBCA6Bu;
  h ^= i2 * 0xC2B2AE35u;
  h += seed * 2654435761u;
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return __uint_as_float((h >> 9) | 0x3F800000u) - 1.0f;
}

// The dropout stream of the JAX grid program (b, h // hb) that holds head h:
// its seed, and the head's index on the iota's axis 0.
struct DropoutStream {
  uint32_t seed;
  uint32_t head;
  __device__ __forceinline__ DropoutStream(uint32_t base, int b, int h, int H, int hb)
      : seed(base + (uint32_t)(b * (H / hb) + h / hb) * 1000003u),
        head((uint32_t)(h % hb)) {}
  // the multiplier of probability (i, j): 0 or keep_scale
  __device__ __forceinline__ float keep(int i, int j, float rate, float keep_scale) const {
    return uniform_hash(seed, head, (uint32_t)i, (uint32_t)j) >= rate ? keep_scale : 0.f;
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + n) of one head's [L, D] matrix into shared memory as
// fp32 at row stride ld, by the whole block.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0, int n,
                                      int D, int ld) {
  const T* base = src + (size_t)row0 * D;
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int j = i / D;
    const int d = i - j * D;
    dst[j * ld + d] = to_f32(base[i]);
  }
}

// sum_d a[d] * b[d] in index order (both kernels recompute the same scores,
// so they must add in the same order)
__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

}  // namespace attn
