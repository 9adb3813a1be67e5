// Multilevel RoIAlign backward (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crct_tpu/ops/roi_align_pallas.py::_bwd_kernel
// (driven by _level_backward and mlra_backward_pallas): the gradient of FPN
// RoIAlign (aligned, S x S bilinear samples a bin, mean over the samples)
// with respect to the pyramid's feature maps. The TPU kernel builds each
// level's gradient slab by slab in VMEM, one pallas_call a level. Here one
// launch covers every level: blocks run in parallel and in no order, so
// the sums across rois go into one zeroed fp32 flat pyramid
// [sum_l H_l * W_l, C] with fp32 atomicAdd (the layout the forward gathers
// from, crct_tpu_torch/ops/roi_align.py).
//
// One block per (roi n, bin row p); the threads run over the channels, so
// consecutive threads add into consecutive addresses of one map row and
// the atomics coalesce. For each bin (p, q) a thread reads g[n, p, q, c]
// once and adds, for each of its S x S samples, w_y * w_x / S^2 * g into the
// four bilinear corners. The corner rows/columns and weights of the roi
// (computed by the wrapper, the forward's geometry) are staged in shared
// memory. Rois on another level need no skipping: each roi's corners
// already point into its own level's rows.
//
// What bounds it: the zeroed and written gradient pyramid (154 MB at the
// 1344^2 canvas, C = 256) against ~51 M atomic adds of 12.8 MB of g per
// call; the bytes set the bound (chip_smoke.py prints it). Atomics reorder
// the fp32 sums from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSamples = 64;   // P * S, checked by the wrapper

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// g:    [N, P, P, C] cotangent of the pooled output (fp32 or bf16)
// idx:  [N, 4, P*S] int32 corner indices: y_lo, y_hi, x_lo, x_hi
// wts:  [N, 4, P*S] fp32 corner weights: wy_lo, wy_hi, wx_lo, wx_hi
// roi:  [N, 2] int32: the roi's level's first flat row, and its width W
// out:  [R, C] fp32 flat pyramid gradient, zeroed by the caller
template <typename T>
__global__ void roi_align_bwd_kernel(const T* __restrict__ g,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ wts,
                                     const int* __restrict__ roi,
                                     float* __restrict__ out, int P, int S,
                                     int C, float inv_s2) {
  const int n = blockIdx.x;
  const int p = blockIdx.y;
  const int PS = P * S;
  __shared__ int s_row[2][kMaxSamples];     // flat row offsets of y_lo/y_hi
  __shared__ float s_wy[2][kMaxSamples];
  __shared__ int s_col[2][kMaxSamples];
  __shared__ float s_wx[2][kMaxSamples];

  const int* idx_n = idx + (size_t)n * 4 * PS;
  const float* w_n = wts + (size_t)n * 4 * PS;
  const int base = roi[2 * n];
  const int width = roi[2 * n + 1];
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) {
    const int corner = i / S;               // 0: lo, 1: hi
    const int r = p * S + i % S;            // this bin row's sample rows
    s_row[corner][i % S] = base + idx_n[corner * PS + r] * width;
    s_wy[corner][i % S] = w_n[corner * PS + r];
  }
  for (int i = threadIdx.x; i < 2 * PS; i += blockDim.x) {
    const int corner = i / PS;
    s_col[corner][i % PS] = idx_n[(2 + corner) * PS + i % PS];
    s_wx[corner][i % PS] = w_n[(2 + corner) * PS + i % PS];
  }
  __syncthreads();

  const T* g_np = g + ((size_t)n * P + p) * P * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    for (int q = 0; q < P; ++q) {
      const float gv = to_float(g_np[(size_t)q * C + c]) * inv_s2;
      for (int sy = 0; sy < S; ++sy) {
        for (int a = 0; a < 2; ++a) {
          const int64_t row = s_row[a][sy];
          const float wy = s_wy[a][sy];
          for (int sx = 0; sx < S; ++sx) {
            const int s = q * S + sx;
            for (int b = 0; b < 2; ++b) {
              const float w = wy * s_wx[b][s];
              atomicAdd(out + (row + s_col[b][s]) * C + c, gv * w);
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16 (of g). Returns the CUDA error of the launch.
int roi_align_bwd(const void* g, const int* idx, const float* wts,
                  const int* roi, float* out, int dtype, int N, int P, int S,
                  int C, cudaStream_t stream) {
  if (N < 1 || P < 1 || S < 1 || C < 1 || P * S > kMaxSamples) {
    return cudaErrorInvalidValue;
  }
  const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  const dim3 grid(N, P);
  const float inv_s2 = 1.0f / (float)(S * S);
  if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(g), idx, wts, roi, out, P, S, C, inv_s2);
  } else if (dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(g), idx, wts, roi, out, P, S, C,
        inv_s2);
  } else {
    return cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
