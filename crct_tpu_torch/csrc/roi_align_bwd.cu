// Multilevel RoIAlign backward (K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel crct_tpu/ops/roi_align_pallas.py::_bwd_kernel
// (driven by _level_backward and mlra_backward_pallas): the gradient of FPN
// RoIAlign (aligned, S x S bilinear samples a bin, mean over the samples)
// with respect to the pyramid's feature maps. The TPU kernel owns a slab of
// output rows in VMEM, skips the rois whose y-extent misses the slab and adds
// each sample row into its two bilinear corner rows. Here each block owns one
// output tile of one level, and every element of the gradient is written
// once, by the block that owns it, in the maps' dtype: no zeroed pyramid, no
// global atomics, no cast pass.
//
// Grid: one block per (8 x 8 tile of one level, chunk of up to kMaxThreads
// channels); the output is the flat pyramid [R, C] that the forward gathers
// from (crct_tpu_torch/ops/roi_align.py), levels one after another. The
// coarsest level's tiles come first in the grid: the large rois assigned to
// it all overlap, so its blocks run longest and start earliest. Each thread
// owns one channel and keeps that channel's 8 x 8 fp32 sums in registers: no
// two threads share a sum, and an add is an FMA, with no shared-memory round
// trip whose latency would chain the adds.
//
// A roi's samples are monotone along each axis, so its footprint on its level
// is [y0[n, 0], y1i[n, PS-1]] x [x0[n, 0], x1i[n, PS-1]] (the ymin / ymax
// of the Pallas backward's slab test, and their x analogue). A block scans
// the rois `threads` at a time and compacts those on its level whose
// footprint meets the tile into a list in roi order (warp ballots); a list
// of any length is taken, a chunk of `threads` rois at a time. The listed
// rois go in groups of up to kMaxGroup, as many as kGroupBytes of shared
// memory stage:
//   1. one thread for each (roi, axis, bin row or column p) turns the
//      corners of p's S samples into a dense weight vector over the tile's
//      kTile rows (columns), summing, in sample order and lo before hi, the
//      weights of corners that fall on one position (the two clamped corners
//      at the map's last row or column, or samples of a narrow box), and a
//      bit mask of the positions hit; the row weights carry the 1 / S^2 of
//      the mean;
//   2. lane m of warp 0 lists roi m's bin rows and columns that hit the
//      tile, and the block lists the group's bins (p, q) that hit it, roi by
//      roi, row by row;
//   3. the block copies g[n, p, q, c0 .. c0 + threads) of kBatch bins at a
//      time into shared memory with 16-byte cp.async (each bin's channels a
//      contiguous segment; each element read once), the next batch's copies
//      in flight while the threads add the current one's: without them a
//      tile under many rois waited on one load of g an add. Each thread sums
//      a bin row's g[p, q] * wx[q][k] over its columns q in 8 registers u[k]
//      and adds wy[p][j] * u[k] into its 8 x 8 sums once the row is done
//      (zero weights where the row or a column misses the tile).
// The rois, bins and positions always go in the same order: the result is
// the same, bit for bit, from run to run. It differs from the plain
// version's (index_add_ of each corner's g / S^2 * wy * wx) by the order of
// the fp32 sums: the weights of coinciding corners are summed first, and a
// row's columns before its rows. A tile that no roi touches stores zeros and
// reads no geometry beyond the scan.
//
// Store: once, in the output dtype (fp32 as it is; bf16 rounded to nearest
// even from the fp32 sum, once, as the plain version rounds). A touched tile
// is stored from the registers, position by position: a warp writes 32
// neighbouring channels of one position, the tile's row of positions a
// contiguous 8 KB (fp32, C = 256). An untouched tile stores zeros with
// 16-byte vector stores, neighbouring threads on neighbouring addresses.
//
// What bounds it: the bound is the bytes (at the 1344^2 canvas, C = 256, the
// fp32 pyramid gradient is 153.5 MB, written once, against 12.8 MB of g for
// the box shape), but the card holds two blocks an SM (128 registers a
// thread), and a touched tile's block spends most of its time waiting on
// its chain of the scan, the staging, g's copies and the barriers between
// them; a tile under many rois (a coarse level under whole-figure boxes) or
// under one small roi whose P^2 bins all fall in it does all of their adds
// in one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;          // positions of a tile, each side
constexpr int kMaxThreads = 256;  // channels of a block, one a thread
constexpr int kMaxLevels = 8;
constexpr int kMaxP = 1024;       // bins a side (10 bits of an entry)
constexpr int kGroupBytes = 24576;  // shared memory of a group's staging
constexpr int kMaxGroup = 32;     // rois a group, one lane of warp 0 each
constexpr int kBatch = 32;        // bins of g a block copies at once

// The levels as the grid orders them: position i holds level lev[i], whose
// tiles are blocks start[i] .. start[i + 1] - 1.
struct Levels {
  int n;
  int lev[kMaxLevels];
  int start[kMaxLevels + 1];
  int H[kMaxLevels];
  int W[kMaxLevels];
  long long off[kMaxLevels];  // the level's first flat row
};

// A staged roi, one axis after the other (y, then x): for each bin row
// (column) p the dense weights w[p][kTile] over the tile's rows (columns);
// the bit mask of the positions each p hits; the p that hit any, in order,
// and their count; padded to 16 bytes. Each roi also has room for its bins
// that hit the tile in the group's two entry arrays.
__host__ __device__ inline int axis_words(int P) {
  return P * kTile + ((2 * P + 1 + 3) & ~3);
}

__host__ __device__ inline int roi_words(int P) {
  return 2 * axis_words(P) + 2 * P * P;
}

// Rois staged at once: as many as kGroupBytes holds, 1 to kMaxGroup.
__host__ __device__ inline int group_size(int P) {
  const int g = kGroupBytes / (4 * roi_words(P));
  return g < 1 ? 1 : (g > kMaxGroup ? kMaxGroup : g);
}

// Two buffers of kBatch bins of g (esize bytes an element), the staging
// and entries, the rois' first entries, the roi list, the warp counts and
// the entry count.
__host__ __device__ inline size_t smem_bytes(int P, int threads, int esize) {
  return 2 * (size_t)kBatch * threads * esize +
         sizeof(float) * ((size_t)group_size(P) * roi_words(P) + kMaxGroup +
                          threads + threads / 32 + 1);
}

template <typename T>
__device__ __forceinline__ float to_float(T v);

template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);

template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the last committed group of this thread's copies
__device__ __forceinline__ void copy_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes of zeros
template <typename TO>
__device__ __forceinline__ void zero16(TO* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

// acc[j][k] += wy[j] * u[k], wy the weights of bin row p of roi m
// (row = m << 10 | p) over the tile's rows
__device__ __forceinline__ void add_row(float (&acc)[kTile][kTile],
                                        const float (&u)[kTile],
                                        const float* stage, int row,
                                        int AW) {
  const float* wy = stage + 2 * (row >> 10) * AW + (row & (kMaxP - 1)) * kTile;
  const float4 y_lo = *reinterpret_cast<const float4*>(wy);
  const float4 y_hi = *reinterpret_cast<const float4*>(wy + 4);
  const float yv[kTile] = {y_lo.x, y_lo.y, y_lo.z, y_lo.w,
                           y_hi.x, y_hi.y, y_hi.z, y_hi.w};
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) acc[j][k] += yv[j] * u[k];
  }
}

// g:    [N, P, P, C] cotangent of the pooled output (fp32 or bf16)
// lvl:  [N] int64 level of each roi
// y0, y1i, x0, x1i: [N, P*S] int64 level-local corner rows / columns
// wy0, wy1, wx0, wx1: [N, P*S] fp32 corner weights
// out:  [R, C] flat pyramid gradient (fp32 or bf16), every element written
template <typename TG, typename TO>
__global__ void __launch_bounds__(kMaxThreads, 2) roi_align_bwd_kernel(
    const TG* __restrict__ g, const int64_t* __restrict__ lvl,
    const int64_t* __restrict__ y0, const int64_t* __restrict__ y1i,
    const int64_t* __restrict__ x0, const int64_t* __restrict__ x1i,
    const float* __restrict__ wy0, const float* __restrict__ wy1,
    const float* __restrict__ wx0, const float* __restrict__ wx1,
    TO* __restrict__ out, const Levels L, int N, int P, int S, int C,
    float inv_s2) {
  extern __shared__ float4 smem4[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int PS = P * S;
  const int AW = axis_words(P);
  const int G = group_size(P);
  TG* gbuf = reinterpret_cast<TG*>(smem4);  // [2][kBatch][T]
  float* stage = reinterpret_cast<float*>(gbuf + 2 * kBatch * T);
  int* keys = reinterpret_cast<int*>(stage + G * 2 * AW);  // m << 20 | p << 10 | q
  int* bins = keys + G * P * P;  // the bin's row of g: n * P * P + p * P + q
  int* first = bins + G * P * P;  // each roi's first entry
  int* list = first + kMaxGroup;
  int* wcount = list + T;
  int* n_entries = wcount + T / 32;

  // this block's tile and channels
  int i = 0;
  while (i + 1 < L.n && (int)blockIdx.x >= L.start[i + 1]) ++i;
  const int l = L.lev[i];
  const int H = L.H[l], W = L.W[l];
  const int tiles_x = (W + kTile - 1) / kTile;
  const int local = blockIdx.x - L.start[i];
  const int ty0 = (local / tiles_x) * kTile;
  const int tx0 = (local % tiles_x) * kTile;
  const int ny = min(kTile, H - ty0);
  const int nx = min(kTile, W - tx0);
  const int c0 = blockIdx.y * T;
  const int cw = min(T, C - c0);
  const int warp = tid >> 5, lane = tid & 31;

  float acc[kTile][kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
#pragma unroll
    for (int k = 0; k < kTile; ++k) acc[j][k] = 0.f;
  }
  bool touched = false;
  for (int base = 0; base < N; base += T) {
    // the rois of this chunk whose footprint meets the tile, in roi order
    const int n = base + tid;
    bool hit = false;
    if (n < N) {  // five loads at once, not the footprint after the level
      const size_t first = (size_t)n * PS, last = first + PS - 1;
      const int64_t lv = lvl[n], ya = y0[first], yb = y1i[last];
      const int64_t xa = x0[first], xb = x1i[last];
      hit = lv == l && ya < ty0 + ny && yb >= ty0 && xa < tx0 + nx &&
            xb >= tx0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, hits = 0;
    for (int w = 0; w < T / 32; ++w) {
      offset += w < warp ? wcount[w] : 0;
      hits += wcount[w];
    }
    if (hits == 0) {
      __syncthreads();  // wcount is rewritten by the next chunk
      continue;
    }
    if (hit) list[offset + __popc(ballot & ((1u << lane) - 1u))] = n;
    touched = true;
    for (int h0 = 0; h0 < hits; h0 += G) {
      const int gn = min(G, hits - h0);
      // the list; the last group's adds, before its staging is overwritten
      __syncthreads();
      // 1. each (roi, axis, bin row or column)'s weights over the tile
      for (int k = tid; k < gn * 2 * P; k += T) {
        const int m = k / (2 * P);
        const bool xaxis = k - m * 2 * P >= P;
        const int p = k - m * 2 * P - (xaxis ? P : 0);
        const size_t at = (size_t)list[h0 + m] * PS + (size_t)p * S;
        const int64_t* lo = (xaxis ? x0 : y0) + at;
        const int64_t* hi = (xaxis ? x1i : y1i) + at;
        const float* wlo = (xaxis ? wx0 : wy0) + at;
        const float* whi = (xaxis ? wx1 : wy1) + at;
        const int start = xaxis ? tx0 : ty0;
        const int extent = xaxis ? nx : ny;
        const float scale = xaxis ? 1.f : inv_s2;
        float* ax = stage + (2 * m + (xaxis ? 1 : 0)) * AW;
        float* w = ax + p * kTile;
        *reinterpret_cast<float4*>(w) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(w + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
        int mask = 0;
        for (int s = 0; s < S; ++s) {
          const int64_t a = lo[s] - start, b = hi[s] - start;
          if (a >= 0 && a < extent) {
            w[a] += wlo[s] * scale;
            mask |= 1 << a;
          }
          if (b >= 0 && b < extent) {
            w[b] += whi[s] * scale;
            mask |= 1 << b;
          }
        }
        reinterpret_cast<int*>(ax + P * kTile)[p] = mask;
      }
      __syncthreads();
      // 2. lane m of warp 0 lists roi m's rows and columns that hit the
      // tile; the roi's bins that hit it, rows x columns, come after those
      // of the rois before it
      if (warp == 0) {
        int rows = 0, cols = 0;
        if (lane < gn) {
          float* ys = stage + 2 * lane * AW;
          int* ym = reinterpret_cast<int*>(ys + P * kTile);
          int* xm = ym + AW;
          for (int p = 0; p < P; ++p) {
            if (ym[p] != 0) ym[P + rows++] = p;
            if (xm[p] != 0) xm[P + cols++] = p;
          }
          ym[2 * P] = rows;
          xm[2 * P] = cols;
        }
        const int count = rows * cols;
        int end = count;
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, end, d);
          if (lane >= d) end += v;
        }
        if (lane < gn) first[lane] = end - count;
        if (lane == 31) *n_entries = end;
      }
      __syncthreads();
      // the entries, one a thread at a time: (roi, p, q) and g's row
      const int ne = *n_entries;
      for (int e = tid; e < ne; e += T) {
        int m = 0;
        while (m + 1 < gn && first[m + 1] <= e) ++m;
        const int* ym = reinterpret_cast<const int*>(stage + 2 * m * AW +
                                                     P * kTile);
        const int* xm = ym + AW;
        const int cols = xm[2 * P];
        const int r = (e - first[m]) / cols, c = e - first[m] - r * cols;
        const int p = ym[P + r], q = xm[P + c];
        keys[e] = (m << 20) | (p << 10) | q;
        bins[e] = list[h0 + m] * P * P + p * P + q;
      }
      __syncthreads();
      // 3. the adds. g's rows of kBatch bins at a time are copied to
      // shared memory (16-byte cp.async, the block's channels of a bin a
      // contiguous segment), the next batch's copies in flight while the
      // threads add the current one's
      const int batches = (ne + kBatch - 1) / kBatch;
      const int chunks = cw * (int)sizeof(TG) / 16;  // a bin's 16-byte parts
      auto fetch = [&](int b) {
        const int nb = min(kBatch, ne - b * kBatch);
        TG* buf = gbuf + (b & 1) * kBatch * T;
        for (int x = tid; x < nb * chunks; x += T) {
          const int slot = x / chunks, part = x - slot * chunks;
          const size_t bin = (size_t)bins[b * kBatch + slot];
          copy16_async(reinterpret_cast<char*>(buf + slot * T) + 16 * part,
                       reinterpret_cast<const char*>(g + bin * C + c0) +
                           16 * part);
        }
        copy_commit();
      };
      // u: the current (roi, bin row)'s sum over its columns,
      // sum_q g[p, q] * wx[q][k]; added into the tile as wy[p][j] * u[k]
      // when the row changes
      int row = -1;
      float u[kTile] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (batches > 0) fetch(0);
      for (int b = 0; b < batches; ++b) {
        if (b + 1 < batches) {
          fetch(b + 1);
        } else {
          copy_commit();  // an empty group: the wait below is for batch b
        }
        copy_wait_but_last();
        __syncthreads();  // every thread's copies of batch b
        if (tid < cw) {
          const TG* buf = gbuf + (b & 1) * kBatch * T + tid;
          const int nb = min(kBatch, ne - b * kBatch);
          for (int v = 0; v < nb; ++v) {
            const int e = keys[b * kBatch + v];
            if ((e >> 10) != row) {  // a new (roi, bin row): add the last
              if (row >= 0) add_row(acc, u, stage, row, AW);
              row = e >> 10;
#pragma unroll
              for (int k = 0; k < kTile; ++k) u[k] = 0.f;
            }
            const float gv = to_float(buf[v * T]);
            const float* wx = stage + 2 * (e >> 20) * AW + AW +
                              (e & (kMaxP - 1)) * kTile;
            const float4 x_lo = *reinterpret_cast<const float4*>(wx);
            const float4 x_hi = *reinterpret_cast<const float4*>(wx + 4);
            u[0] += gv * x_lo.x;
            u[1] += gv * x_lo.y;
            u[2] += gv * x_lo.z;
            u[3] += gv * x_lo.w;
            u[4] += gv * x_hi.x;
            u[5] += gv * x_hi.y;
            u[6] += gv * x_hi.z;
            u[7] += gv * x_hi.w;
          }
        }
        __syncthreads();  // batch b's buffer, before batch b + 2's copies
      }
      if (row >= 0 && tid < cw) add_row(acc, u, stage, row, AW);
    }
    __syncthreads();  // the adds, before the next chunk's list
  }

  // one store of the tile
  TO* dst = out + ((size_t)L.off[l] + (size_t)ty0 * W + tx0) * C + c0;
  if (touched) {
    if (tid < cw) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          if (j < ny && k < nx) {
            dst[((size_t)j * W + k) * C + tid] = from_float<TO>(acc[j][k]);
          }
        }
      }
    }
  } else {
    constexpr int V = 16 / sizeof(TO);
    const int per_row = nx * cw / V;
    for (int v = tid; v < ny * per_row; v += T) {
      const int j = v / per_row;
      const int e = (v - j * per_row) * V;
      const int k = e / cw, ch = e - k * cw;
      zero16<TO>(dst + ((size_t)j * W + k) * C + ch);
    }
  }
}

int threads_for(int C) {
  const int t = ((C + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

using KernelPtr = const void*;

KernelPtr kernel_for(int dtype_g, int dtype_out) {
  if (dtype_g == 0 && dtype_out == 0)
    return (KernelPtr)roi_align_bwd_kernel<float, float>;
  if (dtype_g == 0 && dtype_out == 1)
    return (KernelPtr)roi_align_bwd_kernel<float, __nv_bfloat16>;
  if (dtype_g == 1 && dtype_out == 0)
    return (KernelPtr)roi_align_bwd_kernel<__nv_bfloat16, float>;
  if (dtype_g == 1 && dtype_out == 1)
    return (KernelPtr)roi_align_bwd_kernel<__nv_bfloat16, __nv_bfloat16>;
  return nullptr;
}

// The grid's levels, coarsest first; false if a level cannot be taken.
bool make_levels(const int* hw, int n_levels, Levels* L, int* tiles) {
  if (n_levels < 1 || n_levels > kMaxLevels) return false;
  L->n = n_levels;
  long long off = 0;
  for (int l = 0; l < n_levels; ++l) {
    L->H[l] = hw[2 * l];
    L->W[l] = hw[2 * l + 1];
    if (L->H[l] < 1 || L->W[l] < 1) return false;
    L->off[l] = off;
    off += (long long)L->H[l] * L->W[l];
  }
  long long total = 0;
  for (int i = 0; i < n_levels; ++i) {
    const int l = n_levels - 1 - i;
    L->lev[i] = l;
    L->start[i] = (int)total;
    total += (long long)((L->H[l] + kTile - 1) / kTile) *
             ((L->W[l] + kTile - 1) / kTile);
    if (total > 0x7fffffffLL) return false;
  }
  L->start[n_levels] = (int)total;
  *tiles = (int)total;
  return true;
}

bool shape_ok(int N, int P, int S, int C, int dtype_g, int dtype_out) {
  return N >= 1 && P >= 1 && P < kMaxP && (long long)N * P * P < (1LL << 31) &&
         S >= 1 && C >= 8 &&
         C % 8 == 0 &&
         kernel_for(dtype_g, dtype_out) != nullptr &&
         smem_bytes(P, threads_for(C), dtype_g == 0 ? 4 : 2) <= 232448;
}

}  // namespace

extern "C" {

// The launch's layout for P, S, C, the dtypes (0 fp32, 1 bf16) and the
// levels' (H, W) pairs hw[2 * n_levels]: info = {tile rows, tile columns,
// threads a block, dynamic shared memory bytes, resident blocks an SM, grid
// x (tiles), grid y (channel chunks), rois staged at once}. Returns a CUDA
// error code.
int roi_align_bwd_info(int P, int S, int C, int dtype_g, int dtype_out,
                       const int* hw, int n_levels, int* info) {
  Levels L;
  int tiles = 0;
  if (!shape_ok(1, P, S, C, dtype_g, dtype_out) ||
      !make_levels(hw, n_levels, &L, &tiles)) {
    return cudaErrorInvalidValue;
  }
  const int threads = threads_for(C);
  const size_t smem = smem_bytes(P, threads, dtype_g == 0 ? 4 : 2);
  const KernelPtr k = kernel_for(dtype_g, dtype_out);
  int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads,
                                                           smem);
  if (err) return err;
  info[0] = kTile;
  info[1] = kTile;
  info[2] = threads;
  info[3] = (int)smem;
  info[4] = per_sm;
  info[5] = tiles;
  info[6] = (C + threads - 1) / threads;
  info[7] = group_size(P);
  return 0;
}

// One launch writes the whole [sum H * W, C] gradient `out` (dtype_out)
// from g (dtype_g) and the forward's geometry. Returns the CUDA error of the
// launch.
int roi_align_bwd(const void* g, const int64_t* lvl, const int64_t* y0,
                  const int64_t* y1i, const int64_t* x0, const int64_t* x1i,
                  const float* wy0, const float* wy1, const float* wx0,
                  const float* wx1, void* out, const int* hw, int n_levels,
                  int dtype_g, int dtype_out, int N, int P, int S, int C,
                  cudaStream_t stream) {
  Levels L;
  int tiles = 0;
  if (!shape_ok(N, P, S, C, dtype_g, dtype_out) ||
      !make_levels(hw, n_levels, &L, &tiles)) {
    return cudaErrorInvalidValue;
  }
  const int threads = threads_for(C);
  const size_t smem = smem_bytes(P, threads, dtype_g == 0 ? 4 : 2);
  const KernelPtr k = kernel_for(dtype_g, dtype_out);
  const int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const dim3 grid(tiles, (C + threads - 1) / threads);
  const float inv_s2 = 1.0f / (float)(S * S);
  void* args[] = {(void*)&g,   (void*)&lvl, (void*)&y0,  (void*)&y1i,
                  (void*)&x0,  (void*)&x1i, (void*)&wy0, (void*)&wy1,
                  (void*)&wx0, (void*)&wx1, (void*)&out, (void*)&L,
                  (void*)&N,   (void*)&P,   (void*)&S,   (void*)&C,
                  (void*)&inv_s2};
  const cudaError_t launch =
      cudaLaunchKernel(k, grid, dim3(threads), args, smem, stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(launch != cudaSuccess ? launch : last);
}

}  // extern "C"
