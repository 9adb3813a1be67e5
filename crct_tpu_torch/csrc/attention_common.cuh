// Device helpers shared by the attention kernels (attention_fwd.cu and
// attention_bwd.cu): the dropout hash of the JAX kernels, staging of tiles
// in shared memory with asynchronous 16-byte copies, and TF32 tensor-core
// products (mma.sync m16n8k8) with the fragment loads they take.
//
// Fragments, for lane = 4 * gr + tq (gr = lane / 4, tq = lane % 4), as the
// PTX ISA lays out m16n8k8 with TF32 operands:
//   A (16 x 8, row-major):  a0 (gr, tq)  a1 (gr + 8, tq)  a2 (gr, tq + 4)
//                           a3 (gr + 8, tq + 4)
//   B (8 x 8):              b0 (k = tq, n = gr)  b1 (k = tq + 4, n = gr)
//   C (16 x 8, fp32):       c0 (gr, 2 tq)  c1 (gr, 2 tq + 1)  c2 (gr + 8, 2 tq)
//                           c3 (gr + 8, 2 tq + 1)
// A product's sum over k may take its terms in any order. So a C fragment
// is used as the A operand of the next product as it lies in the registers,
// with k position tq standing for column 2 tq and tq + 4 for 2 tq + 1
// (a = {c0, c2, c1, c3}); the B operand is read with the same permutation
// of its k rows (load_b_perm). No shuffle moves P or dS between products.
//
// Precision: fp32 inputs use 3xTF32 (each operand split into a TF32 high
// part and a TF32 low part, summed as hi*lo + lo*hi + hi*hi in fp32
// accumulators), close to fp32 products. bf16 inputs run every product as
// bf16 m16n8k16 with fp32 accumulators: inputs times inputs exactly, and
// the fp32 probabilities and score gradients split into a bf16 high and a
// bf16 low part (two products), which keeps them to about 16 significant
// bits, finer than TF32's 11.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int kMaxD = 128;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// out[d] = x, out[d + 1] = y where d + 1 < D, else out[d] = x alone (d < D);
// one 32-bit store for a bf16 pair at an even offset
__device__ __forceinline__ void store2(float* out, int d, int D, float x, float y) {
  out[d] = x;
  if (d + 1 < D) out[d + 1] = y;
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, int d, int D, float x, float y) {
  if (d + 1 < D && ((reinterpret_cast<uintptr_t>(out + d) & 3) == 0))
    *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(x, y);
  else {
    out[d] = __float2bfloat16(x);
    if (d + 1 < D) out[d + 1] = __float2bfloat16(y);
  }
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max and sum over the four lanes of a quad, which hold one row of a C
// fragment between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row stride, in elements, of a tile of Dp (a multiple of 8) columns in
// shared memory: a multiple of 16 bytes (for 16-byte copies), and such that
// the fragment loads below, whose lanes read rows gr and columns tq (or rows
// 2 tq and columns gr), touch 32 different banks.
template <typename T>
__host__ __device__ constexpr int row_stride(int Dp) {
  return sizeof(T) == 4 ? Dp + 4 : Dp + (Dp % 16 == 0 ? 8 : 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// wait for every copy this thread started
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Rows [0, n) of a row-major [., D] matrix at src into dst (row stride ld),
// by the whole block, with columns [D, Dp) and rows [n, rows) zeroed. With
// vec (D * sizeof(T) a multiple of 16 and src 16-byte aligned) as 16-byte
// asynchronous copies: wait with cp_async_wait_all and a barrier.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int n, int rows,
                                           int D, int Dp, int ld, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int per_row = D / E;
    for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * E;
      cp_async16(dst + r * ld + c, src + (size_t)r * D + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
      const int r = i / D;
      dst[r * ld + (i - r * D)] = src[i];
    }
  }
  const T zero = from_f32<T>(0.f);
  const int pad = Dp - D;
  for (int i = threadIdx.x; i < n * pad; i += blockDim.x) {
    const int r = i / pad;
    dst[r * ld + D + (i - r * pad)] = zero;
  }
  for (int i = threadIdx.x; i < (rows - n) * Dp; i += blockDim.x) {
    const int r = i / Dp;
    dst[(n + r) * ld + (i - r * Dp)] = zero;
  }
}

// ---- TF32 tensor-core products --------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

template <int N>
struct Frag {
  uint32_t hi[N];
  uint32_t lo[N];  // 3xTF32 only
};
using FragA = Frag<4>;
using FragB = Frag<2>;

// element e of a fragment from the fp32 value x: its TF32 high part and,
// with SPLIT, the TF32 rounding of the rest
template <bool SPLIT, int N>
__device__ __forceinline__ void put(Frag<N>& f, int e, float x) {
  f.hi[e] = tf32(x);
  if constexpr (SPLIT) f.lo[e] = tf32(x - __uint_as_float(f.hi[e]));
}

// as put, for an input element: without SPLIT it was widened from bf16 and
// is a TF32 value already
template <bool SPLIT, int N>
__device__ __forceinline__ void put_in(Frag<N>& f, int e, float x) {
  if constexpr (SPLIT) put<SPLIT>(f, e, x);
  else f.hi[e] = __float_as_uint(x);
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The tensor cores add a product's terms into the fp32 accumulator with
// truncation, not rounding, so the error of a long run of mma's into one
// accumulator grows with the run's length, and with a bias. Sums over rows
// or keys (P V, dv, dk, dq: up to Lq or Lk terms) are therefore taken
// kFlush k-steps (of 8) at a time in a fresh accumulator, each partial
// added to the total by an ordinary (rounding) fp32 add; the sums over the
// head dimension (q k^T, g v^T: at most 16 k-steps) run in one. Found on
// the card: dk summed over 1100 query rows in one accumulator missed the
// plain version by 1.1e-5 relative.
constexpr int kFlush = 4;

// c += a b: one TF32 product, or with SPLIT three (the small terms first)
template <bool SPLIT>
__device__ __forceinline__ void mma(float c[4], const FragA& a, const FragB& b) {
  if constexpr (SPLIT) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
  }
  mma_tf32(c, a.hi, b.hi);
}

// A = rows [r0, r0 + 16) x columns [k0, k0 + 8) of a row-major tile
template <bool SPLIT, typename T>
__device__ __forceinline__ FragA load_a(const T* s, int ld, int r0, int k0, int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  const T* p = s + (r0 + gr) * ld + k0 + tq;
  FragA f;
  put_in<SPLIT>(f, 0, to_f32(p[0]));
  put_in<SPLIT>(f, 1, to_f32(p[8 * ld]));
  put_in<SPLIT>(f, 2, to_f32(p[4]));
  put_in<SPLIT>(f, 3, to_f32(p[8 * ld + 4]));
  return f;
}

// A as load_a, with the k permutation of the C-to-A reuse (columns 2 tq and
// 2 tq + 1 at k positions tq and tq + 4)
template <bool SPLIT>
__device__ __forceinline__ FragA load_a_perm(const float* s, int ld, int r0, int k0,
                                             int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  const float* p = s + (r0 + gr) * ld + k0 + 2 * tq;
  FragA f;
  put<SPLIT>(f, 0, p[0]);
  put<SPLIT>(f, 1, p[8 * ld]);
  put<SPLIT>(f, 2, p[1]);
  put<SPLIT>(f, 3, p[8 * ld + 1]);
  return f;
}

// A from the C fragment c of a previous product (see the header note)
template <bool SPLIT>
__device__ __forceinline__ FragA a_from_c(const float c[4]) {
  FragA f;
  put<SPLIT>(f, 0, c[0]);
  put<SPLIT>(f, 1, c[2]);
  put<SPLIT>(f, 2, c[1]);
  put<SPLIT>(f, 3, c[3]);
  return f;
}

// B (k, n) = s[(n0 + n) * ld + k0 + k]: the tile's rows are B's columns
// (K in q k^T)
template <bool SPLIT, typename T>
__device__ __forceinline__ FragB load_b_rows(const T* s, int ld, int n0, int k0, int lane) {
  const T* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  FragB f;
  put_in<SPLIT>(f, 0, to_f32(p[0]));
  put_in<SPLIT>(f, 1, to_f32(p[4]));
  return f;
}

// B (k, n) = s[(k0 + k) * ld + n0 + n] with the k permutation of a_from_c
// (V in P v)
template <bool SPLIT, typename T>
__device__ __forceinline__ FragB load_b_perm(const T* s, int ld, int k0, int n0, int lane) {
  const T* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  FragB f;
  put_in<SPLIT>(f, 0, to_f32(p[0]));
  put_in<SPLIT>(f, 1, to_f32(p[ld]));
  return f;
}

// ---- bf16 tensor-core products (m16n8k16), for bf16 inputs ---------------
// Fragments hold two bf16 each, the lower column in the low half:
//   A (16 x 16): a0 (gr, 2 tq : 2 tq + 1)  a1 (gr + 8, 2 tq : ..)
//                a2 (gr, 2 tq + 8 : 2 tq + 9)  a3 (gr + 8, 2 tq + 8 : ..)
//   B (16 x 8):  b0 (k = 2 tq : 2 tq + 1, n = gr)  b1 (k = 2 tq + 8 : .., n = gr)
//   C as for m16n8k8. With B's columns the rows of a row-major tile, every
// register is one aligned 32-bit load from shared memory.

struct Frag16A {
  uint32_t r[4];
};
struct Frag16B {
  uint32_t r[2];
};

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A = rows [r0, r0 + 16) x columns [k0, k0 + 16) of a row-major tile
__device__ __forceinline__ Frag16A load_a16(const __nv_bfloat16* s, int ld, int r0,
                                            int k0, int lane) {
  const __nv_bfloat16* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  return {{lds32(p), lds32(p + 8 * ld), lds32(p + 8), lds32(p + 8 * ld + 8)}};
}

// B (k, n) = s[(n0 + n) * ld + k0 + k]
__device__ __forceinline__ Frag16B load_b16_rows(const __nv_bfloat16* s, int ld, int n0,
                                                 int k0, int lane) {
  const __nv_bfloat16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  return {{lds32(p), lds32(p + 8)}};
}

// the bf16 pair (x, y), x in the low half, and the pair of what rounding
// left over: x = hi + lo to about 16 significant bits, finer than TF32
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A (16 x 16), split into hi and lo, from the C fragments of columns 0-7
// (c0) and 8-15 (c1): the accumulators already lie in A's layout
__device__ __forceinline__ void a16_from_c(const float c0[4], const float c1[4], Frag16A& hi,
                                           Frag16A& lo) {
  split_bf16(c0[0], c0[1], hi.r[0], lo.r[0]);
  split_bf16(c0[2], c0[3], hi.r[1], lo.r[1]);
  split_bf16(c1[0], c1[1], hi.r[2], lo.r[2]);
  split_bf16(c1[2], c1[3], hi.r[3], lo.r[3]);
}

// A (16 x 16), split into hi and lo, from rows [r0, r0 + 16) x columns
// [k0, k0 + 16) of a row-major fp32 tile
__device__ __forceinline__ void load_a16_f32(const float* s, int ld, int r0, int k0, int lane,
                                             Frag16A& hi, Frag16A& lo) {
  const float* p = s + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const float2 x0 = *reinterpret_cast<const float2*>(p);
  const float2 x1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float2 x2 = *reinterpret_cast<const float2*>(p + 8);
  const float2 x3 = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
  split_bf16(x0.x, x0.y, hi.r[0], lo.r[0]);
  split_bf16(x1.x, x1.y, hi.r[1], lo.r[1]);
  split_bf16(x2.x, x2.y, hi.r[2], lo.r[2]);
  split_bf16(x3.x, x3.y, hi.r[3], lo.r[3]);
}

// B of the two n-tiles [n0, n0 + 8) and [n0 + 8, n0 + 16), k in
// [k0, k0 + 16), from a row-major [k][n] bf16 tile, by one
// ldmatrix.x4.trans: lanes 8 m .. 8 m + 7 give the rows of 8 x 8 matrix m
// (rows k0 + 8 (m & 1) + .., columns n0 + 8 (m >> 1) + ..)
__device__ __forceinline__ void load_b16_trans(const __nv_bfloat16* s, int ld, int k0, int n0,
                                               int lane, Frag16B& b0, Frag16B& b1) {
  const int m = lane >> 3;
  const __nv_bfloat16* p = s + (k0 + 8 * (m & 1) + (lane & 7)) * ld + n0 + 8 * (m >> 1);
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float c[4], const Frag16A& a, const Frag16B& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
}

// c += (hi + lo) b in bf16 (the small term first)
__device__ __forceinline__ void mma_bf16x2(float c[4], const Frag16A& hi, const Frag16A& lo,
                                           const Frag16B& b) {
  mma_bf16(c, lo, b);
  mma_bf16(c, hi, b);
}

// Bytes of a shared-memory region of n elements of T, rounded up to 16.
template <typename T>
__host__ __device__ constexpr size_t region(size_t n) {
  return (n * sizeof(T) + 15) / 16 * 16;
}

// The head-dimension tiles (of 8 columns) the kernels are built for: D is
// padded with zeros up to 8 * DT.
__host__ __device__ inline int head_tiles(int D) {
  return D <= 32 ? 4 : D <= 48 ? 6 : D <= 64 ? 8 : 16;
}

}  // namespace attn
