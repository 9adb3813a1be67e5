// Fused multi-head attention backward for Hopper (sm_90a), on the tensor
// cores.
//
// Replaces crct_tpu/ops/attention.py::_bwd_kernel (the Pallas TPU kernel).
// With s = q k^T * scale + mask, P = softmax(s), keep the dropout multipliers
// (0 or 1/(1 - rate), the forward's murmur3 hash regenerated from the same
// seed) and out = (P * keep) v, it returns, for the cotangent g of out,
//   dv = (P * keep)^T g ;  dP = (g v^T) * keep ;
//   ds = P * (dP - delta) ;  dq = ds k * scale ;  dk = ds^T q * scale
// with fp32 scores, probabilities and sums, stored in the input dtype (fp32
// or bf16). It makes one pass and no statistics pass: P = exp(s - lse) from
// the rows' log-sum-exp that the forward kernel wrote. Where the keys fit
// one key tile (Lk <= 128: every flagship shape), delta_i = sum_j dP_ij P_ij
// is summed in that pass, over each warp's keys and then over the warps in
// a fixed order, before dS is formed. Above 128 keys it is
// sum_d g_id out_id (FlashAttention-2; it holds under dropout because
// out = (P * keep) v), from the forward's output. Why not that identity
// everywhere: sum_j dS_ij = (sum_j dP_ij P_ij) - delta_i is zero in exact
// arithmetic, and key biases get exactly that as their gradient; with
// delta from dP * P it stays at rounding level, as in the plain version,
// while with delta from the stored output a whole fp32 train step's key-bias
// gradients differed from the plain version's by 5.8e-4 of their largest
// magnitude, where the step is held to 1e-4.
//
// What bounds it on an H100: the five products (the q k^T recompute, g v^T,
// dv, dq, dk) are 10*B*H*Lq*Lk*D FLOP against q, k, v, g, the mask, dq, dk
// and dv read or written once. At the flagship text shape with B = 80 rows
// (H 16, Lq = Lk = 124, D 48) that is 9.4 GFLOP and 214 MB in fp32 (0.141 ms
// at the 67 TFLOP/s fp32 rate, 0.064 ms at 3.35 TB/s: operations bound the
// fp32 row), and 107 MB in bf16 (0.032 ms of bytes against 0.010 ms at 989
// TFLOP/s: bytes bound the bf16 row).
//
// Design: one block per (batch, head), so dk and dv of a key and dq of a
// query are each summed inside one block, without atomics, in a fixed
// order: the result is deterministic. The block's W <= 8 warps take a key
// tile of 16 W keys (all of them at the flagship shapes), one 16-key slab a
// warp, staged with K and V in shared memory by 16-byte cp.async copies.
// For each tile of up to 64 query rows (Q, G and, over several key tiles,
// the forward's output O staged the same way; over several query tiles the
// next tile's copies are in flight meanwhile, in a second buffer):
//   1. each warp computes S^T = K Q^T and dP^T = V G^T for its keys on the
//      tensor cores, 32 queries at a time, turns them into P and
//      P * dP * keep in registers (the keep bit hashed from each
//      accumulator's row and column), adds its part of delta into shared
//      memory, and after a barrier forms (P * keep)^T and dS^T, adds
//      dv += (P * keep)^T G and dk += dS^T Q with those registers as the A
//      operand, and puts dS^T in shared memory;
//   2. after a barrier, the warps compute dq = dS K for the tile's rows, a
//      (16-row slab, half of the head dimension) each. When Lk exceeds one
//      key tile, dq's partial sums of the earlier tiles wait in an fp32
//      scratch that only this block touches.
// Every product is an mma.sync: bf16 m16n8k16 for bf16 inputs (P and dS
// split into bf16 hi + lo, G's, Q's and K's fragments by ldmatrix.trans),
// 3xTF32 m16n8k8 for fp32 (attention_common.cuh). For bf16 inputs
// registers are capped for two blocks an SM, so one block's loads overlap
// another's products.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBQ = 64;     // query rows per tile, at most
constexpr int kMaxKeyTile = 128;  // keys per key tile, at most: 8 warps
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunk = 32;  // query columns of S^T a warp holds at once
                            // (kChunk / 8 = kFlush k-steps)

struct Layout {
  int W;        // warps per block = key slabs per key tile
  int BQ;       // query rows per query tile
  size_t smem;  // dynamic shared memory per block
};

// Query buffers: two (the next tile's copies in flight) where there are
// several query tiles; each holds Q and G, and O where there are several
// key tiles.
__host__ __device__ inline int query_buffers(int Lq, int BQ) { return Lq > BQ ? 2 : 1; }
__host__ __device__ inline int query_mats(int Lk, int W) { return Lk > 16 * W ? 3 : 2; }

template <typename T>
size_t smem_bytes(int W, int BQ, int Lq, int Lk, int D) {
  const int ld = row_stride<T>(8 * head_tiles(D));
  const int BK = 16 * W;
  return region<T>((size_t)2 * BK * ld) +
         query_buffers(Lq, BQ) * region<T>((size_t)query_mats(Lk, W) * BQ * ld) +
         region<float>((size_t)BQ * (BK + 8)) + region<float>((size_t)(W + 1) * BQ);
}

// A key tile of min(Lk, kMaxKeyTile) keys, one 16-key slab a warp, and
// query tiles of at most kBQ rows, a multiple of 16, made smaller by 16
// rows while they do not fit in shared memory (at D = 128 in fp32).
template <typename T>
Layout layout(int Lq, int Lk, int D) {
  const int W = Lk >= kMaxKeyTile ? kMaxKeyTile / 16 : (Lk + 15) / 16;
  int BQ = Lq >= kBQ ? kBQ : (Lq + 15) / 16 * 16;
  while (BQ > 16 && smem_bytes<T>(W, BQ, Lq, Lk, D) > (size_t)kMaxSmem) BQ -= 16;
  return {W, BQ, smem_bytes<T>(W, BQ, Lq, Lk, D)};
}

template <typename T, int DT>
__global__ void __launch_bounds__(256, sizeof(T) == 2 ? 2 : 1)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const T* __restrict__ g, const T* __restrict__ o,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dq_acc, int H, int Lq, int Lk, int D,
                     int Lm, float scale, float rate, float keep_scale,
                     uint32_t seed, int hb, int BQ, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int Dp = 8 * DT;
  constexpr int ld = row_stride<T>(Dp);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x >> 5;
  const int BK = 16 * W;
  const int ldS = BK + 8;  // even (float2 loads); rows 8 words apart mod 32
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + BK * ld;
  // the query buffers (query_buffers, query_mats)
  unsigned char* qbuf = smem + region<T>((size_t)2 * BK * ld);
  const size_t qbytes = region<T>((size_t)query_mats(Lk, W) * BQ * ld);
  float* sdS = reinterpret_cast<float*>(qbuf + query_buffers(Lq, BQ) * qbytes);
  float* sDelta = sdS + BQ * ldS;  // 16-byte aligned: BQ * ldS is a multiple of 4
  float* sPart = sDelta + BQ;      // [W][BQ]: each warp's part of delta

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const T* qh = q + (size_t)bh * Lq * D;
  const T* gh = g + (size_t)bh * Lq * D;
  const T* oh = o + (size_t)bh * Lq * D;
  const float* mb = mask + (size_t)b * Lm * Lk;
  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;
  // one key tile: delta = sum_j dP * P from this pass, summed over the
  // warps' keys; several: delta = g . out, and dq summed over the tiles
  const bool tiled = Lk > BK;
  // the rows [qt0, qt0 + BQ) of Q, G and (over several key tiles) O into
  // query buffer qb, asynchronously
  auto stage_q = [&](int qb, int qt0) {
    const int nq = min(BQ, Lq - qt0);
    T* dst = reinterpret_cast<T*>(qbuf + qb * qbytes);
    stage_tile(dst, qh + (size_t)qt0 * D, nq, BQ, D, Dp, ld, vec);
    stage_tile(dst + BQ * ld, gh + (size_t)qt0 * D, nq, BQ, D, Dp, ld, vec);
    if (tiled) stage_tile(dst + 2 * BQ * ld, oh + (size_t)qt0 * D, nq, BQ, D, Dp, ld, vec);
  };

  for (int kt0 = 0; kt0 < Lk; kt0 += BK) {
    const int nk = min(BK, Lk - kt0);
    const bool last_kt = kt0 + BK >= Lk;
    const int kr0 = 16 * warp;              // the warp's key slab in the tile
    const bool has_keys = kr0 < nk;
    // a key-only mask's values at the lane's two keys
    float mkey[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kl = kr0 + gr + 8 * e;
      mkey[e] = (Lm == 1 && kl < nk) ? mb[kt0 + kl] : 0.f;
    }
    float dKa[DT][4], dVa[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int c = 0; c < 4; ++c) dKa[dt][c] = dVa[dt][c] = 0.f;

    if (kt0 > 0) __syncthreads();
    stage_tile(sK, k + ((size_t)bh * Lk + kt0) * D, nk, BK, D, Dp, ld, vec);
    stage_tile(sV, v + ((size_t)bh * Lk + kt0) * D, nk, BK, D, Dp, ld, vec);

    stage_q(0, 0);
    for (int qt0 = 0, qb = 0; qt0 < Lq; qt0 += BQ, qb ^= 1) {
      const int nq = min(BQ, Lq - qt0);
      const T* sQ = reinterpret_cast<const T*>(qbuf + qb * qbytes);
      const T* sG = sQ + BQ * ld;
      const T* sO = sG + BQ * ld;
      // this tile's copies have landed, and every warp is done with the
      // last tile, whose buffer takes the next tile's copies
      cp_async_wait_all();
      __syncthreads();
      if (qt0 + BQ < Lq) stage_q(qb ^ 1, qt0 + BQ);
      if (tiled) {
        // over several key tiles: delta = g . out
        for (int r = warp; r < BQ; r += W) {
          float d = 0.f;
          if (r < nq)
            for (int c = lane; c < D; c += 32) d += to_f32(sG[r * ld + c]) * to_f32(sO[r * ld + c]);
          d = warp_sum(d);
          if (lane == 0) sDelta[r] = d;
        }
        __syncthreads();
      }

      // 1. S^T, dP^T -> (P * keep)^T, dS^T; dv and dk for the warp's keys
      // (the chunk loop's bounds and barrier are the same for every warp)
      for (int c0 = 0; c0 < nq; c0 += kChunk) {
        const int NT = min(kChunk / 8, (nq - c0 + 7) >> 3);
        float st[kChunk / 8][4], dpt[kChunk / 8][4];
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[nt][c] = dpt[nt][c] = 0.f;
        uint32_t kept = 0;  // the keep bits of the lane's 16 elements
        // the lse (in log2 units) of the lane's query columns
        float l2[kChunk / 8][2];
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ql = c0 + 8 * nt + 2 * tq + e;
            l2[nt][e] = ql < nq ? lse[(size_t)bh * Lq + qt0 + ql] * kLog2e : 0.f;
          }
        if (has_keys) {
          if constexpr (SPLIT) {
#pragma unroll
            for (int kk = 0; kk < DT; ++kk) {
              const FragA ak = load_a<SPLIT>(sK, ld, kr0, 8 * kk, lane);
              const FragA av = load_a<SPLIT>(sV, ld, kr0, 8 * kk, lane);
#pragma unroll
              for (int nt = 0; nt < kChunk / 8; ++nt) {
                if (nt < NT) {
                  mma<SPLIT>(st[nt], ak, load_b_rows<SPLIT>(sQ, ld, c0 + 8 * nt, 8 * kk, lane));
                  mma<SPLIT>(dpt[nt], av, load_b_rows<SPLIT>(sG, ld, c0 + 8 * nt, 8 * kk, lane));
                }
              }
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < DT / 2; ++kk) {
              const Frag16A ak = load_a16(sK, ld, kr0, 16 * kk, lane);
              const Frag16A av = load_a16(sV, ld, kr0, 16 * kk, lane);
#pragma unroll
              for (int nt = 0; nt < kChunk / 8; ++nt) {
                if (nt < NT) {
                  mma_bf16(st[nt], ak, load_b16_rows(sQ, ld, c0 + 8 * nt, 16 * kk, lane));
                  mma_bf16(dpt[nt], av, load_b16_rows(sG, ld, c0 + 8 * nt, 16 * kk, lane));
                }
              }
            }
          }
          // st <- P, dpt <- P * dP * keep, and the keep bits
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int kl = kr0 + gr + 8 * (c >> 1);        // key in the tile
              const int ql = c0 + 8 * nt + 2 * tq + (c & 1);  // query in the tile
              const int j = kt0 + kl, i = qt0 + ql;
              float p = 0.f, pdp = 0.f;
              if (nt < NT && kl < nk && ql < nq) {
                // in log2 units, rounded as the forward kernel rounds it
                const float sc =
                    (st[nt][c] * scale + (Lm == 1 ? mkey[c >> 1] : mb[(size_t)i * Lk + j]))
                    * kLog2e;
                p = exp2f(sc - l2[nt][c & 1]);
                const bool keep =
                    !dropout || drop.keep(i, j, rate, keep_scale) != 0.f;
                pdp = keep ? p * (dropout ? dpt[nt][c] * keep_scale : dpt[nt][c]) : 0.f;
                kept |= (uint32_t)keep << (4 * nt + c);
              }
              st[nt][c] = p;
              dpt[nt][c] = pdp;
            }
          }
          // the warp's part of delta for each query: a sum over its keys,
          // the two rows of the lane and then the eight lanes of a column
          if (!tiled) {
#pragma unroll
            for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float x = dpt[nt][e] + dpt[nt][2 + e];
                x += __shfl_xor_sync(0xffffffffu, x, 4);
                x += __shfl_xor_sync(0xffffffffu, x, 8);
                x += __shfl_xor_sync(0xffffffffu, x, 16);
                const int ql = c0 + 8 * nt + 2 * tq + e;
                if (gr == 0 && ql < BQ) sPart[warp * BQ + ql] = x;
              }
            }
          }
        }
        // delta of the lane's 8 query columns: over one key tile, the
        // warps' parts summed in a fixed order, lane (gr, tq) summing column
        // gr of its tq's eight and the eight lanes then trading sums
        float dl[kChunk / 8][2];
        if (!tiled) {
          __syncthreads();
          const int ql = c0 + 8 * (gr >> 1) + 2 * tq + (gr & 1);
          float mine = 0.f;
          if (ql < BQ)
            for (int w = 0; w < W; ++w) mine += sPart[w * BQ + ql];
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              dl[nt][e] = __shfl_sync(0xffffffffu, mine, 4 * (2 * nt + e) + tq);
        } else {
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ql = c0 + 8 * nt + 2 * tq + e;
              dl[nt][e] = ql < BQ ? sDelta[ql] : 0.f;
            }
        }
        if (has_keys) {
          // st <- (P * keep), dpt <- dS = P * (dP * keep - delta)
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int kl = kr0 + gr + 8 * (c >> 1);
              const int ql = c0 + 8 * nt + 2 * tq + (c & 1);
              const float delta = dl[nt][c & 1];
              const float p = st[nt][c];
              const float ds = dpt[nt][c] - p * delta;
              st[nt][c] = (kept >> (4 * nt + c)) & 1u ? (dropout ? p * keep_scale : p) : 0.f;
              dpt[nt][c] = ds;
              if (ql < BQ) sdS[ql * ldS + kl] = ds;
            }
          }
          // the chunk's products summed apart, then added (kFlush)
          if constexpr (SPLIT) {
            FragA ap[kChunk / 8], ad[kChunk / 8];
#pragma unroll
            for (int nt = 0; nt < kChunk / 8; ++nt) {
              if (nt < NT) {
                ap[nt] = a_from_c<SPLIT>(st[nt]);
                ad[nt] = a_from_c<SPLIT>(dpt[nt]);
              }
            }
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
              float tv[4] = {0.f, 0.f, 0.f, 0.f}, tk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int nt = 0; nt < kChunk / 8; ++nt) {
                if (nt < NT) {
                  mma<SPLIT>(tv, ap[nt], load_b_perm<SPLIT>(sG, ld, c0 + 8 * nt, 8 * dt, lane));
                  mma<SPLIT>(tk, ad[nt], load_b_perm<SPLIT>(sQ, ld, c0 + 8 * nt, 8 * dt, lane));
                }
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                dVa[dt][c] += tv[c];
                dKa[dt][c] += tk[c];
              }
            }
          } else {
            // (P * keep)^T and dS^T in bf16 hi + lo; G's and Q's fragments
            // by ldmatrix.trans
            Frag16A ph[kChunk / 16], pl[kChunk / 16], dh[kChunk / 16], dl[kChunk / 16];
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk) {
              if (2 * kk < NT) {
                a16_from_c(st[2 * kk], st[2 * kk + 1], ph[kk], pl[kk]);
                a16_from_c(dpt[2 * kk], dpt[2 * kk + 1], dh[kk], dl[kk]);
              }
            }
#pragma unroll
            for (int dt = 0; dt < DT; dt += 2) {
              float tv0[4] = {0.f, 0.f, 0.f, 0.f}, tv1[4] = {0.f, 0.f, 0.f, 0.f};
              float tk0[4] = {0.f, 0.f, 0.f, 0.f}, tk1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int kk = 0; kk < kChunk / 16; ++kk) {
                if (2 * kk < NT) {
                  Frag16B b0, b1;
                  load_b16_trans(sG, ld, c0 + 16 * kk, 8 * dt, lane, b0, b1);
                  mma_bf16x2(tv0, ph[kk], pl[kk], b0);
                  mma_bf16x2(tv1, ph[kk], pl[kk], b1);
                  load_b16_trans(sQ, ld, c0 + 16 * kk, 8 * dt, lane, b0, b1);
                  mma_bf16x2(tk0, dh[kk], dl[kk], b0);
                  mma_bf16x2(tk1, dh[kk], dl[kk], b1);
                }
              }
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                dVa[dt][c] += tv0[c];
                dVa[dt + 1][c] += tv1[c];
                dKa[dt][c] += tk0[c];
                dKa[dt + 1][c] += tk1[c];
              }
            }
          }
        }
      }
      __syncthreads();

      // 2. dq = dS K for the tile's rows: (16-row slab, half of the
      // head-dimension tiles, an even count but the last) a warp
      constexpr int H2 = (DT / 2 + 1) / 2 * 2;
      for (int item = warp; item < 2 * ((nq + 15) >> 4); item += W) {
        const int r0 = 16 * (item >> 1);
        const int d0 = (item & 1) * H2;
        float acc[H2][4];
#pragma unroll
        for (int dt = 0; dt < H2; ++dt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
        // kFlush k-steps of 8 keys at a time, summed apart
        for (int k0 = 0; k0 < nk; k0 += 8 * kFlush) {
          float part[H2][4];
#pragma unroll
          for (int dt = 0; dt < H2; ++dt)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[dt][c] = 0.f;
          if constexpr (SPLIT) {
            for (int ks = k0; ks < min(nk, k0 + 8 * kFlush); ks += 8) {
              const FragA a = load_a_perm<SPLIT>(sdS, ldS, r0, ks, lane);
#pragma unroll
              for (int dt = 0; dt < H2; ++dt)
                if (d0 + dt < DT)
                  mma<SPLIT>(part[dt], a, load_b_perm<SPLIT>(sK, ld, ks, 8 * (d0 + dt), lane));
            }
          } else {
            for (int ks = k0; ks < min(nk, k0 + 8 * kFlush); ks += 16) {
              Frag16A ah, al;
              load_a16_f32(sdS, ldS, r0, ks, lane, ah, al);
#pragma unroll
              for (int dt = 0; dt < H2; dt += 2) {
                if (d0 + dt < DT) {
                  Frag16B b0, b1;
                  load_b16_trans(sK, ld, ks, 8 * (d0 + dt), lane, b0, b1);
                  mma_bf16x2(part[dt], ah, al, b0);
                  mma_bf16x2(part[dt + 1], ah, al, b1);
                }
              }
            }
          }
#pragma unroll
          for (int dt = 0; dt < H2; ++dt)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[dt][c] += part[dt][c];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = qt0 + r0 + gr + 8 * (c >> 1);
          if (i >= Lq) continue;
#pragma unroll
          for (int dt = 0; dt < H2; ++dt) {
            const int d = 8 * (d0 + dt) + 2 * tq + (c & 1);
            if (d0 + dt >= DT || d >= D) continue;
            const size_t at = ((size_t)bh * Lq + i) * D + d;
            float x = acc[dt][c];
            if (tiled) {
              if (kt0 > 0) x += dq_acc[at];
              if (!last_kt) {
                dq_acc[at] = x;
                continue;
              }
            }
            store(dq + at, x * scale);
          }
        }
      }
    }

    // dk and dv of the warp's keys
    if (has_keys) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int j = kt0 + kr0 + gr + 8 * rh;
        if (j >= Lk) continue;
        T* dkr = dk + ((size_t)bh * Lk + j) * D;
        T* dvr = dv + ((size_t)bh * Lk + j) * D;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const int d = 8 * dt + 2 * tq;
          if (d >= D) continue;
          store2(dkr, d, D, dKa[dt][2 * rh] * scale, dKa[dt][2 * rh + 1] * scale);
          store2(dvr, d, D, dVa[dt][2 * rh], dVa[dt][2 * rh + 1]);
        }
      }
    }
  }
}

template <typename T, int DT>
const void* kernel_of() {
  return (const void*)attention_bwd_kernel<T, DT>;
}

template <typename T>
const void* kernel_for(int D) {
  switch (head_tiles(D)) {
    case 4: return kernel_of<T, 4>();
    case 6: return kernel_of<T, 6>();
    case 8: return kernel_of<T, 8>();
    default: return kernel_of<T, 16>();
  }
}

// raise a kernel's shared-memory limit once, to the most any launch needs
// (every layout stays within kMaxSmem)
cudaError_t raise_smem_limit(const void* fn) {
  static const void* raised[8];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (raised[i] == fn) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && n < 8) raised[n++] = fn;
  return err;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, const void* o, const void* lse, void* dq, void* dk,
           void* dv, void* dq_acc, int B, int H, int Lq, int Lk, int D, int Lm,
           float scale, float rate, float keep_scale, int seed, int hb,
           cudaStream_t stream) {
  const Layout l = layout<T>(Lq, Lk, D);
  if (Lk > 16 * l.W && dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for<T>(D);
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return (int)err;
  int vec = (D * sizeof(T)) % 16 == 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)o) %
                    16 ==
                0;
  uint32_t useed = (uint32_t)seed;
  int BQ = l.BQ;
  void* args[] = {&q, &k, &v, &mask, &g, &o, &lse, &dq, &dk, &dv, &dq_acc,
                  &H, &Lq, &Lk, &D, &Lm, &scale, &rate, &keep_scale, &useed,
                  &hb, &BQ, &vec};
  err = cudaLaunchKernel(fn, dim3(B * H), dim3(32 * l.W), args, l.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/g/o/dq
// [B,H,Lq,D], k/v/dk/dv [B,H,Lk,D] in that dtype (o the forward's output),
// mask [B,1,Lm,Lk] float32 with Lm in {1, Lq}, lse float32 [B,H,Lq] from the
// forward kernel, dq_acc a float32 scratch of B*H*Lq*D when Lk exceeds
// attention_bwd_key_tile(Lq, Lk, D, dtype), else ignored (may be null). Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* g, const void* o,
                             const void* lse, void* dq, void* dk, void* dv,
                             void* dq_acc, int dtype, int B, int H, int Lq,
                             int Lk, int D, int Lm, float scale, float rate,
                             float keep_scale, int seed, int hb, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, g, o, lse, dq, dk, dv, dq_acc, B, H, Lq,
                         Lk, D, Lm, scale, rate, keep_scale, seed, hb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, g, o, lse, dq, dk, dv, dq_acc, B,
                                 H, Lq, Lk, D, Lm, scale, rate, keep_scale, seed,
                                 hb, s);
  return (int)cudaErrorInvalidValue;
}

// Keys per key tile of a launch at (Lq, Lk, D) in dtype (as in
// attention_bwd): when Lk exceeds it, the launch needs the dq_acc scratch.
// 0 on bad input.
extern "C" int attention_bwd_key_tile(int Lq, int Lk, int D, int dtype) {
  if (Lq < 1 || Lk < 1 || D < 1 || D > kMaxD) return 0;
  if (dtype == 0) return 16 * layout<float>(Lq, Lk, D).W;
  if (dtype == 1) return 16 * layout<__nv_bfloat16>(Lq, Lk, D).W;
  return 0;
}

// Bytes of dynamic shared memory one block of a launch at (Lq, Lk, D) in
// dtype takes (0 on bad input).
extern "C" int attention_bwd_smem(int Lq, int Lk, int D, int dtype) {
  if (Lq < 1 || Lk < 1 || D < 1 || D > kMaxD) return 0;
  if (dtype == 0) return (int)layout<float>(Lq, Lk, D).smem;
  if (dtype == 1) return (int)layout<__nv_bfloat16>(Lq, Lk, D).smem;
  return 0;
}

// Blocks of a launch at (Lq, Lk, D) in dtype that one SM holds at once, as
// the CUDA occupancy calculator gives them from the kernel's registers,
// threads and shared memory; a negative CUDA error code on failure.
extern "C" int attention_bwd_blocks_per_sm(int Lq, int Lk, int D, int dtype) {
  const int smem = attention_bwd_smem(Lq, Lk, D, dtype);
  if (smem == 0 || (dtype != 0 && dtype != 1)) return -(int)cudaErrorInvalidValue;
  const void* fn = dtype == 0 ? kernel_for<float>(D) : kernel_for<__nv_bfloat16>(D);
  const int W = attention_bwd_key_tile(Lq, Lk, D, dtype) / 16;
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * W, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}
