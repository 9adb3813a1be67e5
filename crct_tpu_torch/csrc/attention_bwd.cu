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
// or bf16). With round_p (bf16 only) it is the VJP of the JAX package's
// default XLA path (crct_tpu/models/layers.py:61-64): dv from P rounded to
// bf16 (the kept ones divided in bf16 by bf16(1 - rate)), and
// dP = g v^T rounded to bf16, the kept ones divided in bf16 by
// bf16(1 - rate), before the fp32 softmax backward. It makes one pass and no
// statistics pass: P = exp(s - lse) from
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
// TFLOP/s: bytes bound the bf16 row). At the vision shape (Lq = Lk = 44, D
// 64) it is 1.59 GFLOP against 101 MB in fp32: bytes bound the TF32 TMA
// design (0.030 ms, its 3xTF32 products 0.010 ms at a third of 495 TFLOP/s).
//
// Four designs; attention_bwd picks one by dtype, mode and shape alone
// (attention_bwd_design), and a launch that fails raises, never falls back.
// All take one block per (batch, head), so dk and dv of a key and dq of a
// query are each summed inside one block, without atomics, in a fixed
// order: the result is deterministic.
//
// The wgmma design (bf16 in both modes with Lk <= 128 and D a multiple of
// 8: every bf16 train step at the flagship shapes), FlashAttention-3's
// backward layout: a warpgroup owns 64 keys (two at Lk > 64, keys padded
// with zeros by the tensor map). Thread 0 has TMA copy K and V of the
// (batch, head) once, and Q and G a chunk of 64 queries at a time (3-D
// tensor maps over [B*H, L, D], boxes of 64 columns in the 128-byte
// swizzle that wgmma reads, as K1's design). Each chunk is taken in two
// halves of 32 queries, so that a thread holds 16 + 16 accumulators of S
// and dP at a time: each warpgroup takes S^T = K Q^T and dP^T = V G^T as
// two wgmma m64n32k16 chains, both operands K-major from shared memory, and
// forms P, the keep bits and P * dP in registers, each accumulator's (key,
// query) giving its keep hash and mask, without branches. delta_i, summed
// from those products: each warp's column sums into shared memory, then,
// after a barrier, summed over the warps in a fixed order, the order of the
// mma.sync design. Then dS = P * (dP - delta) in bf16 hi + lo and P * keep
// (ROUND: bf16; -pallas: hi + lo) go to shared memory, transposed and
// swizzled (rows of keys). After a barrier, one batch of products: dV +=
// (P * keep)^T G and dK += dS^T Q with A the warpgroup's rows of those
// tiles (K-major) and G, Q MN-major (their rows are queries), D/2 fp32
// accumulators each over the chunks; dQ = dS K with A the dS^T tiles
// (MN-major, the transpose bit that bf16 allows) and K MN-major, each
// warpgroup taking its half of the head columns over every key, staged in
// a swizzled tile and stored by TMA. dV and dK are stored by TMA through
// the K and V tiles at the end. The TMA stores skip the rows past Lq or Lk
// and the columns past D. A block is 4 or 8 warps with 67-108 KB of shared
// memory at the flagship shapes (ROUND), two or three blocks an SM
// (wg_min_blocks).
//
// The TF32 wgmma design (fp32 with Lk <= 128, D a multiple of 4 and at
// most 48: tf32_takes; every flagship shape but vision's D 64) keeps that
// layout, a warpgroup a 64-key slab, on TF32 wgmma (m64nNk8) with fp32
// accuracy: every product is 3xTF32, A_hi B_hi + A_hi B_lo + A_lo B_hi,
// hi = tf32(x) and lo = tf32(x - hi) (the hardware reads TF32 operands'
// top 19 bits only, so hi is stored rounded). TF32 takes K-major operands
// only, and fp32 tiles are twice bf16's, so the operands are placed where
// each product needs them: K and V arrive once by 16-byte cp.async copies
// into padded rows, and K^T is written once in hi and lo; Q and G arrive a
// chunk of 32 queries at a time (the next chunk's copies in flight), and
// the threads write each chunk in hi and lo with rows of queries (B of
// S^T = K Q^T and dP^T = V G^T) and transposed, rows of head columns (B of
// dK and dV), the queries in the order of the register A operand's k
// positions. S^T and dP^T take A (K, V) from registers, split as they are
// loaded; P * keep and dS, formed in registers as in the bf16 design, are
// the A operands of dV += (P keep)^T G and dK += dS^T Q as the accumulators
// lie (no shuffle, no store), summed a chunk at a time in fresh
// accumulators and then added (the mma.sync design's kFlush); dS also goes
// to shared memory with rows of queries, for dQ^T = K^T dS^T, each
// warpgroup over its own keys, the second's sum added by the first through
// shared memory. delta keeps the mma.sync design's order. A block of 4 or
// 8 warps takes 93-204 KB of shared memory at the flagship shapes, one or
// two blocks an SM (the budget in PERF.md).
//
// The TF32 TMA design (fp32 with Lk <= 64 and 48 < D <= 64, D a multiple
// of 4: tf32_tma_takes; the flagship vision self-attention, 44 keys at D
// 64) takes the TF32 design's products in a block of one warpgroup that
// holds 97.5 KB, so that two blocks share an SM (the TF32 design at D 64
// held 165 KB, one warpgroup an SM), and each block is persistent over an
// equal share of the (batch, head) items. Thread 0 has TMA copy K and V of
// an item and Q and G a chunk of 32 queries at a time, fp32 in the 128-byte
// swizzle that TF32 wgmma reads (3-D tensor maps, zeros past Lk, Lq and D):
// the next chunk's Q and G, or the next item's first with its V, once
// every warp's S^T and dP^T have read the current ones, and the next item's
// K once its dQ^T has; so an item's copies run behind the last one's
// products. The raw Q and G tiles are the high parts of S^T's and dP^T's B
// operands as they lie: the hardware reads a TF32 operand's top 19 bits, a
// truncated high part, so the threads write only the low parts, x -
// trunc(x) rounded to TF32, into tiles of the same layout, and in the same
// pass Q^T and G^T (dK's and dV's B) as the raw values and those low parts
// (a last chunk of at most 16 queries by warp pairs, a matrix each).
// K and V, the register A operands of S^T and dP^T, are split as they load
// from their tiles; dS goes in hi and lo into the low parts' place, the B
// operand of dQ^T = K^T dS^T, whose A is K^T split as it loads across K's
// tile. One warpgroup owns all the keys, so delta and dQ take no other
// warpgroup's sums. dV and dK sum in their accumulators over up to
// kTmaFlush chunks (128 queries) at a time, then into dv and dk (kFlush).
//
// The mma.sync design (fp32 where no wgmma design takes it, and past 128
// keys): the block's W <= 8 warps take a key tile of 16 W keys (all of them
// up to 128 keys), one 16-key slab a warp, staged with K and V in shared
// memory by 16-byte cp.async copies.
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
// split into bf16 hi + lo, or with round_p P bf16 in one product; G's, Q's
// and K's fragments by ldmatrix.trans),
// 3xTF32 m16n8k8 for fp32 (attention_common.cuh). For bf16 inputs
// registers are capped for two blocks an SM, so one block's loads overlap
// another's products.

#include "attention_common.cuh"
#include "hopper.cuh"

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

template <typename T, int DT, bool ROUND>
__global__ void __launch_bounds__(256, sizeof(T) == 2 ? 2 : 1)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const T* __restrict__ g, const T* __restrict__ o,
                     const float* __restrict__ lse, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dq_acc, int H, int Lq, int Lk, int D,
                     int Lm, float scale, float rate, float keep_scale,
                     float keep_rcp, uint32_t seed, int hb, int BQ, int vec) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  static_assert(!(ROUND && SPLIT), "the rounding mode is bf16's");
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
          // st <- P, dpt <- P * dP * keep (ROUND: P times dP rounded to
          // bf16, the kept ones divided in bf16 by bf16(1 - rate)), and the
          // keep bits
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
                if constexpr (ROUND) {
                  const float dp = round_bf16(dpt[nt][c]);
                  pdp = keep ? p * (dropout ? round_bf16(dp * keep_rcp) : dp) : 0.f;
                } else {
                  pdp = keep ? p * (dropout ? dpt[nt][c] * keep_scale : dpt[nt][c]) : 0.f;
                }
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
          // st <- (P * keep) (ROUND: P rounded to bf16, the kept ones
          // divided in bf16 by bf16(1 - rate)), dpt <- dS = P * (dP * keep -
          // delta)
#pragma unroll
          for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int kl = kr0 + gr + 8 * (c >> 1);
              const int ql = c0 + 8 * nt + 2 * tq + (c & 1);
              const float delta = dl[nt][c & 1];
              const float p = st[nt][c];
              const float ds = dpt[nt][c] - p * delta;
              if constexpr (ROUND) {
                const float pb = round_bf16(p);
                st[nt][c] = (kept >> (4 * nt + c)) & 1u
                                ? (dropout ? round_bf16(pb * keep_rcp) : pb)
                                : 0.f;
              } else {
                st[nt][c] = (kept >> (4 * nt + c)) & 1u ? (dropout ? p * keep_scale : p) : 0.f;
              }
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
            // (P * keep)^T (ROUND: bf16 already, no low part) and dS^T in
            // bf16 hi + lo; G's and Q's fragments by ldmatrix.trans
            Frag16A ph[kChunk / 16], pl[kChunk / 16], dh[kChunk / 16], dl[kChunk / 16];
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk) {
              if (2 * kk < NT) {
                if constexpr (ROUND)
                  ph[kk] = a16_from_c_bf16(st[2 * kk], st[2 * kk + 1]);
                else
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
                  if constexpr (ROUND) {
                    mma_bf16(tv0, ph[kk], b0);
                    mma_bf16(tv1, ph[kk], b1);
                  } else {
                    mma_bf16x2(tv0, ph[kk], pl[kk], b0);
                    mma_bf16x2(tv1, ph[kk], pl[kk], b1);
                  }
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

template <typename T, int DT, bool ROUND>
const void* kernel_of() {
  return (const void*)attention_bwd_kernel<T, DT, ROUND>;
}

template <typename T, bool ROUND>
const void* kernel_for(int D) {
  switch (head_tiles(D)) {
    case 4: return kernel_of<T, 4, ROUND>();
    case 6: return kernel_of<T, 6, ROUND>();
    case 8: return kernel_of<T, 8, ROUND>();
    default: return kernel_of<T, 16, ROUND>();
  }
}

// raise a kernel's shared-memory limit once on each device (the limit is a
// device's), to the most any launch needs (every layout stays within
// kMaxSmem)
cudaError_t raise_smem_limit(const void* fn) {
  static const void* raised_fn[64];
  static int raised_dev[64];
  static int n = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < n; ++i)
    if (raised_fn[i] == fn && raised_dev[i] == dev) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && n < 64) {
    raised_fn[n] = fn;
    raised_dev[n++] = dev;
  }
  return err;
}

template <typename T, bool ROUND>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* g, const void* o, const void* lse, void* dq, void* dk,
           void* dv, void* dq_acc, int B, int H, int Lq, int Lk, int D, int Lm,
           float scale, float rate, float keep_scale, float keep_rcp, int seed, int hb,
           cudaStream_t stream) {
  const Layout l = layout<T>(Lq, Lk, D);
  if (Lk > 16 * l.W && dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for<T, ROUND>(D);
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return (int)err;
  int vec = (D * sizeof(T)) % 16 == 0 &&
            ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)o) %
                    16 ==
                0;
  uint32_t useed = (uint32_t)seed;
  int BQ = l.BQ;
  void* args[] = {&q, &k, &v, &mask, &g, &o, &lse, &dq, &dk, &dv, &dq_acc,
                  &H, &Lq, &Lk, &D, &Lm, &scale, &rate, &keep_scale, &keep_rcp,
                  &useed, &hb, &BQ, &vec};
  err = cudaLaunchKernel(fn, dim3(B * H), dim3(32 * l.W), args, l.smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}


// ---- the wgmma design (see the head of the file) ---------------------------

constexpr int kWgRows = 64;   // keys of a warpgroup; query rows of a chunk
constexpr int kWgKeys = 128;  // keys the design takes, at most: two warpgroups
constexpr int kRow = 128;     // bytes of a swizzled row: 64 bf16

// Shared memory of a block at NK keys (NK / 64 warpgroups) and 8 DT head
// columns, by offset from a 1024-byte boundary: K and V (64-column slabs of
// NK rows), Q and G of a 64-query chunk, dS^T of a chunk in bf16 hi and lo
// and (P * keep)^T (ROUND: one bf16 tile; -pallas: hi and lo), each NK key
// rows of 64 queries, the chunk's dQ staged for its TMA store; then each
// warp's part of delta, the lse of two chunks, the key-only mask row and
// the mbarriers.
template <int NK, int DT, bool ROUND>
struct WgLayout {
  static constexpr int nwg = NK / kWgRows;
  static constexpr int slabs = DT > 8 ? 2 : 1;
  static constexpr int kv = slabs * NK * kRow;
  static constexpr int chunk = slabs * kWgRows * kRow;
  static constexpr int ds = NK * kRow;
  static constexpr int off_k = 0, off_v = kv, off_q = 2 * kv, off_g = off_q + chunk,
                       off_ds_hi = off_g + chunk, off_ds_lo = off_ds_hi + ds,
                       off_p = off_ds_lo + ds, off_dq = off_p + (ROUND ? 1 : 2) * ds,
                       off_part = off_dq + chunk, off_lse = off_part + 4 * nwg * kWgRows * 4,
                       off_mask = off_lse + 2 * kWgRows * 4, off_bars = off_mask + NK * 4;
  static constexpr size_t bytes = 1024 + off_bars + 2 * sizeof(uint64_t);
};

// Blocks an SM that an instance's registers are capped for: the
// accumulators of a half chunk's S^T and dP^T (16 + 16 a thread) and of dV
// and dK (4 DT each) stay live together; ptxas spills below these caps
// (the build report).
template <int NK, int DT>
constexpr int wg_min_blocks() {
  return NK == 64 ? (DT <= 8 ? 3 : 2) : (DT <= 6 ? 2 : 1);
}

template <int NK, int DT, bool ROUND>
__global__ void __launch_bounds__(2 * NK, wg_min_blocks<NK, DT>())
attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tdq,
                           const __grid_constant__ CUtensorMap tdk,
                           const __grid_constant__ CUtensorMap tdv,
                           const float* __restrict__ mask, const float* __restrict__ lse,
                           int H, int Lq, int Lk, int Lm, float scale, float rate,
                           float keep_scale, float keep_rcp, uint32_t seed, int hb) {
  using namespace hopper;
  using L = WgLayout<NK, DT, ROUND>;
  constexpr int NWG = L::nwg;
  constexpr int NQ8 = DT / NWG;  // dQ's 8-column groups a warpgroup takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1024-byte boundary, as an offset into smem_raw: the compiler
  // then addresses every tile below as shared memory (LDS, STS)
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = sm + L::off_k;
  unsigned char* sV = sm + L::off_v;
  unsigned char* sQ = sm + L::off_q;
  unsigned char* sG = sm + L::off_g;
  unsigned char* sDsHi = sm + L::off_ds_hi;
  unsigned char* sDsLo = sm + L::off_ds_lo;
  unsigned char* sP = sm + L::off_p;  // -pallas: its lo part L::ds after
  unsigned char* sDq = sm + L::off_dq;
  float* sPart = reinterpret_cast<float*>(sm + L::off_part);  // [warp][query]
  float* sLse = reinterpret_cast<float*>(sm + L::off_lse);    // [chunk % 2][query], log2 units
  float* sMask = reinterpret_cast<float*>(sm + L::off_mask);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::off_bars);  // K and V; Q and G

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int nchunks = (Lq + kWgRows - 1) / kWgRows;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int gw = 4 * wg + (t >> 5);  // the warp's keys are 16 gw .. 16 gw + 15
  const int key[2] = {16 * gw + gr, 16 * gw + gr + 8};

  // Q and G of chunk c (thread 0)
  auto load_chunk = [&](int c) {
    mbar_expect_tx(&bars[1], 2 * L::chunk);
    for (int s = 0; s < L::slabs; ++s) {
      tma_load_3d(sQ + s * kWgRows * kRow, &tq, &bars[1], 64 * s, kWgRows * c, bh);
      tma_load_3d(sG + s * kWgRows * kRow, &tg, &bars[1], 64 * s, kWgRows * c, bh);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], 2 * L::kv);
    for (int s = 0; s < L::slabs; ++s) {
      tma_load_3d(sK + s * NK * kRow, &tk, &bars[0], 64 * s, 0, bh);
      tma_load_3d(sV + s * NK * kRow, &tv, &bars[0], 64 * s, 0, bh);
    }
    load_chunk(0);
  }
  // the key-only mask row (-inf past the last key) and the first chunk's
  // lse, while the copies are in flight
  if (Lm == 1)
    for (int j = threadIdx.x; j < NK; j += blockDim.x)
      sMask[j] = j < Lk ? mask[(size_t)b * Lk + j] : -CUDART_INF_F;
  if (threadIdx.x < kWgRows)
    sLse[threadIdx.x] = (int)threadIdx.x < Lq ? lse[(size_t)bh * Lq + threadIdx.x] * kLog2e : 0.f;
  __syncthreads();

  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;
  const float* mb = mask + (size_t)b * Lm * Lk;
  // a key-only mask's values at the thread's two keys
  const float mk[2] = {sMask[key[0]], sMask[key[1]]};
  float dv[4 * DT], dk[4 * DT];
#pragma unroll
  for (int i = 0; i < 4 * DT; ++i) dv[i] = dk[i] = 0.f;
  mbar_wait(&bars[0], 0);

  for (int c = 0; c < nchunks; ++c) {
    const int q0 = kWgRows * c;
    const float* cl = sLse + (c & 1) * kWgRows;
    // the next chunk's lse, stored once this chunk's first barrier has
    // ended the last chunk's reads of its buffer
    const int nl = q0 + kWgRows + threadIdx.x;
    const float lse_next =
        threadIdx.x < kWgRows && nl < Lq ? lse[(size_t)bh * Lq + nl] * kLog2e : 0.f;
    mbar_wait(&bars[1], c & 1);

    // the chunk in two halves of 32 queries: fewer live registers
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const int h0 = 32 * hq;  // the half's first query in the chunk

      // 1. S^T = K Q^T and dP^T = V G^T: the warpgroup's 64 keys by the
      // half's 32 queries, D / 16 k-steps along the swizzled rows
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT / 2; ++kk) {
        const int at = (kk / 4) * NK * kRow + kWgRows * wg * kRow + (kk % 4) * 32;
        const int bt = (kk / 4) * kWgRows * kRow + h0 * kRow + (kk % 4) * 32;
        wgmma_ss_n32(s, desc_b128(sK + at, 16, 1024), desc_b128(sQ + bt, 16, 1024), 1);
        wgmma_ss_n32(dp, desc_b128(sV + at, 16, 1024), desc_b128(sG + bt, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);

      // 2. s <- P, dp <- P * dP * keep (ROUND: dP rounded to bf16, the
      // kept ones divided in bf16 by bf16(1 - rate)), and the keep bits;
      // without branches (P is 0 outside the keys and queries), and the
      // keep hash only with dropout
      uint32_t kept = 0;
      auto probs = [&](auto with_dropout) {
        constexpr bool DROP = decltype(with_dropout)::value;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the lse (log2 units) of the thread's queries h0 + 8 i + 2 tq4 + e
          const float2 l2 = *reinterpret_cast<const float2*>(&cl[h0 + 8 * i + 2 * tq4]);
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int ql = h0 + 8 * i + 2 * tq4 + (c4 & 1);  // query in the chunk
            const int qi = q0 + ql, kj = key[c4 >> 1];
            const bool in = kj < Lk && qi < Lq;
            const float mv = Lm == 1 ? mk[c4 >> 1] : (in ? mb[(size_t)qi * Lk + kj] : 0.f);
            // in log2 units, rounded as the forward kernel rounds it
            const float sc = (s[4 * i + c4] * scale + mv) * kLog2e;
            const float p = in ? exp2f(sc - (c4 & 1 ? l2.y : l2.x)) : 0.f;
            bool keep = true;
            if constexpr (DROP) keep = drop.keep(qi, kj, rate, keep_scale) != 0.f;
            float pdp;
            if constexpr (ROUND) {
              const float d = round_bf16(dp[4 * i + c4]);
              pdp = keep ? p * (DROP ? round_bf16(d * keep_rcp) : d) : 0.f;
            } else {
              pdp = keep ? p * (DROP ? dp[4 * i + c4] * keep_scale : dp[4 * i + c4]) : 0.f;
            }
            kept |= (uint32_t)keep << (4 * i + c4);
            s[4 * i + c4] = p;
            dp[4 * i + c4] = pdp;
          }
        }
      };
      if (dropout) probs(std::true_type{});
      else probs(std::false_type{});

      // 3. the warp's part of delta for each of the half's queries: a sum
      // over its keys, the lane's two rows and then the eight lanes of a
      // column
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = dp[4 * i + e] + dp[4 * i + 2 + e];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (gr == 0) sPart[gw * kWgRows + h0 + 8 * i + 2 * tq4 + e] = x;
        }
      }
      __syncthreads();  // every warp's part
      if (hq == 0 && threadIdx.x < kWgRows)
        sLse[((c + 1) & 1) * kWgRows + threadIdx.x] = lse_next;
      // delta of the queries h0 + 8 (gr % 4) + 2 tq4 + e: the warps' parts
      // summed in a fixed order; the lanes then trade them
      float mine[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < 4 * NWG; ++w) {
        const float2 x = *reinterpret_cast<const float2*>(
            &sPart[w * kWgRows + h0 + 8 * (gr & 3) + 2 * tq4]);
        mine[0] += x.x;
        mine[1] += x.y;
      }

      // 4. dS = P * (dP * keep - delta) in bf16 hi + lo and (P * keep)
      // (ROUND: P rounded to bf16, the kept ones divided in bf16 by
      // bf16(1 - rate); -pallas: in bf16 hi + lo), transposed, into their
      // swizzled tiles: rows of keys, 64 queries a row
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) dl[e] = __shfl_sync(0xffffffffu, mine[e], 4 * i + tq4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c4 = 2 * hh + e;
            const float p = s[4 * i + c4];
            ds[e] = dp[4 * i + c4] - p * dl[e];
            const bool keep = (kept >> (4 * i + c4)) & 1u;
            if constexpr (ROUND) {
              const float pb = round_bf16(p);
              pv[e] = keep ? (dropout ? round_bf16(pb * keep_rcp) : pb) : 0.f;
            } else {
              pv[e] = keep ? (dropout ? p * keep_scale : p) : 0.f;
            }
          }
          // key[hh] % 8 = gr; 16-byte column group 4 hq + i
          const int at = key[hh] * kRow + (((4 * hq + i) ^ gr) * 16) + 4 * tq4;
          uint32_t hi, lo;
          split_bf16(ds[0], ds[1], hi, lo);
          *reinterpret_cast<uint32_t*>(sDsHi + at) = hi;
          *reinterpret_cast<uint32_t*>(sDsLo + at) = lo;
          if constexpr (ROUND) {
            *reinterpret_cast<uint32_t*>(sP + at) = pack_bf16(pv[0], pv[1]);
          } else {
            split_bf16(pv[0], pv[1], hi, lo);
            *reinterpret_cast<uint32_t*>(sP + at) = hi;
            *reinterpret_cast<uint32_t*>(sP + L::ds + at) = lo;
          }
        }
      }
    }

    // 5. once every warp's tiles are in place, one batch of products:
    //   dV += (P * keep)^T G and dK += dS^T Q over the k-steps that hold
    //   queries: A the warpgroup's 64 key rows of the P and dS^T tiles
    //   (K-major), G and Q MN-major (their rows are queries);
    //   dQ = dS K for the chunk's queries and this warpgroup's 8 NQ8 head
    //   columns over the k-steps that hold keys: A dS^T's tiles (MN-major:
    //   their rows are keys), K MN-major, started NQ8 wg column groups
    //   along its rows
    // (thread 0: the last chunk's dQ store has read its staging tile)
    if (threadIdx.x == 0) tma_store_wait();
    fence_async_shared();
    __syncthreads();
    const int c0 = NQ8 * wg;
    const unsigned char* kq = sK + (c0 / 8) * NK * kRow + (c0 % 8) * 16;
    float dq[4 * NQ8];
#pragma unroll
    for (int i = 0; i < 4 * NQ8; ++i) dq[i] = 0.f;
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (q0 + 16 * kk < Lq) {
        const int at = kWgRows * wg * kRow + kk * 32;
        const uint64_t bg = desc_b128(sG + kk * 16 * kRow, kWgRows * kRow, 1024);
        const uint64_t bq = desc_b128(sQ + kk * 16 * kRow, kWgRows * kRow, 1024);
        if constexpr (!ROUND) wgmma_ss_nt<DT>(dv, desc_b128(sP + L::ds + at, 16, 1024), bg, 1);
        wgmma_ss_nt<DT>(dv, desc_b128(sP + at, 16, 1024), bg, 1);
        wgmma_ss_nt<DT>(dk, desc_b128(sDsLo + at, 16, 1024), bq, 1);
        wgmma_ss_nt<DT>(dk, desc_b128(sDsHi + at, 16, 1024), bq, 1);
      }
    }
#pragma unroll
    for (int ks = 0; ks < NK / 16; ++ks) {
      if (16 * ks < Lk) {
        const uint64_t bk = desc_b128(kq + ks * 16 * kRow, NK * kRow, 1024);
        wgmma_ss_tt<8 * NQ8>(dq, desc_b128(sDsLo + ks * 16 * kRow, NK * kRow, 1024), bk, 1);
        wgmma_ss_tt<8 * NQ8>(dq, desc_b128(sDsHi + ks * 16 * kRow, NK * kRow, 1024), bk, 1);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);

    // 6. dQ (times scale) in bf16 through the staging tile to a TMA store
    // that skips the rows past Lq and the columns past D; once every
    // warpgroup's products are done, the next chunk's Q and G
    store_acc_bf16<NQ8>(sDq, kWgRows, 0, c0, dq, scale);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int sl = 0; sl < L::slabs; ++sl)
        tma_store_3d(&tdq, sDq + sl * kWgRows * kRow, 64 * sl, q0, bh);
      tma_store_commit();
      if (c + 1 < nchunks) load_chunk(c + 1);
    }
  }

  // 7. dK (times scale) and dV in bf16 through the warpgroup's rows of the
  // K and V tiles (every product that reads them is done) to TMA stores
  // that skip the keys past Lk and the columns past D
  store_acc_bf16<DT>(sK, NK, kWgRows * wg, 0, dk, scale);
  store_acc_bf16<DT>(sV, NK, kWgRows * wg, 0, dv, 1.f);
  fence_async_shared();
  named_barrier(1 + wg, 128);
  if (t == 0) {
    for (int sl = 0; sl < L::slabs; ++sl) {
      const int at = sl * NK * kRow + kWgRows * wg * kRow;
      tma_store_3d(&tdk, sK + at, 64 * sl, kWgRows * wg, bh);
      tma_store_3d(&tdv, sV + at, 64 * sl, kWgRows * wg, bh);
    }
    tma_store_wait();
  }
}

template <int NK, int DT, bool ROUND>
int launch_wgmma_dt(const void* q, const void* k, const void* v, const float* mask,
                    const void* g, const float* lse, void* dq, void* dk, void* dv, int B, int H,
                    int Lq, int Lk, int D, int Lm, float scale, float rate, float keep_scale,
                    float keep_rcp, int seed, int hb, cudaStream_t stream) {
  // TMA takes 16-byte aligned tensors
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv) %
          16 !=
      0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = raise_smem_limit((const void*)attention_bwd_wgmma_kernel<NK, DT, ROUND>);
  if (err != cudaSuccess) return (int)err;
  using hopper::tensor_map;
  CUtensorMap tq, tk, tv, tg, tdq, tdk, tdv;
  const int BH = B * H;
  if ((err = tensor_map(&tq, q, BH, Lq, D, kWgRows)) != cudaSuccess ||
      (err = tensor_map(&tk, k, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map(&tv, v, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map(&tg, g, BH, Lq, D, kWgRows)) != cudaSuccess ||
      (err = tensor_map(&tdq, dq, BH, Lq, D, kWgRows)) != cudaSuccess ||
      (err = tensor_map(&tdk, dk, BH, Lk, D, kWgRows)) != cudaSuccess ||
      (err = tensor_map(&tdv, dv, BH, Lk, D, kWgRows)) != cudaSuccess)
    return (int)err;
  const size_t smem = WgLayout<NK, DT, ROUND>::bytes;
  attention_bwd_wgmma_kernel<NK, DT, ROUND><<<BH, 2 * NK, smem, stream>>>(
      tq, tk, tv, tg, tdq, tdk, tdv, mask, lse, H, Lq, Lk, Lm, scale, rate, keep_scale,
      keep_rcp, (uint32_t)seed, hb);
  return (int)cudaGetLastError();
}

template <int NK_, int DT_>
struct WgInstance {
  static constexpr int NK = NK_, DT = DT_;
};

// f(WgInstance<NK, DT>{}) for the wgmma instance of (Lk, D): the keys
// padded to NK = 64 or 128 (one or two warpgroups), the head columns to 8 DT
template <typename F>
int with_wgmma_instance(int Lk, int D, F&& f) {
  const bool wide = Lk > kWgRows;
  switch (head_tiles(D)) {
    case 4: return wide ? f(WgInstance<128, 4>{}) : f(WgInstance<64, 4>{});
    case 6: return wide ? f(WgInstance<128, 6>{}) : f(WgInstance<64, 6>{});
    case 8: return wide ? f(WgInstance<128, 8>{}) : f(WgInstance<64, 8>{});
    default: return wide ? f(WgInstance<128, 16>{}) : f(WgInstance<64, 16>{});
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, const void* g,
                 const void* lse, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                 int D, int Lm, float scale, float rate, float keep_scale, float keep_rcp,
                 int seed, int hb, int round_p, cudaStream_t stream) {
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    const float* m = static_cast<const float*>(mask);
    const float* l = static_cast<const float*>(lse);
    if (round_p)
      return launch_wgmma_dt<I::NK, I::DT, true>(q, k, v, m, g, l, dq, dk, dv, B, H, Lq, Lk,
                                                 D, Lm, scale, rate, keep_scale, keep_rcp,
                                                 seed, hb, stream);
    return launch_wgmma_dt<I::NK, I::DT, false>(q, k, v, m, g, l, dq, dk, dv, B, H, Lq, Lk, D,
                                                Lm, scale, rate, keep_scale, keep_rcp, seed,
                                                hb, stream);
  });
}


// ---- the TF32 wgmma design (fp32; see the head of the file) -----------------

constexpr int kTfChunk = 32;  // queries of a chunk

// Whether the TF32 design takes (Lk, D): up to 128 keys, 16-byte rows and
// D <= 48. At 128 keys wider heads do not fit an SM's shared memory; at 64
// keys D = 64 (the flagship vision shape) fits, one warpgroup a block and
// one block an SM, but measured no faster than the mma.sync design
// (PERF.md): the TF32 TMA design takes 48 < D <= 64 up to 64 keys.
__host__ __device__ inline bool tf32_takes(int Lk, int D) {
  return Lk <= kWgKeys && D % 4 == 0 && D <= 48;
}

// Shared memory of a block at NK keys (NK / 64 warpgroups) and Dp = 8 DT
// head columns, by offset from a 1024-byte boundary. The operands of the
// products, each in TF32 hi and lo, K-major in 32-column (128-byte)
// swizzled slabs: K^T (rows of head columns; dQ^T's A reads 64 rows from a
// slab's start, those past Dp from what follows, which only its rows past
// Dp take), Q and G of a chunk (rows of queries; S^T's and dP^T's B), Q^T
// and G^T of a chunk (rows of head columns, the chunk's 32 queries in the
// order of the register A operand's k positions; dK's and dV's B), dS of a
// chunk (rows of queries; dQ^T's B). Then K and V and the next chunk's Q
// and G as they arrive, in rows padded to Dp + 4 floats (the register A
// operands' loads are free of bank conflicts), each warp's part of delta,
// the lse of two chunks and the key-only mask row. The second warpgroup's
// part of dQ^T goes to the first through the Q and G tiles, unused by then.
template <int NK, int DT>
struct TfLayout {
  static constexpr int nwg = NK / kWgRows;
  static constexpr int Dp = 8 * DT;
  static constexpr int ldr = row_stride<float>(Dp);
  static constexpr int kt_slab = Dp * kRow;
  static constexpr int kt = (NK / 32) * kt_slab;
  static constexpr int qtile = (Dp + 31) / 32 * kTfChunk * kRow;
  static constexpr int qt = Dp * kRow;
  static constexpr int ds = NK / 32 * kTfChunk * kRow;
  static constexpr int raw = NK * ldr * 4;
  static constexpr int stage = kTfChunk * ldr * 4;
  static constexpr int off_kt_hi = 0, off_kt_lo = kt, off_q_hi = 2 * kt,
                       off_q_lo = off_q_hi + qtile, off_g_hi = off_q_lo + qtile,
                       off_g_lo = off_g_hi + qtile,
                       off_qt_hi = off_g_lo + qtile, off_qt_lo = off_qt_hi + qt,
                       off_gt_hi = off_qt_lo + qt, off_gt_lo = off_gt_hi + qt,
                       off_ds_hi = off_gt_lo + qt, off_ds_lo = off_ds_hi + ds,
                       off_k = off_ds_lo + ds, off_v = off_k + raw, off_sq = off_v + raw,
                       off_sg = off_sq + stage, off_part = off_sg + stage,
                       off_lse = off_part + 4 * nwg * kTfChunk * 4,
                       off_mask = off_lse + 2 * kTfChunk * 4, end = off_mask + NK * 4;
  static constexpr size_t bytes = 1024 + end;
  static_assert(bytes <= (size_t)kMaxSmem, "the tiles exceed an SM's shared memory");
};

// A (64 x 8, from registers) of rows [r0, r0 + 16) x columns [k0, k0 + 8)
// of a row-major fp32 tile, split (load_a<true> with tf32_rna)
__device__ __forceinline__ FragA load_a_tf32(const float* s, int ld, int r0, int k0, int lane) {
  const float* p = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  FragA f;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8 * ld], f.hi[1], f.lo[1]);
  split_tf32(p[4], f.hi[2], f.lo[2]);
  split_tf32(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// Rows [0, n) of a row-major [., D] fp32 matrix at src into rows of ld
// floats at dst, 16-byte asynchronous copies by the block's THREADS
// threads, with columns [D, DP) and rows [n, ROWS) zeroed (D a multiple of
// 4: a 16-byte chunk lies inside D or past it). The trip count is the
// compiler's, so that it can batch each thread's copies.
template <int ROWS, int DP, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int D) {
  constexpr int per_row = DP / 4;
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * per_row; i += THREADS) {
    const int r = i / per_row, c = 4 * (i % per_row);
    if (r < n && c < D) cp_async16(dst + r * LD + c, src + (size_t)r * D + c);
    else *reinterpret_cast<float4*>(dst + r * LD + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NK, int DT>
__global__ void __launch_bounds__(2 * NK, 1)
attention_bwd_wgmma_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ mask,
                                const float* __restrict__ g, const float* __restrict__ lse,
                                float* __restrict__ dq, float* __restrict__ dk,
                                float* __restrict__ dv, int H, int Lq, int Lk, int D, int Lm,
                                float scale, float rate, float keep_scale, uint32_t seed,
                                int hb) {
  using namespace hopper;
  using L = TfLayout<NK, DT>;
  constexpr int NWG = L::nwg;
  constexpr int Dp = L::Dp;
  constexpr int C = kTfChunk;
  constexpr int T = 2 * NK;  // threads: every loop's trip count is known
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1024-byte boundary, as an offset into smem_raw (shared-memory
  // loads and stores, not generic ones)
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sKtHi = sm + L::off_kt_hi;
  unsigned char* sKtLo = sm + L::off_kt_lo;
  unsigned char* sQHi = sm + L::off_q_hi;
  unsigned char* sQLo = sm + L::off_q_lo;
  unsigned char* sGHi = sm + L::off_g_hi;
  unsigned char* sGLo = sm + L::off_g_lo;
  unsigned char* sQtHi = sm + L::off_qt_hi;
  unsigned char* sQtLo = sm + L::off_qt_lo;
  unsigned char* sGtHi = sm + L::off_gt_hi;
  unsigned char* sGtLo = sm + L::off_gt_lo;
  unsigned char* sDsHi = sm + L::off_ds_hi;
  unsigned char* sDsLo = sm + L::off_ds_lo;
  float* sK = reinterpret_cast<float*>(sm + L::off_k);
  float* sV = reinterpret_cast<float*>(sm + L::off_v);
  float* sStQ = reinterpret_cast<float*>(sm + L::off_sq);
  float* sStG = reinterpret_cast<float*>(sm + L::off_sg);
  float* sPart = reinterpret_cast<float*>(sm + L::off_part);  // [warp][query]
  float* sLse = reinterpret_cast<float*>(sm + L::off_lse);    // [chunk % 2][query], log2 units
  float* sRed = reinterpret_cast<float*>(sm + L::off_q_hi);   // [element][thread]
  float* sMask = reinterpret_cast<float*>(sm + L::off_mask);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int nchunks = (Lq + C - 1) / C;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int wl = t >> 5;
  const int lane = t & 31;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int gw = 4 * wg + wl;  // the warp's keys are 16 gw .. 16 gw + 15
  const int key[2] = {16 * gw + gr, 16 * gw + gr + 8};
  const float* qh = q + (size_t)bh * Lq * D;
  const float* gh = g + (size_t)bh * Lq * D;

  // K, then V and the first chunk's Q and G, as they are (zeros past Lk,
  // Lq and D), in two groups of copies; the key-only mask row (-inf past
  // the last key) and the first chunk's lse
  stage_rows<NK, Dp, L::ldr, T>(sK, k + (size_t)bh * Lk * D, Lk, D);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_rows<NK, Dp, L::ldr, T>(sV, v + (size_t)bh * Lk * D, Lk, D);
  stage_rows<C, Dp, L::ldr, T>(sStQ, qh, Lq, D);
  stage_rows<C, Dp, L::ldr, T>(sStG, gh, Lq, D);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
  if (Lm == 1)
    for (int j = threadIdx.x; j < NK; j += T)
      sMask[j] = j < Lk ? mask[(size_t)b * Lk + j] : -CUDART_INF_F;
  if (threadIdx.x < C)
    sLse[threadIdx.x] = (int)threadIdx.x < Lq ? lse[(size_t)bh * Lq + threadIdx.x] * kLog2e : 0.f;
  __syncthreads();
  // K^T in TF32 hi + lo, while the second group lands: 4 keys of a row
  // (head column d) a 16-byte chunk
#pragma unroll
  for (int i = threadIdx.x; i < Dp * (NK / 4); i += T) {
    const int d = i % Dp, j4 = i / Dp;
    const float x[4] = {sK[(4 * j4) * L::ldr + d], sK[(4 * j4 + 1) * L::ldr + d],
                        sK[(4 * j4 + 2) * L::ldr + d], sK[(4 * j4 + 3) * L::ldr + d]};
    put_split4(sKtHi, sKtLo, (j4 / 8) * L::kt_slab + d * kRow + (((j4 % 8) ^ (d & 7)) * 16), x);
  }
  cp_async_wait_all();
  __syncthreads();

  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;
  const float* mb = mask + (size_t)b * Lm * Lk;
  // a key-only mask's values at the thread's two keys
  const float mk[2] = {sMask[key[0]], sMask[key[1]]};
  float dvt[Dp / 2], dkt[Dp / 2];  // dV and dK of the warpgroup's keys
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) dvt[i] = dkt[i] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int q0 = C * c;
    const float* cl = sLse + (c & 1) * C;
    // the descriptor of the tiles' base, made anew each chunk, and of a
    // tile at a byte offset from it: the compiler then holds no
    // chunk-invariant descriptors in registers across the loop
    uint64_t d0 = desc_b128(sm, 16, 1024);
    asm volatile("" : "+l"(d0));
    auto desc = [&](int off) { return d0 + (uint64_t)(off >> 4); };
    // the next chunk's lse, stored once this chunk's first barrier has
    // ended the last chunk's reads of its buffer
    const int nl = q0 + C + threadIdx.x;
    const float lse_next =
        threadIdx.x < C && nl < Lq ? lse[(size_t)bh * Lq + nl] * kLog2e : 0.f;

    // 1. the chunk's Q and G in TF32 hi + lo, with rows of queries (4
    // columns a 16-byte chunk) and transposed, rows of head columns (the 4
    // queries 8 i + e + 2 a, a = 0..3, of chunk 2 i + e: the k order of A
    // from the accumulators, a_from_c_tf32)
#pragma unroll
    for (int i = threadIdx.x; i < 2 * C * (Dp / 4); i += T) {
      const int m = i / (C * (Dp / 4));
      const int r = i - m * (C * (Dp / 4));
      const int qi = r / (Dp / 4), d4 = r % (Dp / 4);
      const float4 x4 = *reinterpret_cast<const float4*>((m ? sStG : sStQ) + qi * L::ldr + 4 * d4);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      put_split4(m ? sGHi : sQHi, m ? sGLo : sQLo,
                 (d4 / 8) * (C * kRow) + qi * kRow + (((d4 % 8) ^ (qi & 7)) * 16), x);
    }
#pragma unroll
    for (int i = threadIdx.x; i < 2 * Dp * 8; i += T) {
      const int m = i / (Dp * 8);
      const int r = i - m * (Dp * 8);
      const int d = r % Dp, ch = r / Dp;
      const float* src = (m ? sStG : sStQ) + (8 * (ch >> 1) + (ch & 1)) * L::ldr + d;
      const float x[4] = {src[0], src[2 * L::ldr], src[4 * L::ldr], src[6 * L::ldr]};
      put_split4(m ? sGtHi : sQtHi, m ? sGtLo : sQtLo, d * kRow + ((ch ^ (d & 7)) * 16), x);
    }
    fence_async_shared();
    __syncthreads();
    // the next chunk's Q and G, in flight while this one is taken
    if (c + 1 < nchunks) {
      const int n1 = Lq - q0 - C;
      stage_rows<C, Dp, L::ldr, T>(sStQ, qh + (size_t)(q0 + C) * D, n1, D);
      stage_rows<C, Dp, L::ldr, T>(sStG, gh + (size_t)(q0 + C) * D, n1, D);
    }

    // 2. S^T = K Q^T and dP^T = V G^T: the warpgroup's 64 keys by the
    // chunk's 32 queries, D / 8 k-steps, A (K, V) from registers; one chain
    // and then the other (fewer live registers)
    float s[16], dp[16];
    auto chain = [&](float (&acc)[16], const float* raw, int bhi, int blo) {
      FragA a[DT];
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) a[kk] = load_a_tf32(raw, L::ldr, 16 * gw, 8 * kk, lane);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        const int bt = (kk / 4) * (C * kRow) + (kk % 4) * 32;
        wgmma_rs_3xtf32<C>(acc, a[kk], desc(bhi + bt), desc(blo + bt), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
    };
    chain(s, sK, L::off_q_hi, L::off_q_lo);
    chain(dp, sV, L::off_g_hi, L::off_g_lo);
    fence_regs(s);
    fence_regs(dp);

    // 3. s <- P, dp <- P * dP * keep, and the keep bits; without branches
    // (P is 0 outside the keys and queries), the keep hash only with
    // dropout
    uint32_t kept = 0;
    auto probs = [&](auto with_dropout) {
      constexpr bool DROP = decltype(with_dropout)::value;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the lse (log2 units) of the thread's queries 8 i + 2 tq4 + e
        const float2 l2 = *reinterpret_cast<const float2*>(&cl[8 * i + 2 * tq4]);
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int qi = q0 + 8 * i + 2 * tq4 + (c4 & 1), kj = key[c4 >> 1];
          const bool in = kj < Lk && qi < Lq;
          const float mv = Lm == 1 ? mk[c4 >> 1] : (in ? mb[(size_t)qi * Lk + kj] : 0.f);
          // in log2 units, rounded as the forward kernel rounds it
          const float sc = (s[4 * i + c4] * scale + mv) * kLog2e;
          const float p = in ? exp2f(sc - (c4 & 1 ? l2.y : l2.x)) : 0.f;
          bool keep = true;
          if constexpr (DROP) keep = drop.keep(qi, kj, rate, keep_scale) != 0.f;
          const float pdp = keep ? p * (DROP ? dp[4 * i + c4] * keep_scale : dp[4 * i + c4]) : 0.f;
          kept |= (uint32_t)keep << (4 * i + c4);
          s[4 * i + c4] = p;
          dp[4 * i + c4] = pdp;
        }
      }
    };
    if (dropout) probs(std::true_type{});
    else probs(std::false_type{});

    // 4. delta of each of the chunk's queries: each warp's sum over its
    // keys (the lane's two rows, then the eight lanes of a column), then,
    // after a barrier, the warps' parts in a fixed order (the mma.sync
    // design's); the lanes trade them
    if (threadIdx.x < C) sLse[((c + 1) & 1) * C + threadIdx.x] = lse_next;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = dp[4 * i + e] + dp[4 * i + 2 + e];
        x += __shfl_xor_sync(0xffffffffu, x, 4);
        x += __shfl_xor_sync(0xffffffffu, x, 8);
        x += __shfl_xor_sync(0xffffffffu, x, 16);
        if (gr == 0) sPart[gw * C + 8 * i + 2 * tq4 + e] = x;
      }
    }
    __syncthreads();
    float mine[2] = {0.f, 0.f};
#pragma unroll
    for (int w = 0; w < 4 * NWG; ++w) {
      const float2 x = *reinterpret_cast<const float2*>(&sPart[w * C + 8 * (gr & 3) + 2 * tq4]);
      mine[0] += x.x;
      mine[1] += x.y;
    }

    // 5. dS = P * (dP * keep - delta) and P * keep as the A operands of dK's
    // and dV's k-steps (the accumulators as they lie), in TF32 hi + lo; dS
    // into its tiles, rows of queries
    FragA pa[4], da[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float dl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) dl[e] = __shfl_sync(0xffffffffu, mine[e], 4 * i + tq4);
      float pv[4], ds[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const float p = s[4 * i + c4];
        ds[c4] = dp[4 * i + c4] - p * dl[c4 & 1];
        const bool keep = (kept >> (4 * i + c4)) & 1u;
        pv[c4] = keep ? (dropout ? p * keep_scale : p) : 0.f;
      }
      pa[i] = a_from_c_tf32(pv);
      da[i] = a_from_c_tf32(ds);
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int kj = key[c4 >> 1], ql = 8 * i + 2 * tq4 + (c4 & 1);
        const int at = (kj / 32) * (C * kRow) + ql * kRow + ((((kj % 32) >> 2) ^ (ql & 7)) * 16) +
                       4 * (kj & 3);
        const int e = 2 * (c4 & 1) + (c4 >> 1);  // a_from_c_tf32's place of element c4
        *reinterpret_cast<uint32_t*>(sDsHi + at) = da[i].hi[e];
        *reinterpret_cast<uint32_t*>(sDsLo + at) = da[i].lo[e];
      }
    }

    // 6. this chunk's dV = (P * keep)^T G and dK = dS^T Q over the k-steps
    // that hold queries (the first always does), in fresh accumulators added
    // to the totals after (as the mma.sync design's kFlush): A from
    // registers, B G^T's and Q^T's tiles
    float tv[Dp / 2], tk[Dp / 2];
    fence_regs(tv);
    fence_regs(tk);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q0 + 8 * i < Lq) {
        wgmma_rs_3xtf32<Dp>(tv, pa[i], desc(L::off_gt_hi + 32 * i), desc(L::off_gt_lo + 32 * i),
                            i > 0);
        wgmma_rs_3xtf32<Dp>(tk, da[i], desc(L::off_qt_hi + 32 * i), desc(L::off_qt_lo + 32 * i),
                            i > 0);
      }
    }
    wgmma_commit();
    fence_async_shared();
    __syncthreads();  // every warp's dS in its tiles
    wgmma_wait();
    fence_regs(tv);
    fence_regs(tk);
#pragma unroll
    for (int i = 0; i < Dp / 2; ++i) {
      dvt[i] += tv[i];
      dkt[i] += tk[i];
    }

    // 7. dQ^T = K^T dS^T for the chunk's queries over the warpgroup's own
    // 64 keys: A K^T's tiles (64 rows, those past Dp unused), B dS's (both
    // zero past Lk; a k-step skipped by a warpgroup's keys would branch on
    // the thread's index, and ptxas then serialises every product, C7520);
    // each group of 32 keys in its own accumulators, then summed in order;
    // the second warpgroup's sum goes to the first through shared memory,
    // which adds it and stores dQ times scale
    float dqa[2][C / 2];
    fence_regs(dqa[0]);
    fence_regs(dqa[1]);
    wgmma_fence();
#pragma unroll
    for (int kl = 0; kl < 8; ++kl) {
      const int ks = 8 * wg + kl;  // k-step of 8 keys in the block
      const int at = (ks / 4) * L::kt_slab + (ks % 4) * 32;
      const int bt = (ks / 4) * (C * kRow) + (ks % 4) * 32;
      const uint64_t ds_hi = desc(L::off_ds_hi + bt), kt_hi = desc(L::off_kt_hi + at);
      wgmma_ss_tf32_n32(dqa[kl / 4], desc(L::off_kt_lo + at), ds_hi, kl % 4 > 0);
      wgmma_ss_tf32_n32(dqa[kl / 4], kt_hi, desc(L::off_ds_lo + bt), 1);
      wgmma_ss_tf32_n32(dqa[kl / 4], kt_hi, ds_hi, 1);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(dqa[0]);
    fence_regs(dqa[1]);
    float* dqs = dqa[0];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) dqs[i] += dqa[1][i];
    if constexpr (NWG == 2) {
      if (wg == 1)
#pragma unroll
        for (int i = 0; i < C / 2; ++i) sRed[i * 128 + t] = dqs[i];
      __syncthreads();
      if (wg == 0)
#pragma unroll
        for (int i = 0; i < C / 2; ++i) dqs[i] += sRed[i * 128 + t];
    }
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int d = 16 * wl + gr + 8 * (c4 >> 1);
          const int qi = q0 + 8 * i + 2 * tq4 + (c4 & 1);
          if (d < D && qi < Lq) dq[((size_t)bh * Lq + qi) * D + d] = dqs[4 * i + c4] * scale;
        }
      }
    }

    // the next chunk's Q and G have landed, and every warpgroup is done
    // with this chunk's tiles
    cp_async_wait_all();
    __syncthreads();
  }

  // dK (times scale) and dV of the thread's keys
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int j = key[rh];
    if (j >= Lk) continue;
    float* dkr = dk + ((size_t)bh * Lk + j) * D;
    float* dvr = dv + ((size_t)bh * Lk + j) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = 8 * i + 2 * tq4;  // D is a multiple of 4: d + 1 < D
      if (d >= D) continue;
      *reinterpret_cast<float2*>(dkr + d) =
          make_float2(dkt[4 * i + 2 * rh] * scale, dkt[4 * i + 2 * rh + 1] * scale);
      *reinterpret_cast<float2*>(dvr + d) =
          make_float2(dvt[4 * i + 2 * rh], dvt[4 * i + 2 * rh + 1]);
    }
  }
}

template <int NK, int DT>
int launch_tf32_dt(const void* q, const void* k, const void* v, const void* mask, const void* g,
                   const void* lse, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                   int D, int Lm, float scale, float rate, float keep_scale, int seed, int hb,
                   cudaStream_t stream) {
  // 16-byte copies in, 8-byte stores out
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv) %
          16 !=
      0)
    return (int)cudaErrorMisalignedAddress;
  const void* fn = (const void*)attention_bwd_wgmma_tf32_kernel<NK, DT>;
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return (int)err;
  attention_bwd_wgmma_tf32_kernel<NK, DT><<<B * H, 2 * NK, TfLayout<NK, DT>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(g),
      static_cast<const float*>(lse), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Lq, Lk, D, Lm, scale, rate, keep_scale, (uint32_t)seed, hb);
  return (int)cudaGetLastError();
}

// f(WgInstance<NK, DT>{}) for the TF32 instance of (Lk, D) that tf32_takes:
// the head columns padded to 8 DT, the keys to NK = 64 or 128; at Dp 48
// always 128 (a one-warpgroup instance there needed more than 255
// registers a thread and spilled; the second warpgroup's keys past Lk add
// zeros)
template <typename F>
int with_tf32_instance(int Lk, int D, F&& f) {
  if (head_tiles(D) > 4) return f(WgInstance<128, 6>{});
  return Lk > kWgRows ? f(WgInstance<128, 4>{}) : f(WgInstance<64, 4>{});
}

int launch_tf32(const void* q, const void* k, const void* v, const void* mask, const void* g,
                const void* lse, void* dq, void* dk, void* dv, int B, int H, int Lq, int Lk,
                int D, int Lm, float scale, float rate, float keep_scale, int seed, int hb,
                cudaStream_t stream) {
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return launch_tf32_dt<I::NK, I::DT>(q, k, v, mask, g, lse, dq, dk, dv, B, H, Lq, Lk, D, Lm,
                                        scale, rate, keep_scale, seed, hb, stream);
  });
}


// ---- the TF32 TMA design (fp32 at D 64; see the head of the file) -----------

constexpr int kTmaChunk = 32;   // queries of a chunk
constexpr int kTmaFlush = 4;    // chunks summed into dV's and dK's accumulators
                                // before the sums go to dv and dk (kFlush)

// Whether the TF32 TMA design takes (Lk, D): up to 64 keys (one warpgroup)
// and 48 < D <= 64 with D a multiple of 4 (TMA's 16-byte row strides); the
// TF32 design takes the narrower heads
__host__ __device__ inline bool tf32_tma_takes(int Lk, int D) {
  return Lk <= kWgRows && D % 4 == 0 && D > 48 && D <= 64;
}

// Shared memory of a block, by offset from a 1024-byte boundary. K and V as
// TMA writes them (fp32, K-major: two 32-column (128-byte) swizzled slabs
// of 64 key rows, zeros past Lk and D), and Q and G of a chunk likewise
// (slabs of 32 query rows): the B operands of S^T = K Q^T and dP^T = V G^T
// as they are, the hardware reading a TF32 operand's top 19 bits (a
// truncated high part), and the sources of every other operand. Q's and G's
// low parts, x - trunc(x) rounded to TF32, in the same layout (those B
// operands' small terms), whose place dS takes in hi and lo (rows of
// queries, 64 keys: dQ^T's B) once S^T and dP^T are done. Q^T and G^T,
// the raw values (a truncated high part) and their low parts (rows of head
// columns, the chunk's 32 queries in the register A operand's k order:
// dK's and dV's B). Each warp's part of delta and the mbarriers.
struct TmaLayout {
  static constexpr int C = kTmaChunk;
  static constexpr int kv = 2 * kWgRows * kRow;
  static constexpr int qg = 2 * C * kRow;
  static constexpr int qt = kWgRows * kRow;
  static constexpr int off_k = 0, off_v = kv, off_q = 2 * kv, off_g = off_q + qg,
                       off_q_lo = off_g + qg, off_g_lo = off_q_lo + qg, off_ds_hi = off_q_lo,
                       off_ds_lo = off_g_lo, off_qt_hi = off_g_lo + qg, off_qt_lo = off_qt_hi + qt,
                       off_gt_hi = off_qt_lo + qt, off_gt_lo = off_gt_hi + qt,
                       off_part = off_gt_lo + qt, off_bars = off_part + 4 * C * 4,
                       end = off_bars + 3 * 8;
  static constexpr size_t bytes = 1024 + end;
  static_assert(4 * C == kRow, "a row of Q^T or G^T is one 128-byte slab");
};

// byte offset of element (r, c) of a tile of 32-column 128-byte swizzled
// slabs of `rows` rows (as TMA writes an fp32 box)
__device__ __forceinline__ int sw32(int r, int c, int rows) {
  return (c >> 5) * rows * kRow + r * kRow + ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2);
}

// x's TF32 low part against the truncated high part that the hardware
// reads from x itself
__device__ __forceinline__ uint32_t tf32_lo_of_raw(float x) {
  return tf32_rna(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

// A (64 x 8, from registers) of rows [r0, r0 + 16) x columns [k0, k0 + 8)
// of a swizzled fp32 tile of `rows` rows, split (load_a_tf32); transposed:
// rows [r0, r0 + 16) of the tile's columns by k0 .. k0 + 7 of its rows
template <bool TRANS>
__device__ __forceinline__ FragA load_a_sw(const unsigned char* s, int rows, int r0, int k0,
                                           int lane) {
  const int gr = lane >> 2, tq = lane & 3;
  auto at = [&](int r, int k) {
    return *reinterpret_cast<const float*>(s + (TRANS ? sw32(k, r, rows) : sw32(r, k, rows)));
  };
  FragA f;
  split_tf32(at(r0 + gr, k0 + tq), f.hi[0], f.lo[0]);
  split_tf32(at(r0 + gr + 8, k0 + tq), f.hi[1], f.lo[1]);
  split_tf32(at(r0 + gr, k0 + tq + 4), f.hi[2], f.lo[2]);
  split_tf32(at(r0 + gr + 8, k0 + tq + 4), f.hi[3], f.lo[3]);
  return f;
}

template <int NK, int DT>
__global__ void __launch_bounds__(128, 2)
attention_bwd_wgmma_tf32_tma_kernel(const __grid_constant__ CUtensorMap tmq,
                                    const __grid_constant__ CUtensorMap tmk,
                                    const __grid_constant__ CUtensorMap tmv,
                                    const __grid_constant__ CUtensorMap tmg,
                                    const float* __restrict__ mask, const float* __restrict__ lse,
                                    float* __restrict__ dq, float* __restrict__ dk,
                                    float* __restrict__ dv, int BH, int H, int Lq, int Lk, int D,
                                    int Lm, float scale, float rate, float keep_scale,
                                    uint32_t seed, int hb) {
  using namespace hopper;
  using L = TmaLayout;
  constexpr int C = L::C;
  static_assert(NK == kWgRows && DT == 8, "one warpgroup of 64 keys, 64 head columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1024-byte boundary, as an offset into smem_raw (shared-memory
  // loads and stores, not generic ones)
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* sPart = reinterpret_cast<float*>(sm + L::off_part);  // [warp][query]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::off_bars);  // K; Q and G; V

  const int nchunks = (Lq + C - 1) / C;
  const int t = threadIdx.x;
  const int w = t >> 5;
  const int lane = t & 31;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int key[2] = {16 * w + gr, 16 * w + gr + 8};

  // the copies of a (batch, head) item (thread 0): Q and G of chunk c; K
  // (which 0) or V (which 1)
  auto load_chunk = [&](int item, int c) {
    mbar_expect_tx(&bars[1], 2 * L::qg);
    for (int s = 0; s < 2; ++s) {
      tma_load_3d(sm + L::off_q + s * C * kRow, &tmq, &bars[1], 32 * s, C * c, item);
      tma_load_3d(sm + L::off_g + s * C * kRow, &tmg, &bars[1], 32 * s, C * c, item);
    }
  };
  auto load_kv = [&](int item, int which) {
    const CUtensorMap* map = which ? &tmv : &tmk;
    uint64_t* bar = &bars[which ? 2 : 0];
    mbar_expect_tx(bar, L::kv);
    for (int s = 0; s < 2; ++s)
      tma_load_3d(sm + (which ? L::off_v : L::off_k) + s * NK * kRow, map, bar, 32 * s, 0, item);
  };
  if (t == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (t == 0) {
    load_kv(blockIdx.x, 0);
    load_chunk(blockIdx.x, 0);
    load_kv(blockIdx.x, 1);
  }
  const bool dropout = rate > 0.f;
  // dV and dK of the warpgroup's keys (rows) by the head columns; past the
  // first kTmaFlush chunks their sums so far wait in dv and dk
  float dva[4 * DT], dka[4 * DT];

  // the block's (batch, head) items, blockIdx.x + n gridDim.x: an item's
  // K, V and first Q and G are copied while the last item's products run
  int qphase = 0;  // chunks of Q and G waited for so far
  for (int bh = blockIdx.x, n = 0; bh < BH; bh += gridDim.x, ++n) {
    const int b = bh / H;
    const int h = bh - b * H;
    const int next = bh + gridDim.x;
    const DropoutStream drop(seed, b, h, H, hb);
    const float* mb = mask + (size_t)b * Lm * Lk;
    // a key-only mask's values at the thread's two keys (-inf past the last)
    float mk[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh)
      mk[rh] = Lm == 1 && key[rh] < Lk ? mask[(size_t)b * Lk + key[rh]] : -CUDART_INF_F;
    auto flush = [&](bool add, bool last) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int j = key[rh];
        if (j >= Lk) continue;
        float* dkr = dk + ((size_t)bh * Lk + j) * D;
        float* dvr = dv + ((size_t)bh * Lk + j) * D;
#pragma unroll
        for (int i = 0; i < DT; ++i) {
          const int d = 8 * i + 2 * tq4;  // D is a multiple of 4: d + 1 < D
          if (d >= D) continue;
          float2 xk = make_float2(dka[4 * i + 2 * rh], dka[4 * i + 2 * rh + 1]);
          float2 xv = make_float2(dva[4 * i + 2 * rh], dva[4 * i + 2 * rh + 1]);
          if (add) {
            const float2 pk = *reinterpret_cast<const float2*>(dkr + d);
            const float2 pv = *reinterpret_cast<const float2*>(dvr + d);
            xk = make_float2(xk.x + pk.x, xk.y + pk.y);
            xv = make_float2(xv.x + pv.x, xv.y + pv.y);
          }
          if (last) xk = make_float2(xk.x * scale, xk.y * scale);
          *reinterpret_cast<float2*>(dkr + d) = xk;
          *reinterpret_cast<float2*>(dvr + d) = xv;
        }
      }
    };

    for (int c = 0; c < nchunks; ++c, ++qphase) {
      const int q0 = C * c;
      // a last chunk of at most C / 2 queries: its conversion takes half
      // the queries, one matrix a warp pair
      const bool tail = Lq - q0 <= C / 2;
      // the lse (log2 units) of the thread's queries q0 + 8 i + 2 tq4 + e
      float l2[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * i + 2 * tq4 + e;
          l2[i][e] = qi < Lq ? lse[(size_t)bh * Lq + qi] * kLog2e : 0.f;
        }
      // the descriptor of the tiles' base, made anew each chunk, and of a
      // tile at a byte offset from it
      uint64_t d0 = desc_b128(sm, 16, 1024);
      asm volatile("" : "+l"(d0));
      auto desc = [&](int off) { return d0 + (uint64_t)(off >> 4); };
      mbar_wait(&bars[1], qphase & 1);

      // 1. Q and G in one pass each: a thread takes 4 head columns (16
      // bytes) of the 4 queries that one 16-byte chunk of a Q^T or G^T row
      // holds, 8 (ch / 2) + (ch % 2) + 2 a, a = 0..3 (the k order of A from
      // the accumulators, a_from_c_tf32); their low parts go to the low-part
      // tile at the raw tile's offsets, and the raw values (the truncated high
      // part) and the same low parts to Q^T's or G^T's rows. A warp's loads
      // and stores each take the fewest wavefronts. In a tail the even
      // warps take Q and the odd ones G, the first 16 queries (the rest of
      // the low-part tiles, whatever they hold, enters only columns past Lq,
      // and no k-step of dK or dV reads the rest of Q^T or G^T).
      {
        const int ch = (t & 3) | (tail ? 0 : (w & 1) << 2);
        const int dg = (lane >> 2) | ((w >> 1) << 3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (tail && m != (w & 1)) continue;
          unsigned char* raw = sm + (m ? L::off_g : L::off_q);
          unsigned char* low = sm + (m ? L::off_g_lo : L::off_q_lo);
          unsigned char* thi = sm + (m ? L::off_gt_hi : L::off_qt_hi);
          unsigned char* tlo = sm + (m ? L::off_gt_lo : L::off_qt_lo);
          uint4 x[4], l[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int q = 8 * (ch >> 1) + (ch & 1) + 2 * a;
            const int at = (dg >> 3) * (C * kRow) + q * kRow + (((dg & 7) ^ (q & 7)) << 4);
            x[a] = *reinterpret_cast<const uint4*>(raw + at);
            l[a] = make_uint4(tf32_lo_of_raw(__uint_as_float(x[a].x)),
                              tf32_lo_of_raw(__uint_as_float(x[a].y)),
                              tf32_lo_of_raw(__uint_as_float(x[a].z)),
                              tf32_lo_of_raw(__uint_as_float(x[a].w)));
            *reinterpret_cast<uint4*>(low + at) = l[a];
          }
          auto col = [](const uint4 (&v)[4], int j) {
            return j == 0   ? make_uint4(v[0].x, v[1].x, v[2].x, v[3].x)
                   : j == 1 ? make_uint4(v[0].y, v[1].y, v[2].y, v[3].y)
                   : j == 2 ? make_uint4(v[0].z, v[1].z, v[2].z, v[3].z)
                            : make_uint4(v[0].w, v[1].w, v[2].w, v[3].w);
          };
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 4 * dg + j;
            const int at = d * kRow + ((ch ^ (d & 7)) << 4);
            *reinterpret_cast<uint4*>(thi + at) = col(x, j);
            *reinterpret_cast<uint4*>(tlo + at) = col(l, j);
          }
        }
      }
      fence_async_shared();
      __syncthreads();

      // 2. S^T = K Q^T and dP^T = V G^T: the warpgroup's 64 keys by the
      // chunk's 32 queries, D / 8 k-steps, A (K, V) from registers, split as
      // they load; one chain and then the other (fewer live registers)
      float s[16], dp[16];
      auto chain = [&](float (&acc)[16], int raw, int bhi, int blo) {
        FragA a[DT];
#pragma unroll
        for (int kk = 0; kk < DT; ++kk)
          a[kk] = load_a_sw<false>(sm + raw, NK, 16 * w, 8 * kk, lane);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DT; ++kk) {
          const int bt = (kk / 4) * (C * kRow) + (kk % 4) * 32;
          wgmma_rs_3xtf32<C>(acc, a[kk], desc(bhi + bt), desc(blo + bt), kk > 0);
        }
        wgmma_commit();
        wgmma_wait();
      };
      if (c == 0) mbar_wait(&bars[0], n & 1);  // this item's K
      chain(s, L::off_k, L::off_q, L::off_q_lo);
      if (c == 0) mbar_wait(&bars[2], n & 1);  // and V
      chain(dp, L::off_v, L::off_g, L::off_g_lo);
      fence_regs(s);
      fence_regs(dp);

      // 3. s <- P, dp <- P * dP * keep, and the keep bits; without branches
      // (P is 0 outside the keys and queries), the keep hash only with
      // dropout
      uint32_t kept = 0;
      auto probs = [&](auto with_dropout) {
        constexpr bool DROP = decltype(with_dropout)::value;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const int qi = q0 + 8 * i + 2 * tq4 + (c4 & 1), kj = key[c4 >> 1];
            const bool in = kj < Lk && qi < Lq;
            const float mv = Lm == 1 ? mk[c4 >> 1] : (in ? mb[(size_t)qi * Lk + kj] : 0.f);
            // in log2 units, rounded as the forward kernel rounds it
            const float sc = (s[4 * i + c4] * scale + mv) * kLog2e;
            const float p = in ? exp2f(sc - l2[i][c4 & 1]) : 0.f;
            bool keep = true;
            if constexpr (DROP) keep = drop.keep(qi, kj, rate, keep_scale) != 0.f;
            // (columns past Lq take no product: a tail leaves low parts
            // unconverted there)
            const float pdp = keep && in
                ? p * (DROP ? dp[4 * i + c4] * keep_scale : dp[4 * i + c4]) : 0.f;
            kept |= (uint32_t)keep << (4 * i + c4);
            s[4 * i + c4] = p;
            dp[4 * i + c4] = pdp;
          }
        }
      };
      if (dropout) probs(std::true_type{});
      else probs(std::false_type{});

      // 4. delta of each of the chunk's queries: each warp's sum over its
      // keys (the lane's two rows, then the eight lanes of a column), then,
      // after a barrier, the warps' parts in a fixed order (the mma.sync
      // design's); the lanes trade them
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = dp[4 * i + e] + dp[4 * i + 2 + e];
          x += __shfl_xor_sync(0xffffffffu, x, 4);
          x += __shfl_xor_sync(0xffffffffu, x, 8);
          x += __shfl_xor_sync(0xffffffffu, x, 16);
          if (gr == 0) sPart[w * C + 8 * i + 2 * tq4 + e] = x;
        }
      }
      __syncthreads();  // every warp's part; every warp's S^T and dP^T done
      // the next chunk's Q and G into the raw tiles, or the next item's first
      // and its V, in flight while this chunk's products run
      if (t == 0) {
        if (c + 1 < nchunks) {
          load_chunk(bh, c + 1);
        } else if (next < BH) {
          load_chunk(next, 0);
          load_kv(next, 1);
        }
      }
      float mine[2] = {0.f, 0.f};
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) {
        const float2 x = *reinterpret_cast<const float2*>(&sPart[ww * C + 8 * (gr & 3) + 2 * tq4]);
        mine[0] += x.x;
        mine[1] += x.y;
      }

      // 5. dS = P * (dP * keep - delta) and P * keep as the A operands of dK's
      // and dV's k-steps (the accumulators as they lie), in TF32 hi + lo; dS
      // into its tiles, rows of queries (in the low parts' place)
      FragA pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) dl[e] = __shfl_sync(0xffffffffu, mine[e], 4 * i + tq4);
        float pv[4], ds[4];
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float p = s[4 * i + c4];
          ds[c4] = dp[4 * i + c4] - p * dl[c4 & 1];
          const bool keep = (kept >> (4 * i + c4)) & 1u;
          pv[c4] = keep ? (dropout ? p * keep_scale : p) : 0.f;
        }
        pa[i] = a_from_c_tf32(pv);
        da[i] = a_from_c_tf32(ds);
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int at = sw32(8 * i + 2 * tq4 + (c4 & 1), key[c4 >> 1], C);
          const int e = 2 * (c4 & 1) + (c4 >> 1);  // a_from_c_tf32's place of element c4
          *reinterpret_cast<uint32_t*>(sm + L::off_ds_hi + at) = da[i].hi[e];
          *reinterpret_cast<uint32_t*>(sm + L::off_ds_lo + at) = da[i].lo[e];
        }
      }

      // 6. dV += (P * keep)^T G and dK += dS^T Q over the k-steps that hold
      // queries (the first always does): A from registers, B G^T's and Q^T's
      // tiles; a chain's first product takes scale-d 0 at the start of each
      // run of kTmaFlush chunks
      const bool fresh = c % kTmaFlush == 0;
      fence_regs(dva);
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (q0 + 8 * i < Lq) {
          const int go = !(fresh && i == 0);
          wgmma_rs_3xtf32<8 * DT>(dva, pa[i], desc(L::off_gt_hi + 32 * i),
                                  desc(L::off_gt_lo + 32 * i), go);
          wgmma_rs_3xtf32<8 * DT>(dka, da[i], desc(L::off_qt_hi + 32 * i),
                                  desc(L::off_qt_lo + 32 * i), go);
        }
      }
      wgmma_commit();
      fence_async_shared();
      __syncthreads();  // every warp's dS in its tiles
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
      // a run of kTmaFlush chunks' sums into dv and dk (the first run's
      // stored, the later ones' added), then fresh sums (kFlush)
      if ((c + 1) % kTmaFlush == 0 && c + 1 < nchunks) flush(c + 1 > kTmaFlush, false);

      // 7. dQ^T = K^T dS^T for the chunk's queries over the keys: A K^T from
      // registers (the K tile read across, split as it loads), B dS's tiles
      // (both zero past Lk), the k-steps of 16-key groups that hold keys: a
      // whole chain of each length, picked by Lk (a branch inside the chain
      // around a register-A product made ptxas serialise every product of
      // the kernel, C7512)
      float dqa[C / 2];
      auto dq_chain = [&](auto steps) {
        constexpr int NKS = decltype(steps)::value;
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < NKS; ++ks) {
          const FragA a = load_a_sw<true>(sm + L::off_k, NK, 16 * w, 8 * ks, lane);
          const int bt = (ks / 4) * (C * kRow) + (ks % 4) * 32;
          wgmma_rs_3xtf32<C>(dqa, a, desc(L::off_ds_hi + bt), desc(L::off_ds_lo + bt), ks > 0);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(dqa);
      };
      if (Lk <= 16) dq_chain(std::integral_constant<int, 2>{});
      else if (Lk <= 32) dq_chain(std::integral_constant<int, 4>{});
      else if (Lk <= 48) dq_chain(std::integral_constant<int, 6>{});
      else dq_chain(std::integral_constant<int, 8>{});
      // dQ (times scale) of the thread's head columns and queries
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const int d = 16 * w + gr + 8 * (c4 >> 1);
          const int qi = q0 + 8 * i + 2 * tq4 + (c4 & 1);
          if (d < D && qi < Lq) dq[((size_t)bh * Lq + qi) * D + d] = dqa[4 * i + c4] * scale;
        }
      }
      // every warp is done with this chunk's tiles
      __syncthreads();
    }

    // the next item's K, once every warp's dQ^T has read this one's
    if (t == 0 && next < BH) load_kv(next, 0);
    // dK (times scale) and dV of the thread's keys, with the sums that wait
    // in dk and dv past kTmaFlush chunks
    flush(nchunks > kTmaFlush, true);
  }
}

template <int NK, int DT>
int launch_tf32_tma_dt(const void* q, const void* k, const void* v, const void* mask,
                       const void* g, const void* lse, void* dq, void* dk, void* dv, int B, int H,
                       int Lq, int Lk, int D, int Lm, float scale, float rate, float keep_scale,
                       int seed, int hb, cudaStream_t stream) {
  // TMA takes 16-byte aligned tensors
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)g | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv) %
          16 !=
      0)
    return (int)cudaErrorMisalignedAddress;
  const void* fn = (const void*)attention_bwd_wgmma_tf32_tma_kernel<NK, DT>;
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return (int)err;
  using hopper::tensor_map_f32;
  CUtensorMap tq, tk, tv, tg;
  const int BH = B * H;
  if ((err = tensor_map_f32(&tq, q, BH, Lq, D, kTmaChunk)) != cudaSuccess ||
      (err = tensor_map_f32(&tk, k, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map_f32(&tv, v, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map_f32(&tg, g, BH, Lq, D, kTmaChunk)) != cudaSuccess)
    return (int)err;
  // persistent blocks, as many as the SMs hold, each over an equal share of
  // the items
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 128, TmaLayout::bytes)) !=
          cudaSuccess)
    return (int)err;
  const int cap = per_sm * sms > 0 ? per_sm * sms : 1;
  const int per_block = (BH + cap - 1) / cap;
  const int grid = (BH + per_block - 1) / per_block;
  attention_bwd_wgmma_tf32_tma_kernel<NK, DT><<<grid, 128, TmaLayout::bytes, stream>>>(
      tq, tk, tv, tg, static_cast<const float*>(mask), static_cast<const float*>(lse),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), BH, H, Lq, Lk,
      D, Lm, scale, rate, keep_scale, (uint32_t)seed, hb);
  return (int)cudaGetLastError();
}

}  // namespace

// The design a launch takes: 0 the mma.sync instance over one key tile
// (fp32 and bf16 where no wgmma design takes it), 1 the mma.sync instance
// over several key tiles (Lk above kMaxKeyTile: delta from g . out, dq
// summed in the dq_acc scratch), 2 the wgmma design (bf16 in either mode
// with Lk <= kWgKeys and D a multiple of 8, which TMA's 16-byte row strides
// need), 3 the TF32 wgmma design (fp32 where tf32_takes: every flagship
// shape but vision's D 64), 4 the TF32 TMA design (fp32 where
// tf32_tma_takes: vision's D 64); -1 on bad input.
extern "C" int attention_bwd_design(int dtype, int round_p, int Lk, int D) {
  if (Lk < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1)) return -1;
  if (Lk > kMaxKeyTile) return 1;
  if (dtype == 1) return Lk <= kWgKeys && D % 8 == 0 ? 2 : 0;
  return tf32_takes(Lk, D) ? 3 : tf32_tma_takes(Lk, D) ? 4 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/g/o/dq
// [B,H,Lq,D], k/v/dk/dv [B,H,Lk,D] in that dtype (o the forward's output),
// mask [B,1,Lm,Lk] float32 with Lm in {1, Lq}, lse float32 [B,H,Lq] from the
// forward kernel, dq_acc a float32 scratch of B*H*Lq*D when Lk exceeds
// attention_bwd_key_tile(Lq, Lk, D, dtype), else ignored (may be null).
// keep_scale is the fp32 1 / (1 - rate), keep_rcp the fp32
// 1 / bf16(1 - rate); round_p (bf16 only: in fp32 the two modes are one
// function) takes the VJP of the JAX default path. The wgmma designs
// (attention_bwd_design) take 16-byte aligned q, k, v, g, dq, dk and dv,
// and neither o nor dq_acc. Returns the CUDA error code of the launch
// (0 = launched).
extern "C" int attention_bwd(const void* q, const void* k, const void* v,
                             const void* mask, const void* g, const void* o,
                             const void* lse, void* dq, void* dk, void* dv,
                             void* dq_acc, int dtype, int B, int H, int Lq,
                             int Lk, int D, int Lm, float scale, float rate,
                             float keep_scale, float keep_rcp, int seed, int hb,
                             int round_p, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int design = attention_bwd_design(dtype, round_p, Lk, D);
  if (design == 2)
    return launch_wgmma(q, k, v, mask, g, lse, dq, dk, dv, B, H, Lq, Lk, D, Lm, scale, rate,
                        keep_scale, keep_rcp, seed, hb, round_p, s);
  if (design == 3)
    return launch_tf32(q, k, v, mask, g, lse, dq, dk, dv, B, H, Lq, Lk, D, Lm, scale, rate,
                       keep_scale, seed, hb, s);
  if (design == 4)
    return launch_tf32_tma_dt<kWgRows, 8>(q, k, v, mask, g, lse, dq, dk, dv, B, H, Lq, Lk, D,
                                          Lm, scale, rate, keep_scale, seed, hb, s);
  if (dtype == 0)
    return launch<float, false>(q, k, v, mask, g, o, lse, dq, dk, dv, dq_acc, B, H, Lq,
                                Lk, D, Lm, scale, rate, keep_scale, keep_rcp, seed, hb,
                                s);
  if (dtype == 1 && round_p)
    return launch<__nv_bfloat16, true>(q, k, v, mask, g, o, lse, dq, dk, dv, dq_acc, B,
                                       H, Lq, Lk, D, Lm, scale, rate, keep_scale,
                                       keep_rcp, seed, hb, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(q, k, v, mask, g, o, lse, dq, dk, dv, dq_acc, B,
                                        H, Lq, Lk, D, Lm, scale, rate, keep_scale,
                                        keep_rcp, seed, hb, s);
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
  const void* fn =
      dtype == 0 ? kernel_for<float, false>(D) : kernel_for<__nv_bfloat16, false>(D);
  const int W = attention_bwd_key_tile(Lq, Lk, D, dtype) / 16;
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 32 * W, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Bytes of dynamic shared memory one block of the wgmma design takes at
// (Lq, Lk, D) in the mode round_p (0 where the design takes no such launch).
extern "C" int attention_bwd_wgmma_smem(int Lq, int Lk, int D, int round_p) {
  if (Lq < 1 || attention_bwd_design(1, round_p, Lk, D) != 2) return 0;
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return round_p ? (int)WgLayout<I::NK, I::DT, true>::bytes
                   : (int)WgLayout<I::NK, I::DT, false>::bytes;
  });
}

// Blocks of the wgmma design at (Lq, Lk, D) in the mode round_p that one
// SM holds at once, as the CUDA occupancy calculator gives them from the
// kernel's registers, threads and shared memory; a negative CUDA error code
// on failure.
extern "C" int attention_bwd_wgmma_blocks_per_sm(int Lq, int Lk, int D, int round_p) {
  if (Lq < 1 || attention_bwd_design(1, round_p, Lk, D) != 2)
    return -(int)cudaErrorInvalidValue;
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    const void* fn = round_p ? (const void*)attention_bwd_wgmma_kernel<I::NK, I::DT, true>
                             : (const void*)attention_bwd_wgmma_kernel<I::NK, I::DT, false>;
    cudaError_t err = raise_smem_limit(fn);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 2 * I::NK,
                                                        attention_bwd_wgmma_smem(Lq, Lk, D, round_p));
    return err == cudaSuccess ? blocks : -(int)err;
  });
}

// Bytes of dynamic shared memory one block of the TF32 wgmma design takes
// at (Lq, Lk, D) (0 where the design takes no such launch).
extern "C" int attention_bwd_tf32_smem(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_bwd_design(0, 0, Lk, D) != 3) return 0;
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return (int)TfLayout<I::NK, I::DT>::bytes;
  });
}

// Blocks of the TF32 wgmma design at (Lq, Lk, D) that one SM holds at
// once, as the CUDA occupancy calculator gives them from the kernel's
// registers, threads and shared memory; a negative CUDA error code on
// failure.
extern "C" int attention_bwd_tf32_blocks_per_sm(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_bwd_design(0, 0, Lk, D) != 3) return -(int)cudaErrorInvalidValue;
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    const void* fn = (const void*)attention_bwd_wgmma_tf32_kernel<I::NK, I::DT>;
    cudaError_t err = raise_smem_limit(fn);
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 2 * I::NK,
                                                        TfLayout<I::NK, I::DT>::bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}

// Bytes of dynamic shared memory one block of the TF32 TMA design takes at
// (Lq, Lk, D) (0 where the design takes no such launch).
extern "C" int attention_bwd_tf32_tma_smem(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_bwd_design(0, 0, Lk, D) != 4) return 0;
  return (int)TmaLayout::bytes;
}

// Blocks of the TF32 TMA design at (Lq, Lk, D) that one SM holds at once,
// as the CUDA occupancy calculator gives them from the kernel's registers,
// threads and shared memory; a negative CUDA error code on failure.
extern "C" int attention_bwd_tf32_tma_blocks_per_sm(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_bwd_design(0, 0, Lk, D) != 4) return -(int)cudaErrorInvalidValue;
  const void* fn = (const void*)attention_bwd_wgmma_tf32_tma_kernel<kWgRows, 8>;
  cudaError_t err = raise_smem_limit(fn);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 128, TmaLayout::bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
