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
// Four designs; attention_fwd picks one by dtype, mode and shape alone
// (attention_fwd_design), and a launch that fails raises, never falls back.
//
// The wgmma design (bf16 with Lk <= 128 and D a multiple of 8, in both
// modes: every bf16 train, eval and serve step at the flagship shapes): the
// whole key row in one pass, as the TPU kernel's softmax (_probs) takes
// it. A block of one or two warpgroups takes 64 query rows each of one
// (batch, head). Thread 0 has TMA copy Q of the block, K and V of the
// (batch, head) into shared memory (3-D tensor maps over [B*H, L, D],
// boxes of 64 columns in the 128-byte swizzle that wgmma reads; rows and
// columns outside the tensor arrive as zeros: D = 48 fills 96 of a row's
// 128 bytes) on two mbarriers, Q and K on one and V on the other, so V
// lands while the scores are taken. The key-only mask row is staged once a
// block. Each warpgroup then takes S = Q K^T for all keys (padded to NK =
// 64 or 128) as one chain of D/16 wgmma m64nNKk16 from shared memory into
// registers, the rows' exact max and sum from the accumulators (quad
// shuffles) and P = exp2(s - m) / sum, normalised in fp32. With round_p P
// is rounded to bf16 and the kept ones divided in bf16 by bf16(1 - rate),
// and packed to bf16 A fragments as the accumulators lie; O = P V is one
// chain of wgmma m64nDk16 with A from registers and V as an MN-major
// operand. In -pallas mode (no round_p) P times the fp32 keep multiplier
// 1 / (1 - rate) is split into bf16 hi + lo (about 16 significant bits, as
// the mma.sync instance splits it), packed the same way, and O = P_lo V +
// P_hi V is one chain of two register-A products a k-step into the same
// accumulators. So Q K^T, the mask and exp2 are each taken once. O goes
// through the warpgroup's Q tile (swizzled, conflict-free) to a TMA store
// that clips the rows past Lq and the columns past D. Registers: S 64 fp32
// a thread at NK 128, packed P 32 (-pallas 64, as S is consumed), O D/2;
// two blocks of 8 warps an SM (one of 8 at D > 64).
//
// The TF32 wgmma design (fp32 with Lk <= 128, D a multiple of 4 and at
// most 64: every fp32 serve, eval and ingest step at the flagship shapes)
// takes the wgmma design's one pass over the key row on TF32 wgmma
// (m64nNk8) with fp32 accuracy: both products in 3xTF32, A_hi B_hi + A_hi
// B_lo + A_lo B_hi, hi = tf32(x) and lo = tf32(x - hi) (the hardware reads
// a TF32 operand's top 19 bits, so hi is stored rounded). A block is one
// warpgroup and 64 query rows of one (batch, head); the query tiles of a
// (batch, head) are neighbouring blocks, so that the second reads K and V
// from L2. Q is the register A operand of S = Q K^T, split in registers as
// it loads. TF32 takes B from shared memory, K-major only: the threads load
// K in its own [Lk, D] layout (K-major for this product) and write its hi
// and lo tiles swizzled; once S is done, V^T's hi and lo tiles take K's
// place (K-major for O = P V), each row's keys in the order of the
// register A operand's k positions (the accumulators hold columns 2 tq and
// 2 tq + 1, the A fragment takes k positions tq and tq + 4), so that P
// serves as A where the accumulators lie: no shuffle and no shared-memory
// round trip. The rows' exact max and sum come from the accumulators (quad
// shuffles); P = exp2(s - m) / sum times the fp32 keep multiplier is split
// into hi and lo two k-steps at a time, just before their products (S dies
// as it is consumed; the whole split P would take 128 registers at 128
// keys), and O and the log-sum-exp go out from the registers. One tile for
// K and then V^T keeps a block at 17.25-66.5 KB (49.5 at the text shape),
// so that registers set the blocks an SM: three or four at the flagship
// shapes (the budget in PERF.md).
//
// The mma.sync designs (everything else: fp32 past 128 keys or at other
// head widths, and bf16 past 128 keys or with D not a multiple of 8): a
// block of W <= 8 warps takes 16 W query
// rows of one (batch, head), each warp a 16-row slab. Q of the block and one tile of up to 128
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
// round_p in the mma.sync design: the online softmax multiplies the
// unnormalised exp(s - m) into V and divides at the end, but the JAX path
// rounds the normalised P. So that instance takes two passes over the key
// tiles, the first for the rows' max and sum only (S = Q K^T, no V), the
// second for P = exp(s - m) / sum, rounded, and O += P V in one bf16
// product (no low part).

#include "attention_common.cuh"
#include "hopper.cuh"

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

// raise the kernel's shared-memory limit once on each device (the limit is
// a device's) to the most any launch may take (every launch stays within
// kMaxSmem)
template <auto kernel>
cudaError_t raise_smem_limit() {
  static unsigned long long raised = 0;  // bit d: raised on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (raised & (1ull << dev)))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 64) raised |= 1ull << dev;
  return err;
}

template <typename T, int DT, bool ROUND>
int launch_dt(const T* q, const T* k, const T* v, const float* mask, T* out,
              float* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
              float rate, float keep_scale, float keep_rcp, int seed, int hb,
              cudaStream_t stream) {
  const int W = warps_for(Lq);
  const int bk = key_tile(Lk);
  const size_t smem = smem_bytes<T>(W, bk, D);
  const cudaError_t err = raise_smem_limit<attention_fwd_kernel<T, DT, ROUND>>();
  if (err != cudaSuccess) return (int)err;
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

// ---- the wgmma design (see the head of the file) ---------------------------

constexpr int kWgRows = 64;     // query rows of a warpgroup's tile
constexpr int kWgKeys = 128;    // keys the design takes, at most
constexpr int kRow = 128;       // bytes of a swizzled row: 64 bf16

// Shared memory of a block of nwg warpgroups at NK keys and 8 DT head
// columns, from a 1024-byte boundary: Q (then O) of each warpgroup, K, V
// (each in 64-column slabs of whole 8-row atoms), the mask row, the two
// mbarriers.
template <int NK, int DT>
struct WgLayout {
  static constexpr int slabs = DT > 8 ? 2 : 1;
  static constexpr int q_tile = slabs * kWgRows * kRow;
  static constexpr int kv = slabs * NK * kRow;
  static size_t bytes(int nwg) {
    return 1024 + (size_t)nwg * q_tile + 2 * kv + NK * sizeof(float) + 2 * sizeof(uint64_t);
  }
};

template <int NK, int DT, bool ROUND>
__global__ void __launch_bounds__(256, DT > 8 ? 1 : 2)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const float* __restrict__ mask, float* __restrict__ lse, int H,
                           int Lq, int Lk, int Lm, float scale, float rate, float keep_scale,
                           float keep_rcp, uint32_t seed, int hb) {
  using namespace hopper;
  using L = WgLayout<NK, DT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int nwg = blockDim.x >> 7;
  unsigned char* sK = sQ + nwg * L::q_tile;
  unsigned char* sV = sK + L::kv;
  float* sMask = reinterpret_cast<float*>(sV + L::kv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sMask + NK);  // Q and K; V

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * nwg * kWgRows;
  const int tiles = min(nwg, (Lq - q0 + kWgRows - 1) / kWgRows);  // tiles with rows
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], tiles * L::q_tile + L::kv);
    for (int w = 0; w < tiles; ++w)
      for (int s = 0; s < L::slabs; ++s)
        tma_load_3d(sQ + w * L::q_tile + s * kWgRows * kRow, &tq, &bars[0], 64 * s,
                    q0 + kWgRows * w, bh);
    for (int s = 0; s < L::slabs; ++s)
      tma_load_3d(sK + s * NK * kRow, &tk, &bars[0], 64 * s, 0, bh);
    mbar_expect_tx(&bars[1], L::kv);
    for (int s = 0; s < L::slabs; ++s)
      tma_load_3d(sV + s * NK * kRow, &tv, &bars[1], 64 * s, 0, bh);
  }
  // the key-only mask row, -inf past the last key
  if (Lm == 1)
    for (int j = threadIdx.x; j < NK; j += blockDim.x)
      sMask[j] = j < Lk ? mask[(size_t)b * Lk + j] : -CUDART_INF_F;
  __syncthreads();
  if (wg >= tiles) return;

  const int t = threadIdx.x & 127;
  const int lane = t & 31;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int rl = 16 * (t >> 5) + gr;          // the thread's rows rl, rl + 8 of the tile
  const int row[2] = {q0 + kWgRows * wg + rl, q0 + kWgRows * wg + rl + 8};
  unsigned char* tQ = sQ + wg * L::q_tile;

  // S = Q K^T over every key, D / 16 k-steps along the swizzled rows
  float s[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  mbar_wait(&bars[0], 0);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DT / 2; ++kk) {
    const int at = (kk / 4) * kWgRows * kRow + (kk % 4) * 32;
    const uint64_t da = desc_b128(tQ + at, 16, 1024);
    const uint64_t db = desc_b128(sK + (kk / 4) * NK * kRow + (kk % 4) * 32, 16, 1024);
    if constexpr (NK == 64) wgmma_ss_n64(s, da, db, 1);
    else wgmma_ss_n128(s, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);

  // scores in log2 units and the rows' exact max
  const float* mrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    mrow[i] = mask + ((size_t)b * Lm + (Lm == 1 ? 0 : min(row[i], Lq - 1))) * Lk;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * i + 2 * tq4 + (c & 1);
      const float mv = Lm == 1 ? sMask[j] : (j < Lk ? mrow[c >> 1][j] : -CUDART_INF_F);
      s[4 * i + c] = (s[4 * i + c] * scale + mv) * kLog2e;
      m[c >> 1] = fmaxf(m[c >> 1], s[4 * i + c]);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }

  // P normalised; ROUND: rounded to bf16, the kept ones divided in bf16 by
  // bf16(1 - rate); -pallas: times the fp32 keep multiplier and split into
  // bf16 hi (pa) + lo (pl). Packed as the A fragments of P V's k-steps.
  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;
  uint32_t pa[NK / 16][4];
  uint32_t pl[ROUND ? 1 : NK / 16][4];
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 2 * kk + (r >> 1);
      const int c = 2 * (r & 1);
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * i + 2 * tq4 + e;
        if constexpr (ROUND) {
          p[e] = round_bf16(s[4 * i + c + e] * inv[r & 1]);
          if (dropout)
            p[e] = drop.keep(row[r & 1], j, rate, keep_scale) != 0.f ? round_bf16(p[e] * keep_rcp)
                                                                     : 0.f;
        } else {
          p[e] = s[4 * i + c + e] * inv[r & 1];
          if (dropout) p[e] *= drop.keep(row[r & 1], j, rate, keep_scale);
        }
      }
      if constexpr (ROUND) pa[kk][r] = pack_bf16(p[0], p[1]);
      else split_bf16(p[0], p[1], pa[kk][r], pl[kk][r]);
    }
  }

  // O = P V: the k-steps that hold keys, V MN-major (its rows are keys);
  // -pallas: the low part's product first
  float o[4 * DT];
#pragma unroll
  for (int i = 0; i < 4 * DT; ++i) o[i] = 0.f;
  mbar_wait(&bars[1], 0);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    if (16 * kk < Lk) {
      const uint64_t db = desc_b128(sV + kk * 16 * kRow, NK * kRow, 1024);
      if constexpr (!ROUND) wgmma_rs<DT>(o, pl[kk], db, 1);
      wgmma_rs<DT>(o, pa[kk], db, 1);
    }
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(o);

  // O in bf16 into the warpgroup's Q tile (every warp's S has read it),
  // swizzled as the TMA store reads it, then stored
  named_barrier(1 + wg, 128);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = rl + 8 * e;
      unsigned char* at = tQ + (dt / 8) * kWgRows * kRow + r * kRow +
                          (((dt % 8) ^ (r & 7)) * 16) + 4 * tq4;
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * dt + 2 * e], o[4 * dt + 2 * e + 1]);
    }
  }
  fence_async_shared();
  named_barrier(1 + wg, 128);
  if (t == 0) {
    for (int sl = 0; sl < L::slabs; ++sl)
      tma_store_3d(&to, tQ + sl * kWgRows * kRow, 64 * sl, q0 + kWgRows * wg, bh);
    tma_store_wait();
  }
  if (lse != nullptr && tq4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < Lq) lse[(size_t)bh * Lq + row[i]] = (m[i] + log2f(l[i])) * kLn2;
  }
}

// warpgroups a block of the wgmma design takes for Lq query rows
int wg_count(int Lq) { return Lq > kWgRows ? 2 : 1; }

template <int NK, int DT, bool ROUND>
int launch_wgmma_dt(const void* q, const void* k, const void* v, const float* mask, void* out,
                    float* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
                    float rate, float keep_scale, float keep_rcp, int seed, int hb,
                    cudaStream_t stream) {
  // TMA takes 16-byte aligned tensors
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaError_t err = raise_smem_limit<attention_fwd_wgmma_kernel<NK, DT, ROUND>>();
  if (err != cudaSuccess) return (int)err;
  using hopper::tensor_map;
  CUtensorMap tq, tk, tv, to;
  const int BH = B * H;
  if ((err = tensor_map(&tq, q, BH, Lq, D, kWgRows)) != cudaSuccess ||
      (err = tensor_map(&tk, k, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map(&tv, v, BH, Lk, D, NK)) != cudaSuccess ||
      (err = tensor_map(&to, out, BH, Lq, D, kWgRows)) != cudaSuccess)
    return (int)err;
  const int nwg = wg_count(Lq);
  const dim3 grid(BH, (Lq + nwg * kWgRows - 1) / (nwg * kWgRows));
  attention_fwd_wgmma_kernel<NK, DT, ROUND>
      <<<grid, 128 * nwg, WgLayout<NK, DT>::bytes(nwg), stream>>>(
          tq, tk, tv, to, mask, lse, H, Lq, Lk, Lm, scale, rate, keep_scale, keep_rcp,
          (uint32_t)seed, hb);
  return (int)cudaGetLastError();
}

template <int NK_, int DT_>
struct WgInstance {
  static constexpr int NK = NK_, DT = DT_;
};

// f(WgInstance<NK, DT>{}) for the wgmma instance of (Lk, D): the keys
// padded to NK = 64 or 128, the head columns to 8 DT
template <typename F>
int with_wgmma_instance(int Lk, int D, F&& f) {
  const bool wide = Lk > 64;
  switch (head_tiles(D)) {
    case 4: return wide ? f(WgInstance<128, 4>{}) : f(WgInstance<64, 4>{});
    case 6: return wide ? f(WgInstance<128, 6>{}) : f(WgInstance<64, 6>{});
    case 8: return wide ? f(WgInstance<128, 8>{}) : f(WgInstance<64, 8>{});
    default: return wide ? f(WgInstance<128, 16>{}) : f(WgInstance<64, 16>{});
  }
}

int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* out,
                 void* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
                 float rate, float keep_scale, float keep_rcp, int seed, int hb, int round_p,
                 cudaStream_t stream) {
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    const float* m = static_cast<const float*>(mask);
    float* l = static_cast<float*>(lse);
    if (round_p)
      return launch_wgmma_dt<I::NK, I::DT, true>(q, k, v, m, out, l, B, H, Lq, Lk, D, Lm,
                                                 scale, rate, keep_scale, keep_rcp, seed, hb,
                                                 stream);
    return launch_wgmma_dt<I::NK, I::DT, false>(q, k, v, m, out, l, B, H, Lq, Lk, D, Lm, scale,
                                                rate, keep_scale, keep_rcp, seed, hb, stream);
  });
}

// ---- the TF32 wgmma design (fp32; see the head of the file) -----------------

// Shared memory of a block at NK keys and Dp = 8 DT head columns, by offset
// from a 1024-byte boundary: K in TF32 hi and lo, the B operand of S = Q
// K^T (K-major: rows of keys; 32 head columns a 128-byte swizzled slab, the
// 16 past the last whole slab at Dp 48 in a 64-byte swizzled one, which
// saves a quarter of the tile), then, in K's place once S has read K, V^T
// in TF32 hi and lo, the B operand of O = P V (K-major: rows of head
// columns, 32 keys a 128-byte swizzled slab, in the order of the register A
// operand's k positions); the key-only mask row.
template <int NK, int DT>
struct TfLayout {
  static constexpr int Dp = 8 * DT;
  static constexpr int full = Dp / 32;          // K's 128-byte slabs
  static constexpr bool half = Dp % 32 != 0;    // and a 64-byte one
  static constexpr int k_tile = NK * (kRow * full + (half ? 64 : 0));
  static constexpr int vt_slab = Dp * kRow;
  static constexpr int vt_tile = NK / 32 * vt_slab;
  static constexpr int off_k_hi = 0, off_k_lo = k_tile, off_vt_hi = 0, off_vt_lo = vt_tile,
                       off_mask = 2 * k_tile, end = off_mask + NK * 4;
  static constexpr size_t bytes = 1024 + end;
  static_assert(vt_tile == k_tile && Dp % 16 == 0 && Dp <= 64 && k_tile % 1024 == 0 &&
                    vt_slab % 1024 == 0,
                "V^T fills K's place; the slabs start on the swizzles' boundaries");
};

// byte offset in K's tile of the 16-byte chunk c (head columns 4 c .. 4 c +
// 3) of key row j
template <int NK, int DT>
__device__ __forceinline__ int k_chunk(int j, int c) {
  using L = TfLayout<NK, DT>;
  return c < 8 * L::full ? (c / 8) * NK * kRow + j * kRow + (((c % 8) ^ (j & 7)) * 16)
                         : L::full * NK * kRow + j * 64 + (((c % 8) ^ ((j >> 1) & 3)) * 16);
}

// A block is one warpgroup (kTfThreads threads) and takes 64 query rows of
// one (batch, head); several blocks an SM, so that one block's loads
// overlap another's products
constexpr int kTfThreads = 128;
// k-steps of O = P V split and issued together: their fragments (8
// registers a k-step) are what O's products add to S's registers
constexpr int kTfGroup = 2;

// Blocks an SM that the registers are capped for (65,536 / (128 x blocks)
// a thread): four at 64 keys (128 registers), three at 128 (168; two at
// Dp 64, where three spilled), within what shared memory holds (1 KB
// reserved a block)
template <int NK, int DT>
constexpr int tf32_min_blocks() {
  const int regs = NK == 64 ? 4 : DT == 8 ? 2 : 3;
  const int smem = 233472 / ((int)TfLayout<NK, DT>::bytes + 1024);
  return regs < smem ? regs : smem;
}

template <int NK, int DT>
__global__ void __launch_bounds__(kTfThreads, (tf32_min_blocks<NK, DT>()))
attention_fwd_wgmma_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ mask,
                                float* __restrict__ out, float* __restrict__ lse, int H, int Lq,
                                int Lk, int D, int Lm, float scale, float rate,
                                float keep_scale, uint32_t seed, int hb) {
  using namespace hopper;
  using L = TfLayout<NK, DT>;
  constexpr int Dp = L::Dp;
  constexpr int T = kTfThreads;  // every loop's trip count is known
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the first 1024-byte boundary, as an offset into smem_raw (shared-memory
  // loads and stores, not generic ones)
  unsigned char* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  float* sMask = reinterpret_cast<float*>(sm + L::off_mask);

  // the query tiles of a (batch, head) are neighbouring blocks, so that
  // the second's K and V come from L2
  const int tiles = (Lq + kWgRows - 1) / kWgRows;
  const int bh = blockIdx.x / tiles;
  const int q0 = kWgRows * (blockIdx.x - bh * tiles);
  const int b = bh / H;
  const int h = bh - b * H;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int gr = lane >> 2, tq4 = lane & 3;
  const int rl = 16 * (t >> 5) + gr;  // the thread's rows rl, rl + 8 of the tile
  const int row[2] = {q0 + rl, q0 + rl + 8};
  const float* kh = k + (size_t)bh * Lk * D;
  const float* vh = v + (size_t)bh * Lk * D;

  // Q and K loaded first, so that their latencies overlap: Q of the
  // thread's rows in the register A operand's places of S's D / 8 k-steps,
  // a0 (gr, tq), a1 (gr + 8, tq), a2 (gr, tq + 4), a3 (gr + 8, tq + 4); K a
  // 16-byte chunk (4 head columns) at a time, neighbouring threads along a
  // key row; zeros past Lq, Lk and D
  constexpr int kc = Dp / 4;
  constexpr int kn = NK * kc / T, vn = Dp * (NK / 4) / T;
  static_assert(NK * kc % T == 0 && Dp * (NK / 4) % T == 0, "whole staging rounds");
  float qx[DT][4];
  float4 kx[kn];
  {
    const float* qr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) qr[i] = q + ((size_t)bh * Lq + min(row[i], Lq - 1)) * D;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e & 1, col = 8 * kk + tq4 + 4 * (e >> 1);
        qx[kk][e] = row[r] < Lq && col < D ? qr[r][col] : 0.f;
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kn; ++it) {
    const int i = t + it * T;
    const int j = i / kc, c = i % kc;
    kx[it] = j < Lk && 4 * c < D ? *reinterpret_cast<const float4*>(kh + (size_t)j * D + 4 * c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // V^T in TF32 hi + lo into K's place (below), once every warp's S has
  // read K
  float vx[vn][4];
  auto store_vt = [&] {
#pragma unroll
    for (int it = 0; it < vn; ++it) {
      const int i = t + it * T;
      const int d = i % Dp, ch = i / Dp;
      put_split4(sm + L::off_vt_hi, sm + L::off_vt_lo,
                 (ch / 8) * L::vt_slab + d * kRow + (((ch % 8) ^ (d & 7)) * 16), vx[it]);
    }
    fence_async_shared();
    __syncthreads();
  };

  // Q split in registers; K in TF32 hi + lo into its tiles; the key-only
  // mask row (-inf past the last key)
  FragA qa[DT];
#pragma unroll
  for (int kk = 0; kk < DT; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(qx[kk][e], qa[kk].hi[e], qa[kk].lo[e]);
#pragma unroll
  for (int it = 0; it < kn; ++it) {
    const int i = t + it * T;
    const float x[4] = {kx[it].x, kx[it].y, kx[it].z, kx[it].w};
    put_split4(sm + L::off_k_hi, sm + L::off_k_lo, k_chunk<NK, DT>(i / kc, i % kc), x);
  }
  if (Lm == 1)
    for (int j = t; j < NK; j += T)
      sMask[j] = j < Lk ? mask[(size_t)b * Lk + j] : -CUDART_INF_F;
  fence_async_shared();
  __syncthreads();

  // S = Q K^T over every key in 3xTF32, D / 8 k-steps along K's rows (the
  // last two at Dp 48 from the 64-byte swizzled slab)
  float s[NK / 2];
  const uint64_t d128 = desc_b128(sm, 16, 1024);
  const uint64_t d64 = desc_b64(sm, 512);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DT; ++kk) {
    const bool wide = kk / 4 < L::full;
    const int at = (kk / 4) * NK * kRow + (kk % 4) * 32;
    const uint64_t dk = wide ? d128 : d64;
    wgmma_rs_3xtf32<NK>(s, qa[kk], dk + ((L::off_k_hi + at) >> 4),
                        dk + ((L::off_k_lo + at) >> 4), kk > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(s);

  // V in the chunks of V^T, loaded once S is done: row d's 16-byte chunk
  // ch holds the keys 8 (ch / 2) + (ch % 2) + 2 a, a = 0..3, the k
  // positions tq of the register A operand that the accumulators' columns
  // 2 tq and 2 tq + 1 give (a_from_c_tf32); neighbouring threads along a V
  // row. V^T is stored before the softmax at 128 keys (V's and S's
  // registers together would cap the blocks an SM), after it at 64 (V's
  // loads in flight meanwhile)
#pragma unroll
  for (int it = 0; it < vn; ++it) {
    const int i = t + it * T;
    const int d = i % Dp, j0 = 8 * ((i / Dp) >> 1) + ((i / Dp) & 1);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = j0 + 2 * a;
      vx[it][a] = j < Lk && d < D ? vh[(size_t)j * D + d] : 0.f;
    }
  }
  if constexpr (NK == 128) {
    __syncthreads();
    store_vt();
  }

  // scores in log2 units and the rows' exact max, sum and P = exp2(s - m)
  // / sum, as the wgmma design takes them
  const float* mrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    mrow[i] = mask + ((size_t)b * Lm + (Lm == 1 ? 0 : min(row[i], Lq - 1))) * Lk;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < NK / 8; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 8 * i + 2 * tq4 + (c & 1);
      const float mv = Lm == 1 ? sMask[j] : (j < Lk ? mrow[c >> 1][j] : -CUDART_INF_F);
      s[4 * i + c] = (s[4 * i + c] * scale + mv) * kLog2e;
      m[c >> 1] = fmaxf(m[c >> 1], s[4 * i + c]);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]);
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) {
    s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / l[i];
  }

  if constexpr (NK == 64) {
    __syncthreads();
    store_vt();
  }

  // O = P V in 3xTF32 over the k-steps (8 keys) that hold keys, P times the
  // fp32 keep multiplier as the A operand where the accumulators lie, split
  // a group of kTfGroup k-steps at a time just before its products (so S
  // dies as it is consumed, and the group's fragments after its wait); the
  // products of the high parts in om, the small terms in os (fewer
  // truncating additions into each, see kFlush)
  const DropoutStream drop(seed, b, h, H, hb);
  const bool dropout = rate > 0.f;
  float om[4 * DT], os[4 * DT];
  const uint64_t dv = desc_b128(sm, 16, 1024);
#pragma unroll
  for (int g = 0; g < NK / 8; g += kTfGroup) {
    if (8 * g < Lk) {
      FragA pa[kTfGroup];
#pragma unroll
      for (int e = 0; e < kTfGroup; ++e) {
        const int i = g + e;
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          p[c] = s[4 * i + c] * inv[c >> 1];
          if (dropout) p[c] *= drop.keep(row[c >> 1], 8 * i + 2 * tq4 + (c & 1), rate, keep_scale);
        }
        pa[e] = a_from_c_tf32(p);
      }
      fence_regs(om);
      fence_regs(os);
      wgmma_fence();
#pragma unroll
      for (int e = 0; e < kTfGroup; ++e) {
        const int i = g + e;
        if (8 * i < Lk) {
          const int at = (i / 4) * L::vt_slab + (i % 4) * 32;
          const uint64_t bhi = dv + ((L::off_vt_hi + at) >> 4);
          const uint64_t blo = dv + ((L::off_vt_lo + at) >> 4);
          wgmma_rs_tf32<Dp>(os, pa[e].lo, bhi, i > 0);
          wgmma_rs_tf32<Dp>(os, pa[e].hi, blo, 1);
          wgmma_rs_tf32<Dp>(om, pa[e].hi, bhi, i > 0);
        }
      }
      wgmma_commit();
      wgmma_wait();
    }
  }
  fence_regs(om);
  fence_regs(os);

  // O and the rows' log-sum-exp, straight from the registers (the rows
  // past Lq and the columns past D skipped; D is a multiple of 4)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (row[e] >= Lq) continue;
    float* orow = out + ((size_t)bh * Lq + row[e]) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = 8 * dt + 2 * tq4;
      if (d < D)
        *reinterpret_cast<float2*>(orow + d) =
            make_float2(om[4 * dt + 2 * e] + os[4 * dt + 2 * e],
                        om[4 * dt + 2 * e + 1] + os[4 * dt + 2 * e + 1]);
    }
    if (lse != nullptr && tq4 == 0) lse[(size_t)bh * Lq + row[e]] = (m[e] + log2f(l[e])) * kLn2;
  }
}

template <int NK, int DT>
int launch_tf32_dt(const void* q, const void* k, const void* v, const void* mask, void* out,
                   void* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale,
                   float rate, float keep_scale, int seed, int hb, cudaStream_t stream) {
  // 16-byte loads of K, as the bf16 design's TMA needs: every tensor of the
  // design 16-byte aligned
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cudaError_t err = raise_smem_limit<attention_fwd_wgmma_tf32_kernel<NK, DT>>();
  if (err != cudaSuccess) return (int)err;
  const int blocks = B * H * ((Lq + kWgRows - 1) / kWgRows);
  attention_fwd_wgmma_tf32_kernel<NK, DT><<<blocks, kTfThreads, TfLayout<NK, DT>::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(lse), H, Lq,
      Lk, D, Lm, scale, rate, keep_scale, (uint32_t)seed, hb);
  return (int)cudaGetLastError();
}

// Whether the TF32 design takes (Lk, D): up to 128 keys, 16-byte rows (D a
// multiple of 4) and D <= 64 (Dp 32, 48 or 64)
inline bool tf32_takes(int Lk, int D) { return Lk <= kWgKeys && D % 4 == 0 && D <= 64; }

// f(WgInstance<NK, DT>{}) for the TF32 instance of (Lk, D) that tf32_takes:
// the keys padded to NK = 64 or 128, the head columns to 8 DT
template <typename F>
int with_tf32_instance(int Lk, int D, F&& f) {
  const bool wide = Lk > 64;
  switch (head_tiles(D)) {
    case 4: return wide ? f(WgInstance<128, 4>{}) : f(WgInstance<64, 4>{});
    case 6: return wide ? f(WgInstance<128, 6>{}) : f(WgInstance<64, 6>{});
    default: return wide ? f(WgInstance<128, 8>{}) : f(WgInstance<64, 8>{});
  }
}

int launch_tf32(const void* q, const void* k, const void* v, const void* mask, void* out,
                void* lse, int B, int H, int Lq, int Lk, int D, int Lm, float scale, float rate,
                float keep_scale, int seed, int hb, cudaStream_t stream) {
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return launch_tf32_dt<I::NK, I::DT>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm, scale,
                                        rate, keep_scale, seed, hb, stream);
  });
}

}  // namespace

// The design a launch takes: 0 the mma.sync one-pass online softmax (fp32
// where the TF32 design does not take it, and bf16 -pallas where the wgmma
// design does not), 1 the mma.sync two-pass rounding instance (bf16 with
// round_p where the wgmma design does not take it), 2 the wgmma design
// (bf16 in either mode with Lk <= kWgKeys and D a multiple of 8, which
// TMA's 16-byte row strides need), 3 the TF32 wgmma design (fp32 where
// tf32_takes: every flagship shape); -1 on bad input.
extern "C" int attention_fwd_design(int dtype, int round_p, int Lk, int D) {
  if (Lk < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 1 && Lk <= kWgKeys && D % 8 == 0) return 2;
  if (dtype == 0 && tf32_takes(Lk, D)) return 3;
  return dtype == 1 && round_p ? 1 : 0;
}

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous: q/out [B,H,Lq,D],
// k/v [B,H,Lk,D] in that dtype, mask [B,1,Lm,Lk] float32 with Lm in {1, Lq},
// lse float32 [B,H,Lq] or null (not written). keep_scale is the fp32
// 1 / (1 - rate), keep_rcp the fp32 1 / bf16(1 - rate); round_p (bf16
// only: in fp32 the two modes are one function) rounds P as the JAX default
// path does. The wgmma designs take 16-byte aligned q, k, v and out.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* out, void* lse, int dtype,
                             int B, int H, int Lq, int Lk, int D, int Lm,
                             float scale, float rate, float keep_scale, float keep_rcp,
                             int seed, int hb, int round_p, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lk < 1 || D < 1 || D > kMaxD || hb < 1 ||
      H % hb != 0 || (Lm != 1 && Lm != Lq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (attention_fwd_design(dtype, round_p, Lk, D)) {
    case 0:
      if (dtype == 0)
        return launch<float, false>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm, scale,
                                    rate, keep_scale, keep_rcp, seed, hb, s);
      return launch<__nv_bfloat16, false>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm,
                                          scale, rate, keep_scale, keep_rcp, seed, hb, s);
    case 1:
      return launch<__nv_bfloat16, true>(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm,
                                         scale, rate, keep_scale, keep_rcp, seed, hb, s);
    case 2:
      return launch_wgmma(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm, scale, rate,
                          keep_scale, keep_rcp, seed, hb, round_p, s);
    case 3:
      return launch_tf32(q, k, v, mask, out, lse, B, H, Lq, Lk, D, Lm, scale, rate, keep_scale,
                         seed, hb, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Bytes of dynamic shared memory one block of the wgmma design takes at
// (Lq, Lk, D) (0 where the design takes no such launch; both modes take
// the same).
extern "C" int attention_fwd_wgmma_smem(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_fwd_design(1, 1, Lk, D) != 2) return 0;
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return (int)WgLayout<I::NK, I::DT>::bytes(wg_count(Lq));
  });
}

// Blocks of the wgmma design at (Lq, Lk, D) in the mode round_p that one
// SM holds at once, as the CUDA occupancy calculator gives them from the
// kernel's registers, threads and shared memory; a negative CUDA error code
// on failure.
extern "C" int attention_fwd_wgmma_blocks_per_sm(int Lq, int Lk, int D, int round_p) {
  if (Lq < 1 || attention_fwd_design(1, round_p, Lk, D) != 2)
    return -(int)cudaErrorInvalidValue;
  return with_wgmma_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    const void* fn = round_p ? (const void*)attention_fwd_wgmma_kernel<I::NK, I::DT, true>
                             : (const void*)attention_fwd_wgmma_kernel<I::NK, I::DT, false>;
    cudaError_t err = round_p ? raise_smem_limit<attention_fwd_wgmma_kernel<I::NK, I::DT, true>>()
                              : raise_smem_limit<attention_fwd_wgmma_kernel<I::NK, I::DT, false>>();
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, 128 * wg_count(Lq),
                                                        WgLayout<I::NK, I::DT>::bytes(wg_count(Lq)));
    return err == cudaSuccess ? blocks : -(int)err;
  });
}

// Bytes of dynamic shared memory one block of the TF32 wgmma design takes
// at (Lq, Lk, D) (0 where the design takes no such launch).
extern "C" int attention_fwd_tf32_smem(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_fwd_design(0, 0, Lk, D) != 3) return 0;
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    return (int)TfLayout<I::NK, I::DT>::bytes;
  });
}

// Blocks of the TF32 wgmma design at (Lq, Lk, D) that one SM holds at
// once, as the CUDA occupancy calculator gives them from the kernel's
// registers, threads and shared memory; a negative CUDA error code on
// failure.
extern "C" int attention_fwd_tf32_blocks_per_sm(int Lq, int Lk, int D) {
  if (Lq < 1 || attention_fwd_design(0, 0, Lk, D) != 3) return -(int)cudaErrorInvalidValue;
  return with_tf32_instance(Lk, D, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t err = raise_smem_limit<attention_fwd_wgmma_tf32_kernel<I::NK, I::DT>>();
    if (err != cudaSuccess) return -(int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, attention_fwd_wgmma_tf32_kernel<I::NK, I::DT>, kTfThreads,
        TfLayout<I::NK, I::DT>::bytes);
    return err == cudaSuccess ? blocks : -(int)err;
  });
}
