// flash_bwd: flash-attention backward for Hopper (sm_90a), two kernels.
//
// Replaces the TPU kernels triton_dist_tpu/kernels/flash_attention.py
// `_flash_bwd_dq_kernel` (dq) and `_flash_bwd_dkv_kernel` (dk, dv), both
// launched from `_flash_bwd_pallas`.  Same contract: q / dout [B, Hq, Sq,
// D], k / v [B, Hkv, Sk, D] in bf16 (any b/h/s strides, unit d stride),
// lse and delta = rowsum(dout * out) [B, Hq, Sq] f32 contiguous; global
// positions q_offset + i and kv_offset + j; causal, sliding window,
// soft-cap; segmented positions by per-block start vectors qoffs / koffs
// exactly as in flash_fwd.cu (its header: blocks of SEG = 64 rows, one
// vector per batch row, so a ring step's ranks fold into the batch, and
// a per-tile liveness test where the contiguous mode takes one range).
// Outputs are contiguous, bf16 or (out_f32) f32.  Each kernel
// recomputes P from (q, k, lse) tile by tile (`_recompute_p_ds`):
//   P  = exp(s - lse), 0 where masked      (s = scale * q.k, soft-capped)
//   dP = dO V^T
//   dS = P * (dP - delta) * scale          (* (1 - tanh^2) with a soft-cap)
//   dq = dS K,  dk = dS^T Q,  dv = P^T dO
// P is rounded to bf16 before the dv product and dS before the dq / dk
// products, as the TPU kernels cast them; every product accumulates in
// f32.  Masked lanes get P = 0 before anything reads them, so rows with
// nothing visible (lse = NEG_INF, where exp overflows) give zeros.
//
// What bounds it on an H100: the gradient needs five products of
// 2 * S * S * D flops per q-head (S again, dP, dV, dK, dQ), halved by
// causality, against ~(q, k, v, out, dout, dq, dk, dv) bytes: at the
// training shape (S 2048, Hq 32, D 128) 8.6e10 flops against 84 MB, far
// above the card's 295 flop/byte balance, so the tensor cores bound it.
// The split into two kernels recomputes S and dP in both (seven products),
// the price of having one sequential sum per output and no atomics.
//
// Design.  Both kernels use the register layout of flash_fwd.cu: 4 warps,
// `mma.sync.m16n8k16` bf16 products fed by `ldmatrix`, f32 accumulators in
// registers, a product's C tiles handed to the next product as A
// fragments without touching shared memory, and a two-stage cp.async ring
// for the streamed tiles.
// - dq: one block per (q-tile, kv-head, batch).  The q-tile folds all
//   G = Hq / Hkv heads of the group into its 64 rows (row r = g * BQ + i,
//   BQ = 64 / G), as the forward does; each warp owns 16 rows and their
//   16 x 128 dq accumulator.  Q and dO stay in shared memory; K / V tiles
//   of 64 keys stream through the ring over the live key tiles only
//   (`_block_live`: the closed-form range for contiguous keys, tested per
//   tile for segmented ones).
// - dkv: one block per (key-tile of 64, kv-head, batch); each warp owns 16
//   keys and their dk and dv accumulators (2 x 16 x 128 f32).  The block
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T, so P^T
//   and dS^T are already the A fragments of dv += P^T dO and dk += dS^T Q.
//   Q / dO tiles of 32 folded rows (all G heads: r = g * BQ + i, BQ =
//   32 / G) stream over the live q range, so one block sums every head of
//   the group into its keys without atomics (why the TPU splits dq from
//   dkv).  32 rows keep S^T and dP^T at 16 registers each beside the 128
//   of the accumulators.
// Tiles that are wholly visible (`_block_full`) skip the per-element mask.
// wgmma, TMA and a fused delta are later steps (PERF.md has the measured
// time beside the bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;

constexpr int D = 128;         // head dim
constexpr int NT = 128;        // 4 warps
constexpr int LD = D + 8;      // bf16 row stride in shared memory (272 B)
constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
constexpr int DQ_BM = 64;      // dq: folded q rows per block (16 per warp)
constexpr int DQ_BN = 64;      // dq: keys per streamed tile
constexpr int KV_BN = 64;      // dkv: keys per block (16 per warp)
constexpr int KV_BM = 32;      // dkv: folded q rows per streamed tile
constexpr int SEG = 64;        // positions per entry of a start vector

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* delta;
  void* out0;  // dq, or dk
  void* out1;  // dv
  int Sq, Sk, Hq, Hkv, G;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // dout
  const int* qoffs;  // [B][Sq / SEG] block starts, or null (contiguous)
  const int* koffs;  // [B][Sk / SEG]
  long long qoffs_sb, koffs_sb;
  int q_offset, kv_offset, causal, window, out_f32;
  float scale, soft_cap;
};

// Global position of local row i of batch row b (flash_fwd.cu's rule).
// SEGM: the segmented mode (a start vector on either side), its own
// instantiation of each kernel, as in flash_fwd.cu; without it the
// positions are the contiguous closed form.
template <bool SEGM>
__device__ inline int q_pos(const BwdParams& p, int b, int i) {
  return SEGM && p.qoffs ? p.qoffs[b * p.qoffs_sb + i / SEG] + i % SEG
                         : p.q_offset + i;
}
template <bool SEGM>
__device__ inline int k_pos(const BwdParams& p, int b, int key) {
  return SEGM && p.koffs ? p.koffs[b * p.koffs_sb + key / SEG] + key % SEG
                         : p.kv_offset + key;
}

constexpr size_t DQ_SMEM = static_cast<size_t>(2 * DQ_BM + 4 * DQ_BN) * LD * 2;
constexpr size_t KV_SMEM =
    static_cast<size_t>(2 * KV_BN + 4 * KV_BM) * LD * 2 + 4 * KV_BM * 4;

// `_visibility_mask` with the ragged edges: is key `key` (at position
// kpos) visible to q row `i` (at position qpos)?  Both local indices.
__device__ inline bool visible(const BwdParams& p, int i, int key, int qpos,
                               int kpos) {
  return i < p.Sq && key < p.Sk && (!p.causal || qpos >= kpos) &&
         (!p.window || qpos - kpos < p.window);
}

// `_block_full`: every (q row, key) pair of q rows [i0, i0 + nq) at
// positions from q_first x keys [k0, k0 + nk) from k_first is visible and
// in range.
__device__ inline bool tile_full(const BwdParams& p, int i0, int nq,
                                 int q_first, int k0, int nk, int k_first) {
  return i0 + nq <= p.Sq && k0 + nk <= p.Sk &&
         (!p.causal || q_first >= k_first + nk - 1) &&
         (!p.window || q_first + nq - 1 - k_first < p.window);
}

// Scaled, soft-capped logit and the cap's derivative (1 without a cap).
__device__ inline float logit(const BwdParams& p, float acc, float& dcap) {
  float x = acc * p.scale;
  dcap = 1.f;
  if (p.soft_cap > 0.f) {
    const float t = tanhf(x / p.soft_cap);
    x = p.soft_cap * t;
    dcap = 1.f - t * t;
  }
  return x;
}

// Store a thread's two adjacent f32 values of one output row.
__device__ inline void store2(void* base, bool f32, long long off, float a,
                              float b) {
  if (f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __floats2bfloat162_rn(a, b);
  }
}

// One 16-byte chunk per thread per step: `rows` rows of a folded q-side
// tile (Q or dO) whose row r is head h * G + r / BQ, position q0 + r % BQ.
template <int ROWS>
__device__ inline void load_q_side(bf16* dst, const bf16* src, long long sb,
                                   long long sh, long long ss,
                                   const BwdParams& p, int b, int h, int q0,
                                   int BQ) {
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int j = threadIdx.x + i * NT, r = j / CHUNKS, c = j % CHUNKS;
    const int qi = q0 + r % BQ;
    cp_async16(dst + r * LD + c * 8,
               qi < p.Sq ? src + b * sb + (h * p.G + r / BQ) * sh + qi * ss +
                               c * 8
                         : nullptr,
               p.k);
  }
}

// One 16-byte chunk per thread per step: `rows` key rows from key t0 on.
template <int ROWS>
__device__ inline void load_k_side(bf16* dst, const bf16* src, long long sb,
                                   long long sh, long long ss,
                                   const BwdParams& p, int b, int h, int t0) {
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    const int j = threadIdx.x + i * NT, r = j / CHUNKS, c = j % CHUNKS;
    const int key = t0 + r;
    cp_async16(dst + r * LD + c * 8,
               key < p.Sk ? src + b * sb + h * sh + key * ss + c * 8 : nullptr,
               p.k);
  }
}

template <bool SEGM>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [DQ_BM][LD]
  bf16* sO = sQ + DQ_BM * LD;                    // dO [DQ_BM][LD]
  bf16* sK = sO + DQ_BM * LD;                    // [2][DQ_BN][LD]
  bf16* sV = sK + 2 * DQ_BN * LD;                // [2][DQ_BN][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int BQ = DQ_BM / p.G;
  const int q0 = blockIdx.x * BQ;
  const int n_rows = min(BQ, p.Sq - q0);
  const int q_first = q_pos<SEGM>(p, b, q0);
  const int q_last = q_first + n_rows - 1;

  // `_block_live` per key tile, as in the forward (contiguous keys take
  // the closed-form live range and test no tile).
  int t_begin = 0, t_end = (p.Sk + DQ_BN - 1) / DQ_BN;
  if (!SEGM || !p.koffs) {
    int hi = p.Sk;
    if (p.causal) hi = min(hi, q_last - p.kv_offset + 1);
    int lo = 0;
    if (p.window) lo = max(lo, q_first - p.window + 1 - p.kv_offset);
    t_begin = lo / DQ_BN;
    t_end = hi > t_begin * DQ_BN ? (hi + DQ_BN - 1) / DQ_BN : t_begin;
  }
  auto next_live = [&](int t) {
    if (!SEGM || !p.koffs) return t;
    for (; t < t_end; ++t) {
      const int kf = k_pos<SEGM>(p, b, t * DQ_BN);
      const int nk = min(DQ_BN, p.Sk - t * DQ_BN);
      if ((!p.causal || kf <= q_last) &&
          (!p.window || kf + nk - 1 > q_first - p.window))
        break;
    }
    return t;
  };

  // This thread's two rows of the warp's 16: gq and gq + 8.
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gq + r * 8;
    const int i = q0 + row % BQ;
    lse_r[r] = dl_r[r] = 0.f;
    if (i < p.Sq) {
      const long long idx =
          (static_cast<long long>(b) * p.Hq + h * p.G + row / BQ) * p.Sq + i;
      lse_r[r] = p.lse[idx];
      dl_r[r] = p.delta[idx];
    }
  }

  int t = next_live(t_begin);
  if (t < t_end) {
    load_q_side<DQ_BM>(sQ, p.q, p.q_sb, p.q_sh, p.q_ss, p, b, h, q0, BQ);
    load_q_side<DQ_BM>(sO, p.dout, p.o_sb, p.o_sh, p.o_ss, p, b, h, q0, BQ);
    load_k_side<DQ_BN>(sK, p.k, p.k_sb, p.k_sh, p.k_ss, p, b, h, t * DQ_BN);
    load_k_side<DQ_BN>(sV, p.v, p.v_sb, p.v_sh, p.v_ss, p, b, h, t * DQ_BN);
    cp_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; t < t_end; ++it) {
    const int t0 = t * DQ_BN, buf = it & 1;
    const int tn = next_live(t + 1);
    if (tn < t_end) {
      const int nb = buf ^ 1;
      load_k_side<DQ_BN>(sK + nb * DQ_BN * LD, p.k, p.k_sb, p.k_sh, p.k_ss, p,
                         b, h, tn * DQ_BN);
      load_k_side<DQ_BN>(sV + nb * DQ_BN * LD, p.v, p.v_sb, p.v_sh, p.v_ss, p,
                         b, h, tn * DQ_BN);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* k_t = sK + buf * DQ_BN * LD;
    const bf16* v_t = sV + buf * DQ_BN * LD;

    // S = Q K^T and dP = dO V^T, each [16 x 64] per warp.
    float s[DQ_BN / 8][4], dp[DQ_BN / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], ao[4];
      load_a(a, sQ, LD, warp * 16, kk * 16);
      load_a(ao, sO, LD, warp * 16, kk * 16);
#pragma unroll
      for (int jp = 0; jp < DQ_BN / 16; ++jp) {
        unsigned kb[4], vb[4];
        load_b_nk(kb, k_t, LD, jp * 16, kk * 16);
        mma16816(s[2 * jp], a, kb[0], kb[1]);
        mma16816(s[2 * jp + 1], a, kb[2], kb[3]);
        load_b_nk(vb, v_t, LD, jp * 16, kk * 16);
        mma16816(dp[2 * jp], ao, vb[0], vb[1]);
        mma16816(dp[2 * jp + 1], ao, vb[2], vb[3]);
      }
    }

    // P and dS (into dp) on the two rows this thread holds.
    const int k_first = k_pos<SEGM>(p, b, t0);
    const bool full = tile_full(p, q0, BQ, q_first, t0, DQ_BN, k_first);
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dcap;
        const float x = logit(p, s[j][e], dcap);
        bool vis = true;
        if (!full) {
          const int row = warp * 16 + gq + (e >> 1) * 8;
          const int col = j * 8 + 2 * tq + (e & 1);
          vis = visible(p, q0 + row % BQ, t0 + col, q_first + row % BQ,
                        k_first + col);
        }
        const float pe = vis ? expf(x - lse_r[e >> 1]) : 0.f;
        dp[j][e] = pe * (dp[j][e] - dl_r[e >> 1]) * p.scale * dcap;
      }
    }

    // dQ[16 x 128] += dS[16 x 64] K[64 x 128].
#pragma unroll
    for (int ks = 0; ks < DQ_BN / 16; ++ks) {
      unsigned a[4];
      acc_to_a(a, dp, ks);
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        unsigned kb[4];
        load_b_kn(kb, k_t, LD, ks * 16, jp * 16);
        mma16816(acc[2 * jp], a, kb[0], kb[1]);
        mma16816(acc[2 * jp + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it refills
    t = tn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + gq + r * 8;
    const int i = q0 + row % BQ;
    if (i >= p.Sq) continue;
    const long long o_row =
        (static_cast<long long>(b) * p.Hq + h * p.G + row / BQ) * p.Sq + i;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(p.out0, p.out_f32, o_row * D + j * 8 + 2 * tq, acc[j][2 * r],
             acc[j][2 * r + 1]);
  }
}

template <bool SEGM>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [KV_BN][LD]
  bf16* sV = sK + KV_BN * LD;                    // [KV_BN][LD]
  bf16* sQ = sV + KV_BN * LD;                    // [2][KV_BM][LD]
  bf16* sO = sQ + 2 * KV_BM * LD;                // dO [2][KV_BM][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * KV_BM * LD);  // lse [2][KV_BM]
  float* sD = sL + 2 * KV_BM;                                 // delta [2][KV_BM]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int BQ = KV_BM / p.G;
  const int k0 = blockIdx.x * KV_BN;
  const int n_keys = min(KV_BN, p.Sk - k0);
  const int k_first = k_pos<SEGM>(p, b, k0);
  const int k_last = k_first + n_keys - 1;

  // The TPU kernel's `live` test per q tile of BQ positions: causal rows
  // reach the first key's position, a window's rows start before the
  // last key's window ends (contiguous rows take the closed-form live
  // range and test no tile).
  int t_begin = 0, t_end = (p.Sq + BQ - 1) / BQ;
  if (!SEGM || !p.qoffs) {
    int ihi = p.Sq;
    if (p.window) ihi = min(ihi, k_last + p.window - p.q_offset);
    int ilo = 0;
    if (p.causal) ilo = max(ilo, k_first - p.q_offset);
    t_begin = ilo / BQ;
    t_end = ihi > t_begin * BQ ? (ihi + BQ - 1) / BQ : t_begin;
  }
  auto next_live = [&](int t) {
    if (!SEGM || !p.qoffs) return t;
    for (; t < t_end; ++t) {
      const int qf = q_pos<SEGM>(p, b, t * BQ);
      const int ql = qf + min(BQ, p.Sq - t * BQ) - 1;
      if ((!p.causal || ql >= k_first) &&
          (!p.window || qf < k_last + p.window))
        break;
    }
    return t;
  };

  // lse / delta of a folded q tile into shared memory (plain loads; the
  // barrier before the tile's use publishes them).
  auto load_rows = [&](int q0, int buf) {
    if (tid < KV_BM) {
      const int i = q0 + tid % BQ;
      float l = 0.f, d = 0.f;
      if (i < p.Sq) {
        const long long idx =
            (static_cast<long long>(b) * p.Hq + h * p.G + tid / BQ) * p.Sq + i;
        l = p.lse[idx];
        d = p.delta[idx];
      }
      sL[buf * KV_BM + tid] = l;
      sD[buf * KV_BM + tid] = d;
    }
  };

  int t = next_live(t_begin);
  if (t < t_end) {
    load_k_side<KV_BN>(sK, p.k, p.k_sb, p.k_sh, p.k_ss, p, b, h, k0);
    load_k_side<KV_BN>(sV, p.v, p.v_sb, p.v_sh, p.v_ss, p, b, h, k0);
    load_q_side<KV_BM>(sQ, p.q, p.q_sb, p.q_sh, p.q_ss, p, b, h, t * BQ, BQ);
    load_q_side<KV_BM>(sO, p.dout, p.o_sb, p.o_sh, p.o_ss, p, b, h, t * BQ,
                       BQ);
    load_rows(t * BQ, 0);
    cp_commit();
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }

  for (int it = 0; t < t_end; ++it) {
    const int q0 = t * BQ, buf = it & 1;
    const int tn = next_live(t + 1);
    if (tn < t_end) {
      const int nb = buf ^ 1;
      load_q_side<KV_BM>(sQ + nb * KV_BM * LD, p.q, p.q_sb, p.q_sh, p.q_ss, p,
                         b, h, tn * BQ, BQ);
      load_q_side<KV_BM>(sO + nb * KV_BM * LD, p.dout, p.o_sb, p.o_sh,
                         p.o_ss, p, b, h, tn * BQ, BQ);
      load_rows(tn * BQ, nb);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* q_t = sQ + buf * KV_BM * LD;
    const bf16* o_t = sO + buf * KV_BM * LD;
    const float* l_t = sL + buf * KV_BM;
    const float* d_t = sD + buf * KV_BM;

    // S^T = K Q^T and dP^T = V dO^T, each [16 keys x 32 rows] per warp.
    float s[KV_BM / 8][4], dp[KV_BM / 8][4];
#pragma unroll
    for (int j = 0; j < KV_BM / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4], av[4];
      load_a(a, sK, LD, warp * 16, kk * 16);
      load_a(av, sV, LD, warp * 16, kk * 16);
#pragma unroll
      for (int jp = 0; jp < KV_BM / 16; ++jp) {
        unsigned qb[4], ob[4];
        load_b_nk(qb, q_t, LD, jp * 16, kk * 16);
        mma16816(s[2 * jp], a, qb[0], qb[1]);
        mma16816(s[2 * jp + 1], a, qb[2], qb[3]);
        load_b_nk(ob, o_t, LD, jp * 16, kk * 16);
        mma16816(dp[2 * jp], av, ob[0], ob[1]);
        mma16816(dp[2 * jp + 1], av, ob[2], ob[3]);
      }
    }

    // P^T (into s) and dS^T (into dp): the row of an element is a key, its
    // column a folded q row.
    const int q_first = q_pos<SEGM>(p, b, q0);
    const bool full = tile_full(p, q0, BQ, q_first, k0, KV_BN, k_first);
#pragma unroll
    for (int j = 0; j < KV_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * tq + (e & 1);
        float dcap;
        const float x = logit(p, s[j][e], dcap);
        bool vis = true;
        if (!full) {
          const int kr = warp * 16 + gq + (e >> 1) * 8;
          vis = visible(p, q0 + col % BQ, k0 + kr, q_first + col % BQ,
                        k_first + kr);
        }
        const float pe = vis ? expf(x - l_t[col]) : 0.f;
        s[j][e] = pe;
        dp[j][e] = pe * (dp[j][e] - d_t[col]) * p.scale * dcap;
      }
    }

    // dV[16 x 128] += P^T[16 x 32] dO[32 x 128];
    // dK[16 x 128] += dS^T[16 x 32] Q[32 x 128].
#pragma unroll
    for (int ks = 0; ks < KV_BM / 16; ++ks) {
      unsigned ap[4], ads[4];
      acc_to_a(ap, s, ks);
      acc_to_a(ads, dp, ks);
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        unsigned ob[4], qb[4];
        load_b_kn(ob, o_t, LD, ks * 16, jp * 16);
        mma16816(acc_v[2 * jp], ap, ob[0], ob[1]);
        mma16816(acc_v[2 * jp + 1], ap, ob[2], ob[3]);
        load_b_kn(qb, q_t, LD, ks * 16, jp * 16);
        mma16816(acc_k[2 * jp], ads, qb[0], qb[1]);
        mma16816(acc_k[2 * jp + 1], ads, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it refills
    t = tn;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + gq + r * 8;
    if (key >= p.Sk) continue;
    const long long o_row =
        (static_cast<long long>(b) * p.Hkv + h) * p.Sk + key;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long off = o_row * D + j * 8 + 2 * tq;
      store2(p.out0, p.out_f32, off, acc_k[j][2 * r], acc_k[j][2 * r + 1]);
      store2(p.out1, p.out_f32, off, acc_v[j][2 * r], acc_v[j][2 * r + 1]);
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* out0, void* out1, int Hq, int Hkv, int Sq, int Sk,
                      const long long* st, const void* qoffs,
                      long long qoffs_sb, const void* koffs,
                      long long koffs_sb, int q_offset, int kv_offset,
                      int causal, int window, int out_f32, float scale,
                      float soft_cap) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.q_sb = st[0]; p.q_sh = st[1]; p.q_ss = st[2];
  p.k_sb = st[3]; p.k_sh = st[4]; p.k_ss = st[5];
  p.v_sb = st[6]; p.v_sh = st[7]; p.v_ss = st[8];
  p.o_sb = st[9]; p.o_sh = st[10]; p.o_ss = st[11];
  p.qoffs = static_cast<const int*>(qoffs);
  p.koffs = static_cast<const int*>(koffs);
  p.qoffs_sb = qoffs_sb;
  p.koffs_sb = koffs_sb;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  p.out_f32 = out_f32;
  p.scale = scale;
  p.soft_cap = soft_cap;
  return p;
}

// cudaFuncSetAttribute once per kernel, device and process (outside any
// graph capture: the first call of each wrapper is an eager one).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (done & (1u << dev)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

template <bool SEGM>
int launch_dq(const BwdParams& p, int B, void* stream) {
  static unsigned attr_set = 0;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<SEGM>, DQ_SMEM, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int BQ = DQ_BM / p.G;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hkv, B);
  flash_bwd_dq_kernel<SEGM><<<grid, NT, DQ_SMEM,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool SEGM>
int launch_dkv(const BwdParams& p, int B, void* stream) {
  static unsigned attr_set = 0;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<SEGM>, KV_SMEM, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Sk + KV_BN - 1) / KV_BN, p.Hkv, B);
  flash_bwd_dkv_kernel<SEGM><<<grid, NT, KV_SMEM,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q (b, h, s), k, v, dout — 12 values, element units.  qoffs /
// koffs: per-block start vectors (flash_fwd.cu's header), or null for
// q_offset / kv_offset.
extern "C" int tdt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Hq, int Hkv,
    int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, const void* qoffs, long long qoffs_sb, const void* koffs,
    long long koffs_sb, int q_offset, int kv_offset, int causal, int window,
    int out_f32, float scale, float soft_cap, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const BwdParams p = make_params(q, k, v, dout, lse, delta, dq, nullptr, Hq,
                                  Hkv, Sq, Sk, st, qoffs, qoffs_sb, koffs,
                                  koffs_sb, q_offset, kv_offset, causal,
                                  window, out_f32, scale, soft_cap);
  return qoffs || koffs ? launch_dq<true>(p, B, stream)
                        : launch_dq<false>(p, B, stream);
}

extern "C" int tdt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Hq,
    int Hkv, int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, const void* qoffs, long long qoffs_sb, const void* koffs,
    long long koffs_sb, int q_offset, int kv_offset, int causal, int window,
    int out_f32, float scale, float soft_cap, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const BwdParams p = make_params(q, k, v, dout, lse, delta, dk, dv, Hq, Hkv,
                                  Sq, Sk, st, qoffs, qoffs_sb, koffs, koffs_sb,
                                  q_offset, kv_offset, causal,
                                  window, out_f32, scale, soft_cap);
  return qoffs || koffs ? launch_dkv<true>(p, B, stream)
                        : launch_dkv<false>(p, B, stream);
}
