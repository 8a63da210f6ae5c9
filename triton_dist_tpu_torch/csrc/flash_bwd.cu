// flash_bwd: flash-attention backward for Hopper (sm_90a), two kernels on
// the wgmma / TMA pieces of sm90.cuh.
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
// The split into two kernels recomputes S and dP in both (eight products
// with dkv's second S^T, below), the price of one sequential sum per
// output: no atomics, deterministic (why the TPU splits dq from dkv).
//
// Design.  Each block is three warpgroups: a producer and two consumers
// (setmaxnreg moves registers from the first to the others; ptxas still
// kept these consumers near the launch's 168 registers a thread, so the
// tiles are sized for that; without it dq ran slower).  The
// producer brings tiles by TMA (128-byte swizzle) into a ring of full /
// empty mbarriers; the consumers run every product on wgmma with f32
// accumulators in registers, and hand P and dS to the next product as
// the register A operand, rounded to bf16, without touching shared
// memory.  Tile widths keep each consumer's accumulators within what
// ptxas pipelines without serialising the wgmmas or spilling.
// - dq: a block owns 128 folded q rows of one (batch, kv-head): all G =
//   Hq / Hkv heads of the group times BQ = 128 / G positions (row r = g *
//   BQ + i), 64 per consumer, with its 64 x 128 dq accumulator.  Q and dO
//   arrive once; K / V tiles of 32 keys stream over the live key tiles.
//   S = Q K^T and dP = dO V^T are m64n32k16 products from shared memory
//   (K-major), dQ += dS K an m64n128k16 with dS in registers and K's tile
//   as the MN-major B.
// - dkv: a block owns 64 keys of one (batch, kv-head).  K and V arrive
//   once; Q / dO tiles of 32 folded rows (all G heads: r = g * BQ + i, BQ
//   = 32 / G) stream over the live q tiles with their lse and delta
//   (loaded by the producer's first warp into shared memory), so one
//   block sums every head of the group into its keys without atomics.
//   The first consumer sums dV, the second dK, over the same tiles; each
//   computes the transposed tile S^T = K Q^T (m64n32k16, A = K from
//   shared memory, B = Q K-major), the second also dP^T = V dO^T, so P^T
//   and dS^T are already the register A operands of dV += P^T dO and dK
//   += dS^T Q (m64n128k16, B = dO or Q MN-major).  S^T is computed twice
//   (five products a tile, not four): one warpgroup holding dK, dV, S^T
//   and dP^T (192 accumulator registers) made ptxas serialise every
//   wgmma and spill.
// Both kernels walk live tiles only (`_block_live`: the closed-form range
// for contiguous positions, tested per tile for segmented ones, where a
// 128-row tile spans two start-vector entries) and skip the per-element
// mask on tiles that are wholly visible (`_block_full`).  The softmax
// terms run in base 2 (exp2 of log2(e)-scaled logits and lse), each pass
// in a loop of its own.  Blocks are ordered heaviest first under
// causality: dq's last q tiles (which see the most keys) and dkv's first
// key tiles (seen by the most rows) start first, across every (batch,
// head).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tdt_sm90;
using bf16 = __nv_bfloat16;

constexpr int D = 128;         // head dim
constexpr int NT = 384;        // a producer and two consumer warpgroups
constexpr int ST = 2;          // dq: streamed K / V stages
constexpr int SEG = 64;        // positions per entry of a start vector
constexpr int DQ_BM = 128;     // dq: folded q rows per block
constexpr int DQ_BN = 32;      // dq: keys per streamed tile
constexpr int KV_BN = 64;      // dkv: keys per block
constexpr int KV_BM = 32;      // dkv: folded q rows per streamed tile
constexpr int KV_ST = 3;       // dkv: streamed Q / dO stages
static_assert(DQ_BN == 32 && KV_BM == 32, "S and dP are m64n32 products");
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// Bytes of one 64-column swizzled half of a tile of that many rows.
constexpr uint32_t half_bytes(int rows) { return rows * 128; }

struct BwdParams {
  CUtensorMap qmap;  // q: {D, Sq, Hq, B}, box {64, BQ, G, 1}
  CUtensorMap omap;  // dout, as q
  CUtensorMap kmap;  // k: {D, Sk, Hkv, B}, box {64, keys, 1, 1}
  CUtensorMap vmap;
  const float* lse;
  const float* delta;
  void* out0;  // dq, or dk
  void* out1;  // dv
  int B, Sq, Sk, Hq, Hkv, G, BQ, bq_log, n_tiles;  // BQ = 1 << bq_log
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
__device__ __forceinline__ int q_pos(const BwdParams& p, int b, int i) {
  return SEGM && p.qoffs ? p.qoffs[b * p.qoffs_sb + i / SEG] + i % SEG
                         : p.q_offset + i;
}
template <bool SEGM>
__device__ __forceinline__ int k_pos(const BwdParams& p, int b, int key) {
  return SEGM && p.koffs ? p.koffs[b * p.koffs_sb + key / SEG] + key % SEG
                         : p.kv_offset + key;
}

// First and last position of local rows [i0, i0 + n) of one side: the
// least and the largest over the start-vector entries they span.
template <bool SEGM, bool KSIDE>
__device__ __forceinline__ int2 pos_range(const BwdParams& p, int b, int i0,
                                          int n) {
  const int* offs = KSIDE ? p.koffs : p.qoffs;
  if (!SEGM || !offs) {
    const int o = KSIDE ? p.kv_offset : p.q_offset;
    return make_int2(o + i0, o + i0 + n - 1);
  }
  const long long sb = KSIDE ? p.koffs_sb : p.qoffs_sb;
  int lo = 0x7fffffff, hi = -0x7fffffff;
  for (int e = i0 / SEG; e <= (i0 + n - 1) / SEG; ++e) {
    const int a = max(i0, e * SEG), z = min(i0 + n, (e + 1) * SEG) - 1;
    const int st = offs[b * sb + e] - e * SEG;
    lo = min(lo, st + a);
    hi = max(hi, st + z);
  }
  return make_int2(lo, hi);
}

// `_block_live` / `_block_full` of a q range against a key range.
__device__ __forceinline__ bool live(const BwdParams& p, int2 q, int2 k) {
  return (!p.causal || k.x <= q.y) && (!p.window || k.y > q.x - p.window);
}
__device__ __forceinline__ bool full(const BwdParams& p, int2 q, int2 k) {
  return (!p.causal || q.x >= k.y) && (!p.window || q.y - k.x < p.window);
}

// `_visibility_mask` with the ragged edges: is key `key` (at position
// kpos) visible to q row `i` (at position qpos)?  Both local indices.
__device__ __forceinline__ bool visible(const BwdParams& p, int i, int key,
                                        int qpos, int kpos) {
  return i < p.Sq && key < p.Sk && (!p.causal || qpos >= kpos) &&
         (!p.window || qpos - kpos < p.window);
}

constexpr float NEG_INF = -1.0e30f;

// Scaled, soft-capped logits of an accumulator, in place (each in a loop
// of its own, so the common path runs straight through).
template <int N>
__device__ __forceinline__ void scale_logits(const BwdParams& p,
                                             float (&s)[N]) {
  if (p.soft_cap > 0.f) {
    const float in = p.scale / p.soft_cap;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = p.soft_cap * tanh_fast(s[i] * in);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= p.scale;
  }
}

// P = exp(s - lse) (0 where masked: s = NEG_INF) into s and dS = P (dP -
// delta) scale (1 - tanh^2 with a soft-cap, from the capped logit: tanh =
// s / cap) into dp.  lse2(i) is element i's lse in base 2, delta(i) its
// delta.
template <int N, class L, class Dl>
__device__ __forceinline__ void p_ds(const BwdParams& p, float (&s)[N],
                                     float (&dp)[N], L lse2, Dl delta) {
  if (p.soft_cap > 0.f) {
    const float inv = 1.f / p.soft_cap;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = s[i], t = x * inv;
      const float pe =
          x > 0.5f * NEG_INF ? exp2_approx(x * LOG2E - lse2(i)) : 0.f;
      s[i] = pe;
      dp[i] = pe * (dp[i] - delta(i)) * p.scale * (1.f - fminf(t * t, 1.f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float x = s[i];
      const float pe =
          x > 0.5f * NEG_INF ? exp2_approx(x * LOG2E - lse2(i)) : 0.f;
      s[i] = pe;
      dp[i] = pe * (dp[i] - delta(i)) * p.scale;
    }
  }
}

// Store a thread's two adjacent f32 values of one output row.
__device__ __forceinline__ void store2(void* base, bool f32, long long off,
                                       float a, float b) {
  if (f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + off) =
        make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(base) + off) =
        __floats2bfloat162_rn(a, b);
  }
}

// ------------------------------------------------------------------ dq

struct DqSmem {
  bf16 q[2 * DQ_BM * 64];
  bf16 o[2 * DQ_BM * 64];  // dO
  bf16 k[ST][2 * DQ_BN * 64];
  bf16 v[ST][2 * DQ_BN * 64];
  uint64_t qfull, full[ST], empty[ST];
};
constexpr uint32_t DQ_QH = half_bytes(DQ_BM), DQ_KH = half_bytes(DQ_BN);

// A dq block: its q tile and the range of key tiles it may visit.
struct DqTile {
  int b, h, q0, n_rows, t_begin, t_end;
  int2 qr;  // first / last position of its rows
};

template <bool SEGM>
__device__ __forceinline__ DqTile dq_tile(const BwdParams& p) {
  DqTile t;
  const int BH = p.B * p.Hkv;
  const int x = p.n_tiles - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = blockIdx.x % BH;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.q0 = x * p.BQ;
  t.n_rows = min(p.BQ, p.Sq - t.q0);
  t.qr = pos_range<SEGM, false>(p, t.b, t.q0, t.n_rows);
  t.t_begin = 0;
  t.t_end = (p.Sk + DQ_BN - 1) / DQ_BN;
  if (!SEGM || !p.koffs) {  // contiguous keys: the closed-form live range
    int hi = p.Sk;
    if (p.causal) hi = min(hi, t.qr.y - p.kv_offset + 1);
    int lo = 0;
    if (p.window) lo = max(lo, t.qr.x - p.window + 1 - p.kv_offset);
    t.t_begin = lo / DQ_BN;
    t.t_end = hi > t.t_begin * DQ_BN ? (hi + DQ_BN - 1) / DQ_BN : t.t_begin;
  }
  return t;
}

template <bool SEGM>
__device__ __forceinline__ int dq_next(const BwdParams& p, const DqTile& t,
                                       int kt) {
  if constexpr (!SEGM) return kt;
  if (!p.koffs) return kt;
  for (; kt < t.t_end; ++kt) {
    const int k0 = kt * DQ_BN;
    if (live(p, t.qr, pos_range<SEGM, true>(p, t.b, k0,
                                            min(DQ_BN, p.Sk - k0))))
      break;
  }
  return kt;
}

template <bool SEGM>
__device__ __forceinline__ void dq_producer(const BwdParams& p, DqSmem& sm) {
  if (threadIdx.x != 0) return;
  const DqTile t = dq_tile<SEGM>(p);
  mbar_arrive_tx(&sm.qfull, 4 * DQ_QH);
  for (int hf = 0; hf < 2; ++hf) {
    tma_load_4d(sm.q + hf * DQ_BM * 64, &p.qmap, &sm.qfull, hf * 64, t.q0,
                t.h * p.G, t.b);
    tma_load_4d(sm.o + hf * DQ_BM * 64, &p.omap, &sm.qfull, hf * 64, t.q0,
                t.h * p.G, t.b);
  }
  Ring<ST> ring;
  for (int kt = dq_next<SEGM>(p, t, t.t_begin); kt < t.t_end;
       kt = dq_next<SEGM>(p, t, kt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.empty[st], ring.phase ^ 1u);
    mbar_arrive_tx(&sm.full[st], 4 * DQ_KH);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(sm.k[st] + hf * DQ_BN * 64, &p.kmap, &sm.full[st], hf * 64,
                  kt * DQ_BN, t.h, t.b);
      tma_load_4d(sm.v[st] + hf * DQ_BN * 64, &p.vmap, &sm.full[st], hf * 64,
                  kt * DQ_BN, t.h, t.b);
    }
    ring.next();
  }
}

template <bool SEGM>
__device__ __forceinline__ void dq_consumer(const BwdParams& p, DqSmem& sm,
                                            int cw) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const DqTile t = dq_tile<SEGM>(p);

  // This thread's two rows: local index, position, lse, delta.
  int row_i[2], row_pos[2];
  float lse2_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * cw + 16 * warp + gq + 8 * r;
    const int i = t.q0 + (row & (p.BQ - 1));
    row_i[r] = i;
    row_pos[r] = 0;
    lse2_r[r] = dl_r[r] = 0.f;
    if (i < p.Sq) {
      row_pos[r] = q_pos<SEGM>(p, t.b, i);
      const long long idx =
          (static_cast<long long>(t.b) * p.Hq + t.h * p.G + (row >> p.bq_log)) *
              p.Sq + i;
      lse2_r[r] = p.lse[idx] * LOG2E;
      dl_r[r] = p.delta[idx];
    }
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bf16* sq = sm.q + cw * 64 * 64;
  const bf16* so = sm.o + cw * 64 * 64;
  mbar_wait(&sm.qfull, 0);

  Ring<ST> ring;
  for (int kt = dq_next<SEGM>(p, t, t.t_begin); kt < t.t_end;
       kt = dq_next<SEGM>(p, t, kt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.full[st], ring.phase);
    const bf16* sk = sm.k[st];
    const bf16* sv = sm.v[st];

    // S = Q K^T and dP = dO V^T, each [64 x DQ_BN].
    float s[DQ_BN / 2], dp[DQ_BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32<0>(s, desc_k(sq, kk, DQ_QH), desc_k(sk, kk, DQ_KH),
                      kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32<0>(dp, desc_k(so, kk, DQ_QH), desc_k(sv, kk, DQ_KH),
                      kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS (into dp) on the two rows this thread holds.  A key tile lies in
    // one start-vector entry: its positions run on from k_first.
    const int t0 = kt * DQ_BN;
    const int nk = min(DQ_BN, p.Sk - t0);
    const int k_first = k_pos<SEGM>(p, t.b, t0);
    const bool whole = t.q0 + p.BQ <= p.Sq && t0 + DQ_BN <= p.Sk &&
                       full(p, t.qr, make_int2(k_first, k_first + nk - 1));
    scale_logits(p, s);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = 8 * j + 2 * tq + (e & 1);
          if (!visible(p, row_i[r], t0 + col, row_pos[r], k_first + col))
            s[4 * j + e] = NEG_INF;
        }
      }
    }
    p_ds<DQ_BN / 2>(p, s, dp, [&](int i) { return lse2_r[(i >> 1) & 1]; },
                    [&](int i) { return dl_r[(i >> 1) & 1]; });

    // dQ[64 x 128] += dS[64 x DQ_BN] K[DQ_BN x 128], dS in registers.
    unsigned da[DQ_BN / 16][4];
#pragma unroll
    for (int ks = 0; ks < DQ_BN / 16; ++ks) acc_to_a(da[ks], dp, ks);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DQ_BN / 16; ++ks)
      wgmma_rs_n128<1>(acc, da[ks], desc_mn(sk, ks, DQ_KH), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < DQ_BN / 16; ++ks) fence_regs(da[ks]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    ring.next();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * cw + 16 * warp + gq + 8 * r;
    if (row_i[r] >= p.Sq) continue;
    const long long o_row =
        (static_cast<long long>(t.b) * p.Hq + t.h * p.G + (row >> p.bq_log)) *
            p.Sq +
        row_i[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(p.out0, p.out_f32, o_row * D + j * 8 + 2 * tq, acc[4 * j + 2 * r],
             acc[4 * j + 2 * r + 1]);
  }
}

template <bool SEGM>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ char smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    mbar_init(&sm.qfull, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 8);  // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dealloc<PRODUCER_REGS>();
    dq_producer<SEGM>(p, sm);
  } else {
    regs_alloc<CONSUMER_REGS>();
    dq_consumer<SEGM>(p, sm, threadIdx.x / 128 - 1);
  }
}

// ----------------------------------------------------------------- dkv

struct DkvSmem {
  bf16 k[2 * KV_BN * 64];
  bf16 v[2 * KV_BN * 64];
  bf16 q[KV_ST][2 * KV_BM * 64];
  bf16 o[KV_ST][2 * KV_BM * 64];  // dO
  float lse[KV_ST][KV_BM], dl[KV_ST][KV_BM];  // lse in base 2, delta
  uint64_t kvfull, full[KV_ST], empty[KV_ST];
};
constexpr uint32_t KV_KH = half_bytes(KV_BN), KV_QH = half_bytes(KV_BM);

// A dkv block: its keys and the range of q tiles it may visit.
struct DkvTile {
  int b, h, k0, t_begin, t_end;
  int2 kr;  // first / last position of its keys
};

template <bool SEGM>
__device__ __forceinline__ DkvTile dkv_tile(const BwdParams& p) {
  DkvTile t;
  const int BH = p.B * p.Hkv;
  const int x = static_cast<int>(blockIdx.x) / BH;
  const int bh = blockIdx.x % BH;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.k0 = x * KV_BN;
  t.kr = pos_range<SEGM, true>(p, t.b, t.k0, min(KV_BN, p.Sk - t.k0));
  // The TPU kernel's `live` test per q tile of BQ positions: causal rows
  // reach the first key's position, a window's rows start before the
  // last key's window ends (contiguous rows take the closed-form range).
  t.t_begin = 0;
  t.t_end = (p.Sq + p.BQ - 1) / p.BQ;
  if (!SEGM || !p.qoffs) {
    int ihi = p.Sq;
    if (p.window) ihi = min(ihi, t.kr.y + p.window - p.q_offset);
    int ilo = 0;
    if (p.causal) ilo = max(ilo, t.kr.x - p.q_offset);
    t.t_begin = ilo / p.BQ;
    t.t_end = ihi > t.t_begin * p.BQ ? (ihi + p.BQ - 1) / p.BQ : t.t_begin;
  }
  return t;
}

// A q tile of BQ = KV_BM / G positions lies in one start-vector entry.
template <bool SEGM>
__device__ __forceinline__ int dkv_next(const BwdParams& p,
                                        const DkvTile& t, int qt) {
  if constexpr (!SEGM) return qt;
  if (!p.qoffs) return qt;
  for (; qt < t.t_end; ++qt) {
    const int qf = q_pos<SEGM>(p, t.b, qt * p.BQ);
    if (live(p, make_int2(qf, qf + min(p.BQ, p.Sq - qt * p.BQ) - 1), t.kr))
      break;
  }
  return qt;
}

// The producer's first warp: K and V once, then each live Q / dO tile
// with its lse (base 2) and delta, two rows a lane.
template <bool SEGM>
__device__ __forceinline__ void dkv_producer(const BwdParams& p,
                                             DkvSmem& sm) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const DkvTile t = dkv_tile<SEGM>(p);
  if (lane == 0) {
    mbar_arrive_tx(&sm.kvfull, 4 * KV_KH);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(sm.k + hf * KV_BN * 64, &p.kmap, &sm.kvfull, hf * 64, t.k0,
                  t.h, t.b);
      tma_load_4d(sm.v + hf * KV_BN * 64, &p.vmap, &sm.kvfull, hf * 64, t.k0,
                  t.h, t.b);
    }
  }
  Ring<KV_ST> ring;
  for (int qt = dkv_next<SEGM>(p, t, t.t_begin); qt < t.t_end;
       qt = dkv_next<SEGM>(p, t, qt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.empty[st], ring.phase ^ 1u);
    // Folded row r: head h G + r / BQ at position qt BQ + r % BQ.
#pragma unroll
    for (int r = lane; r < KV_BM; r += 32) {
      const int i = qt * p.BQ + (r & (p.BQ - 1));
      float l = 0.f, d = 0.f;
      if (i < p.Sq) {
        const long long idx =
            (static_cast<long long>(t.b) * p.Hq + t.h * p.G +
             (r >> p.bq_log)) * p.Sq + i;
        l = p.lse[idx] * LOG2E;
        d = p.delta[idx];
      }
      sm.lse[st][r] = l;
      sm.dl[st][r] = d;
    }
    if (lane == 0) {
      mbar_arrive_tx(&sm.full[st], 4 * KV_QH);
      for (int hf = 0; hf < 2; ++hf) {
        tma_load_4d(sm.q[st] + hf * KV_BM * 64, &p.qmap, &sm.full[st],
                    hf * 64, qt * p.BQ, t.h * p.G, t.b);
        tma_load_4d(sm.o[st] + hf * KV_BM * 64, &p.omap, &sm.full[st],
                    hf * 64, qt * p.BQ, t.h * p.G, t.b);
      }
    }
    mbar_arrive(&sm.full[st]);  // publishes this lane's lse / delta
    ring.next();
  }
}

// A consumer warpgroup: DK false sums dV = P^T dO, DK true dK = dS^T Q,
// over the same 64 keys and every live q tile (each recomputes S^T: a
// warpgroup holds one 64 x 128 f32 accumulator beside S^T and dP^T, so
// its wgmmas stay pipelined).
template <bool SEGM, bool DK>
__device__ __forceinline__ void dkv_consumer(const BwdParams& p,
                                             DkvSmem& sm) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const DkvTile t = dkv_tile<SEGM>(p);

  // This thread's two keys: local index and position.
  int key_i[2], key_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_i[r] = t.k0 + 16 * warp + gq + 8 * r;
    key_pos[r] = key_i[r] < p.Sk ? k_pos<SEGM>(p, t.b, key_i[r]) : 0;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait(&sm.kvfull, 0);

  Ring<KV_ST> ring;
  for (int qt = dkv_next<SEGM>(p, t, t.t_begin); qt < t.t_end;
       qt = dkv_next<SEGM>(p, t, qt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.full[st], ring.phase);
    const bf16* sq = sm.q[st];
    const bf16* so = sm.o[st];
    const float* sl = sm.lse[st];
    const float* sd = sm.dl[st];

    // S^T = K Q^T (and dP^T = V dO^T), [64 keys x KV_BM folded rows].
    float s[KV_BM / 2], dp[KV_BM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32<0>(s, desc_k(sm.k, kk, KV_KH), desc_k(sq, kk, KV_QH),
                      kk > 0);
    if constexpr (DK) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n32<0>(dp, desc_k(sm.v, kk, KV_KH), desc_k(so, kk, KV_QH),
                        kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if constexpr (DK) fence_regs(dp);

    // P^T (and dS^T): an element's row is a key, its column a folded q
    // row (head col / BQ, position q_first + col % BQ).
    const int q0 = qt * p.BQ;
    const int n_rows = min(p.BQ, p.Sq - q0);
    const int q_first = q_pos<SEGM>(p, t.b, q0);
    const bool whole =
        q0 + p.BQ <= p.Sq && t.k0 + KV_BN <= p.Sk &&
        full(p, make_int2(q_first, q_first + n_rows - 1), t.kr);
    scale_logits(p, s);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < KV_BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int ci = (8 * j + 2 * tq + (e & 1)) & (p.BQ - 1);
          if (!visible(p, q0 + ci, key_i[r], q_first + ci, key_pos[r]))
            s[4 * j + e] = NEG_INF;
        }
      }
    }
    auto lse2 = [&](int i) { return sl[8 * (i >> 2) + 2 * tq + (i & 1)]; };
    unsigned a[KV_BM / 16][4];
    if constexpr (DK) {
      p_ds<KV_BM / 2>(
          p, s, dp, lse2,
          [&](int i) { return sd[8 * (i >> 2) + 2 * tq + (i & 1)]; });
#pragma unroll
      for (int ks = 0; ks < KV_BM / 16; ++ks) acc_to_a(a[ks], dp, ks);
    } else {
#pragma unroll
      for (int i = 0; i < KV_BM / 2; ++i)
        s[i] = s[i] > 0.5f * NEG_INF ? exp2_approx(s[i] * LOG2E - lse2(i))
                                     : 0.f;
#pragma unroll
      for (int ks = 0; ks < KV_BM / 16; ++ks) acc_to_a(a[ks], s, ks);
    }

    // dV[64 x 128] += P^T[64 x KV_BM] dO[KV_BM x 128], or
    // dK[64 x 128] += dS^T[64 x KV_BM] Q[KV_BM x 128]; the A operand in
    // registers, rounded to bf16.
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KV_BM / 16; ++ks)
      wgmma_rs_n128<1>(acc, a[ks], desc_mn(DK ? sq : so, ks, KV_QH), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KV_BM / 16; ++ks) fence_regs(a[ks]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    ring.next();
  }

  void* out = DK ? p.out0 : p.out1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key_i[r] >= p.Sk) continue;
    const long long o_row =
        (static_cast<long long>(t.b) * p.Hkv + t.h) * p.Sk + key_i[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(out, p.out_f32, o_row * D + j * 8 + 2 * tq, acc[4 * j + 2 * r],
             acc[4 * j + 2 * r + 1]);
  }
}

template <bool SEGM>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ char smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    mbar_init(&sm.kvfull, 1);
    for (int i = 0; i < KV_ST; ++i) {
      mbar_init(&sm.full[i], 1 + 32);  // the TMA arrival + lse / delta
      mbar_init(&sm.empty[i], 8);      // every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dealloc<PRODUCER_REGS>();
    dkv_producer<SEGM>(p, sm);
  } else if (threadIdx.x < 256) {
    regs_alloc<CONSUMER_REGS>();
    dkv_consumer<SEGM, false>(p, sm);
  } else {
    regs_alloc<CONSUMER_REGS>();
    dkv_consumer<SEGM, true>(p, sm);
  }
}

// ---------------------------------------------------------------- host

// Parameters and tensor maps of one launch.  dq (dkv false): q / dO boxes
// of 128 folded rows, k / v boxes of 64 keys; dkv: q / dO boxes of 64
// folded rows, k / v boxes of 128 keys.
int make_params(BwdParams& p, bool dkv, const void* q, const void* k,
                const void* v, const void* dout, const void* lse,
                const void* delta, void* out0, void* out1, int B, int Hq,
                int Hkv, int Sq, int Sk, const long long* st,
                const void* qoffs, long long qoffs_sb, const void* koffs,
                long long koffs_sb, int q_offset, int kv_offset, int causal,
                int window, int out_f32, float scale, float soft_cap) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || 32 % (Hq / Hkv) || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out0 = out0;
  p.out1 = out1;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.BQ = (dkv ? KV_BM : DQ_BM) / p.G;
  p.bq_log = 0;
  while ((1 << p.bq_log) < p.BQ) ++p.bq_log;
  p.n_tiles = dkv ? (Sk + KV_BN - 1) / KV_BN : (Sq + p.BQ - 1) / p.BQ;
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
  const long long qd[4] = {D, Sq, Hq, B};
  const long long kd[4] = {D, Sk, Hkv, B};
  const long long qs[4] = {1, st[2], st[1], st[0]};
  const long long ks[4] = {1, st[5], st[4], st[3]};
  const long long vs[4] = {1, st[8], st[7], st[6]};
  const long long os[4] = {1, st[11], st[10], st[9]};
  const int qbox[4] = {64, p.BQ, p.G, 1};
  const int kbox[4] = {64, dkv ? KV_BN : DQ_BN, 1, 1};
  int err = make_map(&p.qmap, q, 4, qd, qs, qbox);
  if (!err) err = make_map(&p.omap, dout, 4, qd, os, qbox);
  if (!err) err = make_map(&p.kmap, k, 4, kd, ks, kbox);
  if (!err) err = make_map(&p.vmap, v, 4, kd, vs, kbox);
  return err;
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
int launch_dq(const BwdParams& p, void* stream) {
  static unsigned attr_set = 0;
  constexpr size_t smem = sizeof(DqSmem) + 1024;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<SEGM>, smem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<SEGM><<<p.n_tiles * p.Hkv * p.B, NT, smem,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool SEGM>
int launch_dkv(const BwdParams& p, void* stream) {
  static unsigned attr_set = 0;
  constexpr size_t smem = sizeof(DkvSmem) + 1024;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<SEGM>, smem, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<SEGM><<<p.n_tiles * p.Hkv * p.B, NT, smem,
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
  BwdParams p;
  const int err = make_params(p, false, q, k, v, dout, lse, delta, dq,
                              nullptr, B, Hq, Hkv, Sq, Sk, st, qoffs,
                              qoffs_sb, koffs, koffs_sb, q_offset, kv_offset,
                              causal, window, out_f32, scale, soft_cap);
  if (err) return err;
  return qoffs || koffs ? launch_dq<true>(p, stream)
                        : launch_dq<false>(p, stream);
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
  BwdParams p;
  const int err = make_params(p, true, q, k, v, dout, lse, delta, dk, dv, B,
                              Hq, Hkv, Sq, Sk, st, qoffs, qoffs_sb, koffs,
                              koffs_sb, q_offset, kv_offset, causal, window,
                              out_f32, scale, soft_cap);
  if (err) return err;
  return qoffs || koffs ? launch_dkv<true>(p, stream)
                        : launch_dkv<false>(p, stream);
}
