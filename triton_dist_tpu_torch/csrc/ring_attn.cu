// ring_attn: fused ring attention for Hopper (sm_90a), over the
// distributed verbs of dist_verbs.cuh and the wgmma / TMA pieces of
// sm90.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/ring_attention.py
// `_ring_attn_kernel` (:409, launched from `_ring_attention_pallas_fwd` at
// :511).  Same contract, for every rank r of a world of W: rank r's
// sequence shard q [S_loc, B, Hq, D], k / v [S_loc, B, Hkv, D] (bf16,
// D = 128) at the global positions `_shard_starts` gives (contiguous:
// r S_loc + i; zigzag: chunks r and 2W - 1 - r of S_loc / 2 each);
// rank r's out [S_loc, B, Hq, D] bf16 is causal / windowed / soft-capped
// GQA attention of its q over ALL W shards' K / V (the reference's
// `_block_update` rule: key visible iff (not causal or qpos >= kpos) and
// (not window or qpos - kpos < window); logits capped before masking).
//
// The ring.  K / V blocks travel right (rank r -> r + 1) through slots in
// the symmetric workspace: at step s rank r consumes the block of rank
// r - s.  Step 0 reads the rank's own k / v where they lie; for s >= 1
// rank r's left neighbour copies the block it consumed at step s - 1 into
// rank r's slot s - 1, chunk by chunk (one (batch, kv-head) pair's K and V
// rows [c * chunk_rows, ...) per chunk), and sets an arrival flag per
// (slot, pair, chunk) to the call's epoch; one flag covers the chunk's K
// and V rows.  A compute item reading slot s - 1 waits on the flags of
// its pair alone.
//
// Backpressure.  The TPU kernel keeps two slots and a credit semaphore:
// a slot is reused every other step, so a sender must learn that the
// receiver has finished with it.  Here every rank holds W - 1 slots, one
// per step, each written once per call, so no slot is ever reused within
// a call and no credit is needed (and a block never waits on a compute:
// see the order below).  Between calls the entry barrier keeps a rank
// from writing into a peer that has not entered this call (on one card,
// the stream already orders the launches).  The price is memory:
// (W - 1) K / V blocks per rank, 25 MB per rank at the Llama-3-8B CP-4
// shape (S_loc 2048, B 1, Hkv 8).
//
// Schedule and deadlock freedom.  One cooperative launch of a flat grid,
// as many blocks as the card holds resident (one an SM), walking ONE item
// list over every folded rank, built on the host (`_ring_plan` in
// kernels/ring_attention.py): first every copy item (step by step, rank
// by rank), then every compute item (rank, pair, q tile) sorted heaviest
// first by its count of live key tiles over the W steps.  Block b takes
// items b, b + nb, ... in list order.  A copy item of step s >= 2 waits
// on the left rank's copy of step s - 1 (a lower index), a compute item
// waits on copies only, so every wait is on work that no block puts
// behind a wait of its own, and every block is resident.  A fixed share
// of blocks per rank (the design before) left the contiguous causal
// layout's last rank, with 2W - 1 times the first rank's live tiles,
// setting the time; one sorted list balances the ranks on one card.  On
// separate cards each rank walks its own list, so the contiguous
// layout's imbalance remains there, and zigzag is the reference's answer
// to it.
//
// Compute.  A block is three warpgroups: a producer and two consumers
// (setmaxnreg moves registers from the first to the others).  A q tile is
// 128 folded rows (the G = Hq / Hkv heads of one kv-head times BQ = 128 /
// G positions), 64 per consumer.  The producer's first thread brings the
// tile's Q (double-buffered, so the next item's Q arrives under this
// one's tail) and each live K / V tile of 128 keys by TMA into a
// two-stage ring of full / empty mbarriers; before a step s >= 1 the
// producer warpgroup waits on the step's arrival flags.  Each consumer
// computes S = Q K^T with wgmma.m64n128k16 (Q and K from shared memory,
// K-major), runs the online softmax on the accumulator registers in f32
// and base 2 (scale, soft-cap, then the mask only on tiles that
// `_block_full` says need it, each pass a loop of its own: interleaved
// per element, the common path ran 4x slower), rounds P to bf16 in
// registers (as the TPU kernel casts it to
// q's dtype) and issues O += P V with P as the register A operand and V's
// tile as the MN-major B.  The tile's (m, l, O) stay in registers across
// all W steps.  Dead key tiles (`_block_live` false: wholly in the
// future, or outside every row's window) are neither loaded nor computed,
// and a step with no live tile neither waits nor loads: under zigzag half
// the (q chunk, kv chunk) pairs are dead.  Positions come from `pos_of`
// per key and per row, so a tile may straddle zigzag's chunk seam (S_loc
// 384: 192-row chunks); liveness and fullness take the tile's first and
// last positions (pos_of is increasing along a shard).
//
// What bounds it on an H100: operations.  Causal attention over the
// whole sequence at Llama-3-8B CP 4 (W 4, S_loc 2048, Hq 32, D 128) is
// 4 * 32 * 8192^2 * 128 / 2 = 0.55 TFLOP per call, ~0.56 ms at 989
// TFLOP/s bf16; the ring moves W (W - 1) blocks of 8.4 MB, ~0.03 ms at
// 3.35 TB/s.  PERF.md has the measured time beside the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"
#include "sm90.cuh"

namespace {

using namespace tdt_sm90;
using bf16 = __nv_bfloat16;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int D = 128;         // head dim
constexpr int BM = 128;        // folded q rows per tile (64 per consumer)
constexpr int BN = 128;        // keys per tile
constexpr int ST = 2;          // K / V stages
constexpr int NT = 384;        // producer + two consumer warpgroups
constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float NEG_INF = -1.0e30f;
constexpr uint32_t Q_HALF = BM * 128;   // bytes of a tile's 64-column half
constexpr uint32_t KV_HALF = BN * 128;

struct Smem {
  bf16 q[2][2 * BM * 64];   // two Q buffers, each two swizzled halves
  bf16 k[ST][2 * BN * 64];
  bf16 v[ST][2 * BN * 64];
  uint64_t full[ST], empty[ST], qfull[2], qempty[2];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;  // + 1024-byte alignment

struct Params {
  CUtensorMap qmap;  // q: {D, S_loc, Hq, B, W}, box {64, BQ, G, 1, 1}
  CUtensorMap kmap;  // k: {D, S_loc, Hkv, B, W}, box {64, BN, 1, 1, 1}
  CUtensorMap vmap;
  CUtensorMap kslot_map[MAX_RANKS];  // rank r's {D, S_loc, B Hkv, W - 1}
  CUtensorMap vslot_map[MAX_RANKS];
  const bf16* k;  // rank-stacked [W][S_loc][B][Hkv][D] by the strides below
  const bf16* v;
  bf16* out;      // [W][S_loc][B][Hq][D] contiguous
  long long k_rs, k_ss, k_sb, k_sh;
  long long v_rs, v_ss, v_sb, v_sh;
  Peers<bf16> kslot;      // rank r's [W - 1][B * Hkv][S_loc][D]
  Peers<bf16> vslot;
  Peers<unsigned> flags;  // rank r's [W - 1][B * Hkv][n_rc]
  Peers<unsigned> bar;    // rank r's [W] barrier slots
  const int4* items;      // [n_items] (s, rank, pair, chunk or q tile)
  int n_items, n_copy;
  int world, s_loc, B, Hq, Hkv, G, BQ, chunk_rows, n_rc;
  int zigzag, causal, window;
  float scale, soft_cap;
  unsigned epoch;
};

// `_shard_starts`: global position of row i of rank `rank`'s shard
// (increasing in i).
__device__ __forceinline__ int pos_of(const Params& p, int rank, int i) {
  if (!p.zigzag) return rank * p.s_loc + i;
  const int c = p.s_loc / 2;
  return i < c ? rank * c + i : (2 * p.world - 1 - rank) * c + (i - c);
}

// Copy item: rows [r0, r1) of pair bh's K and V block that rank `me`
// consumed at step s - 1 into the right neighbour's slot s - 1, then the
// chunk's arrival flag there.  The whole block copies.
__device__ __forceinline__ void copy_item(const Params& p, int me, int s,
                                          int bh, int c) {
  const int BH = p.B * p.Hkv;
  const int right = (me + 1) % p.world;
  const long long blk = static_cast<long long>(p.s_loc) * D;
  const int r0 = c * p.chunk_rows;
  const int r1 = min(r0 + p.chunk_rows, p.s_loc);
  if (s >= 2)  // my slot s - 2 holds that block once the left rank's copy
    tdt_dist::wait(p.flags.p[me] + ((s - 2) * BH + bh) * p.n_rc + c,
                   p.epoch);
  bf16* dk = p.kslot.p[right] + ((s - 1) * BH + bh) * blk;
  bf16* dv = p.vslot.p[right] + ((s - 1) * BH + bh) * blk;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int n = (r1 - r0) * CHUNKS;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int row = r0 + i / CHUNKS, col = (i % CHUNKS) * 8;
    const bf16 *sk, *sv;
    if (s == 1) {
      sk = p.k + me * p.k_rs + row * p.k_ss + b * p.k_sb + h * p.k_sh + col;
      sv = p.v + me * p.v_rs + row * p.v_ss + b * p.v_sb + h * p.v_sh + col;
    } else {
      const long long off = ((s - 2) * BH + bh) * blk + row * D + col;
      sk = p.kslot.p[me] + off;
      sv = p.vslot.p[me] + off;
    }
    *reinterpret_cast<uint4*>(dk + row * D + col) =
        *reinterpret_cast<const uint4*>(sk);
    *reinterpret_cast<uint4*>(dv + row * D + col) =
        *reinterpret_cast<const uint4*>(sv);
  }
  fence_proxy_async_global();  // the receiver's TMA reads these rows
  tdt_dist::signal(p.flags.p[right] + ((s - 1) * BH + bh) * p.n_rc + c,
                   p.epoch);
}

// A compute item's q tile: rank me, pair bh = b Hkv + h, folded rows
// [0, 128) = head h G + r / BQ at local position q0 + r % BQ.
struct QTile {
  int me, bh, b, h, q0, n_rows, q_first, q_last;
};

__device__ __forceinline__ QTile q_tile(const Params& p, int4 w) {
  QTile t;
  t.me = w.y;
  t.bh = w.z;
  t.b = w.z / p.Hkv;
  t.h = w.z % p.Hkv;
  t.q0 = w.w * p.BQ;
  t.n_rows = min(p.BQ, p.s_loc - t.q0);
  t.q_first = pos_of(p, t.me, t.q0);
  t.q_last = pos_of(p, t.me, t.q0 + t.n_rows - 1);
  return t;
}

// `_block_live` of key tile t of rank src's block against the q tile.
__device__ __forceinline__ bool tile_live(const Params& p, const QTile& q,
                                          int src, int t) {
  const int k0 = t * BN, nk = min(BN, p.s_loc - k0);
  const int kf = pos_of(p, src, k0), kl = pos_of(p, src, k0 + nk - 1);
  return (!p.causal || kf <= q.q_last) &&
         (!p.window || kl > q.q_first - p.window);
}

__device__ __forceinline__ int next_live(const Params& p, const QTile& q,
                                         int src, int t) {
  const int n_kt = (p.s_loc + BN - 1) / BN;
  while (t < n_kt && !tile_live(p, q, src, t)) ++t;
  return t;
}

// The producer warpgroup: Q and every live K / V tile of this block's
// compute items, in the consumers' order.  Thread 0 issues the TMA loads;
// the warpgroup waits on a step's arrival flags together.
__device__ __forceinline__ void producer(const Params& p, Smem& sm, int it0) {
  const int tid = threadIdx.x;  // 0..127
  const int n_kt = (p.s_loc + BN - 1) / BN;
  const int BH = p.B * p.Hkv;
  Ring<ST> ring;
  Ring<2> qring;
  for (int it = it0; it < p.n_items; it += gridDim.x) {
    const QTile q = q_tile(p, p.items[it]);
    if (tid == 0) {
      const int st = qring.stage;
      mbar_wait(&sm.qempty[st], qring.phase ^ 1u);
      mbar_arrive_tx(&sm.qfull[st], 2 * Q_HALF);
      for (int hf = 0; hf < 2; ++hf)
        tma_load_5d(sm.q[st] + hf * BM * 64, &p.qmap, &sm.qfull[st], hf * 64,
                    q.q0, q.h * p.G, q.b, q.me);
    }
    qring.next();
    for (int s = 0; s < p.world; ++s) {
      const int src = (q.me - s + p.world) % p.world;
      int t = next_live(p, q, src, 0);
      if (t >= n_kt) continue;  // a dead block: no wait, no load
      if (s > 0) {
        if (tid < p.n_rc)
          tdt_dist::spin_until(
              p.flags.p[q.me] + ((s - 1) * BH + q.bh) * p.n_rc + tid,
              p.epoch);
        named_sync(1, 128);
        fence_proxy_async_global();
      }
      for (; t < n_kt; t = next_live(p, q, src, t + 1)) {
        if (tid == 0) {
          const int st = ring.stage;
          mbar_wait(&sm.empty[st], ring.phase ^ 1u);
          mbar_arrive_tx(&sm.full[st], 4 * KV_HALF);
          for (int hf = 0; hf < 2; ++hf) {
            bf16* dk = sm.k[st] + hf * BN * 64;
            bf16* dv = sm.v[st] + hf * BN * 64;
            if (s == 0) {
              tma_load_5d(dk, &p.kmap, &sm.full[st], hf * 64, t * BN, q.h,
                          q.b, q.me);
              tma_load_5d(dv, &p.vmap, &sm.full[st], hf * 64, t * BN, q.h,
                          q.b, q.me);
            } else {
              tma_load_4d(dk, &p.kslot_map[q.me], &sm.full[st], hf * 64,
                          t * BN, q.bh, s - 1);
              tma_load_4d(dv, &p.vslot_map[q.me], &sm.full[st], hf * 64,
                          t * BN, q.bh, s - 1);
            }
          }
        }
        ring.next();
      }
    }
  }
}

// A consumer warpgroup (cw = 0, 1): rows 64 cw .. 64 cw + 63 of each q
// tile, over every live K / V tile the producer brings, then its out rows.
__device__ __forceinline__ void consumer(const Params& p, Smem& sm, int it0,
                                         int cw) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int n_kt = (p.s_loc + BN - 1) / BN;
  const int S = p.s_loc;
  Ring<ST> ring;
  Ring<2> qring;
  for (int it = it0; it < p.n_items; it += gridDim.x) {
    const QTile q = q_tile(p, p.items[it]);
    // This thread's two rows: folded row, local index, global position.
    int row_i[2], row_pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 64 * cw + 16 * warp + gq + 8 * r;
      row_i[r] = q.q0 + row % p.BQ;
      row_pos[r] = row_i[r] < S ? pos_of(p, q.me, row_i[r]) : 0;
    }
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};
    float l_r[2] = {0.f, 0.f};

    const int qst = qring.stage;
    mbar_wait(&sm.qfull[qst], qring.phase);
    const bf16* sq = sm.q[qst] + cw * 64 * 64;  // this consumer's 64 rows

    for (int s = 0; s < p.world; ++s) {
      const int src = (q.me - s + p.world) % p.world;
      for (int t = next_live(p, q, src, 0); t < n_kt;
           t = next_live(p, q, src, t + 1)) {
        const int st = ring.stage;
        mbar_wait(&sm.full[st], ring.phase);
        const bf16* sk = sm.k[st];
        const bf16* sv = sm.v[st];

        // S[64 x 128] = Q K^T.
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n128<0>(sc, desc_k(sq, kk, Q_HALF),
                           desc_k(sk, kk, KV_HALF), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // Online softmax on this thread's two rows (`_block_update`) in
        // the base-2 domain (logits times log2(e), exp2): scale and cap
        // every logit, then mask the tiles that need it, each in a loop
        // of its own so the common path runs straight through.
        const int t0 = t * BN;
        const int k_first = pos_of(p, src, t0);
        const int k_last = pos_of(p, src, min(t0 + BN, S) - 1);
        const bool full =
            t0 + BN <= S && q.q0 + p.BQ <= S &&
            (!p.causal || q.q_first >= k_last) &&
            (!p.window || q.q_last - k_first < p.window);
        if (p.soft_cap > 0.f) {
          const float in = p.scale / p.soft_cap, out = p.soft_cap * LOG2E;
#pragma unroll
          for (int i = 0; i < 64; ++i) sc[i] = out * tanh_fast(sc[i] * in);
        } else {
          const float sl = p.scale * LOG2E;
#pragma unroll
          for (int i = 0; i < 64; ++i) sc[i] *= sl;
        }
        if (!full) {
          // Key positions: run 0 from local 0, zigzag's run 1 from split.
          const int split = p.zigzag ? S / 2 : S;
          const int run0 = pos_of(p, src, 0);
          const int run1 = p.zigzag ? pos_of(p, src, split) - split : 0;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int key = t0 + 8 * j + 2 * tq + (e & 1);
              const int kpos = key + (key < split ? run0 : run1);
              const bool vis = row_i[r] < S && key < S &&
                               (!p.causal || row_pos[r] >= kpos) &&
                               (!p.window || row_pos[r] - kpos < p.window);
              if (!vis) sc[4 * j + e] = NEG_INF;
            }
          }
        }
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < 64; ++i)
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
          alpha[r] = exp2_approx(m_r[r] - m_new);
          m_r[r] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int r = (i >> 1) & 1;
          const float x = sc[i];
          const float pe = x > 0.5f * NEG_INF ? exp2_approx(x - m_r[r]) : 0.f;
          sum[r] += pe;
          sc[i] = pe;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];

        // O[64 x 128] += P[64 x 128] V[128 x 128], P in registers.
        unsigned pa[BN / 16][4];
#pragma unroll
        for (int ks = 0; ks < BN / 16; ++ks) acc_to_a(pa[ks], sc, ks);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BN / 16; ++ks)
          wgmma_rs_n128<1>(o, pa[ks], desc_mn(sv, ks, KV_HALF), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int ks = 0; ks < BN / 16; ++ks) fence_regs(pa[ks]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[st]);
        ring.next();
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.qempty[qst]);
    qring.next();

    // out = O / l in bf16 (a row with nothing visible stays 0).
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_r[r]);
      const int row = 64 * cw + 16 * warp + gq + 8 * r;
      const int i = row_i[r];
      if (i >= S) continue;
      const long long o_row =
          ((static_cast<long long>(q.me) * S + i) * p.B + q.b) * p.Hq +
          q.h * p.G + row / p.BQ;
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      bf16* dst = p.out + o_row * D + 2 * tq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
ring_attn_kernel(const __grid_constant__ Params p) {
  extern __shared__ char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], 8);  // every consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&sm.qfull[i], 1);
      mbar_init(&sm.qempty[i], 8);
    }
    mbar_fence_init();
  }
  // The entry barrier of every rank this launch serves (barrier_all's
  // protocol: thread (me, peer) marks me's arrival at peer and waits for
  // peer's at me).
  if (tid < p.world * p.world) {
    const int me = tid / p.world, peer = tid % p.world;
    tdt_dist::st_release(p.bar.p[peer] + me, p.epoch);
    tdt_dist::spin_until(p.bar.p[me] + peer, p.epoch);
  }
  __syncthreads();

  // Copy items first, by the whole block.
  int it = blockIdx.x;
  for (; it < p.n_copy; it += gridDim.x) {
    const int4 w = p.items[it];
    copy_item(p, w.y, w.x, w.z, w.w);
    __syncthreads();
  }
  // Then this block's compute items, warp-specialised.
  if (tid < 128) {
    regs_dealloc<PRODUCER_REGS>();
    producer(p, sm, it);
  } else {
    regs_alloc<CONSUMER_REGS>();
    consumer(p, sm, it, tid / 128 - 1);
  }
}

}  // namespace

// One call for every rank of a world of `world` (1..8).  q / k / v: base
// pointers of the rank-stacked inputs with their (rank, position, batch,
// head) strides in elements (unit head-dim stride, 16-byte aligned rows);
// out [W][S_loc][B][Hq][128] bf16 contiguous.  kslot / vslot / flags /
// bar: pointer tables of `world` addresses (slots [W - 1][B Hkv][S_loc]
// [128] bf16, flags [W - 1][B Hkv][n_rc], barrier [W]); a chunk is
// chunk_rows rows, n_rc = ceil(S_loc / chunk_rows) <= 128.  items: the
// item list [n_items][4] int32 on the card (`_ring_plan`), its first
// n_copy the copy items.  Zigzag needs (S_loc / 2) % 64 == 0.  epoch:
// this call's, from the workspace.
extern "C" int tdt_ring_attn(
    const void* q, const void* k, const void* v, void* out, long long q_rs,
    long long q_ss, long long q_sb, long long q_sh, long long k_rs,
    long long k_ss, long long k_sb, long long k_sh, long long v_rs,
    long long v_ss, long long v_sb, long long v_sh, const long long* kslot,
    const long long* vslot, const long long* flags, const long long* bar,
    const void* items, int n_items, int n_copy, int world, int s_loc, int B,
    int Hq, int Hkv, int chunk_rows, int n_rc, int zigzag, int causal,
    int window, float scale, float soft_cap, unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || s_loc < 1 || B < 1 || Hkv < 1 ||
      Hq % Hkv || 64 % (Hq / Hkv) || chunk_rows < 1 || n_rc > 128 ||
      n_rc != (s_loc + chunk_rows - 1) / chunk_rows ||
      (zigzag && (s_loc / 2) % 64) || n_items < 1 || n_copy < 0 ||
      n_copy > n_items)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.k_rs = k_rs; p.k_ss = k_ss; p.k_sb = k_sb; p.k_sh = k_sh;
  p.v_rs = v_rs; p.v_ss = v_ss; p.v_sb = v_sb; p.v_sh = v_sh;
  p.kslot = peers<bf16>(kslot, world);
  p.vslot = peers<bf16>(vslot, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.items = static_cast<const int4*>(items);
  p.n_items = n_items;
  p.n_copy = n_copy;
  p.world = world;
  p.s_loc = s_loc;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.BQ = BM / p.G;
  p.chunk_rows = chunk_rows;
  p.n_rc = n_rc;
  p.zigzag = zigzag;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.soft_cap = soft_cap;
  p.epoch = epoch;

  // Tensor maps: q / k / v by their strides, each rank's slots.
  const long long qd[5] = {D, s_loc, Hq, B, world};
  const long long qs[5] = {1, q_ss, q_sh, q_sb, q_rs};
  const int qbox[5] = {64, p.BQ, p.G, 1, 1};
  const long long kd[5] = {D, s_loc, Hkv, B, world};
  const long long ks[5] = {1, k_ss, k_sh, k_sb, k_rs};
  const long long vs[5] = {1, v_ss, v_sh, v_sb, v_rs};
  const int kbox[5] = {64, BN, 1, 1, 1};
  int err = make_map(&p.qmap, q, 5, qd, qs, qbox);
  if (!err) err = make_map(&p.kmap, k, 5, kd, ks, kbox);
  if (!err) err = make_map(&p.vmap, v, 5, kd, vs, kbox);
  if (world > 1) {
    const long long sd[4] = {D, s_loc, static_cast<long long>(B) * Hkv,
                             world - 1};
    const long long ss[4] = {1, D, static_cast<long long>(s_loc) * D,
                             static_cast<long long>(B) * Hkv * s_loc * D};
    for (int r = 0; r < world && !err; ++r) {
      err = make_map(&p.kslot_map[r], p.kslot.p[r], 4, sd, ss, kbox);
      if (!err) err = make_map(&p.vslot_map[r], p.vslot.p[r], 4, sd, ss, kbox);
    }
  }
  if (err) return err;
  static unsigned attr = 0;
  return tdt_dist::launch_coop_flat(ring_attn_kernel, p, NT,
                                    static_cast<int>(SMEM_BYTES), n_items,
                                    attr, static_cast<cudaStream_t>(stream));
}
