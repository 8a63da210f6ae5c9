// ring_attn: fused ring attention for Hopper (sm_90a), over the
// distributed verbs of dist_verbs.cuh.
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
// and V rows.  A block computing on slot s - 1 waits on the flags of its
// pair alone.
//
// Backpressure.  The TPU kernel keeps two slots and a credit semaphore:
// a slot is reused every other step, so a sender must learn that the
// receiver has finished with it.  Here every rank holds W - 1 slots, one
// per step, each written once per call, so no slot is ever reused within
// a call and no credit is needed (and a block never waits on a compute:
// see the order below).  Between calls the entry barrier_all keeps a
// rank from writing into a peer that has not entered this call (on one
// card, the stream already orders the launches).  The price is memory:
// (W - 1) K / V blocks per rank, 25 MB per rank at the Llama-3-8B CP-4
// shape (S_loc 2048, B 1, Hkv 8).
//
// Order and deadlock freedom.  One cooperative launch, a 2-D grid
// (blockIdx.y = rank), every block resident and persistent, walking its
// rank's items in one list: first every copy item (step by step), then
// every compute item (a q tile).  A copy item of step s >= 2 waits on the
// left rank's copy of step s - 1 (a lower index in the same list order),
// a compute item waits on copies only, so every wait is on work that no
// block puts behind a wait of its own.  With tile-outer order and two
// slots a slot would never be released while tiles wait on the block
// after it; W slots and copies first remove that cycle.
//
// Compute.  The flash_fwd.cu design: a q tile of 64 folded rows (the
// G = Hq / Hkv heads of one kv-head times BQ = 64 / G positions), 4
// warps of 16 rows, Q fragments in registers, S = Q K^T and O += P V as
// mma.sync.m16n8k16 bf16 products with f32 accumulation, P rounded to
// bf16 (as the TPU kernel casts it to q's dtype), K / V tiles of 64 keys
// through a two-stage cp.async ring.  The tile's (m, l, O) stay in
// registers across all W steps (tile-outer order).  Dead key tiles
// (`_block_live` false: wholly in the future, or outside every row's
// window) are skipped, and a step with no live tile neither waits nor
// loads: under zigzag half the (q chunk, kv chunk) pairs are dead.
// Wholly visible tiles drop the per-element mask (`_block_full`).
//
// What bounds it on an H100: operations.  Causal attention over the
// whole sequence at Llama-3-8B CP 4 (W 4, S_loc 2048, Hq 32, D 128) is
// 4 * 32 * 8192^2 * 128 / 2 = 0.55 TFLOP per call, ~0.56 ms at 989
// TFLOP/s bf16; the ring moves W (W - 1) blocks of 8.4 MB, ~0.03 ms at
// 3.35 TB/s.  wgmma, TMA and a dynamic tile queue are later steps
// (PERF.md has the measured time beside the bound).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"
#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int D = 128;         // head dim
constexpr int BM = 64;         // folded q rows per tile (16 per warp)
constexpr int BN = 64;         // keys per tile
constexpr int NT = 128;        // 4 warps
constexpr int LD = D + 8;      // bf16 row stride in shared memory (272 B)
constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
constexpr float NEG_INF = -1.0e30f;
constexpr size_t SMEM_BYTES = static_cast<size_t>(BM + 4 * BN) * LD * 2;

struct Params {
  const bf16* q;  // rank-stacked [W][S_loc][B][Hq][D] by the strides below
  const bf16* k;
  const bf16* v;
  bf16* out;      // [W][S_loc][B][Hq][D] contiguous
  long long q_rs, q_ss, q_sb, q_sh;  // rank, position, batch, head strides
  long long k_rs, k_ss, k_sb, k_sh;
  long long v_rs, v_ss, v_sb, v_sh;
  Peers<bf16> kslot;      // rank r's [W - 1][B * Hkv][S_loc][D]
  Peers<bf16> vslot;
  Peers<unsigned> flags;  // rank r's [W - 1][B * Hkv][n_rc]
  Peers<unsigned> bar;    // rank r's [W] barrier slots
  int world, s_loc, B, Hq, Hkv, G, BQ, chunk_rows, n_rc;
  int zigzag, causal, window;
  float scale, soft_cap;
  unsigned epoch;
};

// `_shard_starts`: global position of row i of rank `rank`'s shard.
__device__ inline int pos_of(const Params& p, int rank, int i) {
  if (!p.zigzag) return rank * p.s_loc + i;
  const int c = p.s_loc / 2;
  return i < c ? rank * c + i : (2 * p.world - 1 - rank) * c + (i - c);
}

// Copy item: rows [r0, r1) of pair bh's K and V block that rank `me`
// consumed at step s - 1 into the right neighbour's slot s - 1, then the
// chunk's arrival flag there.
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
  tdt_dist::signal(p.flags.p[right] + ((s - 1) * BH + bh) * p.n_rc + c,
                   p.epoch);
}

// Compute item: q tile qt of pair bh over all W steps, then its out rows.
__device__ __forceinline__ void compute_item(const Params& p, int me,
                                             int bh, int qt, char* smem_raw) {
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* sK = sQ + BM * LD;                       // [2][BN][LD]
  bf16* sV = sK + 2 * BN * LD;                   // [2][BN][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int BH = p.B * p.Hkv;
  const int b = bh / p.Hkv, h = bh % p.Hkv;
  const int S = p.s_loc;
  const int q0 = qt * p.BQ;
  const int n_rows = min(p.BQ, S - q0);
  const int q_first = pos_of(p, me, q0);
  const int q_last = q_first + n_rows - 1;
  const int n_kt = (S + BN - 1) / BN;

  // Q tile: folded row r is head h * G + r / BQ at position q0 + r % BQ.
#pragma unroll
  for (int i = 0; i < BM * CHUNKS / NT; ++i) {
    const int j = tid + i * NT, r = j / CHUNKS, c = j % CHUNKS;
    const int qi = q0 + r % p.BQ;
    cp_async16(sQ + r * LD + c * 8,
               qi < S ? p.q + me * p.q_rs + qi * p.q_ss + b * p.q_sb +
                            (h * p.G + r / p.BQ) * p.q_sh + c * 8
                      : nullptr,
               p.q);
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  unsigned qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) load_a(qf[kk], sQ, LD, warp * 16, kk * 16);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int s = 0; s < p.world; ++s) {
    const int src = (me - s + p.world) % p.world;
    auto live = [&](int t) {
      const int kf = pos_of(p, src, t * BN), nk = min(BN, S - t * BN);
      return (!p.causal || kf <= q_last) &&
             (!p.window || kf + nk - 1 > q_first - p.window);
    };
    auto next_live = [&](int t) {
      while (t < n_kt && !live(t)) ++t;
      return t;
    };
    int t = next_live(0);
    if (t >= n_kt) continue;  // a dead block: no wait, no load

    const bf16 *kb, *vb;
    long long k_ss, v_ss;
    if (s == 0) {
      kb = p.k + me * p.k_rs + b * p.k_sb + h * p.k_sh;
      vb = p.v + me * p.v_rs + b * p.v_sb + h * p.v_sh;
      k_ss = p.k_ss;
      v_ss = p.v_ss;
    } else {
      tdt_dist::wait(p.flags.p[me] + ((s - 1) * BH + bh) * p.n_rc, p.epoch,
                     p.n_rc);
      const long long off = ((s - 1) * BH + bh) * static_cast<long long>(S) * D;
      kb = p.kslot.p[me] + off;
      vb = p.vslot.p[me] + off;
      k_ss = v_ss = D;
    }
    auto load_kv = [&](int t0, int buf) {
      bf16* dk = sK + buf * BN * LD;
      bf16* dv = sV + buf * BN * LD;
#pragma unroll
      for (int i = 0; i < BN * CHUNKS / NT; ++i) {
        const int j = tid + i * NT, r = j / CHUNKS, c = j % CHUNKS;
        const int key = t0 + r;
        const bool ok = key < S;
        cp_async16(dk + r * LD + c * 8, ok ? kb + key * k_ss + c * 8 : nullptr,
                   p.k);
        cp_async16(dv + r * LD + c * 8, ok ? vb + key * v_ss + c * 8 : nullptr,
                   p.k);
      }
    };
    load_kv(t * BN, 0);
    cp_commit();
    for (int it = 0; t < n_kt; ++it) {
      const int t0 = t * BN, buf = it & 1;
      const int tn = next_live(t + 1);
      if (tn < n_kt) {
        load_kv(tn * BN, buf ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* k_t = sK + buf * BN * LD;
      const bf16* v_t = sV + buf * BN * LD;

      // S[16 x 64] = Q K^T.
      float sc[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < BN / 16; ++jp) {
          unsigned kf[4];
          load_b_nk(kf, k_t, LD, jp * 16, kk * 16);
          mma16816(sc[2 * jp], qf[kk], kf[0], kf[1]);
          mma16816(sc[2 * jp + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // Online softmax on this thread's two rows (`_block_update`).
      const int k_first = pos_of(p, src, t0);
      const bool full =
          t0 + BN <= S && q0 + p.BQ <= S &&
          (!p.causal || q_first >= k_first + BN - 1) &&
          (!p.window || q_last - k_first < p.window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * p.scale;
          if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
          if (!full) {
            const int row = warp * 16 + gq + (e >> 1) * 8;
            const int i = q0 + row % p.BQ;
            const int kc = j * 8 + 2 * tq + (e & 1);
            const int qpos = q_first + row % p.BQ, kpos = k_first + kc;
            const bool vis = i < S && t0 + kc < S &&
                             (!p.causal || qpos >= kpos) &&
                             (!p.window || qpos - kpos < p.window);
            if (!vis) x = NEG_INF;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
        alpha[r] = expf(m_r[r] - m_new);
        m_r[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[j][e];
          const float pe = x > 0.5f * NEG_INF ? expf(x - m_r[e >> 1]) : 0.f;
          sum[e >> 1] += pe;
          sc[j][e] = pe;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O[16 x 128] += P[16 x 64] V[64 x 128].
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks) {
        unsigned a[4];
        acc_to_a(a, sc, ks);
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
          unsigned vf[4];
          load_b_kn(vf, v_t, LD, ks * 16, jp * 16);
          mma16816(o[2 * jp], a, vf[0], vf[1]);
          mma16816(o[2 * jp + 1], a, vf[2], vf[3]);
        }
      }
      __syncthreads();  // every warp is done with buf before it refills
      t = tn;
    }
  }

  // out = O / l in bf16 (a row with nothing visible stays 0).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const int row = warp * 16 + gq + r * 8;
    const int i = q0 + row % p.BQ;
    if (i >= S) continue;
    const long long o_row =
        ((static_cast<long long>(me) * S + i) * p.B + b) * p.Hq + h * p.G +
        row / p.BQ;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    bf16* dst = p.out + o_row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

__global__ void __launch_bounds__(NT, 2)
ring_attn_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  const int BH = p.B * p.Hkv;
  const int n_copy = (p.world - 1) * BH * p.n_rc;
  const int n_qt = (p.s_loc + p.BQ - 1) / p.BQ;
  const int n_items = n_copy + BH * n_qt;
  for (int it = lb; it < n_items; it += nb) {
    if (it < n_copy) {
      const int per_step = BH * p.n_rc;
      copy_item(p, me, 1 + it / per_step, (it % per_step) / p.n_rc,
                it % p.n_rc);
    } else {
      const int c = it - n_copy;
      compute_item(p, me, c / n_qt, c % n_qt, smem_raw);
    }
    __syncthreads();  // shared memory and flags are free for the next item
  }
}

}  // namespace

// One call for every rank of a world of `world` (1..8).  q / k / v: base
// pointers of the rank-stacked inputs with their (rank, position, batch,
// head) strides in elements (unit head-dim stride, 16-byte aligned rows);
// out [W][S_loc][B][Hq][128] bf16 contiguous.  kslot / vslot / flags /
// bar: pointer tables of `world` addresses (slots [W - 1][B Hkv][S_loc]
// [128] bf16, flags [W - 1][B Hkv][n_rc], barrier [W]); a chunk is
// chunk_rows rows, n_rc = ceil(S_loc / chunk_rows) <= 128.  Zigzag needs
// (S_loc / 2) % 64 == 0.  epoch: this call's, from the workspace.
extern "C" int tdt_ring_attn(
    const void* q, const void* k, const void* v, void* out, long long q_rs,
    long long q_ss, long long q_sb, long long q_sh, long long k_rs,
    long long k_ss, long long k_sb, long long k_sh, long long v_rs,
    long long v_ss, long long v_sb, long long v_sh, const long long* kslot,
    const long long* vslot, const long long* flags, const long long* bar,
    int world, int s_loc, int B, int Hq, int Hkv, int chunk_rows, int n_rc,
    int zigzag, int causal, int window, float scale, float soft_cap,
    unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || s_loc < 1 || B < 1 || Hkv < 1 ||
      Hq % Hkv || BM % (Hq / Hkv) || chunk_rows < 1 || n_rc > NT ||
      n_rc != (s_loc + chunk_rows - 1) / chunk_rows ||
      (zigzag && (s_loc / 2) % BN))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.out = static_cast<bf16*>(out);
  p.q_rs = q_rs; p.q_ss = q_ss; p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_rs = k_rs; p.k_ss = k_ss; p.k_sb = k_sb; p.k_sh = k_sh;
  p.v_rs = v_rs; p.v_ss = v_ss; p.v_sb = v_sb; p.v_sh = v_sh;
  p.kslot = peers<bf16>(kslot, world);
  p.vslot = peers<bf16>(vslot, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
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
  const int BH = B * Hkv;
  const int items = (world - 1) * BH * n_rc + BH * ((s_loc + p.BQ - 1) / p.BQ);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ring_attn_kernel, p, NT,
                               static_cast<int>(SMEM_BYTES), world, items,
                               attr, static_cast<cudaStream_t>(stream));
}
