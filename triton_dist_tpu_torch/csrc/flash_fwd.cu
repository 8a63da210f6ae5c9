// flash_fwd: GQA flash-attention forward for Hopper (sm_90a), bf16 and
// int8 K/V.
//
// Replaces the TPU kernels triton_dist_tpu/kernels/flash_attention.py
// `_flash_kernel` (:116, launched from `_flash_pallas`; here
// `flash_fwd_wg_kernel`) and `_flash_kernel_i8` (:209; here
// `flash_fwd_i8_kernel`).  Same contract: q [B, Hq, Sq, D], k/v [B, Hkv,
// Sk, D] in bf16 (int8 with f32 scales for the twin; any b/h/s strides,
// unit d stride) -> out [B, Hq, Sq, D] bf16 plus lse [B, Hq, Sq] f32 in
// natural log (the backward kernels read it); global positions q_offset +
// i and kv_offset + j; causal, sliding window, soft-cap; rows with nothing
// visible give out 0 and lse NEG_INF.
//
// Segmented positions (the zigzag context-parallel shard: rows made of
// several position runs) ride per-block start vectors, as the TPU
// kernel's scalar-prefetch `qoffs` / `koffs` do: qoffs [B][Sq / SEG] and
// koffs [B][Sk / SEG] int32 (batch stride qoffs_sb / koffs_sb, 0 to share
// one vector) give the global position of row SEG j, and rows within a
// block of SEG are contiguous.  Each batch row has its own vectors, so the
// W ranks of one ring step fold into the batch and one launch serves
// them all.  A null vector is the contiguous closed form
// q_offset + i / kv_offset + j.  SEGM (a start vector on either side) is
// its own instantiation of each kernel, so the serving and training
// launches pay nothing for the segmented mode.
//
// What bounds it on an H100: causal prefill at the main path's shapes
// (Sq 512..2048, Hq 32, D 128) does 4 * D * Hq flops a visible (query,
// key) pair against (q + k + v + out) bytes, far above the card's 295
// flop/byte balance, so the tensor cores bound it (989 TFLOP/s bf16
// dense).  PERF.md has the measured time beside the bound.
//
// The bf16 kernel (`flash_fwd_wg_kernel`) runs on the wgmma / TMA pieces
// of sm90.cuh and the consumer tile body of attn_tile.cuh (ring_attn.cu's
// body, lifted out; that kernel keeps its copy, see the header).  One block per (q tile, kv-head, batch) is three
// warpgroups: a producer and two consumers (setmaxnreg moves registers
// from the first to the others).  As on the TPU the q tile folds all G =
// Hq / Hkv heads of the group into its rows (row r = g * BQ + i, 128
// rows, BQ = 128 / G positions, 64 rows a consumer), so every K/V tile
// read from device memory serves the whole group; TMA brings it as one
// box {64, BQ, G, 1} over (d, s, hq, b) per 64-column half, rows past Sq
// read as zeros and are never stored.  The producer's first thread then
// brings each live 128-key K / V tile by TMA into a two-stage ring of
// full / empty mbarriers.  Each consumer computes S = Q K^T with
// wgmma.m64n128k16, runs the online softmax in f32 and base 2, and
// issues O += P V with P rounded to bf16 in registers as the A operand
// (attn_tile.cuh), and stores out = O / l and lse = (m2 + log2 l) ln 2.
// The key loop visits only live tiles (`_block_live`: for contiguous keys
// the causal and window bounds give the tile range directly; segmented
// keys test each tile) and drops the per-element mask on tiles that are
// wholly visible (`_block_full`).  A 128-key tile spans two start-vector
// entries (and at G = 1 a q tile two as well), so liveness and fullness
// take the least and the largest position over the entries a tile covers
// (the last position need not follow the first), and the mask reads a
// key's position as one of two runs that meet at the entries' seam.
// TMA reads keys past Sk as zeros, which would score 0, so a ragged last
// tile is never `_block_full` and takes the mask.  Under causal masking
// late q tiles carry the most key tiles: blocks are ordered heaviest
// first, the last q tile of every (batch, kv-head) before the one before
// it.  The tensor maps are encoded on the host at each call (by value in
// the kernel's parameters, so a CUDA graph replays them).
//
// The int8 kernel (`flash_fwd_i8_kernel`: chunked prefill against an int8
// cache, forward only) keeps the Ampere design: one block of 4 warps per
// (64-row q tile, kv-head, batch), the q tile folding the group (BQ = 64
// / G), each warp 16 query rows with their fragments, score tile,
// accumulator and softmax statistics in registers (FlashAttention-2);
// S = Q K^T and O += P V are `mma.sync.m16n8k16` bf16 products fed by
// `ldmatrix`.  The int8 K/V tiles and their per-position f32 scales [B,
// Hkv, Sk] stream through a two-stage cp.async ring (half the bytes), and
// each tile converts to bf16 in shared memory ahead of the mma.sync path
// (|q| <= 127 is exact in bf16).  K's scale applies per S column after
// Q K^T: a thread's C fragment holds columns 2 (lane % 4) + {0, 1} + 8 j,
// whose scales it reads from shared memory; V's scale folds into P before
// P is rounded to the bf16 A fragment of P V, where the TPU kernel
// rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int SEG = 64;  // positions per entry of a start vector

// Global position of local row i of batch row b (see the header).
__device__ inline int pos_of(const int* offs, long long sb, int base, int b,
                             int i) {
  return offs ? offs[b * sb + i / SEG] + i % SEG : base + i;
}

// ------------------------------------------------------- the bf16 kernel

namespace wg {

using namespace tdt_attn;

constexpr int BM = 128;   // folded q rows per tile (64 per consumer)
constexpr int ST = 2;     // K / V stages
constexpr int NT = 384;   // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

struct Smem {
  bf16 q[2 * BM * 64];  // two swizzled halves
  bf16 k[ST][2 * BN * 64];
  bf16 v[ST][2 * BN * 64];
  uint64_t qfull, full[ST], empty[ST];
};
constexpr size_t SMEM_BYTES = sizeof(Smem) + 1024;  // + 1024-byte alignment

struct Params {
  CUtensorMap qmap;  // q: {D, Sq, Hq, B}, box {64, BQ, G, 1}
  CUtensorMap kmap;  // k: {D, Sk, Hkv, B}, box {64, BN, 1, 1}
  CUtensorMap vmap;
  bf16* out;         // [B, Hq, Sq, D] contiguous
  float* lse;        // [B, Hq, Sq]
  int B, Sq, Sk, Hq, Hkv, G, BQ, n_qt;
  const int* qoffs;  // [B][Sq / SEG] block starts, or null (contiguous)
  const int* koffs;  // [B][Sk / SEG]
  long long qoffs_sb, koffs_sb;
  int q_offset, kv_offset;
  Mask mk;
};

// Least and largest position of local rows [i0, i0 + n) of one side: the
// contiguous closed form, or the min / max over the start-vector entries
// they span.
template <bool SEGM>
__device__ __forceinline__ int2 pos_range(const int* offs, long long sb,
                                          int base, int b, int i0, int n) {
  if (!SEGM || !offs) return make_int2(base + i0, base + i0 + n - 1);
  int lo = 0x7fffffff, hi = -0x7fffffff;
  for (int e = i0 / SEG; e <= (i0 + n - 1) / SEG; ++e) {
    const int a = max(i0, e * SEG), z = min(i0 + n, (e + 1) * SEG) - 1;
    const int st = offs[b * sb + e] - e * SEG;
    lo = min(lo, st + a);
    hi = max(hi, st + z);
  }
  return make_int2(lo, hi);
}

// A block's q tile and the range of key tiles it may visit.
struct QTile {
  int b, h, q0, n_rows, t_begin, t_end;
  int2 qr;  // least / largest position of its rows
};

template <bool SEGM>
__device__ __forceinline__ QTile q_tile(const Params& p) {
  QTile t;
  const int BH = p.B * p.Hkv;
  // heaviest first: the last q tile of every (batch, kv-head) leads
  const int x = p.n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = blockIdx.x % BH;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.q0 = x * p.BQ;
  t.n_rows = min(p.BQ, p.Sq - t.q0);
  t.qr = pos_range<SEGM>(p.qoffs, p.qoffs_sb, p.q_offset, t.b, t.q0,
                         t.n_rows);
  t.t_begin = 0;
  t.t_end = (p.Sk + BN - 1) / BN;
  if (!SEGM || !p.koffs) {  // contiguous keys: the closed-form live range
    int hi = p.Sk;
    if (p.mk.causal) hi = min(hi, t.qr.y - p.kv_offset + 1);
    int lo = 0;
    if (p.mk.window) lo = max(lo, t.qr.x - p.mk.window + 1 - p.kv_offset);
    t.t_begin = lo / BN;
    t.t_end = hi > t.t_begin * BN ? (hi + BN - 1) / BN : t.t_begin;
  }
  return t;
}

// Least / largest position of key tile kt's keys.
template <bool SEGM>
__device__ __forceinline__ int2 key_range(const Params& p, int b, int kt) {
  const int k0 = kt * BN;
  return pos_range<SEGM>(p.koffs, p.koffs_sb, p.kv_offset, b, k0,
                         min(BN, p.Sk - k0));
}

// `_block_live` / `_block_full` of a q range against a key range.
__device__ __forceinline__ bool live(const Mask& mk, int2 q, int2 k) {
  return (!mk.causal || k.x <= q.y) && (!mk.window || k.y > q.x - mk.window);
}
__device__ __forceinline__ bool full(const Mask& mk, int2 q, int2 k) {
  return (!mk.causal || q.x >= k.y) && (!mk.window || q.y - k.x < mk.window);
}

// The first live key tile at or after kt (contiguous keys: every tile of
// the closed-form range is live).
template <bool SEGM>
__device__ __forceinline__ int next_live(const Params& p, const QTile& t,
                                         int kt) {
  if constexpr (!SEGM) return kt;
  if (!p.koffs) return kt;
  for (; kt < t.t_end; ++kt)
    if (live(p.mk, t.qr, key_range<SEGM>(p, t.b, kt))) break;
  return kt;
}

// The producer's first thread: Q once, then every live K / V tile.
template <bool SEGM>
__device__ __forceinline__ void producer(const Params& p, Smem& sm) {
  if (threadIdx.x != 0) return;
  const QTile t = q_tile<SEGM>(p);
  int kt = next_live<SEGM>(p, t, t.t_begin);
  if (kt >= t.t_end) return;  // nothing visible: the consumers store zeros
  mbar_arrive_tx(&sm.qfull, 2 * HALF);
  for (int hf = 0; hf < 2; ++hf)
    tma_load_4d(sm.q + hf * BM * 64, &p.qmap, &sm.qfull, hf * 64, t.q0,
                t.h * p.G, t.b);
  Ring<ST> ring;
  for (; kt < t.t_end; kt = next_live<SEGM>(p, t, kt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.empty[st], ring.phase ^ 1u);
    mbar_arrive_tx(&sm.full[st], 4 * HALF);
    for (int hf = 0; hf < 2; ++hf) {
      tma_load_4d(sm.k[st] + hf * BN * 64, &p.kmap, &sm.full[st], hf * 64,
                  kt * BN, t.h, t.b);
      tma_load_4d(sm.v[st] + hf * BN * 64, &p.vmap, &sm.full[st], hf * 64,
                  kt * BN, t.h, t.b);
    }
    ring.next();
  }
}

// A consumer warpgroup (cw = 0, 1): folded rows 64 cw .. 64 cw + 63.
template <bool SEGM>
__device__ __forceinline__ void consumer(const Params& p, Smem& sm, int cw) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2;
  const QTile t = q_tile<SEGM>(p);

  // This thread's two rows: local index, global position.
  int row_i[2], row_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 64 * cw + 16 * warp + gq + 8 * r;
    row_i[r] = t.q0 + row % p.BQ;
    row_pos[r] = row_i[r] < p.Sq
                     ? pos_of(SEGM ? p.qoffs : nullptr, p.qoffs_sb,
                              p.q_offset, t.b, row_i[r])
                     : 0;
  }
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};
  const bf16* sq = sm.q + cw * 64 * 64;  // this consumer's 64 rows

  Ring<ST> ring;
  int kt = next_live<SEGM>(p, t, t.t_begin);
  if (kt < t.t_end) mbar_wait(&sm.qfull, 0);
  for (; kt < t.t_end; kt = next_live<SEGM>(p, t, kt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.full[st], ring.phase);
    const int t0 = kt * BN;
    const int2 kr = key_range<SEGM>(p, t.b, kt);
    const bool whole = t.q0 + p.BQ <= p.Sq && t0 + BN <= p.Sk &&
                       full(p.mk, t.qr, kr);
    // Key positions: the tile's first start-vector entry runs up to
    // split, the second from it (contiguous keys: one run).
    int split = p.Sk, run0 = p.kv_offset, run1 = p.kv_offset;
    if (SEGM && p.koffs && !whole) {  // read by the mask pass only
      const long long e = static_cast<long long>(t.b) * p.koffs_sb + t0 / SEG;
      split = t0 + SEG;
      run0 = p.koffs[e] - t0;
      run1 = split < p.Sk ? p.koffs[e + 1] - split : 0;
    }
    tile_step(o, m_r, l_r, sq, sm.k[st], sm.v[st], whole, row_i, row_pos,
              p.Sq, t0, p.Sk, split, run0, run1, p.mk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[st]);
    ring.next();
  }

  // out = O / l in bf16, lse = (m2 + log2 l) ln 2 (NEG_INF when empty).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const int row = 64 * cw + 16 * warp + gq + 8 * r;
    if (row_i[r] >= p.Sq) continue;
    const long long o_row =
        (static_cast<long long>(t.b) * p.Hq + t.h * p.G + row / p.BQ) *
            p.Sq + row_i[r];
    store_row(o, r, l, p.out + o_row * D);
    if ((lane & 3) == 0)
      p.lse[o_row] = l > 0.f ? (m_r[r] + log2f(l)) * LN2 : NEG_INF;
  }
}

template <bool SEGM>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wg_kernel(const __grid_constant__ Params p) {
  extern __shared__ char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
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
    producer<SEGM>(p, sm);
  } else {
    regs_alloc<CONSUMER_REGS>();
    consumer<SEGM>(p, sm, threadIdx.x / 128 - 1);
  }
}

template <bool SEGM>
int launch(const Params& p, void* stream) {
  // once per device, process and instantiation (outside graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wg_kernel<SEGM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  flash_fwd_wg_kernel<SEGM><<<p.n_qt * p.Hkv * p.B, NT, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// ------------------------------------------------------- the int8 kernel

namespace i8 {

using namespace tdt_frag;

constexpr int D = 128;       // head dim
constexpr int BM = 64;       // q-tile rows (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int NT = 128;      // 4 warps
constexpr int LD = D + 8;    // bf16 row stride in shared memory (272 B)
constexpr int LD8 = D + 16;  // int8 staging row stride (bytes)
constexpr float NEG_INF = -1.0e30f;  // finite -inf proxy, as on the TPU

// This field order (k / v also as bf16 pointers) is kept for ptxas's
// register assignment: without the two pointers it assigned others and
// the kernel ran ~2% slower on an H100.
struct Params {
  const bf16* q;
  const bf16* k;      // the int8 K / V's addresses (k: a valid address for
  const bf16* v;      // a zero-filled cp.async)
  const int8_t* k8;   // int8 K/V and their f32 scales [B, Hkv, Sk]
  const int8_t* v8;
  const float* ksc;
  const float* vsc;
  bf16* out;
  float* lse;
  int Sq, Sk, Hq, Hkv, G, BQ;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, ks_ss;
  long long vs_sb, vs_sh, vs_ss;
  const int* qoffs;  // [B][Sq / SEG] block starts, or null (contiguous)
  const int* koffs;  // [B][Sk / SEG]
  long long qoffs_sb, koffs_sb;
  int q_offset, kv_offset, causal, window;
  float scale, soft_cap;
};

// Q, one bf16 K/V tile, and a two-stage ring of int8 K/V tiles with their
// scales.
constexpr size_t SMEM_BYTES =
    static_cast<size_t>(BM + 2 * BN) * LD * 2 + 4 * BN * LD8 + 4 * BN * 4;

// Every tile of this kernel (64 keys, 64 / G query positions) lies inside
// one block of SEG, so a tile's positions are its first position plus the
// row offset.
template <bool SEGM>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_i8_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* sK = sQ + BM * LD;                       // [BN][LD]
  bf16* sV = sK + BN * LD;                       // [BN][LD]
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + BN * LD);
  int8_t* sV8 = sK8 + 2 * BN * LD8;              // [2][BN][LD8] each
  float* sKs = reinterpret_cast<float*>(sV8 + 2 * BN * LD8);  // [2][BN]
  float* sVs = sKs + 2 * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * p.BQ;
  const int n_rows = min(p.BQ, p.Sq - q0);
  const int q_first =
      SEGM ? pos_of(p.qoffs, p.qoffs_sb, p.q_offset, b, q0) : p.q_offset + q0;
  const int q_last = q_first + n_rows - 1;
  auto k_pos = [&](int key) {
    return SEGM ? pos_of(p.koffs, p.koffs_sb, p.kv_offset, b, key)
                : p.kv_offset + key;
  };

  // `_block_live` per key tile t: causal stops past the last row's
  // position, a window starts at the first row's earliest visible key.
  // Contiguous keys take the closed-form live range [t_begin, t_end),
  // every tile of which is live, and test no tile; segmented keys test
  // each tile.
  int t_begin = 0, t_end = (p.Sk + BN - 1) / BN;
  if (!SEGM || !p.koffs) {
    int hi = p.Sk;
    if (p.causal) hi = min(hi, q_last - p.kv_offset + 1);
    int lo = 0;
    if (p.window) lo = max(lo, q_first - p.window + 1 - p.kv_offset);
    t_begin = lo / BN;
    t_end = hi > t_begin * BN ? (hi + BN - 1) / BN : t_begin;
  }
  auto live = [&](int t) {
    const int kf = k_pos(t * BN), nk = min(BN, p.Sk - t * BN);
    return (!p.causal || kf <= q_last) &&
           (!p.window || kf + nk - 1 > q_first - p.window);
  };
  auto next_live = [&](int t) {
    if (SEGM && p.koffs)
      while (t < t_end && !live(t)) ++t;
    return t;
  };

  auto load_kv = [&](int t0, int buf) {
    int8_t* dk = sK8 + buf * BN * LD8;
    int8_t* dv = sV8 + buf * BN * LD8;
#pragma unroll
    for (int i = 0; i < BN * (D / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (D / 16), c = j % (D / 16);
      const int key = t0 + r;
      const bool ok = key < p.Sk;
      cp_async16(dk + r * LD8 + c * 16,
                 ok ? p.k8 + b * p.k_sb + h * p.k_sh + key * p.k_ss + c * 16
                    : nullptr, p.k8);
      cp_async16(dv + r * LD8 + c * 16,
                 ok ? p.v8 + b * p.v_sb + h * p.v_sh + key * p.v_ss + c * 16
                    : nullptr, p.k8);
    }
    static_assert(NT == 2 * BN, "one scale per thread");
    const int r = tid % BN, key = t0 + r;
    const bool ok = key < p.Sk;
    if (tid < BN)
      cp_async4(sKs + buf * BN + r,
                ok ? p.ksc + b * p.ks_sb + h * p.ks_sh + key * p.ks_ss
                   : nullptr, p.ksc);
    else
      cp_async4(sVs + buf * BN + r,
                ok ? p.vsc + b * p.vs_sb + h * p.vs_sh + key * p.vs_ss
                   : nullptr, p.ksc);
  };

  // Each thread's two rows of the warp's 16: gq and gq + 8.
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  int t = next_live(t_begin);
  if (t < t_end) {
#pragma unroll
    for (int i = 0; i < BM * (D / 8) / NT; ++i) {
      const int j = tid + i * NT, r = j / (D / 8), c = j % (D / 8);
      const int qi = q0 + r % p.BQ;
      cp_async16(sQ + r * LD + c * 8,
                 qi < p.Sq ? p.q + b * p.q_sb + (h * p.G + r / p.BQ) * p.q_sh
                                 + qi * p.q_ss + c * 8
                           : nullptr, p.k);
    }
    load_kv(t * BN, 0);
    cp_commit();
  }

  unsigned qf[D / 16][4];  // the warp's Q fragments, one per k-step
  for (int it = 0; t < t_end; ++it) {
    const int t0 = t * BN, buf = it & 1;
    const int tn = next_live(t + 1);
    if (tn < t_end) {
      load_kv(tn * BN, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16);
    }
    const float* ks_t = sKs + buf * BN;
    const float* vs_t = sVs + buf * BN;
    // the staged int8 tiles -> the bf16 tiles the fragments read
#pragma unroll
    for (int i = 0; i < BN * (D / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (D / 16), c = j % (D / 16);
      cvt_i8x16_bf16(sK + r * LD + c * 16, sK8 + buf * BN * LD8 + r * LD8
                                               + c * 16);
      cvt_i8x16_bf16(sV + r * LD + c * 16, sV8 + buf * BN * LD8 + r * LD8
                                               + c * 16);
    }
    __syncthreads();

    // S[16 x 64] = Q K^T: 8 key n-tiles of 8, 8 k-steps of 16 over D.
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        unsigned kb[4];
        load_b_nk(kb, sK, LD, jp * 16, kk * 16);
        mma16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Online softmax on the two rows this thread holds (the TPU kernels'
    // m / l / alpha rule; masked logits NEG_INF, their p an explicit 0).
    const int k_first = k_pos(t0);
    const bool full =
        t0 + BN <= p.Sk && q0 + p.BQ <= p.Sq &&
        (!p.causal || q_first >= k_first + BN - 1) &&
        (!p.window || q_last - k_first < p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 ks2 =
          *reinterpret_cast<const float2*>(ks_t + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * ((e & 1 ? ks2.y : ks2.x) * p.scale);
        if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
        if (!full) {
          // `_visibility_mask`
          const int row = warp * 16 + gq + (e >> 1) * 8;
          const int i = q0 + row % p.BQ;
          const int key = t0 + j * 8 + 2 * tq + (e & 1);
          const int qpos = q_first + (i - q0), kpos = k_first + (key - t0);
          const bool vis = i < p.Sq && key < p.Sk &&
                           (!p.causal || qpos >= kpos) &&
                           (!p.window || qpos - kpos < p.window);
          if (!vis) x = NEG_INF;
        }
        s[j][e] = x;
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
      const float2 vs2 =
          *reinterpret_cast<const float2*>(vs_t + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x > 0.5f * NEG_INF ? expf(x - m_r[e >> 1]) : 0.f;
        sum[e >> 1] += pe;
        // V's scale folds into P before its bf16 rounding
        s[j][e] = pe * (e & 1 ? vs2.y : vs2.x);
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

    // O[16 x 128] += P[16 x 64] V[64 x 128]: P's A fragments come from
    // the S accumulators (n-tiles 2ks, 2ks + 1 = keys 16ks .. 16ks + 15).
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      unsigned a[4];
      acc_to_a(a, s, ks);
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        unsigned vb[4];
        load_b_kn(vb, sV, LD, ks * 16, jp * 16);
        mma16816(o[2 * jp], a, vb[0], vb[1]);
        mma16816(o[2 * jp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it refills
    t = tn;
  }

  // Epilogue: out = O / l in bf16, lse = m + log(l) (NEG_INF when empty).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const int row = warp * 16 + gq + r * 8;
    const int i = q0 + row % p.BQ;
    if (i >= p.Sq) continue;
    const long long o_row =
        (static_cast<long long>(b) * p.Hq + h * p.G + row / p.BQ) * p.Sq + i;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    bf16* dst = p.out + o_row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (tq == 0) p.lse[o_row] = l > 0.f ? m_r[r] + logf(l) : NEG_INF;
  }
}

template <bool SEGM>
int launch(Params& p, int B, void* stream) {
  // once per device, process and instantiation (outside graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_i8_kernel<SEGM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  const dim3 grid((p.Sq + p.BQ - 1) / p.BQ, p.Hkv, B);
  flash_fwd_i8_kernel<SEGM><<<grid, NT, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8

}  // namespace

// q / k / v with their (b, h, s) strides in elements (unit head-dim
// stride; TMA's rules: 16-byte aligned bases, every stride of a dim of
// more than one row a nonzero multiple of 16 bytes, below 2^40).  qoffs /
// koffs: the per-block start vectors (header), or null for q_offset /
// kv_offset.  D = 128 and G = Hq / Hkv dividing 64.
extern "C" int tdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int Hq, int Hkv,
                             int Sq, int Sk, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, const void* qoffs,
                             long long qoffs_sb, const void* koffs,
                             long long koffs_sb, int q_offset, int kv_offset,
                             int causal, int window, float scale,
                             float soft_cap, void* stream) {
  using namespace wg;
  if (B < 1 || Hkv < 1 || Hq % Hkv || 64 % (Hq / Hkv) || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.BQ = BM / p.G;
  p.n_qt = (Sq + p.BQ - 1) / p.BQ;
  p.qoffs = static_cast<const int*>(qoffs);
  p.koffs = static_cast<const int*>(koffs);
  p.qoffs_sb = qoffs_sb;
  p.koffs_sb = koffs_sb;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.mk = Mask{causal, window, scale, soft_cap};
  const long long qd[4] = {D, Sq, Hq, B};
  const long long kd[4] = {D, Sk, Hkv, B};
  const long long qs[4] = {1, q_ss, q_sh, q_sb};
  const long long ks[4] = {1, k_ss, k_sh, k_sb};
  const long long vs[4] = {1, v_ss, v_sh, v_sb};
  const int qbox[4] = {64, p.BQ, p.G, 1};
  const int kbox[4] = {64, BN, 1, 1};
  int err = make_map(&p.qmap, q, 4, qd, qs, qbox);
  if (!err) err = make_map(&p.kmap, k, 4, kd, ks, kbox);
  if (!err) err = make_map(&p.vmap, v, 4, kd, vs, kbox);
  if (err) return err;
  return qoffs || koffs ? launch<true>(p, stream) : launch<false>(p, stream);
}

// The int8 twin: k/v int8 (strides in bytes) with f32 scale planes
// k_scale / v_scale [B, Hkv, Sk] and their strides.  qoffs / koffs: the
// per-block start vectors (header), or null for q_offset / kv_offset.
extern "C" int tdt_flash_fwd_i8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, void* lse, int B, int Hq, int Hkv,
    int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long ks_sb, long long ks_sh,
    long long ks_ss, long long vs_sb, long long vs_sh, long long vs_ss,
    const void* qoffs, long long qoffs_sb, const void* koffs,
    long long koffs_sb, int q_offset, int kv_offset, int causal, int window,
    float scale, float soft_cap, void* stream) {
  using namespace i8;
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.k8 = static_cast<const int8_t*>(k);
  p.v8 = static_cast<const int8_t*>(v);
  p.ksc = static_cast<const float*>(k_scale);
  p.vsc = static_cast<const float*>(v_scale);
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.BQ = BM / p.G;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_ss = ks_ss;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_ss = vs_ss;
  p.qoffs = static_cast<const int*>(qoffs);
  p.koffs = static_cast<const int*>(koffs);
  p.qoffs_sb = qoffs_sb;
  p.koffs_sb = koffs_sb;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.soft_cap = soft_cap;
  return qoffs || koffs ? launch<true>(p, B, stream)
                        : launch<false>(p, B, stream);
}
