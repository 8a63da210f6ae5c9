// flash_fwd: GQA flash-attention forward for Hopper (sm_90a), bf16 and
// int8 K/V.
//
// Replaces the TPU kernels triton_dist_tpu/kernels/flash_attention.py
// `_flash_kernel` (:116, launched from `_flash_pallas`) and
// `_flash_kernel_i8` (:209), both as `flash_fwd_wg_kernel` (its int8
// instantiation for the second).  Same contract: q [B, Hq, Sq, D], k/v
// [B, Hkv, Sk, D] in bf16 (int8 with f32 scales for the int8 mode; any
// b/h/s strides, unit d stride) -> out [B, Hq, Sq, D] bf16 plus lse [B,
// Hq, Sq] f32 in natural log (the backward kernels read it); global
// positions q_offset + i and kv_offset + j; causal, sliding window,
// soft-cap; rows with nothing visible give out 0 and lse NEG_INF.
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
// The kernel (`flash_fwd_wg_kernel`) runs on the wgmma / TMA pieces of
// sm90.cuh and the consumer tile body of attn_tile.cuh (ring_attn.cu's
// body, lifted out; that kernel keeps its copy, see the header).  One
// block per (q tile, kv-head, batch) is three warpgroups: a producer and
// two consumers (setmaxnreg moves registers from the first to the
// others).  As on the TPU the q tile folds all G = Hq / Hkv heads of the
// group into its rows (row r = g * BQ + i, 128 rows, BQ = 128 / G
// positions, 64 rows a consumer), so every K/V tile read from device
// memory serves the whole group; TMA brings it as one
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
// The int8 mode (`flash_fwd_wg_kernel<SEGM, true>`: chunked prefill
// against an int8 cache, forward only) is the same kernel.  The int8 K / V
// tiles and their f32 per-position scales [B, Hkv, Sk] travel half the
// bytes: producer warp 0 brings each 64-key half tile into a staging ring
// of SST slots by 1-D bulk copies (one a tensor when its rows are
// contiguous, else one a row: no tensor map) and the scales 4 bytes a
// lane by cp.async on the same mbarrier; producer warps 1-3 convert each
// staged half to bf16 (|q| <= 127 is exact: a byte permute and a
// subtraction a value) in the 128-byte-swizzled layout the wgmma
// descriptors read, copy the scales beside the bf16 stage (keys past Sk
// get scale 0), and arrive on the stage's full barrier.  The consumers
// run the bf16 tile body with two additions (attn_tile.cuh): K's scale
// multiplies each logit column after Q K^T, V's folds into P before P is
// rounded to the bf16 A operand, where the TPU kernel rounds.  Q still
// arrives by TMA.
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

// ------------------------------------------------------------- the kernel

namespace wg {

using namespace tdt_attn;
using tdt_frag::i8x4_to_f32;
using tdt_frag::pack_bf16_exact;

constexpr int BM = 128;   // folded q rows per tile (64 per consumer)
constexpr int ST = 2;     // K / V stages
constexpr int NT = 384;   // producer + two consumer warpgroups
// int8: 64-key half tiles staged as they arrive, converted by producer
// warps 1-3 (the converters)
constexpr int HB = 64;
constexpr int SST = 3;
constexpr int CONVERTERS = 3;
// setmaxnreg moves registers within the launch's 168 a thread: the int8
// producer warpgroup converts, so it keeps more than 40.
template <bool I8>
constexpr int PRODUCER_REGS = I8 ? 56 : 40;
template <bool I8>
constexpr int CONSUMER_REGS = I8 ? 224 : 232;

template <bool I8>
struct Smem {
  bf16 q[2 * BM * 64];  // two swizzled halves
  bf16 k[ST][2 * BN * 64];
  bf16 v[ST][2 * BN * 64];
  // int8: each bf16 stage's K scales [BN] then V scales [BN], and the
  // staging slots: K rows [HB][D], V rows, K scales [HB], V scales
  float sc[I8 ? ST : 1][I8 ? 2 * BN : 1];
  int8_t raw[I8 ? SST : 1][I8 ? 2 * HB * D + 2 * HB * 4 : 16];
  uint64_t qfull, full[ST], empty[ST];
  uint64_t sfull[I8 ? SST : 1], sempty[I8 ? SST : 1];
};
template <bool I8>
constexpr size_t SMEM_BYTES = sizeof(Smem<I8>) + 1024;  // + alignment

struct Params {
  CUtensorMap qmap;  // q: {D, Sq, Hq, B}, box {64, BQ, G, 1}
  CUtensorMap kmap;  // bf16 k: {D, Sk, Hkv, B}, box {64, BN, 1, 1}
  CUtensorMap vmap;
  bf16* out;         // [B, Hq, Sq, D] contiguous
  float* lse;        // [B, Hq, Sq]
  int B, Sq, Sk, Hq, Hkv, G, BQ, n_qt;
  const int* qoffs;  // [B][Sq / SEG] block starts, or null (contiguous)
  const int* koffs;  // [B][Sk / SEG]
  long long qoffs_sb, koffs_sb;
  int q_offset, kv_offset;
  Mask mk;
  // int8: k / v rows and their f32 scales, (b, h, s) strides in elements
  const int8_t* k8;
  const int8_t* v8;
  const float* ksc;
  const float* vsc;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, ks_ss, vs_sb, vs_sh, vs_ss;
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

// Q by TMA (one thread), once: the consumers wait on qfull.
__device__ __forceinline__ void issue_q(const Params& p, bf16* q,
                                        uint64_t* qfull, const QTile& t) {
  mbar_arrive_tx(qfull, 2 * HALF);
  for (int hf = 0; hf < 2; ++hf)
    tma_load_4d(q + hf * BM * 64, &p.qmap, qfull, hf * 64, t.q0, t.h * p.G,
                t.b);
}

// bf16: the producer's first thread: Q once, then every live K / V tile.
template <bool SEGM>
__device__ __forceinline__ void producer(const Params& p, Smem<false>& sm) {
  if (threadIdx.x != 0) return;
  const QTile t = q_tile<SEGM>(p);
  int kt = next_live<SEGM>(p, t, t.t_begin);
  if (kt >= t.t_end) return;  // nothing visible: the consumers store zeros
  issue_q(p, sm.q, &sm.qfull, t);
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

// int8, producer warp 0: Q once, then every live tile's two halves into
// the staging slots.  Rows past Sk are not copied (the converters' bf16
// rows for them hold whatever the slot held: finite, masked, scale 0).
template <bool SEGM>
__device__ __forceinline__ void loader(const Params& p, Smem<true>& sm) {
  const int lane = threadIdx.x & 31;
  const QTile t = q_tile<SEGM>(p);
  int kt = next_live<SEGM>(p, t, t.t_begin);
  if (kt >= t.t_end) return;
  if (lane == 0) issue_q(p, sm.q, &sm.qfull, t);
  const long long kb = t.b * p.k_sb + t.h * p.k_sh;
  const long long vb = t.b * p.v_sb + t.h * p.v_sh;
  const long long ksb = t.b * p.ks_sb + t.h * p.ks_sh;
  const long long vsb = t.b * p.vs_sb + t.h * p.vs_sh;
  Ring<SST> sr;
  for (; kt < t.t_end; kt = next_live<SEGM>(p, t, kt + 1)) {
    for (int hb = 0; hb < 2; ++hb) {
      const int k0 = kt * BN + hb * HB;
      const int nv = max(0, min(HB, p.Sk - k0));
      uint64_t* bar = &sm.sfull[sr.stage];
      int8_t* raw = sm.raw[sr.stage];
      mbar_wait(&sm.sempty[sr.stage], sr.phase ^ 1u);
      if (lane == 0) mbar_arrive_tx(bar, 2u * D * nv);
      __syncwarp();
      const int8_t* ks = p.k8 + kb + k0 * p.k_ss;
      const int8_t* vs = p.v8 + vb + k0 * p.v_ss;
      if (p.k_ss == D) {  // contiguous rows: one copy
        if (lane == 0 && nv) bulk_load(raw, ks, D * nv, bar);
      } else {
        for (int r = lane; r < nv; r += 32)
          bulk_load(raw + r * D, ks + r * p.k_ss, D, bar);
      }
      if (p.v_ss == D) {
        if (lane == 0 && nv) bulk_load(raw + HB * D, vs, D * nv, bar);
      } else {
        for (int r = lane; r < nv; r += 32)
          bulk_load(raw + (HB + r) * D, vs + r * p.v_ss, D, bar);
      }
      float* sc = reinterpret_cast<float*>(raw + 2 * HB * D);
      for (int r = lane; r < nv; r += 32) {
        cp_async_4(sc + r, p.ksc + ksb + (k0 + r) * p.ks_ss);
        cp_async_4(sc + HB + r, p.vsc + vsb + (k0 + r) * p.vs_ss);
      }
      cp_async_arrive(bar);
      sr.next();
    }
  }
}

// int8, converter warp cw (0..2) of one staged half (keys 64 hb ..) into
// the bf16 K and V tiles: a task is 16 int8 values (a 16-byte chunk of
// dims 16 c .. 16 c + 15 of one row) -> two 16-byte bf16 chunks at their
// swizzled positions.  Consecutive lanes take the four chunks of one
// 64-column half of a row, then the next row, so each 8-lane store phase
// covers 8 distinct 16-byte bank groups (rows of both parities).
__device__ __forceinline__ void convert_half(const int8_t* raw, bf16* kt,
                                             bf16* vt, int hb, int cw) {
  const int lane = threadIdx.x & 31;
  for (int u = 32 * cw + lane; u < 2 * HB * (D / 16);
       u += 32 * CONVERTERS) {
    const int tensor = u / (HB * (D / 16));  // 0 K, 1 V
    const int rem = u % (HB * (D / 16));
    const int dh = rem / (HB * 4);           // 64-column half
    const int rr = (rem % (HB * 4)) / 4, c4 = rem % 4;
    const uint4 x = *reinterpret_cast<const uint4*>(
        raw + (tensor * HB + rr) * D + 16 * (4 * dh + c4));
    const unsigned wd[4] = {x.x, x.y, x.z, x.w};
    unsigned hv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float f[4];
      i8x4_to_f32(wd[i], f);
      hv[2 * i] = pack_bf16_exact(f[0], f[1]);
      hv[2 * i + 1] = pack_bf16_exact(f[2], f[3]);
    }
    const int row = hb * HB + rr;
    char* half = reinterpret_cast<char*>(tensor ? vt : kt) + dh * HALF +
                 row * 128;
    *reinterpret_cast<uint4*>(half + (((2 * c4) ^ (row & 7)) << 4)) =
        make_uint4(hv[0], hv[1], hv[2], hv[3]);
    *reinterpret_cast<uint4*>(half + (((2 * c4 + 1) ^ (row & 7)) << 4)) =
        make_uint4(hv[4], hv[5], hv[6], hv[7]);
  }
}

// int8, converter warps: every live tile, once its bf16 stage is free,
// from its two staged halves (keys past Sk get scale 0).
template <bool SEGM>
__device__ __forceinline__ void converter(const Params& p, Smem<true>& sm,
                                          int cw) {
  const int lane = threadIdx.x & 31;
  const QTile t = q_tile<SEGM>(p);
  Ring<ST> ring;
  Ring<SST> sr;
  for (int kt = next_live<SEGM>(p, t, t.t_begin); kt < t.t_end;
       kt = next_live<SEGM>(p, t, kt + 1)) {
    const int st = ring.stage;
    mbar_wait(&sm.empty[st], ring.phase ^ 1u);
    for (int hb = 0; hb < 2; ++hb) {
      mbar_wait(&sm.sfull[sr.stage], sr.phase);
      const int8_t* raw = sm.raw[sr.stage];
      const int nv = max(0, min(HB, p.Sk - (kt * BN + hb * HB)));
      convert_half(raw, sm.k[st], sm.v[st], hb, cw);
      const float* sc = reinterpret_cast<const float*>(raw + 2 * HB * D);
      for (int r = 32 * cw + lane; r < HB; r += 32 * CONVERTERS) {
        sm.sc[st][hb * HB + r] = r < nv ? sc[r] : 0.f;
        sm.sc[st][BN + hb * HB + r] = r < nv ? sc[HB + r] : 0.f;
      }
      fence_proxy_async_shared();  // the stores, before wgmma reads them
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.sempty[sr.stage]);
      sr.next();
    }
    if (lane == 0) mbar_arrive(&sm.full[st]);
    ring.next();
  }
}

// A consumer warpgroup (cw = 0, 1): folded rows 64 cw .. 64 cw + 63.
template <bool SEGM, bool I8>
__device__ __forceinline__ void consumer(const Params& p, Smem<I8>& sm,
                                         int cw) {
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
    tile_step<I8>(o, m_r, l_r, sq, sm.k[st], sm.v[st], whole, row_i,
                  row_pos, p.Sq, t0, p.Sk, split, run0, run1, p.mk,
                  I8 ? sm.sc[st] : nullptr);
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

template <bool SEGM, bool I8>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wg_kernel(const __grid_constant__ Params p) {
  extern __shared__ char smem_raw[];
  Smem<I8>& sm = *reinterpret_cast<Smem<I8>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  if (threadIdx.x == 0) {
    mbar_init(&sm.qfull, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&sm.full[i], I8 ? CONVERTERS : 1);
      mbar_init(&sm.empty[i], 8);  // every consumer warp
    }
    if constexpr (I8) {
      for (int i = 0; i < SST; ++i) {
        mbar_init(&sm.sfull[i], 1 + 32);  // + the cp.async lanes
        mbar_init(&sm.sempty[i], CONVERTERS);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    regs_dealloc<PRODUCER_REGS<I8>>();
    if constexpr (I8) {
      if (threadIdx.x < 32)
        loader<SEGM>(p, sm);
      else
        converter<SEGM>(p, sm, threadIdx.x / 32 - 1);
    } else {
      producer<SEGM>(p, sm);
    }
  } else {
    regs_alloc<CONSUMER_REGS<I8>>();
    consumer<SEGM, I8>(p, sm, threadIdx.x / 128 - 1);
  }
}

template <bool SEGM, bool I8>
int launch(const Params& p, void* stream) {
  // once per device, process and instantiation (outside graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wg_kernel<SEGM, I8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES<I8>));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  flash_fwd_wg_kernel<SEGM, I8><<<p.n_qt * p.Hkv * p.B, NT, SMEM_BYTES<I8>,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The fields both modes share, and q's tensor map.
int fill(Params& p, const void* q, void* out, void* lse, int B, int Hq,
         int Hkv, int Sq, int Sk, long long q_sb, long long q_sh,
         long long q_ss, const void* qoffs, long long qoffs_sb,
         const void* koffs, long long koffs_sb, int q_offset, int kv_offset,
         int causal, int window, float scale, float soft_cap) {
  if (B < 1 || Hkv < 1 || Hq % Hkv || 64 % (Hq / Hkv) || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.k8 = p.v8 = nullptr;
  p.ksc = p.vsc = nullptr;
  const long long qd[4] = {D, Sq, Hq, B};
  const long long qs[4] = {1, q_ss, q_sh, q_sb};
  const int qbox[4] = {64, p.BQ, p.G, 1};
  return make_map(&p.qmap, q, 4, qd, qs, qbox);
}

}  // namespace wg

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
  Params p;
  int err = fill(p, q, out, lse, B, Hq, Hkv, Sq, Sk, q_sb, q_sh, q_ss, qoffs,
                 qoffs_sb, koffs, koffs_sb, q_offset, kv_offset, causal,
                 window, scale, soft_cap);
  const long long kd[4] = {D, Sk, Hkv, B};
  const long long ks[4] = {1, k_ss, k_sh, k_sb};
  const long long vs[4] = {1, v_ss, v_sh, v_sb};
  const int kbox[4] = {64, BN, 1, 1};
  if (!err) err = make_map(&p.kmap, k, 4, kd, ks, kbox);
  if (!err) err = make_map(&p.vmap, v, 4, kd, vs, kbox);
  if (err) return err;
  return qoffs || koffs ? launch<true, false>(p, stream)
                        : launch<false, false>(p, stream);
}

// The int8 mode: q as above (read by TMA); k / v int8 [B, Hkv, Sk, D]
// with strides in bytes (16-byte aligned rows: read by 1-D bulk copies)
// and the f32 scale planes k_scale / v_scale [B, Hkv, Sk] with theirs
// (any).  qoffs / koffs: the per-block start vectors (header), or null for
// q_offset / kv_offset.
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
  using namespace wg;
  Params p;
  const int err = fill(p, q, out, lse, B, Hq, Hkv, Sq, Sk, q_sb, q_sh, q_ss,
                       qoffs, qoffs_sb, koffs, koffs_sb, q_offset, kv_offset,
                       causal, window, scale, soft_cap);
  if (err) return err;
  p.k8 = static_cast<const int8_t*>(k);
  p.v8 = static_cast<const int8_t*>(v);
  p.ksc = static_cast<const float*>(k_scale);
  p.vsc = static_cast<const float*>(v_scale);
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_ss = ks_ss;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_ss = vs_ss;
  return qoffs || koffs ? launch<true, true>(p, stream)
                        : launch<false, true>(p, stream);
}
