// decode / decode_paged: GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels triton_dist_tpu/kernels/flash_decode.py
// `_decode_kernel` (contiguous cache, launched from `gqa_decode_shard`),
// `_decode_kernel_paged` (block-table pools, launched from
// `gqa_decode_paged_shard`) and their int8-KV twin `_decode_kernel_i8`.
// One kernel serves all; the four C entries differ only in how the
// address of key position `pos` is found (contiguous caches
// [B, Hkv, S, D] are walked by stride, paged pools [N, Hkv, page, D] read
// the page id from block_table[b, pos / page]) and in the cache type:
// bf16, or int8 with f32 per-position scales [B, Hkv, S] (paged:
// [N, Hkv, page], indexed by the same page id as the data).  The int8
// pages have no Pallas kernel in the reference, which computes them as
// XLA math (`_paged_gather` + `_local_decode_xla`); the port gives them
// the same kernel.
//
// Contract (the TPU kernels'): q rows are the T * G queries of one
// (batch, kv-head) pair, row r = t * G + g; lens arrive in the
// `_pack_lens_arg` layouts [B] / [2, B] / [3, B] (valid rows, window end,
// live query count) and the visibility rule is `_chunk_valid`: query t of
// request b sits at wlen - (qlen - 1 - t), dead rows (t >= qlen) see
// nothing and return out 0 and lse NEG_INF.  Out is f32 [B, T, Hq, D],
// lse f32 [B, T, Hq].
//
// What bounds it on an H100: decode is a stream of the K/V cache.  At the
// main path's engine shape (B 8, S ~2048, Hkv 8, D 128, bf16) it must read
// 2 * 8 * 8 * 2048 * 128 * 2 B = 67.1 MB, 20.0 us at 3.35 TB/s, and does
// only ~2 * T * G flops per byte read, so device memory bounds it.  An
// int8 cache moves (128 + 4) / 256 of those bytes.
//
// Design: a pipelined split-KV stream with its merge in the same launch.
// - Splits by live length.  Grid (split, kv-head, batch).  The split count
//   comes from shapes alone (kernels/flash_decode.py `split_plan`: no host
//   sync; the grid stays within one wave of two resident blocks an SM,
//   since a block's start and its merge are latencies a second wave pays
//   again); each block derives from lens (and the window) its pair's live
//   64-key tiles and takes its even share of them (`pair_of` and
//   `split_share` mirror flash_decode.py's `live_tiles` and `split_tiles`,
//   which the CPU tests hold), so no split of a live pair is empty while
//   another walks many tiles.
// - Warp specialisation.  A producer warp keeps a ring of STAGES<I8> K / V
//   tiles in flight (full / empty mbarriers): 16-byte cp.async copies,
//   each lane's arriving on the stage's full barrier as they land
//   (cp.async.mbarrier.arrive.noinc), the int8 rows' f32 scales 4 bytes a
//   lane the same way; page ids are read from the block table before the
//   stage frees.  A stage keeps its rows at a padded stride (D + 8 bf16,
//   D + 16 bytes int8): at the cache's own 256-byte stride every row
//   starts on bank 0, and each 8 x 8 fragment read of V (8 keys of one
//   column block) would conflict 8 ways.  So a row cannot land with its
//   neighbours in one 1-D bulk copy, and one bulk copy a row (128 a bf16
//   tile) ran at the copy engine's request rate, well behind these copies
//   (PERF.md has the trial).  Rows past
//   the pair's cache length are not copied: their logits are masked and
//   (bf16) their V values zeroed in registers.
// - Consumer warps keep S, P, O, m and l in registers (mma.sync m16n8k16
//   of mma_frag.cuh; the online softmax in base 2).  The T * G query rows,
//   padded to RP = 16, 32, 64 or 128, make RG row groups of 16; of the 4
//   consumer warps (8 at RP 128) each takes one row group and a slice of
//   KW = 64 * RG / 4 keys of every tile, so at T = 1 (up to 16 rows) the
//   warps walk different keys, each with its own m, l and O, and merge
//   through shared memory at the block's end.  P is rounded to bf16 in
//   registers, where the TPU kernel rounds.  int8 tiles convert in
//   registers as the B fragments are built (exact: a byte permute and a
//   subtraction a value, mma_frag.cuh `i8x4_to_f32`); K's scale multiplies
//   each logit column, V's folds into P before its rounding.  The K words
//   are read with the head dim permuted within each 16 (Q's fragments take
//   the same order), the V words with the output columns permuted within
//   each 32 (`dim_of`), so every read is one conflict-free 32-bit word.
// - The merge in the same launch.  A pair's splits with tiles each write
//   a normalised partial (o, lse), fence, and count themselves on the
//   pair's counter (a workspace zeroed once); the block that counts last
//   merges the partials by log-sum-exp (the reference's
//   `combine_partials`) and resets the counter, so a CUDA-graph replay
//   finds it zero.  A pair with one live split writes its result
//   directly; a pair with none (a dead or empty one) is written out 0,
//   lse NEG_INF by its split 0.  A call is one launch in every mode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"
#include "sm90.cuh"

namespace {

using namespace tdt_frag;
using tdt_sm90::cp_async_4;
using tdt_sm90::cp_async_arrive;
using tdt_sm90::exp2_approx;
using tdt_sm90::mbar_arrive;
using tdt_sm90::mbar_fence_init;
using tdt_sm90::mbar_init;
using tdt_sm90::mbar_wait;
using tdt_sm90::named_sync;
using tdt_sm90::tanh_fast;

constexpr int D = 128;        // head dim
constexpr int BN = 64;        // keys a tile (flash_decode.TILE)
constexpr int LDH = D + 8;    // bf16 row stride of Q and the K / V stages
constexpr int LD8 = D + 16;   // byte row stride of the int8 stages
constexpr int LDM = D + 4;    // f32 row stride of the warps' merge rows
constexpr int HEAD = 256 + 2 * BN * 16;  // barriers, flag, row offsets
constexpr int MAX_SMEM = 232448;
constexpr float NEG_INF = -1.0e30f;  // finite -inf proxy, as on the TPU
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One ring stage: K and V rows, and (int8) the K and V scales.
template <bool I8>
__host__ __device__ constexpr int stage_bytes() {
  return I8 ? 2 * BN * LD8 + 2 * BN * 4 : 2 * BN * LDH * 2;
}
// The ring's depth: 2 bf16 stages, 3 int8 ones (half the bytes a stage);
// PERF.md has the trials.
template <bool I8>
constexpr int STAGES = I8 ? 3 : 2;
// The ring's bytes, which the end of a block reuses: the consumer warps'
// merge rows, then the pair's merge of (n_split + 2) * R floats, which
// bounds the split count (flash_decode.RING_BYTES, `split_plan`).
template <bool I8>
constexpr int RING_BYTES = STAGES<I8> * stage_bytes<I8>();
static_assert(4 * (32 + 16 * LDM) * 4 <= RING_BYTES<true>,
              "the key slices' merge rows fit the ring");

struct Params {
  const bf16* q;
  const char* k;       // key / value rows: bf16, or int8
  const char* v;
  const float* ksc;    // int8: the f32 per-position scales
  const float* vsc;
  const int* table;
  const int* lens;
  float* out;          // [B, T, Hq, D]
  float* lse;          // [B, T, Hq]
  float* o_part;       // [B * Hkv, n_split, R, D]
  float* lse_part;     // [B * Hkv, n_split, R]
  int* counts;         // [B * Hkv], zero between calls
  int B, T, Hq, Hkv, G, R;
  int S_total;  // cache positions addressable: S, or n_pages * page
  int page, n_pages, paged;
  int n_split;
  long long k_s0, k_s1, k_s2;  // elements: (b, h, s) or (page, h, row)
  long long v_s0, v_s1, v_s2;
  long long ks_s0, ks_s1, ks_s2;  // scales: (b, h, s) or (page, h, row)
  long long vs_s0, vs_s1, vs_s2;
  int lens_rows, use_qlens, window;
  float scale, soft_cap;
};

// One (batch, kv-head) pair's lengths (`_read_lens`) and live tiles.
struct Pair {
  int llen, wlen, qlen;
  int hi_copy;     // rows below it hold cache data: min(llen, S_total)
  int t_lo, t_hi;  // live tiles [t_lo, t_hi)
};

// flash_decode.live_tiles: the tiles any live query of the pair sees.
__device__ __forceinline__ Pair pair_of(const Params& p, int b) {
  Pair a;
  a.llen = p.lens[b];
  a.wlen = p.lens_rows >= 2 ? p.lens[p.B + b] : a.llen;
  a.qlen = p.lens_rows == 3 ? p.lens[2 * p.B + b] : p.T;
  a.hi_copy = max(0, min(a.llen, p.S_total));
  int hi = a.hi_copy, lo = 0;
  if (p.use_qlens) {
    hi = a.qlen > 0 ? min(hi, a.wlen) : 0;
    if (p.window) lo = a.wlen - (a.qlen - 1) - p.window;
  } else if (p.window) {
    lo = a.wlen - p.window;
  }
  lo = max(lo, 0);
  a.t_lo = lo / BN;
  a.t_hi = hi > lo ? (hi + BN - 1) / BN : a.t_lo;
  return a;
}

// flash_decode.split_tiles: split s's share [x, y) of n live tiles, the
// first n % n_split splits one tile more.
__device__ __forceinline__ int2 split_share(int n, int n_split, int s) {
  const int q = n / n_split, r = n % n_split;
  const int first = s * q + min(s, r);
  return make_int2(first, first + q + (s < r ? 1 : 0));
}

// `_chunk_valid`: does query row `row` of the pair see position pos?
__device__ __forceinline__ bool visible(const Params& p, const Pair& a,
                                        int row, int pos) {
  if (row >= p.R || pos >= a.hi_copy) return false;
  if (p.use_qlens) {
    const int d = a.qlen - 1 - row / p.G;
    if (d < 0 || pos >= a.wlen - d) return false;
    if (p.window && pos < a.wlen - d - p.window) return false;
  } else if (p.window && pos < a.wlen - p.window) {
    return false;
  }
  return true;
}

// Index of query row r of (b, h) in the [B, T, Hq] output layout.
__device__ __forceinline__ long long out_row(const Params& p, int b, int h,
                                             int r) {
  const int t = r / p.G, g = r % p.G;
  return (static_cast<long long>(b) * p.T + t) * p.Hq + h * p.G + g;
}

// Head-dim column of value c (0, 1: its column pair) of O's n-tile j in
// this lane: bf16 the natural 8 j + 2 tq + c; int8 the V words' order,
// 32 (j / 4) + 8 tq + 4 c + j % 4.
template <bool I8>
__device__ __forceinline__ int dim_of(int j, int c, int tq) {
  return I8 ? 32 * (j >> 2) + 8 * tq + 4 * c + (j & 3) : 8 * j + 2 * tq + c;
}

struct Shared {
  uint64_t* full;
  uint64_t* empty;
  volatile int* flag;
  longlong2* offs;   // [BN] the producer's K / V row offsets of a tile
  longlong2* soffs;  // [BN] and (int8) its scales'
  bf16* q;           // [RP][LDH]
  char* stages;      // [STAGES][stage_bytes]
};

template <bool I8>
__device__ __forceinline__ Shared carve(char* base, int RP) {
  Shared sh;
  sh.full = reinterpret_cast<uint64_t*>(base);
  sh.empty = sh.full + STAGES<I8>;
  sh.flag = reinterpret_cast<volatile int*>(sh.empty + STAGES<I8>);
  sh.offs = reinterpret_cast<longlong2*>(base + 256);
  sh.soffs = sh.offs + BN;
  sh.q = reinterpret_cast<bf16*>(base + HEAD);
  sh.stages = base + HEAD + RP * LDH * 2;
  return sh;
}

// A pair no split sees (dead or empty): out 0, lse NEG_INF.
__device__ __forceinline__ void write_dead(const Params& p, int b, int h) {
  for (int i = threadIdx.x; i < p.R * D; i += blockDim.x) {
    const long long o = out_row(p, b, h, i / D);
    p.out[o * D + i % D] = 0.f;
    if (i % D == 0) p.lse[o] = NEG_INF;
  }
}

// The producer warp: tiles [ts, te) into the ring by 16-byte cp.async,
// each lane's copies arriving on the stage's full barrier as they land
// (cp.async.mbarrier.arrive.noinc: the barrier counts the 32 lanes).  The
// tile's row offsets (a page id from the table for paged pools) are
// computed first, two rows a lane, into `offs`; then lane l copies 16-byte
// chunk l % CPR of rows l / CPR, l / CPR + 32 / CPR, ...
template <bool I8>
__device__ __forceinline__ void produce(const Params& p, const Shared& sh,
                                        const Pair& a, int b, int h, int ts,
                                        int te) {
  constexpr int ESZ = I8 ? 1 : 2;
  constexpr int CPR = D * ESZ / 16;         // 16-byte chunks a row
  constexpr int RPS = 32 / CPR;             // rows a warp step covers
  constexpr int LD = I8 ? LD8 : LDH * 2;    // bytes between staged rows
  const int lane = threadIdx.x & 31;
  int st = 0;
  unsigned ph = 0;
  for (int t = ts; t < te; ++t) {
    const int t0 = t * BN;
    const int nv = min(BN, a.hi_copy - t0);  // rows with cache data
    __syncwarp();  // the previous tile's offsets are read
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = lane + 32 * j;
      if (r < nv) {
        const int pos = t0 + r;
        long long i0 = b;
        int row = pos;
        if (p.paged) {
          i0 = p.table[static_cast<long long>(b) * p.n_pages + pos / p.page];
          row = pos % p.page;
        }
        sh.offs[r] = make_longlong2(i0 * p.k_s0 + h * p.k_s1 + row * p.k_s2,
                                    i0 * p.v_s0 + h * p.v_s1 + row * p.v_s2);
        if constexpr (I8)
          sh.soffs[r] =
              make_longlong2(i0 * p.ks_s0 + h * p.ks_s1 + row * p.ks_s2,
                             i0 * p.vs_s0 + h * p.vs_s1 + row * p.vs_s2);
      }
    }
    __syncwarp();
    mbar_wait(&sh.empty[st], ph ^ 1u);
    char* stg = sh.stages + st * stage_bytes<I8>();
    const int c = lane % CPR;
    for (int r = lane / CPR; r < nv; r += RPS) {
      const longlong2 o = sh.offs[r];
      cp_async16(stg + r * LD + 16 * c, p.k + o.x * ESZ + 16 * c, nullptr);
      cp_async16(stg + (BN + r) * LD + 16 * c, p.v + o.y * ESZ + 16 * c,
                 nullptr);
    }
    if constexpr (I8) {
      float* sc = reinterpret_cast<float*>(stg + 2 * BN * LD8);
      for (int r = lane; r < nv; r += 32) {
        const longlong2 o = sh.soffs[r];
        cp_async_4(sc + r, p.ksc + o.x);
        cp_async_4(sc + BN + r, p.vsc + o.y);
      }
    }
    cp_async_arrive(&sh.full[st]);
    if (++st == STAGES<I8>) {
      st = 0;
      ph ^= 1u;
    }
  }
}

// A consumer warp: its row group and key slice of every tile [ts, te),
// then the block's rows out (directly, or as split s's partial).
template <int KW, int NCW, bool I8>
__device__ __forceinline__ void consume(const Params& p, const Shared& sh,
                                        const Pair& a, int b, int h, int s,
                                        int ts, int te, int used) {
  constexpr int KS = BN / KW;   // key slices a tile
  constexpr int RG = NCW / KS;  // row groups of 16
  constexpr int RP = 16 * RG;
  constexpr int NJ = KW / 8;    // S n-tiles a warp holds
  constexpr int NC = NCW * 32;  // consumer threads
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int rg = w % RG, kb = (w / RG) * KW;
  const int row0 = 16 * rg + gq;  // this lane's rows: row0, row0 + 8

  // Q: the pair's R rows (pad rows zero), then each warp's fragments
  for (int i = threadIdx.x; i < RP * (D / 8); i += NC) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < p.R)
      x = *reinterpret_cast<const uint4*>(p.q + out_row(p, b, h, r) * D +
                                          c * 8);
    *reinterpret_cast<uint4*>(sh.q + r * LDH + c * 8) = x;
  }
  named_sync(1, NC);
  // Q's A fragment of k-step kk (int8: the head dims 16 kk + 4 tq .. + 3
  // of the K words' order).  Held in registers across tiles, but at
  // 64-key slices, where they would spill: there each k-step reloads it.
  auto q_frag = [&](unsigned (&f)[4], int kk) {
    if constexpr (I8) {
      const uint2 x0 = *reinterpret_cast<const uint2*>(
          sh.q + row0 * LDH + 16 * kk + 4 * tq);
      const uint2 x1 = *reinterpret_cast<const uint2*>(
          sh.q + (row0 + 8) * LDH + 16 * kk + 4 * tq);
      f[0] = x0.x;
      f[1] = x1.x;
      f[2] = x0.y;
      f[3] = x1.y;
    } else {
      load_a(f, sh.q, LDH, 16 * rg, 16 * kk);
    }
  };
  constexpr bool QREG = KW < BN;
  unsigned qf[QREG ? D / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(qf[kk], kk);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m2[2] = {NEG_INF, NEG_INF};  // row maxima, base 2
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  const bool cap = p.soft_cap > 0.f;
  const float mul = cap ? p.scale / p.soft_cap : p.scale * LOG2E;
  const float cap2 = p.soft_cap * LOG2E;

  int st = 0;
  unsigned ph = 0;
  for (int t = ts; t < te; ++t) {
    mbar_wait(&sh.full[st], ph);
    const char* stg = sh.stages + st * stage_bytes<I8>();
    const int t0 = t * BN;
    const bool tail = t0 + BN > a.hi_copy;  // rows past the cache data
    const bool whole = !tail && !p.use_qlens && !p.window;

    // S[16 x KW] = Q K^T over this warp's keys kb .. kb + KW - 1
    float sc[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned qa[4];
      if constexpr (!QREG) q_frag(qa, kk);
      const unsigned (&a)[4] = QREG ? qf[QREG ? kk : 0] : qa;
      if constexpr (I8) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const unsigned wd = *reinterpret_cast<const unsigned*>(
              stg + (kb + 8 * j + gq) * LD8 + 16 * kk + 4 * tq);
          float f[4];
          i8x4_to_f32(wd, f);
          mma16816(sc[j], a, pack_bf16_exact(f[0], f[1]),
                   pack_bf16_exact(f[2], f[3]));
        }
      } else {
        const bf16* sk = reinterpret_cast<const bf16*>(stg);
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {
          unsigned kf[4];
          load_b_nk(kf, sk, LDH, kb + 16 * jp, 16 * kk);
          mma16816(sc[2 * jp], a, kf[0], kf[1]);
          mma16816(sc[2 * jp + 1], a, kf[2], kf[3]);
        }
      }
    }

    // the online softmax (the TPU kernels' m / l / alpha rule, base 2);
    // masked logits NEG_INF, their p an explicit 0
    const float* ksc = reinterpret_cast<const float*>(stg + 2 * BN * LD8);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * j + 2 * tq + (e & 1);
        float x = sc[j][e];
        if constexpr (I8) x *= ksc[key];
        x = cap ? cap2 * tanh_fast(x * mul) : x * mul;
        if (!whole && !visible(p, a, row0 + 8 * (e >> 1), t0 + key))
          x = NEG_INF;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m2[r], quad_max(mx[r]));
      alpha[r] = exp2_approx(m2[r] - m_new);
      m2[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[j][e];
        float pe = x > 0.5f * NEG_INF ? exp2_approx(x - m2[e >> 1]) : 0.f;
        sum[e >> 1] += pe;
        if constexpr (I8)  // V's scale folds into P before its rounding
          pe = pe > 0.f ? pe * ksc[BN + kb + 8 * j + 2 * tq + (e & 1)] : 0.f;
        sc[j][e] = pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O[16 x D] += P[16 x KW] V[KW x D], P's A fragments from S
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      unsigned pa[4];
      acc_to_a(pa, sc, ks);
      const int k0 = kb + 16 * ks;
      if constexpr (I8) {
        const char* v8 = stg + BN * LD8;
#pragma unroll
        for (int J = 0; J < D / 32; ++J) {
          const char* vp = v8 + (k0 + 2 * tq) * LD8 + 32 * J + 4 * gq;
          float fa[4], fb[4], fc[4], fd[4];
          i8x4_to_f32(*reinterpret_cast<const unsigned*>(vp), fa);
          i8x4_to_f32(*reinterpret_cast<const unsigned*>(vp + LD8), fb);
          i8x4_to_f32(*reinterpret_cast<const unsigned*>(vp + 8 * LD8), fc);
          i8x4_to_f32(*reinterpret_cast<const unsigned*>(vp + 9 * LD8), fd);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mma16816(o[4 * J + i], pa, pack_bf16_exact(fa[i], fb[i]),
                     pack_bf16_exact(fc[i], fd[i]));
        }
      } else {
        const bf16* sv = reinterpret_cast<const bf16*>(stg + BN * LDH * 2);
        // keys past the cache data were not copied: zero their V values
        unsigned m0 = ~0u, m1 = ~0u;
        if (tail) {
          const int key = t0 + k0 + 2 * tq;
          m0 = (key < a.hi_copy ? 0xFFFFu : 0u) |
               (key + 1 < a.hi_copy ? 0xFFFF0000u : 0u);
          m1 = (key + 8 < a.hi_copy ? 0xFFFFu : 0u) |
               (key + 9 < a.hi_copy ? 0xFFFF0000u : 0u);
        }
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          unsigned vf[4];
          load_b_kn(vf, sv, LDH, k0, 16 * jd);
          mma16816(o[2 * jd], pa, vf[0] & m0, vf[1] & m1);
          mma16816(o[2 * jd + 1], pa, vf[2] & m0, vf[3] & m1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sh.empty[st]);
    if (++st == STAGES<I8>) {
      st = 0;
      ph ^= 1u;
    }
  }

  // The block's rows: out and lse directly when this is the pair's only
  // live split, else split s's partial.
  const bool direct = used == 1;
  const long long pair = static_cast<long long>(b) * p.Hkv + h;
  auto dst = [&](int r, float*& od, float*& ld) {
    const long long i = direct ? out_row(p, b, h, r)
                               : (pair * p.n_split + s) * p.R + r;
    od = (direct ? p.out : p.o_part) + i * D;
    ld = (direct ? p.lse : p.lse_part) + i;
  };
  const float lr[2] = {quad_sum(l[0]), quad_sum(l[1])};
  if constexpr (KS == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.R) continue;
      float *od, *ld;
      dst(row, od, ld);
      const float inv = lr[r] > 0.f ? 1.f / lr[r] : 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          od[dim_of<I8>(j, c, tq)] = o[j][2 * r + c] * inv;
      if (tq == 0)
        *ld = lr[r] > 0.f ? (m2[r] + log2f(lr[r])) * LN2 : NEG_INF;
    }
  } else {
    // the key slices of a row group merge through shared memory: every
    // consumer is done with the stages, which hold each warp's m[16],
    // l[16] and O[16][LDM]
    named_sync(1, NC);
    float* mine = reinterpret_cast<float*>(sh.stages) + w * (32 + 16 * LDM);
    if (tq == 0) {
      mine[gq] = m2[0];
      mine[gq + 8] = m2[1];
      mine[16 + gq] = lr[0];
      mine[16 + gq + 8] = lr[1];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        mine[32 + (gq + 8 * (c >> 1)) * LDM + dim_of<I8>(j, c & 1, tq)] =
            o[j][c];
    named_sync(1, NC);
    const float* all = reinterpret_cast<const float*>(sh.stages);
    for (int i = threadIdx.x; i < p.R * D; i += NC) {
      const int r = i / D, c = i % D, g = r / 16, rr = r % 16;
      float M = NEG_INF;
#pragma unroll
      for (int k = 0; k < KS; ++k)
        M = fmaxf(M, all[(g + RG * k) * (32 + 16 * LDM) + rr]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float* wk = all + (g + RG * k) * (32 + 16 * LDM);
        const float f = exp2_approx(wk[rr] - M);
        L += wk[16 + rr] * f;
        O += wk[32 + rr * LDM + c] * f;
      }
      float *od, *ld;
      dst(r, od, ld);
      od[c] = L > 0.f ? O / L : 0.f;
      if (c == 0) *ld = L > 0.f ? (M + log2f(L)) * LN2 : NEG_INF;
    }
  }
  if (direct) return;

  // Count this split on the pair; the last to count merges the partials
  // (`combine_partials`) and resets the counter.
  __threadfence();
  named_sync(1, NC);
  if (threadIdx.x == 0)
    *sh.flag = atomicAdd(&p.counts[pair], 1) == used - 1;
  named_sync(1, NC);
  if (!*sh.flag) return;
  __threadfence();
  // every split's lse of every row, then each row's weights, in shared
  // memory (one round trip each), then the weighted sum of the partial
  // rows, eight splits' loads in flight at a time
  const long long base = pair * p.n_split * p.R;
  float* wt = reinterpret_cast<float*>(sh.stages);  // [used][R]
  float* rm = wt + used * p.R;                      // [R] max, [R] sum
  for (int i = threadIdx.x; i < used * p.R; i += NC)
    wt[i] = __ldcg(p.lse_part + base + i);
  named_sync(1, NC);
  for (int r = threadIdx.x; r < p.R; r += NC) {
    float m = NEG_INF, sum = 0.f;
    for (int k = 0; k < used; ++k) m = fmaxf(m, wt[k * p.R + r]);
    for (int k = 0; k < used; ++k) {
      const float lk = wt[k * p.R + r];
      const float wk = lk > 0.5f * NEG_INF ? expf(lk - m) : 0.f;
      wt[k * p.R + r] = wk;
      sum += wk;
    }
    rm[r] = m;
    rm[p.R + r] = sum;
  }
  named_sync(1, NC);
  for (int i = threadIdx.x; i < p.R * (D / 4); i += NC) {
    const int r = i / (D / 4), c = 4 * (i % (D / 4));
    const long long o = out_row(p, b, h, r);
    const float sum = rm[p.R + r];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (sum > 0.f) {  // else no split saw the row: out 0, lse NEG_INF
      for (int k0 = 0; k0 < used; k0 += 8) {
        float4 x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (k0 + j < used)
            x[j] = __ldcg(reinterpret_cast<const float4*>(
                p.o_part + (base + (k0 + j) * p.R + r) * D + c));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (k0 + j >= used) break;
          const float wk = wt[(k0 + j) * p.R + r] / sum;
          acc.x += wk * x[j].x;
          acc.y += wk * x[j].y;
          acc.z += wk * x[j].z;
          acc.w += wk * x[j].w;
        }
      }
    }
    *reinterpret_cast<float4*>(p.out + o * D + c) = acc;
    if (c == 0) p.lse[o] = sum > 0.f ? rm[r] + logf(sum) : NEG_INF;
  }
  if (threadIdx.x == 0) p.counts[pair] = 0;
}

// KW keys a consumer warp takes of each tile, NCW consumer warps, plus
// one producer warp.
template <int KW, int NCW, bool I8>
__global__ void __launch_bounds__((NCW + 1) * 32, NCW == 4 ? 2 : 1)
decode_kernel(const __grid_constant__ Params p) {
  constexpr int RP = 16 * NCW * KW / BN;
  extern __shared__ __align__(128) char smem_raw[];
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Pair a = pair_of(p, b);
  const int n = a.t_hi - a.t_lo;
  const int used = min(n, p.n_split);  // splits with tiles
  const int2 share = split_share(n, p.n_split, s);
  if (share.x >= share.y) {
    if (s == 0 && used == 0) write_dead(p, b, h);
    return;
  }
  const Shared sh = carve<I8>(smem_raw, RP);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES<I8>; ++i) {
      mbar_init(&sh.full[i], 32);  // the producer's lanes' cp.async
      mbar_init(&sh.empty[i], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= NCW * 32)
    produce<I8>(p, sh, a, b, h, a.t_lo + share.x, a.t_lo + share.y);
  else
    consume<KW, NCW, I8>(p, sh, a, b, h, s, a.t_lo + share.x,
                         a.t_lo + share.y, used);
}

template <int KW, int NCW, bool I8>
int run(const Params& p, void* stream) {
  constexpr int RP = 16 * NCW * KW / BN;
  const size_t smem = HEAD + RP * LDH * 2 + RING_BYTES<I8>;
  // once per device, process and instantiation (outside any graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<KW, NCW, I8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  decode_kernel<KW, NCW, I8><<<dim3(p.n_split, p.Hkv, p.B), (NCW + 1) * 32,
                               smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool I8>
int launch_decode(const Params& p, void* stream) {
  // the pair's merge keeps (n_split + 2) * R floats in the ring
  if (p.n_split < 1 || (p.n_split + 2LL) * p.R * 4 > RING_BYTES<I8>)
    return static_cast<int>(cudaErrorInvalidValue);
  int rp = 16;
  while (rp < p.R) rp *= 2;
  switch (rp) {
    case 16: return run<16, 4, I8>(p, stream);
    case 32: return run<32, 4, I8>(p, stream);
    case 64: return run<64, 4, I8>(p, stream);
    case 128: return run<64, 8, I8>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

void set_contiguous(Params& p, int S, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss) {
  p.table = nullptr;
  p.S_total = S;
  p.page = 1;
  p.n_pages = 0;
  p.paged = 0;
  p.k_s0 = k_sb; p.k_s1 = k_sh; p.k_s2 = k_ss;
  p.v_s0 = v_sb; p.v_s1 = v_sh; p.v_s2 = v_ss;
}

void set_paged(Params& p, const void* table, int page, int n_pages,
               long long k_sn, long long k_sh, long long k_sp,
               long long v_sn, long long v_sh, long long v_sp) {
  p.table = static_cast<const int*>(table);
  p.S_total = page * n_pages;
  p.page = page;
  p.n_pages = n_pages;
  p.paged = 1;
  p.k_s0 = k_sn; p.k_s1 = k_sh; p.k_s2 = k_sp;
  p.v_s0 = v_sn; p.v_s1 = v_sh; p.v_s2 = v_sp;
}

void set_scales(Params& p, const void* ks, const void* vs, long long ks_0,
                long long ks_1, long long ks_2, long long vs_0,
                long long vs_1, long long vs_2) {
  p.ksc = static_cast<const float*>(ks);
  p.vsc = static_cast<const float*>(vs);
  p.ks_s0 = ks_0; p.ks_s1 = ks_1; p.ks_s2 = ks_2;
  p.vs_s0 = vs_0; p.vs_s1 = vs_1; p.vs_s2 = vs_2;
}

void fill_common(Params& p, const void* q, const void* k, const void* v,
                 const void* lens, void* out, void* lse, void* o_part,
                 void* lse_part, void* counts, int B, int T, int Hq,
                 int Hkv, int n_split, int lens_rows,
                 int use_qlens, int window, float scale, float soft_cap) {
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.ksc = p.vsc = nullptr;
  p.ks_s0 = p.ks_s1 = p.ks_s2 = p.vs_s0 = p.vs_s1 = p.vs_s2 = 0;
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.counts = static_cast<int*>(counts);
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.R = T * p.G;
  p.n_split = n_split;
  p.lens_rows = lens_rows;
  p.use_qlens = use_qlens;
  p.window = window;
  p.scale = scale;
  p.soft_cap = soft_cap;
}

}  // namespace

// The common arguments: q [B, (T,) Hq, D] bf16; lens in a `_pack_lens_arg`
// layout (lens_rows 1-3); out / lse as the header says; o_part / lse_part
// [B * Hkv, n_split, T * G, D] / [.., T * G] f32 scratch (unread when
// n_split is 1); counts [B * Hkv] int32, zero before the call and after
// it; n_split at most RING_BYTES / (4 * T * G) - 2.  Strides in elements.
extern "C" int tdt_decode(const void* q, const void* k, const void* v,
                          const void* lens, void* out, void* lse,
                          void* o_part, void* lse_part, void* counts, int B,
                          int T, int Hq, int Hkv, int S, int n_split,
                          long long k_sb, long long k_sh,
                          long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, int lens_rows, int use_qlens,
                          int window, float scale, float soft_cap,
                          void* stream) {
  Params p;
  fill_common(p, q, k, v, lens, out, lse, o_part, lse_part, counts, B, T,
              Hq, Hkv, n_split, lens_rows, use_qlens, window, scale,
              soft_cap);
  set_contiguous(p, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  return launch_decode<false>(p, stream);
}

extern "C" int tdt_decode_paged(const void* q, const void* k_pool,
                                const void* v_pool, const void* table,
                                const void* lens, void* out, void* lse,
                                void* o_part, void* lse_part, void* counts,
                                int B, int T, int Hq, int Hkv, int page,
                                int n_pages, int n_split,
                                long long k_sn, long long k_sh,
                                long long k_sp, long long v_sn,
                                long long v_sh, long long v_sp,
                                int lens_rows, int use_qlens, int window,
                                float scale, float soft_cap, void* stream) {
  Params p;
  fill_common(p, q, k_pool, v_pool, lens, out, lse, o_part, lse_part,
              counts, B, T, Hq, Hkv, n_split, lens_rows, use_qlens,
              window, scale, soft_cap);
  set_paged(p, table, page, n_pages, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp);
  return launch_decode<false>(p, stream);
}

// The int8 twins: int8 k/v (same layouts, strides in bytes) plus the f32
// scale planes k_scale / v_scale with their own strides.
extern "C" int tdt_decode_i8(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* lens, void* out, void* lse,
                             void* o_part, void* lse_part, void* counts,
                             int B, int T, int Hq, int Hkv, int S,
                             int n_split, long long k_sb,
                             long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, long long ks_b,
                             long long ks_h, long long ks_s, long long vs_b,
                             long long vs_h, long long vs_s, int lens_rows,
                             int use_qlens, int window, float scale,
                             float soft_cap, void* stream) {
  Params p;
  fill_common(p, q, k, v, lens, out, lse, o_part, lse_part, counts, B, T,
              Hq, Hkv, n_split, lens_rows, use_qlens, window, scale,
              soft_cap);
  set_contiguous(p, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  set_scales(p, k_scale, v_scale, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s);
  return launch_decode<true>(p, stream);
}

extern "C" int tdt_decode_paged_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lens, void* out, void* lse, void* o_part, void* lse_part,
    void* counts, int B, int T, int Hq, int Hkv, int page, int n_pages,
    int n_split, long long k_sn, long long k_sh, long long k_sp,
    long long v_sn, long long v_sh, long long v_sp, long long ks_n,
    long long ks_h, long long ks_p, long long vs_n, long long vs_h,
    long long vs_p, int lens_rows, int use_qlens, int window, float scale,
    float soft_cap, void* stream) {
  Params p;
  fill_common(p, q, k_pool, v_pool, lens, out, lse, o_part, lse_part,
              counts, B, T, Hq, Hkv, n_split, lens_rows, use_qlens,
              window, scale, soft_cap);
  set_paged(p, table, page, n_pages, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp);
  set_scales(p, k_scale, v_scale, ks_n, ks_h, ks_p, vs_n, vs_h, vs_p);
  return launch_decode<true>(p, stream);
}
