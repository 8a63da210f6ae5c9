// gemm_rs: the overlapped GEMM-ReduceScatter of the tensor-parallel linears
// for Hopper (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/gemm_reduce_scatter.py
// `_gemm_rs_kernel` (:103, launched from `gemm_rs_shard` at :764), its
// uni-directional ring.  Same contract, for every rank r of a world of W:
// given the rank's A_r [W m_loc, k] (every row, its shard of the
// contraction) and its weight shard B_r [k, N] (or B_r^T stored [N][k],
// read in place), rank r gets C_r = sum over ranks q of A_q[rows of chunk
// r] @ B_q, [m_loc, N] bf16.
//
// Rounding: each rank's partial is rounded to bf16, as the reference
// stages its partials in the output dtype (:764-772); the W partials of a
// tile are summed in f32 in the fixed order q = 0 .. W-1 and rounded once.
// The reference instead adds in bf16 at every ring step (`_add_body`,
// :100), rounding W - 1 times in a rank-dependent order; this kernel's sum
// is the same on every run and closer to the exact one.
//
// What bounds it on an H100: operations.  Llama-3-8B's down projection at
// TP 4 (M 2048, k 3584, N 4096) is 240.5 GFLOP over the four ranks, 0.2432
// ms at the 989 TFLOP/s bf16 peak, against 192 MB of operands and output
// (0.057 ms at 3.35 TB/s).  The staging adds each chunk's G bf16
// partials, written and read once: 16 MB a rank at down.
//
// The uni kernel (tdt_gemm_rs; tdt_gemm_rs_group, the same kernel over a
// group of a larger mesh, with torus = 0 in index order and with torus =
// 1 in the torus order: `gemm_rs_wg_kernel`), on the
// warp-specialised mainloop of sm90_gemm.cuh: one cooperative launch, one
// block of 384 threads an SM, the blocks split evenly among the ranks (a
// spin-wait is safe only when every block is resident), every block past
// barrier_all (the reference's neighbour barrier, :144-149) on entry.
// - Schedule: the reference's chunk order.  Rank q computes its partial of
//   chunk q - 1, q - 2, ..., its own chunk last; its blocks walk that list
//   in strides, a chunk's 128 x 256 tiles column band by column band (the
//   blocks that run together share B's columns; against row tiles
//   outermost, down 0.3931 against 0.4945 ms, PERF.md row 15).
// - Mainloop: producer warp 0's lane 0 issues the TMA loads of A (the
//   rank's rows of chunk oj, through a map over the rank-stacked a [W,
//   W m_loc, k]) and B ([k][N], the MN-major operand, or [N][k] with
//   b_nk, both read in place) into a 4-stage ring; two consumer
//   warpgroups run `wgmma m64n256k16` on rows 0-63 and 64-127;
//   setmaxnreg moves registers from the producer (40) to them (232).  A
//   chunk's last row tile may load the next chunk's rows (zeros past the
//   operand's end): the stores and the fold drop them, so no partial
//   reaches into the next chunk (any m_loc >= 1).
// - Every chunk, the owner's own too: the consumers round the accumulator
//   to bf16 and store it from registers into slot jm of the owner's
//   staging buffer, in the accumulator's fragment order (thread t's
//   16-byte vector v of consumer cw at uint4 (16 cw + v) x 128 + t of the
//   tile: every store and every load of a warp is 512 contiguous bytes)
//   and arrive on an mbarrier; producer warp 1, idle otherwise, waits on
//   it and raises the flag of that (slot, 128 x 256 tile): a system fence
//   and a release store.  Against one consumer thread raising it after a
//   named barrier of the two warpgroups, whose fence held its warpgroup
//   off the next product: wo 0.1605 against 0.1858 ms, down 0.3790
//   against 0.3982 (PERF.md row 15).
// - The fold: after its GEMM tiles, each rank walks its own chunk's tiles
//   as separate items; a consumer warpgroup waits on the G flags of a
//   tile, loads the G staged vectors of each of its 16 before adding them
//   in f32 in index order (the torus mode: in the torus order, each add
//   rounded to bf16; see tdt_gemm_rs_group), and writes C once.  The A/B
//   against the fold in the epilogue of the owner's own tiles (its
//   accumulator rounded and added in registers, no own staging; PERF.md
//   row 15, NVIDIA H100 80GB HBM3, 700 W) read the same times within 2%
//   at every shape (down 0.3907 against 0.3931 ms), and the epilogue fold
//   spilled 500 bytes a thread (its packed accumulator beside the loads
//   at the kernel's 168 registers, which setmaxnreg does not raise for
//   ptxas): the separate items won, spill-free and one code path.  An
//   epilogue fold through shared memory has no room: the ring takes 193
//   KB of the 227, a staged 128 x 256 tile 64 KB (the torus mode's fold
//   items borrow the ring once the block's GEMM items are done).
// On one card (the virtual world) the staging stores are device-memory
// stores, not NVLink traffic.
//
// The tile loop of bf16_tile.cuh (128 x 128 tiles, mma.sync, two blocks
// an SM) keeps the bf16 bidirectional ring; no model path launches it.
//
// The int8 mode (tdt_gemm_rs_i8; tdt_gemm_rs_group_i8 over a group, the
// reference's `quantized` path :700-702): gemm_rs_wg_kernel<I8 = true>,
// the same items, staging, flags and fold on int8 A and B with exact
// int32 partials (`wgmma ...s32.s8.s8`; producer warps 1-3 transpose each
// staged B tile, sm90_gemm.cuh), staged in int32 in fragment order and
// summed in index order: int32 adds are exact in any order, so the result
// is the exact product.  Tiles of 256 x 128 (Cfg's TALL), or 128 x 256
// where one tile holds a chunk's rows (i8_tall: m_loc <= 128, the decode
// shapes, where the 256-row tile computed twice the products: m16 down
// 0.2184 against 0.1367 ms; 256 x 128 won at the prefill shapes, down
// 0.3986 against 0.4492, wo 0.2211 against 0.2364; PERF.md's int8
// GEMM-RS findings).  A staged tile's vectors past a ragged chunk's rows
// are neither stored nor read.  The consumers raise each staged tile's
// flag (raise_tile): producer warps 1-3 transpose, so no signal warp is
// free.
//
// The bidirectional ring (tdt_gemm_rs_bidir, the TPU `_gemm_rs_bidir_
// kernel` :205): the N columns split in half; half 0's partials reduce
// round the ring rightward (rank me folds chunk me - 1 - s at step s), half
// 1's leftward (chunk me + 1 + s), each rank's own chunk last.  A ring
// reduction in the reference's hop order: at step s rank me computes its
// partial tile, rounds it to bf16 (the reference stages partials in the
// output dtype), and for s >= 1 waits for the running sum its previous
// peer left in its landing slot s - 1 and adds it in bf16 (`acc = local +
// recv`, one rounding, `_add_body` :97-100), in place in the destination
// where its rounded partial went: its next peer's landing slot s (or, at
// the last step, its output); then it raises that slot's tile flag.
// W - 1 landing slots per direction take the place of the reference's
// credit semaphores (no slot is reused within a call), and each direction
// has its own slots and flags.  Given the same
// partials, the sums are bit for bit the reference's.  Its int8 mode
// (tdt_gemm_rs_bidir_i8, the same kernel's int32 path :698-702):
// gemm_rs_bidir_i8_wg_kernel, the same step order on the int8 uni
// kernel's mainloop, tiles and fragment-order staging, each hop's add in
// the int32 registers.
//
// The SASS (`chip_smoke.py`'s build phase and `-Xptxas -v`, NVIDIA H100
// 80GB HBM3, 700 W): 4 HGMMA in each of gemm_rs_wg_kernel's six bf16
// instances (B [k][N] or [N][k], FLAT, GROUP or TORUS), 168 registers at
// launch (setmaxnreg 40 / 232 at run time), 0 spills; 8 IGMMA in each int8
// instance of 256 x 128 tiles, 4 in each of 128 x 256 (uni FLAT and
// GROUP, bidir), 168 registers (setmaxnreg 56 / 224), 0 spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "dist_verbs.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace tdt_frag;
using tdt_bf16::BM;
using tdt_bf16::BN;
using tdt_bf16::fold_add;
using tdt_bf16::NT;
using tdt_bf16::Tiles;
using tdt_dist::FoldPlan;
using tdt_dist::Group;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;
using tdt_gemm90::bf16_hi;
using tdt_gemm90::bf16_lo;
using tdt_gemm90::frag_col;
using tdt_gemm90::frag_row;

// ------------------------------------------------ the uni kernel (wgmma)

enum Mode { FLAT = 0, GROUP = 1, TORUS = 2 };

constexpr int WBM = tdt_gemm90::BM, WBN = tdt_gemm90::BN;
// 16-byte vectors of a staged tile: bf16 partials, int32 in int8 (either
// int8 tile shape holds 128 x 256 values)
constexpr int TILE_U4 = WBM * WBN / 8;
constexpr int TILE_U4_I8 = WBM * WBN / 4;
// The torus order's column unit: the reference cuts N into its 2n parts in
// 128-column units (`_split_parts(N // 128, 2n)`); a 128 x 256 tile spans
// two units, each of which lies in one part.
constexpr int TORUS_UNIT = 128;
static_assert(WBN == 2 * TORUS_UNIT, "a tile spans two torus units");

// The int8 tile of a chunk of m_loc rows: 256 x 128 (Cfg's TALL: half the
// transposes a product), unless one 128 x 256 tile holds the chunk's rows
// (half the products).  gemm_reduce_scatter.i8_tile mirrors it.
inline bool i8_tall(int m_loc) { return m_loc > WBM; }

template <class OutT>
struct WgParams {
  CUtensorMap amap;       // a {k, G m_loc, W}
  CUtensorMap bmap;       // b {N, k, W}, or {k, N, W} (B_NK)
  Peers<uint4> stage;     // rank r's [G slots][tiles][TILE_U4]: rank q's
                          // partial tiles in slot q, fragment order (bidir:
                          // its landing slots [2][W - 1][tiles][TILE_U4_I8])
  Peers<OutT> out;        // rank r's C [m_loc][N]
  Peers<unsigned> flags;  // rank r's [G slots][tiles] ([2][W - 1][tiles])
  Peers<unsigned> bar;    // rank r's [W] barrier slots
  Group grp;              // GROUP, TORUS: the ranks that reduce (slot =
                          // index)
  int part_end[6];        // TORUS: column part q ends at unit part_end[q]
  FoldPlan plans[MAX_RANKS][6];  // TORUS: joint index j's fold of part q
  int world, m_loc, n, k, tiles_m, tiles_n;  // bidir: the tiles of a half
  unsigned epoch;
};

// Item t of rank `me`'s list (index jm of G): its partial of chunk oj,
// tile (i, j); the chunks jm - 1, jm - 2, ..., jm, each tiles_m x tiles_n
// tiles column band by column band.
struct WgItem {
  int oj, i, j;
};

template <class P>
__device__ __forceinline__ WgItem wg_item(const P& p, int t, int jm, int G) {
  const int per = p.tiles_m * p.tiles_n;
  const int s = t / per, r = t - s * per;
  WgItem x;
  x.oj = (jm + 2 * G - 1 - s) % G;
  x.j = r / p.tiles_m;
  x.i = r - x.j * p.tiles_m;
  return x;
}

// A consumer's half of a tile, rounded to bf16, in fragment order at
// `tile` (the header).
__device__ __forceinline__ void stage_tile(const float (&acc)[128],
                                           uint4* tile, int cw) {
  uint4* dst = tile + cw * (TILE_U4 / 2) + (threadIdx.x & 127);
#pragma unroll
  for (int v = 0; v < 16; ++v)
    dst[v * 128] = make_uint4(pack_bf16(acc[8 * v], acc[8 * v + 1]),
                              pack_bf16(acc[8 * v + 2], acc[8 * v + 3]),
                              pack_bf16(acc[8 * v + 4], acc[8 * v + 5]),
                              pack_bf16(acc[8 * v + 6], acc[8 * v + 7]));
}

// int8: vector v of a consumer's half of a tile in fragment order is its
// accumulator's acc[4 v .. 4 v + 3] (sm90_gemm.cuh's frag_row /
// frag_col: rows r and r + 8, two columns); thread t's vector v of
// consumer cw lies at uint4 (32 cw + v) x 128 + t of the tile, so every
// access of a warp is 512 contiguous bytes.  Vectors whose rows lie past
// the tile's `rows` (a ragged chunk's) are neither staged nor read.

// int8: a consumer's half of a tile, plus (`from` not null) the running
// sum staged at `from`, stored in fragment order at `to`, or (`to` null)
// into C at c (the tile's row 0, row stride ldc; columns >= n dropped).
// Eight vectors at a time, their loads first: each accumulator register
// dies with its store, and `from` never aliases the destination, so the
// next loads may be issued ahead of these stores.  (Groups of 4, 8, 16
// and 32 at 15bi wo: 0.1913, 0.1802, 0.1842 and 0.2678 ms, 16 and 32
// spilling; a load, add and store a vector with no restrict: 0.2448;
// PERF.md's int8 GEMM-RS findings.)
template <class C>
__device__ __forceinline__ void tile_out(const int (&acc)[128], int cw,
                                         int rows,
                                         const uint4* __restrict__ from,
                                         uint4* __restrict__ to,
                                         int* __restrict__ c = nullptr,
                                         long long ldc = 0, int n = 0,
                                         int col0 = 0) {
  const int off = cw * (TILE_U4_I8 / 2) + (threadIdx.x & 127);
  constexpr int GV = 8;  // vectors a group
#pragma unroll
  for (int v0 = 0; v0 < 32; v0 += GV) {
    uint4 y[GV];
#pragma unroll
    for (int u = 0; u < GV; ++u)
      if (from != nullptr && frag_row<C>(v0 + u, cw) < rows)
        y[u] = __ldcg(from + off + (v0 + u) * 128);
#pragma unroll
    for (int u = 0; u < GV; ++u) {
      const int v = v0 + u, r = frag_row<C>(v, cw);
      if (r >= rows) continue;
      int4 x = make_int4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                         acc[4 * v + 3]);
      if (from != nullptr) {
        x.x += static_cast<int>(y[u].x);
        x.y += static_cast<int>(y[u].y);
        x.z += static_cast<int>(y[u].z);
        x.w += static_cast<int>(y[u].w);
      }
      if (to != nullptr) {
        reinterpret_cast<int4*>(to)[off + v * 128] = x;
        continue;
      }
      const int col = col0 + frag_col<C>(v);
      if (col >= n) continue;
      *reinterpret_cast<int2*>(c + r * ldc + col) = make_int2(x.x, x.y);
      if (r + 8 < rows)
        *reinterpret_cast<int2*>(c + (r + 8) * ldc + col) =
            make_int2(x.z, x.w);
    }
  }
}

// int8: the flag of a staged tile.  The two consumer warpgroups meet at a
// named barrier and thread 128 raises it: a system fence and a release
// store.  (No producer thread is free to take it, as bf16's signal warp
// does: producer warps 1-3 transpose.  Against the TMA lane raising it
// between its loads: within 2.5% either way at every prefill shape; a
// transposer warp raising it between its k-tiles: 12-28% slower.  PERF.md's
// int8 GEMM-RS findings.)
__device__ __forceinline__ void raise_tile(unsigned* flag, unsigned epoch) {
  tdt_sm90::named_sync(3, 256);
  if (threadIdx.x == 128) {
    __threadfence_system();
    tdt_dist::st_release(flag, epoch);
  }
}

// The torus order's add on two packed bf16 lanes: `add.rn.bf16x2`, the
// exact sum rounded once to bf16.  The reference's `_add_body` adds bf16
// values in f32 and rounds the sum to bf16; the bits agree, since f32's
// 24 bits hold 2 x 8 + 2 and a sum of two bf16 values rounds innocuously
// through it.
struct AddBf16x2 {
  __device__ __forceinline__ unsigned operator()(unsigned a,
                                                 unsigned b) const {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

// One fragment-order vector v of a consumer's sums into C, as packed bf16
// pairs: word 2 h2 + h is column tile 2 v + h2, row r + 8 h (rows >=
// `rows` dropped), columns + 0, 1 (columns >= n dropped); dst is the
// thread's row r, column col0 + 2 (lane % 4).
__device__ __forceinline__ void store_vec(bf16* dst, const unsigned (&wd)[4],
                                          int v, long long ldc, int r,
                                          int rows, int n, int col0,
                                          int lane) {
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int col = col0 + 8 * (2 * v + h2) + 2 * (lane & 3);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r + 8 * h < rows)
        *reinterpret_cast<unsigned*>(dst + 8 * h * ldc + 8 * (2 * v + h2)) =
            wd[2 * h2 + h];
  }
}

// The G staged partials of a consumer's half of a tile (slot q at
// `slot0` + q x slot_u4 vectors) summed in f32 in index order q = 0 .. G -
// 1 and written to C at c (the tile's row 0, row stride ldc; rows >=
// `rows` and columns >= n dropped).  A 16-byte vector v of the fragment
// order is the pairs of column tiles j = 2 v, 2 v + 1, rows r and r + 8.
// Every load of a vector is issued before its adds.
__device__ __forceinline__ void fold_store(const uint4* slot0,
                                           long long slot_u4, int G, int cw,
                                           bf16* c, long long ldc, int rows,
                                           int n, int col0) {
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const uint4* src = slot0 + cw * (TILE_U4 / 2) + wt;
  const int r = 64 * cw + 16 * warp + (lane >> 2);
  bf16* dst = c + r * ldc + col0 + 2 * (lane & 3);
#pragma unroll
  for (int v = 0; v < 16; ++v) {
    uint4 w[MAX_RANKS];
#pragma unroll
    for (int q = 0; q < MAX_RANKS; ++q)
      if (q < G) w[q] = __ldcg(src + q * slot_u4 + v * 128);
    float s[8];
#pragma unroll
    for (int q = 0; q < MAX_RANKS; ++q) {
      if (q >= G) break;
      const float x[8] = {bf16_lo(w[q].x), bf16_hi(w[q].x),
                          bf16_lo(w[q].y), bf16_hi(w[q].y),
                          bf16_lo(w[q].z), bf16_hi(w[q].z),
                          bf16_lo(w[q].w), bf16_hi(w[q].w)};
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = q == 0 ? x[e] : s[e] + x[e];
    }
    const unsigned wd[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                            pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7])};
    store_vec(dst, wd, v, ldc, r, rows, n, col0, lane);
  }
}

// The torus fold of a consumer's half of a tile: fold_store's sums in the
// reference's torus order and rounding, and its stores.  The
// fragment-order vector v holds columns 16 v .. 16 v + 15 of the tile, so
// 128-column unit v / 8: vectors 0-7 fold by the plan f0, 8-15 by f1
// (dist_verbs.cuh `fold_plan`; n_axes, the group's axes), every add
// rounded to bf16, on the packed words as they were staged.  The loads
// land in shared memory, not registers: `land`, this warpgroup's half of
// the mainloop ring's B tiles (idle once the block's GEMM items are done),
// two buffers of FOLD_V vectors x MAX_RANKS positions x 128 threads.
// Each thread copies its G staged vectors of a batch by cp.async, in plan
// order (position q's source plan_src(f, q) at q), while it folds the
// batch before; it reads back only what it copied, so no barrier.  (Held
// in registers, the G loads of a vector spilled at the kernel's 168
// registers with a second vector in flight (36 bytes: down 0.5090, wo
// 0.2515 ms); four positions at a time spilled nothing but ran 0.5246
// and 0.2665, against this design's 0.5035 and 0.2429 in the same call,
// PERF.md row 16.)
constexpr int FOLD_V = 2;
constexpr int LAND_U4 = 2 * FOLD_V * MAX_RANKS * 128;  // a warpgroup's
static_assert(LAND_U4 * 16 * 2 <= tdt_gemm90::Cfg<false, false>::NS *
                                      tdt_gemm90::Cfg<false, false>::B_BYTES,
              "both warpgroups' landing buffers fit in the ring's B tiles");

__device__ __forceinline__ void fold_store_torus(
    const uint4* slot0, long long slot_u4, int G, int cw, bf16* c,
    long long ldc, int rows, int n, int col0, const FoldPlan& f0,
    const FoldPlan& f1, int n_axes, uint4* land) {
  constexpr int BATCHES = 16 / FOLD_V;
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const uint4* src = slot0 + cw * (TILE_U4 / 2) + wt;
  const int r = 64 * cw + 16 * warp + (lane >> 2);
  bf16* dst = c + r * ldc + col0 + 2 * (lane & 3);
  land += wt;
  // batch b: vectors FOLD_V b .., into buffer b % 2
  auto issue = [&](int b) {
    const FoldPlan f = FOLD_V * b < 8 ? f0 : f1;
    uint4* to = land + (b & 1) * (LAND_U4 / 2);
#pragma unroll
    for (int k = 0; k < FOLD_V; ++k)
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q)
        if (q < G) {
          const uint4* from = src + tdt_dist::plan_src(f, q) * slot_u4 +
                              (FOLD_V * b + k) * 128;
          cp_async16(to + (k * MAX_RANKS + q) * 128, from, from);
        }
    cp_commit();
  };
  issue(0);
#pragma unroll 1
  for (int b = 0; b < BATCHES; ++b) {
    if (b + 1 < BATCHES)
      issue(b + 1);
    else
      cp_commit();  // an empty group: batch b is then the older one
    cp_wait<1>();
    const FoldPlan f = FOLD_V * b < 8 ? f0 : f1;
    const uint4* at = land + (b & 1) * (LAND_U4 / 2);
#pragma unroll
    for (int k = 0; k < FOLD_V; ++k) {
      unsigned acc[4][3];  // each word's running sums by level
#pragma unroll
      for (int q = 0; q < MAX_RANKS; ++q) {
        if (q >= G) break;
        const uint4 w = at[(k * MAX_RANKS + q) * 128];
        const unsigned x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tdt_dist::fold_step(f, q, x[i], acc[i], AddBf16x2());
      }
      const unsigned wd[4] = {tdt_dist::fold_result(acc[0], n_axes),
                              tdt_dist::fold_result(acc[1], n_axes),
                              tdt_dist::fold_result(acc[2], n_axes),
                              tdt_dist::fold_result(acc[3], n_axes)};
      store_vec(dst, wd, FOLD_V * b + k, ldc, r, rows, n, col0, lane);
    }
  }
  cp_wait<0>();
}

// The int8 fold: the G staged int32 partials of a consumer's half of a
// tile summed in index order (exact) and written to C at c (tile_out's
// vectors; rows >= `rows` and columns >= n dropped).
template <class C>
__device__ __forceinline__ void fold_store_i8(const uint4* slot0,
                                              long long slot_u4, int G,
                                              int cw, int* c, long long ldc,
                                              int rows, int n, int col0) {
  const uint4* src = slot0 + cw * (TILE_U4_I8 / 2) + (threadIdx.x & 127);
#pragma unroll 4
  for (int v = 0; v < 32; ++v) {
    const int r = frag_row<C>(v, cw);
    const int col = col0 + frag_col<C>(v);
    if (r >= rows || col >= n) continue;
    uint4 w[MAX_RANKS];
#pragma unroll
    for (int q = 0; q < MAX_RANKS; ++q)
      if (q < G) w[q] = __ldcg(src + q * slot_u4 + v * 128);
    int s[4] = {static_cast<int>(w[0].x), static_cast<int>(w[0].y),
                static_cast<int>(w[0].z), static_cast<int>(w[0].w)};
#pragma unroll
    for (int q = 1; q < MAX_RANKS; ++q) {
      if (q >= G) break;
      s[0] += static_cast<int>(w[q].x);
      s[1] += static_cast<int>(w[q].y);
      s[2] += static_cast<int>(w[q].z);
      s[3] += static_cast<int>(w[q].w);
    }
    *reinterpret_cast<int2*>(c + r * ldc + col) = make_int2(s[0], s[1]);
    if (r + 8 < rows)
      *reinterpret_cast<int2*>(c + (r + 8) * ldc + col) =
          make_int2(s[2], s[3]);
  }
}

// The torus part of 128-column unit u: the first q with u < part_end[q]
// (a part of no units is passed over; a unit past N, in the last tile's
// second half, takes the last part and is never stored).
template <class P>
__device__ __forceinline__ int torus_part(const P& p, int u) {
  int q = 0;
  while (q < 2 * p.grp.n - 1 && u >= p.part_end[q]) ++q;
  return q;
}

// MODE FLAT: the whole world reduces, in rank order (tdt_gemm_rs,
// tdt_gemm_rs_i8); GROUP: the ranks of `p.grp`, in index order
// (tdt_gemm_rs_group torus = 0, tdt_gemm_rs_group_i8); TORUS (bf16): the
// ranks of `p.grp`, each column part in its torus order and rounding
// (tdt_gemm_rs_group torus = 1).  I8: int8 A and B, exact int32 partials
// staged in int32 and summed exactly, on the tile i8_tall picks (TALL).
template <bool I8, bool B_NK, int MODE, bool TALL>
__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
gemm_rs_wg_kernel(const __grid_constant__
                  WgParams<typename std::conditional<I8, int, bf16>::type>
                      p) {
  static_assert(!(I8 && MODE == TORUS), "the torus order is bf16's");
  using C = tdt_gemm90::Cfg<I8, B_NK, TALL>;
  constexpr int TU4 = I8 ? TILE_U4_I8 : TILE_U4;
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  // bf16: staged tile n's stores done (the 256 consumer threads arrive),
  // and its flag raised (the signal warp arrives); two of each in turn
  __shared__ __align__(8) uint64_t staged[2], raised[2];
  const int me = blockIdx.y;
  const int G = MODE == FLAT ? p.world : p.grp.G;
  const int jm = MODE == FLAT ? me : tdt_dist::group_index(p.grp, me);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      tdt_sm90::mbar_init(&staged[q], 256);
      tdt_sm90::mbar_init(&raised[q], 1);
    }
    tdt_gemm90::init_barriers(sm);  // fences the inits
  }
  if (MODE == FLAT)  // both sync the block too
    tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  else
    tdt_dist::barrier_group(p.bar, me, p.grp, p.epoch);

  const int per = p.tiles_m * p.tiles_n;
  const int n_gemm = G * per;
  const int n_kt = (p.k + C::BK - 1) / C::BK;
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int t = blockIdx.x; t < n_gemm; t += gridDim.x) {
        const WgItem x = wg_item(p, t, jm, G);
        const int row0 = x.oj * p.m_loc + x.i * C::TM;
        for (int kt = 0; kt < n_kt; ++kt)
          tdt_gemm90::produce_k_tile<I8, B_NK, TALL>(
              sm, ring, &p.bmap, x.j * C::TN, kt, me,
              [&](void* dst, uint64_t* bar, int k0) {
                tdt_sm90::tma_load_3d(dst, &p.amap, bar, k0, row0, me);
              });
      }
    } else if (I8 && threadIdx.x >= 32) {
      const int mine = static_cast<int>(blockIdx.x) < n_gemm
                           ? (n_gemm - blockIdx.x - 1) / gridDim.x + 1
                           : 0;
      tdt_gemm90::transposer<C>(sm, mine, n_kt, threadIdx.x / 32 - 1);
    } else if (!I8 && threadIdx.x == 32) {
      // the signal warp: the flags of this block's staged tiles, in the
      // consumers' order
      int n = 0;
      for (int t = blockIdx.x; t < n_gemm; t += gridDim.x, ++n) {
        const WgItem x = wg_item(p, t, jm, G);
        const int owner =
            MODE == FLAT ? x.oj : tdt_dist::group_rank(p.grp, me, x.oj);
        tdt_sm90::mbar_wait(&staged[n & 1], (n >> 1) & 1);
        __threadfence_system();
        tdt_dist::st_release(p.flags.p[owner] + static_cast<long long>(jm) *
                                 per + x.i * p.tiles_n + x.j,
                             p.epoch);
        tdt_sm90::mbar_arrive(&raised[n & 1]);
      }
    }
    return;
  }
  tdt_sm90::regs_alloc<C::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1, wt = threadIdx.x & 127;
  tdt_sm90::Ring<C::NS> ring;
  tdt_sm90::Ring<C::NTS> tring;
  int n = 0;  // bf16: this block's staged tiles so far
  for (int t = blockIdx.x; t < n_gemm + per; t += gridDim.x) {
    if (t < n_gemm) {
      // my partial of chunk oj into slot jm of its owner's staging, and
      // the flag of that (slot, tile)
      const WgItem x = wg_item(p, t, jm, G);
      typename C::Acc acc[C::NACC];
      tdt_gemm90::mma_tile<I8, B_NK, TALL>(acc, sm, ring, tring, n_kt, cw);
      const int owner =
          MODE == FLAT ? x.oj : tdt_dist::group_rank(p.grp, me, x.oj);
      const long long f = static_cast<long long>(jm) * per +
                          x.i * p.tiles_n + x.j;
      if constexpr (I8) {
        tile_out<C>(acc, cw, p.m_loc - x.i * C::TM, nullptr,
                    p.stage.p[owner] + f * TU4);
        raise_tile(p.flags.p[owner] + f, p.epoch);
      } else {
        stage_tile(acc, p.stage.p[owner] + f * TU4, cw);
        // staged[n & 1] is free once the signal warp has raised tile n - 2
        if (n >= 2) tdt_sm90::mbar_wait(&raised[n & 1], ((n >> 1) - 1) & 1);
        tdt_sm90::mbar_arrive(&staged[n & 1]);
        ++n;
      }
      continue;
    }
    // my chunk's tile: the G staged partials folded into C
    const int tile = t - n_gemm, i = tile / p.tiles_n;
    const int j = tile - i * p.tiles_n;
    if (wt < G) tdt_dist::spin_until(p.flags.p[me] + wt * per + tile,
                                     p.epoch);
    tdt_sm90::named_sync(1 + cw, 128);
    const uint4* slot0 = p.stage.p[me] + static_cast<long long>(tile) * TU4;
    const long long slot_u4 = static_cast<long long>(per) * TU4;
    const int rows = min(C::TM, p.m_loc - i * C::TM);
    auto* c = p.out.p[me] + static_cast<long long>(i) * C::TM * p.n;
    if constexpr (I8) {
      fold_store_i8<C>(slot0, slot_u4, G, cw, c, p.n, rows, p.n, j * C::TN);
    } else if constexpr (MODE == TORUS) {
      // the first fold item: both consumer warpgroups are past their last
      // product (wgmma_wait<0>), and every TMA load of the ring has landed,
      // so the ring's B tiles are free for the fold's landing buffers
      if (t - static_cast<int>(gridDim.x) < n_gemm)
        tdt_sm90::named_sync(4, 256);
      fold_store_torus(slot0, slot_u4, G, cw, c, p.n, rows, p.n, j * C::TN,
                       p.plans[jm][torus_part(p, 2 * j)],
                       p.plans[jm][torus_part(p, 2 * j + 1)], p.grp.n,
                       reinterpret_cast<uint4*>(sm.b[0]) + cw * LAND_U4);
    } else {
      fold_store(slot0, slot_u4, G, cw, c, p.n, rows, p.n, j * C::TN);
    }
  }
}

// The int8 bidirectional ring (tdt_gemm_rs_bidir_i8) on the same
// mainloop and tiles: rank me's items in step order (step s, direction d,
// tile t of a half: rows i, columns d N / 2 + j TN ..), the chunk me - 1 -
// s (d 0, to the right) or me + 1 + s (d 1, to the left), its own at s =
// W - 1.  The consumers compute the partial tile, then for s >= 1 wait on
// the previous peer's flag of (d, s - 1, t), add that running sum from
// this rank's landing slot into the int32 registers (fragment order), and
// store the sum into the next peer's landing slot (d, s) in fragment
// order and raise its flag, or at the last step into C (row-major, masked
// to the half's columns and to m_loc).  A wait inside a consumer that
// holds its accumulator is safe only because every block is resident
// (cooperative launch) and an item waits only on an earlier step's item,
// whose consumers raise its flag before they wait on anything.
template <bool TALL>
__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
gemm_rs_bidir_i8_wg_kernel(const __grid_constant__ WgParams<int> p) {
  using C = tdt_gemm90::Cfg<true, false, TALL>;
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  const int me = blockIdx.y, W = p.world;
  if (threadIdx.x == 0) tdt_gemm90::init_barriers(sm);
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);  // syncs the block too

  const int nh = p.n / 2, per = p.tiles_m * p.tiles_n;
  const int n_items = W * 2 * per;
  const int n_kt = (p.k + C::BK - 1) / C::BK;
  // item it: step s, direction d, tile t = (i, j), its chunk
  struct Item {
    int s, d, t, i, j, chunk;
  };
  auto item = [&](int it) {
    Item x;
    const int sd = it / per;
    x.t = it - sd * per;
    x.s = sd / 2;
    x.d = sd - 2 * x.s;
    x.i = x.t / p.tiles_n;
    x.j = x.t - x.i * p.tiles_n;
    const int c =
        x.s == W - 1 ? me : (x.d == 0 ? me - 1 - x.s : me + 1 + x.s);
    x.chunk = c < 0 ? c + W : (c >= W ? c - W : c);
    return x;
  };
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const Item x = item(it);
        const int row0 = x.chunk * p.m_loc + x.i * C::TM;
        for (int kt = 0; kt < n_kt; ++kt)
          tdt_gemm90::produce_k_tile<true, false, TALL>(
              sm, ring, &p.bmap, x.d * nh + x.j * C::TN, kt, me,
              [&](void* dst, uint64_t* bar, int k0) {
                tdt_sm90::tma_load_3d(dst, &p.amap, bar, k0, row0, me);
              });
      }
    } else if (threadIdx.x >= 32) {
      const int mine = static_cast<int>(blockIdx.x) < n_items
                           ? (n_items - blockIdx.x - 1) / gridDim.x + 1
                           : 0;
      tdt_gemm90::transposer<C>(sm, mine, n_kt, threadIdx.x / 32 - 1);
    }
    return;
  }
  tdt_sm90::regs_alloc<C::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1, wt = threadIdx.x & 127;
  tdt_sm90::Ring<C::NS> ring;
  tdt_sm90::Ring<C::NTS> tring;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    int acc[C::NACC];
    tdt_gemm90::mma_tile<true, false, TALL>(acc, sm, ring, tring, n_kt, cw);
    const Item x = item(it);  // after the product: no register held over it
    const int rows = min(C::TM, p.m_loc - x.i * C::TM);
    const uint4* from = nullptr;
    if (x.s > 0) {
      // landing slot (d, s - 1) of tile t: [2][W - 1][tiles], flags alike
      const long long f =
          static_cast<long long>(x.d * (W - 1) + x.s - 1) * per + x.t;
      if (wt == 0) tdt_dist::spin_until(p.flags.p[me] + f, p.epoch);
      tdt_sm90::named_sync(1 + cw, 128);
      from = p.stage.p[me] + f * TILE_U4_I8;
    }
    if (x.s == W - 1) {
      tile_out<C>(acc, cw, rows, from, nullptr,
                  p.out.p[me] + static_cast<long long>(x.i) * C::TM * p.n +
                      x.d * nh,
                  p.n, nh, x.j * C::TN);
      continue;
    }
    const int next = x.d == 0 ? (me + 1 == W ? 0 : me + 1)
                              : (me == 0 ? W - 1 : me - 1);
    const long long to =
        static_cast<long long>(x.d * (W - 1) + x.s) * per + x.t;
    tile_out<C>(acc, cw, rows, from, p.stage.p[next] + to * TILE_U4_I8);
    raise_tile(p.flags.p[next] + to, p.epoch);
  }
}

// ------------------------------------------ the tile loop's bidir ring

struct Params {
  Peers<const bf16> a;     // rank r's A [W m_loc][k]
  Peers<const bf16> b;     // rank r's weight [k][N]
  Peers<bf16> stage;       // rank r's landing slots (below)
  Peers<bf16> out;         // rank r's C [m_loc][N]
  Peers<unsigned> flags;   // rank r's flags (below)
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  int world, m_loc, n, k;
  unsigned epoch;
};

// land: rank r's [2 directions][W - 1 slots][m_loc][N / 2] running sums;
// flags: rank r's [2][W - 1][tiles of m_loc x N / 2].  Rank me's items in
// step order: (step s, direction d, tile t); an item of step s waits only
// on the item (s - 1, d, t) of its previous peer, at an earlier place.
__global__ void __launch_bounds__(NT, 2)
gemm_rs_bidir_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, W = p.world;
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);

  const int nh = p.n / 2, tiles_n = (nh + BN - 1) / BN;
  const int per = (p.m_loc + BM - 1) / BM * tiles_n;  // tiles of a half
  const long long slot = static_cast<long long>(p.m_loc) * nh;
  const int n_items = W * 2 * per;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int sd = it / per, t = it - sd * per;
    const int s = sd / 2, d = sd - 2 * s;
    const int i = t / tiles_n, j = t - i * tiles_n;
    const bool last = s == W - 1;
    // d 0: chunk me - 1 - s, to the right; d 1: chunk me + 1 + s, left
    int chunk = last ? me : (d == 0 ? me - 1 - s : me + 1 + s);
    chunk = chunk < 0 ? chunk + W : (chunk >= W ? chunk - W : chunk);
    const int next = d == 0 ? (me + 1 == W ? 0 : me + 1)
                            : (me == 0 ? W - 1 : me - 1);
    const int rows = min(BM, p.m_loc - i * BM);
    float acc[4][4][4];
    tdt_bf16::mma_tile<false, true>(
        acc, smem,
        p.a.p[me] + (static_cast<long long>(chunk) * p.m_loc + i * BM) * p.k,
        p.k, p.b.p[me] + d * nh, p.n, rows, nh, p.k, 0, j * BN);
    // my rounded partial into its destination: my next peer's landing
    // slot s, or my output at the last step; then + the running sum from
    // my landing slot s - 1
    bf16* dst = last ? p.out.p[me] + static_cast<long long>(i) * BM * p.n +
                           d * nh
                     : p.stage.p[next] + (d * (W - 1) + s) * slot +
                           static_cast<long long>(i) * BM * nh;
    const long long ld = last ? p.n : nh;
    tdt_bf16::store_tile(acc, dst, ld, rows, nh, 0, j * BN);
    if (s > 0) {
      tdt_dist::wait(p.flags.p[me] + (d * (W - 1) + s - 1) * per + t,
                     p.epoch);
      fold_add(dst, ld, p.stage.p[me] + (d * (W - 1) + s - 1) * slot +
                            static_cast<long long>(i) * BM * nh,
               nh, rows, nh, j * BN);
    }
    if (!last)
      tdt_dist::signal(p.flags.p[next] + (d * (W - 1) + s) * per + t,
                       p.epoch);
  }
}

Params make_params(const long long* a, const long long* b,
                   const long long* stage, const long long* out,
                   const long long* flags, const long long* bar, int world,
                   int m_loc, int n, int k, unsigned epoch) {
  Params p;
  p.a = peers<const bf16>(a, world);
  p.b = peers<const bf16>(b, world);
  p.stage = peers<bf16>(stage, world);
  p.out = peers<bf16>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  return p;
}

// The tensor maps of p over the rank-stacked a [W][G m_loc][k] and b
// ([W][k][N], or [W][N][k] with b_nk) for the tiles of C; the ranks of
// each table must be equally spaced (a map spans them).  int8 B is
// staged as it lies (the raw [128 k][TN] tile, no swizzle) for the
// transposers.
template <class C, class P>
int make_maps(P& p, const long long* a, const long long* b, int G, int world,
              int m_loc, int n, int k, bool b_nk) {
  constexpr int E = sizeof(typename C::T);
  constexpr bool I8 = E == 1;
  const long long a_rs = tdt_dist::rank_stride(a, world,
                                               1LL * E * G * m_loc * k);
  const long long b_rs = tdt_dist::rank_stride(b, world, 1LL * E * k * n);
  if (a_rs < 0 || b_rs < 0) return static_cast<int>(cudaErrorInvalidValue);
  // the device's context current on this thread before the encodes (an
  // autograd worker thread may have none yet: tdt_gemm90::launch_gemm)
  int dev = 0;
  cudaGetDevice(&dev);
  cudaSetDevice(dev);
  const auto dt = I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const void* a0 = reinterpret_cast<const void*>(a[0]);
  const void* b0 = reinterpret_cast<const void*>(b[0]);
  const long long ad[3] = {k, static_cast<long long>(G) * m_loc, world};
  const long long as[3] = {1, k, a_rs / E};
  const int abox[3] = {C::BK, C::TM, 1};
  int err = tdt_sm90::make_map_t(&p.amap, dt, E, sw, a0, 3, ad, as, abox);
  if (err) return err;
  if (b_nk) {  // b [W][N][k]: K-major boxes of 256 rows
    const long long bd[3] = {k, n, world}, bs[3] = {1, k, b_rs / E};
    const int bbox[3] = {C::BK, C::TN, 1};
    return tdt_sm90::make_map_t(&p.bmap, dt, E, sw, b0, 3, bd, bs, bbox);
  }
  // b [W][k][N]: bf16 64-column boxes; int8 the raw tile
  const long long bd[3] = {n, k, world}, bs[3] = {1, n, b_rs / E};
  const int bbox[3] = {I8 ? C::TN : 64, C::BK, 1};
  return tdt_sm90::make_map_t(&p.bmap, dt, E,
                              I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : sw, b0, 3,
                              bd, bs, bbox);
}

template <class OutT>
WgParams<OutT> wg_params(const long long* stage, const long long* out,
                         const long long* flags, const long long* bar,
                         const Group& g, int world, int m_loc, int n, int k,
                         unsigned epoch) {
  WgParams<OutT> p;
  p.stage = peers<uint4>(stage, world);
  p.out = peers<OutT>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = g;
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  return p;
}

// Launch the uni kernel over the group `g` (FLAT: the flat world;
// TORUS: part_end, the 2 g.n parts' ends in 128-column units, and each
// joint index's fold plans, made here): the tensor maps, then the
// cooperative grid.
template <bool I8, bool B_NK, int MODE, bool TALL = false>
int launch_wg(const long long* a, const long long* b, const long long* stage,
              const long long* out, const long long* flags,
              const long long* bar, const Group& g, int world, int m_loc,
              int n, int k, unsigned epoch, void* stream,
              const int* part_end = nullptr) {
  using C = tdt_gemm90::Cfg<I8, B_NK, TALL>;
  auto p = wg_params<typename std::conditional<I8, int, bf16>::type>(
      stage, out, flags, bar, g, world, m_loc, n, k, epoch);
  for (int q = 0; q < 6; ++q) {
    p.part_end[q] = part_end != nullptr && q < 2 * g.n ? part_end[q] : 0;
    for (int j = 0; j < MAX_RANKS; ++j)
      p.plans[j][q] = part_end != nullptr && q < 2 * g.n && j < g.G
                          ? tdt_dist::fold_plan(g, j, q)
                          : FoldPlan{0u, 0u, 0u};
  }
  p.tiles_m = (m_loc + C::TM - 1) / C::TM;
  p.tiles_n = (n + C::TN - 1) / C::TN;
  const int err = make_maps<C>(p, a, b, g.G, world, m_loc, n, k, B_NK);
  if (err) return err;
  const int items = (g.G + 1) * p.tiles_m * p.tiles_n;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(gemm_rs_wg_kernel<I8, B_NK, MODE, TALL>, p,
                               tdt_gemm90::NT, tdt_gemm90::smem_bytes<C>(),
                               world, items, attr,
                               static_cast<cudaStream_t>(stream));
}

// The int8 uni kernel on the tile i8_tall picks.
template <int MODE>
int launch_wg_i8(const long long* a, const long long* b,
                 const long long* stage, const long long* out,
                 const long long* flags, const long long* bar, const Group& g,
                 int world, int m_loc, int n, int k, unsigned epoch,
                 void* stream) {
  return i8_tall(m_loc)
             ? launch_wg<true, false, MODE, true>(a, b, stage, out, flags,
                                                  bar, g, world, m_loc, n, k,
                                                  epoch, stream)
             : launch_wg<true, false, MODE, false>(a, b, stage, out, flags,
                                                   bar, g, world, m_loc, n,
                                                   k, epoch, stream);
}

// The int8 bidir ring: the tile grid of a half (N / 2 columns), the same
// maps as the uni kernel's over the flat world.
template <bool TALL>
int launch_bidir_i8(const long long* a, const long long* b,
                    const long long* land, const long long* out,
                    const long long* flags, const long long* bar, int world,
                    int m_loc, int n, int k, unsigned epoch, void* stream) {
  using C = tdt_gemm90::Cfg<true, false, TALL>;
  auto p = wg_params<int>(land, out, flags, bar, tdt_dist::flat_group(world),
                          world, m_loc, n, k, epoch);
  p.tiles_m = (m_loc + C::TM - 1) / C::TM;
  p.tiles_n = (n / 2 + C::TN - 1) / C::TN;
  const int err = make_maps<C>(p, a, b, world, world, m_loc, n, k, false);
  if (err) return err;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(gemm_rs_bidir_i8_wg_kernel<TALL>, p,
                               tdt_gemm90::NT, tdt_gemm90::smem_bytes<C>(),
                               world, world * 2 * p.tiles_m * p.tiles_n,
                               attr, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses of one rank-stacked tensor (equally
// spaced: the kernel's tensor maps span them).  bf16 throughout; m_loc >=
// 1, k % 8 == 0 and n % 8 == 0, every base 16-byte aligned (the wrapper
// checks); stage: W * tiles * 128 * 256 elements per rank and flags: W *
// tiles per rank, tiles = ceil(m_loc / 128) * ceil(n / 256); epoch: this
// call's, from the workspace.
extern "C" int tdt_gemm_rs(const long long* a, const long long* b,
                           const long long* stage, const long long* out,
                           const long long* flags, const long long* bar,
                           int world, int m_loc, int n, int k, int b_nk,
                           unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || m_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Group g = tdt_dist::flat_group(world);
  return b_nk ? launch_wg<false, true, FLAT>(a, b, stage, out, flags, bar,
                                             g, world, m_loc, n, k, epoch,
                                             stream)
              : launch_wg<false, false, FLAT>(a, b, stage, out, flags, bar,
                                              g, world, m_loc, n, k, epoch,
                                              stream);
}

// The bidirectional ring: bf16, b [k][N] (no transposed mode); world >= 2,
// N % 16 == 0 (whole 16-byte rows of each half); land: 2 (W - 1) m_loc
// N / 2 per rank; flags: 2 (W - 1) ceil(m_loc / 128) ceil(N / 256) per
// rank.
extern "C" int tdt_gemm_rs_bidir(const long long* a, const long long* b,
                                 const long long* land,
                                 const long long* out,
                                 const long long* flags,
                                 const long long* bar, int world, int m_loc,
                                 int n, int k, unsigned epoch,
                                 void* stream) {
  if (world < 2 || world > MAX_RANKS || m_loc < 1 || n % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(a, b, land, out, flags, bar, world, m_loc, n, k,
                         epoch);
  const int per = (m_loc + BM - 1) / BM * ((n / 2 + BN - 1) / BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(gemm_rs_bidir_kernel, p, NT,
                               Tiles<false>::SMEM, world, world * 2 * per,
                               attr, static_cast<cudaStream_t>(stream));
}

// The int8 mode of the bidirectional ring: int8 A and B [k][N], int32
// land and C; world >= 2, k % 32 == 0 and N % 32 == 0 (each half starts
// on a 16-byte column); land: 2 (W - 1) tiles x 128 x 256 int32 per rank
// and flags: 2 (W - 1) tiles per rank, tiles = ceil(m_loc / TM) x
// ceil(N / 2 / TN) (the int8 tile TM x TN).
extern "C" int tdt_gemm_rs_bidir_i8(const long long* a, const long long* b,
                                    const long long* land,
                                    const long long* out,
                                    const long long* flags,
                                    const long long* bar, int world,
                                    int m_loc, int n, int k, unsigned epoch,
                                    void* stream) {
  if (world < 2 || world > MAX_RANKS || m_loc < 1 || n % 32 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return i8_tall(m_loc)
             ? launch_bidir_i8<true>(a, b, land, out, flags, bar, world,
                                     m_loc, n, k, epoch, stream)
             : launch_bidir_i8<false>(a, b, land, out, flags, bar, world,
                                      m_loc, n, k, epoch, stream);
}

// The int8 mode: int8 A and B [k][N], int32 stage and C; m_loc >= 1, k %
// 32 == 0 and n % 16 == 0; stage: W * tiles * 128 * 256 int32 per rank
// and flags: W * tiles per rank, tiles = ceil(m_loc / TM) * ceil(n / TN).
extern "C" int tdt_gemm_rs_i8(const long long* a, const long long* b,
                              const long long* stage, const long long* out,
                              const long long* flags, const long long* bar,
                              int world, int m_loc, int n, int k,
                              unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || m_loc < 1 || n % 16 || k % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wg_i8<FLAT>(a, b, stage, out, flags, bar,
                            tdt_dist::flat_group(world), world, m_loc, n, k,
                            epoch, stream);
}

// The torus GEMM-RS (the TPU `_torus_gemm_rs_kernel`, gemm_reduce_scatter.py
// :326, launched from `_torus_gemm_rs_shard` :571) and the uni kernel over
// one axis of a larger mesh: gemm_rs_wg_kernel over the joint group
// `group` ([n, size0..2, stride0..2]; dist_verbs.cuh `Group`) instead of
// the flat world.  A's rows are the group's G chunks in joint order (flat
// axes-major), and rank r of joint index j gets chunk j.  Stage and flags
// as tdt_gemm_rs's with G slots (gemm_reduce_scatter.wg_workspace).
//
// torus = 1 (bf16, 2 or 3 axes; N % 128 == 0): the TORUS mode, the
// reference's torus order.  It cuts the N columns into 2n parts in
// 128-column units (`_split_parts(N // 128, 2n)`, :591-597), part q taking
// path flavor q; phase 0 rings along the flavor's first axis with the GEMM
// as producer, later phases ring the order-major sub-bands (:415-561),
// every hop adding `acc = local + recv` in bf16 (`_add_body`).  NVLink
// joins every rank of the group to every other, so the kernel keeps the
// uni kernel's items, staging and flags (every rank's bf16 partial of
// every chunk in slot jm of the owner's stage, fragment order, a flag per
// (slot, 128 x 256 tile)), and only its fold items differ: the owner
// loads the G staged vectors of each fragment-order vector, then folds
// them in the order and rounding of the part its 16 columns fall in
// (dist_verbs.cuh `fold_plan`: the G x 2n plans made on the host, in the
// parameters; a 128 x 256 tile may span two parts).  Given the same
// partials, the sums are bit for bit the reference's.  part_end: the 2n
// parts' ends in 128-column units (the last = N / 128).  Deadlock
// freedom is the uni kernel's: the launch is cooperative (every block
// resident), in every rank's list every GEMM item comes before every fold
// item, a fold item waits only on GEMM items' flags, and a GEMM item
// waits on nothing.
// torus = 0: the GROUP mode, its f32 sum in index order (part_end unused).
// The int8 mode (tdt_gemm_rs_group_i8): exact int32 partials and sums, so
// the torus order's sums are these.
extern "C" int tdt_gemm_rs_group(const long long* a, const long long* b,
                                 const long long* stage,
                                 const long long* out,
                                 const long long* flags,
                                 const long long* bar, const int* group,
                                 const int* part_end, int torus, int world,
                                 int m_loc, int n, int k, int b_nk,
                                 unsigned epoch, void* stream) {
  const Group g = tdt_dist::group_from(group);
  if (world < 1 || world > MAX_RANKS || m_loc < 1 ||
      tdt_dist::bad_group(g, world) ||
      (torus && (g.n < 2 || n % TORUS_UNIT ||
                 part_end[2 * g.n - 1] != n / TORUS_UNIT)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (torus)
    return b_nk ? launch_wg<false, true, TORUS>(a, b, stage, out, flags, bar,
                                                g, world, m_loc, n, k, epoch,
                                                stream, part_end)
                : launch_wg<false, false, TORUS>(a, b, stage, out, flags,
                                                 bar, g, world, m_loc, n, k,
                                                 epoch, stream, part_end);
  return b_nk ? launch_wg<false, true, GROUP>(a, b, stage, out, flags, bar,
                                              g, world, m_loc, n, k, epoch,
                                              stream)
              : launch_wg<false, false, GROUP>(a, b, stage, out, flags, bar,
                                               g, world, m_loc, n, k, epoch,
                                               stream);
}

extern "C" int tdt_gemm_rs_group_i8(const long long* a, const long long* b,
                                    const long long* stage,
                                    const long long* out,
                                    const long long* flags,
                                    const long long* bar, const int* group,
                                    int world, int m_loc, int n, int k,
                                    unsigned epoch, void* stream) {
  const Group g = tdt_dist::group_from(group);
  if (world < 1 || world > MAX_RANKS || m_loc < 1 || n % 16 || k % 32 ||
      tdt_dist::bad_group(g, world))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wg_i8<GROUP>(a, b, stage, out, flags, bar, g, world, m_loc,
                             n, k, epoch, stream);
}
