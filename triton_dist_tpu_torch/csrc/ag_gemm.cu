// ag_gemm: the overlapped AllGather-GEMM of the tensor-parallel linears for
// Hopper (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/allgather_gemm.py
// `_ag_gemm_kernel` (:240, launched from `ag_gemm_shard` at :828), its
// uni-directional ring, in both of the modes its A dtype picks (:700-705).
// Same contract, for every rank r of a world of W: given the rank's rows
// A_r [m_loc, K] and its weight shard B_r [K, n], it returns the gathered
// A_full [W m_loc, K] (segment s = rank s's rows, on every rank) and C_r =
// A_full @ B_r [W m_loc, n]:
// - tdt_ag_gemm: bf16 with f32 accumulation; B_r may also be B_r^T stored
//   [n][K] (the backward's transposed operand, read in place);
// - tdt_ag_gemm_i8: int8 A and B, the pushes move int8 and C is the exact
//   int32 product (the W8A8 column-parallel linears; no backward, so no
//   transposed B).
//
// Schedule (uni): full mesh, not the TPU's ring.  A TPU chip reaches its
// two ring neighbours over ICI, so the reference forwards each segment one
// hop per step; NVLink joins every H100 of a host to every other, so here
// each rank pushes its own segment straight into every rank's gathered
// buffer.  The push is cut into the reference's `chunks` (:370-373): c row
// chunks of m_loc / c rows, each with one flag per (receiving rank,
// segment, chunk); a chunk moves as pieces of one row tile (128 rows; 256
// on the torus int8 tile), each pushed by one block and counted at the
// receiver, and the last piece of a chunk raises its flag.  The GEMM tiles
// of rank r start on r's own segment, read from its input without waiting
// (the reference's step 0), then walk the segments r + 1, r + 2, ... and
// wait on the flags of every chunk their rows span.  On one card (the virtual
// world) the pushes are device-memory copies, not NVLink transfers.
//
// The int8 wire (tdt_ag_gemm_wire, the reference's `wire_dtype="int8"`,
// :295-311): each rank's rows arrive quantized per row (int8 and an f32
// scale per row; the reference's [m_loc, 128] scale plane is a TPU lane
// unit, here [m_loc] floats), the pushes move the int8 rows and their
// scales, and the GEMM tiles dequantize in their A-tile load
// (bf16_tile.cuh A_I8): bf16(float(q) * scale), then the bf16 product.
//
// The bidirectional ring (tdt_ag_gemm_bidir, the TPU `_ag_gemm_bidir_
// kernel` :108): each segment splits into a top half that rings rightward
// and a bottom half that rings leftward.  At step s rank me holds the top
// half of slot me - s and the bottom half of slot me + s: it forwards each
// to its next peer in that half's direction (step 0 from its input, later
// steps once the half's flag has reached this call), and its GEMM tiles
// consume the two halves of step s.  One flag set per direction (slot and
// direction index the flag), as the reference keeps semaphores per
// direction, so an arrival from one direction never passes a wait on the
// other.  Its GEMM tiles run on the uni kernel's wgmma / TMA mainloop
// (ag_gemm_bidir_wg_kernel), step by step, within a step column band by
// column band over both halves' row tiles, so the blocks that run
// together share B's columns as the uni kernel's do over a segment (the
// reference's order, half, row tile, then column, put every column band
// under one wave: gate/up 0.73 against 0.54 ms, PERF.md row 13b).  The
// tile-loop kernel it replaced ran gate/up in 1.03 ms.
//
// Row tails: m_loc is any positive count (a 1,000-token prompt over 4
// ranks gives 250 rows).  Tiles are indexed by (segment, tile within the
// segment), ceil(m_loc / BM) of them per segment, and the last tile of a
// segment is masked to the rows it holds (loads past them zero-filled,
// stores past them dropped), so a tile never straddles two segments and
// waits on one flag.
//
// What bounds it on an H100: Llama-3-8B's gate/up projection at TP 4
// (m_loc 512, K 4096, n 3584) is 240.5 GFLOP over the four ranks, 0.243 ms
// at the 989 TFLOP/s bf16 peak, against 260 MB that must move (A, B, the
// gathered A and C): operations bound it.  The gather moves 16 x 4 MB.
// In int8 the same projection is 240.5 G int8 operations, 0.1215 ms at the
// 1,979 TOP/s int8 peak, against 218 MB (int8 A, B and gathered A, i32 C):
// operations still bound it.  The torus order at TP 8 over (2, 4) (m_loc
// 256, n 1,792 a rank) does the same 240.5 G operations: 0.243 ms bf16,
// 0.1215 ms int8.
//
// Design.  One cooperative launch holds every rank of the virtual world: a
// persistent grid, sized by the occupancy calculator so every block is
// resident (a spin-wait is safe only then), split evenly among the ranks.
// A rank's blocks walk its item list in strides: the copies first (the
// ring's forwards in step order), then the GEMM tiles.  Every item waits
// only on items at earlier places of another rank's list, which every
// block reaches first, so no wait can close a cycle.  Every block passes
// barrier_all on entry (the reference's neighbour barrier, :339-344), or
// barrier_group over the torus's joint group: no rank writes into a peer
// that has not entered the kernel.  The uni kernels (tdt_ag_gemm,
// tdt_ag_gemm_i8) and the torus order (tdt_ag_gemm_torus[_i8]) are one
// kernel, ag_gemm_wg_kernel, over the flat world (FLAT) or a joint group;
// it and the bidir ring (tdt_ag_gemm_bidir: ag_gemm_bidir_wg_kernel) run
// their tiles on the wgmma / TMA mainloop of sm90_gemm.cuh, 128 x 256
// (the torus int8 256 x 128); the wire keeps the tile loop of
// bf16_tile.cuh (128 x 128).  The torus's int8 tile, A/B at Llama-3-8B
// TP-8 widths on (2, 4), m_loc 256 (PERF.md row 14i; NVIDIA H100 80GB
// HBM3, 700 W): 256 x 128 0.4108 ms against 128 x 256 0.4297 (the
// transposers set the int8 rate, and a transposed byte serves twice the
// rows); the flat int8 mode stays on 128 x 256 (PERF.md rows 8 / 9).
// The tile loops the torus order ran on before (bf16_tile.cuh 128 x 128,
// i8_tile.cuh 64 x 128) took gate/up 0.99 ms bf16, 1.01 int8.  The flat
// instances' loops keep their earlier text (item_of for every item, the
// group flags folded in): a walk split into copy and tile functions ran
// the flat int8 mode 4% slower in device time with fewer instructions
// (PERF.md, PR 24).
//
// Piece counters: a chunk's pieces add one each to the receiver's counter
// for that chunk (after their copy and a system fence); the piece that
// brings it to the chunk's count resets it to 0 for the next call and
// raises the chunk's flag with this call's epoch.  A flag never needs
// clearing; a counter is 0 between calls.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_tile.cuh"
#include "dist_verbs.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace tdt_frag;
using tdt_dist::count_signal;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

template <class TA, class TB, class OutT>
struct Params {
  Peers<const TA> a;       // rank r's rows [m_loc][K] (the wire: int8)
  Peers<const float> s;    // the wire: rank r's row scales [m_loc]
  Peers<const TB> b;       // rank r's weight [K][n], or [n][K] (B_NK)
  Peers<TA> ag;            // rank r's gathered A [W m_loc][K]: peers write
  Peers<float> ag_s;       // the wire: rank r's gathered scales [W m_loc]
  Peers<OutT> c;           // rank r's C [W m_loc][n]
  Peers<unsigned> flags;   // uni: [W segments][chunks]; bidir: [2][W]
  Peers<unsigned> cnt;     // piece counters, laid out as the flags
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  tdt_dist::Group grp;     // uni: the ranks that gather (segment = index)
  int world, m_loc, n, k;
  int crow;                // rows of one chunk (uni; m_loc % crow == 0)
  unsigned epoch;
};

// The wire's scales of `rows` rows (whole floats, any count).
__device__ __forceinline__ void put_scales(float* dst, const float* src,
                                           int rows) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    dst[i] = __ldcg(src + i);
}

// One item of rank `me`'s uni list of n_copy + G * tiles * tiles_n (G the
// ranks of its group `g`, `j` its index there): a copy (it < n_copy) of
// piece `piece` of chunk `chunk` of my segment into rank `peer`'s gathered
// buffer (the peers first, my own buffer last, so no block waits on my own
// copy), or a GEMM tile (segment `seg`, row tile `tile`, column tile
// `col`) walking the segments from my own.  `rows`: the rows the piece or
// row tile holds.
struct Item {
  bool copy;
  int peer, chunk, piece, seg, tile, col, rows;
};

template <int BM, bool FLAT, bool COLS_OUTER = false>
__device__ __forceinline__ Item item_of(int it, int me,
                                        const tdt_dist::Group& g, int G,
                                        int j, int m_loc, int crow,
                                        int tiles, int tiles_n) {
  Item x{};
  const int ppc = (crow + BM - 1) / BM;           // pieces per chunk
  const int per_peer = m_loc / crow * ppc;
  const int n_copy = G * per_peer;
  x.copy = it < n_copy;
  if (x.copy) {
    const int p = it / per_peer, rest = it - p * per_peer;
    int to = j + 1 + p;
    if (to >= G) to -= G;
    x.peer = FLAT ? to : tdt_dist::group_rank(g, me, to);
    x.chunk = rest / ppc;
    x.piece = rest - x.chunk * ppc;
    x.rows = min(BM, crow - x.piece * BM);
  } else {
    const int t = it - n_copy;
    x.seg = (j + t / (tiles * tiles_n)) % G;
    if (COLS_OUTER) {  // the blocks that run together share B's columns
      x.col = (t / tiles) % tiles_n;
      x.tile = t % tiles;
    } else {
      x.tile = (t / tiles_n) % tiles;
      x.col = t % tiles_n;
    }
    x.rows = min(BM, m_loc - x.tile * BM);
  }
  return x;
}

// The rows a GEMM tile reads: my own input for my own segment j (no wait),
// else my gathered buffer once the flag of every chunk the tile's rows
// span has reached this call.  `scale`: the wire's row scales beside.
template <int BM, class TA, class TB, class OutT>
__device__ __forceinline__ const TA* tile_rows(
    const Params<TA, TB, OutT>& p, int me, int j, const Item& x,
    const float** scale) {
  const long long row0 = static_cast<long long>(x.tile) * BM;
  if (x.seg == j) {
    *scale = p.s.p[me] ? p.s.p[me] + row0 : nullptr;
    return p.a.p[me] + row0 * p.k;
  }
  const int n_chunks = p.m_loc / p.crow;
  const int c0 = static_cast<int>(row0) / p.crow;
  const int c1 = (static_cast<int>(row0) + x.rows - 1) / p.crow;
  tdt_dist::wait(p.flags.p[me] + x.seg * n_chunks + c0, p.epoch,
                 c1 - c0 + 1);
  const long long seg_row = static_cast<long long>(x.seg) * p.m_loc + row0;
  *scale = p.ag_s.p[me] ? p.ag_s.p[me] + seg_row : nullptr;
  return p.ag.p[me] + seg_row * p.k;
}

// Push piece x.piece of chunk x.chunk of my segment (j) into rank x.peer's
// gathered buffer (and the wire's scales), then count it there.
template <int BM, class TA, class TB, class OutT>
__device__ __forceinline__ void push_piece(const Params<TA, TB, OutT>& p,
                                           int me, int j, const Item& x) {
  const int n_chunks = p.m_loc / p.crow;
  const int row0 = x.chunk * p.crow + x.piece * BM;
  const long long dst_row = static_cast<long long>(j) * p.m_loc + row0;
  tdt_dist::putmem(p.ag.p[x.peer] + dst_row * p.k,
                   p.a.p[me] + static_cast<long long>(row0) * p.k,
                   static_cast<long long>(x.rows) * p.k *
                       static_cast<int>(sizeof(TA)));
  if (p.s.p[me]) put_scales(p.ag_s.p[x.peer] + dst_row, p.s.p[me] + row0,
                            x.rows);
  const int f = j * n_chunks + x.chunk;
  count_signal(p.cnt.p[x.peer] + f, (p.crow + BM - 1) / BM,
               p.flags.p[x.peer] + f, p.epoch);
}

// The tile-loop kernel of the int8 wire (int8 rows dequantized in the
// A-tile load of bf16_tile.cuh, B [K][n]; the flat world).  Two blocks per
// SM: 128 registers, no spills (ptxas), 10-30% faster than the one block
// that 167-213 registers allow (PERF.md).
__global__ void __launch_bounds__(tdt_bf16::NT, 2)
ag_gemm_kernel(const __grid_constant__ Params<int8_t, bf16, bf16> p) {
  constexpr int BM = tdt_bf16::BM, BN = tdt_bf16::BN;
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, W = p.world;
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);

  const int tiles = (p.m_loc + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int n_copy = W * (p.m_loc / p.crow) * ((p.crow + BM - 1) / BM);
  const int n_items = n_copy + W * tiles * tiles_n;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item x = item_of<BM, true>(it, me, p.grp, W, me, p.m_loc, p.crow,
                                     tiles, tiles_n);
    if (x.copy) {
      push_piece<BM>(p, me, me, x);
      continue;
    }
    const float* scale = nullptr;
    const int8_t* src = tile_rows<BM>(p, me, me, x, &scale);
    float acc[4][4][4];
    tdt_bf16::mma_tile<false, true, true>(acc, smem, src, p.k, p.b.p[me],
                                          p.n, x.rows, p.n, p.k, 0,
                                          x.col * BN, scale);
    tdt_bf16::store_tile(acc,
               p.c.p[me] + (static_cast<long long>(x.seg) * p.m_loc +
                            static_cast<long long>(x.tile) * BM) * p.n,
               p.n, x.rows, p.n, 0, x.col * BN);
  }
}

// The uni kernels of tdt_ag_gemm (bf16, B [K][n] or [n][K]) and
// tdt_ag_gemm_i8 (int8, exact int32 C) over the flat world (FLAT), and of
// the torus entries over a joint group: the same item list, flags and
// pushes as the wire's kernel above (item_of, push_piece; pieces of one
// row tile), each GEMM tile on the warp-specialised wgmma / TMA
// mainloop of sm90_gemm.cuh (Cfg's tile: 128 x 256, or int8 256 x 128 with
// TALL).  A block passes the entry barrier (barrier_all, or off the flat
// world barrier_group after thread 0 has put my index j in the group into
// shared memory: the producer's 40 registers hold no group state, it
// reads j there at every tile), runs its copy items with all its threads,
// then splits: the producer warpgroup's warp 0 waits on a tile's flags
// (lane i on chunk c0 + i; the torus has one chunk a segment), then its
// lane 0 issues fence.proxy.async.global (the peers' pushes are
// generic-proxy stores; the TMA that reads them is the async proxy) and
// the tile's loads; in int8 warps 1-3 transpose each staged B tile; the
// consumer warpgroups multiply and store.  Every TMA load reads this
// rank's own memory: its input for its own segment j, its gathered buffer
// for the others, its own weight.  The maps span the rank-stacked
// tensors with the rank outermost, and their row dimension is bounded at
// m_loc, so a ragged last tile reads zeros, never the next segment's
// rows (which may still be in flight): a tile waits only on its own
// segment's chunks.
template <bool I8, bool B_NK>
struct WgParams {
  CUtensorMap amap;   // a  {K, m_loc, W}
  CUtensorMap agmap;  // ag {K, m_loc, G segments, W ranks}
  CUtensorMap bmap;   // b  {n, K, W}, or {K, n, W} (B_NK)
  Params<typename tdt_gemm90::Cfg<I8, B_NK>::T,
         typename tdt_gemm90::Cfg<I8, B_NK>::T,
         typename std::conditional<I8, int, bf16>::type> q;
};

template <bool I8, bool B_NK, bool FLAT, bool TALL = false>
__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
ag_gemm_wg_kernel(const __grid_constant__ WgParams<I8, B_NK> p) {
  using C = tdt_gemm90::Cfg<I8, B_NK, TALL>;
  constexpr int BM = C::TM, BN = C::TN;
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  __shared__ int s_j;  // my index in the group
  const auto& q = p.q;
  const int me = blockIdx.y, W = FLAT ? q.world : q.grp.G;
  if (threadIdx.x == 0) tdt_gemm90::init_barriers(sm);
  if (FLAT) {
    tdt_dist::barrier_all(q.bar, me, W, q.epoch);  // syncs the block too
  } else {
    if (threadIdx.x == 0) s_j = tdt_dist::group_index(q.grp, me);
    tdt_dist::barrier_group(q.bar, me, q.grp, q.epoch);
  }

  const int tiles = (q.m_loc + BM - 1) / BM, tiles_n = (q.n + BN - 1) / BN;
  const int n_copy = W * (q.m_loc / q.crow) * ((q.crow + BM - 1) / BM);
  const int n_items = n_copy + W * tiles * tiles_n;
  int it = blockIdx.x;
  for (; it < n_copy; it += gridDim.x) {
    const int j = FLAT ? me : s_j;
    push_piece<BM>(q, me, j,
                   item_of<BM, FLAT>(it, me, q.grp, W, j, q.m_loc, q.crow,
                                     tiles, tiles_n));
  }
  const int n_kt = (q.k + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (warp == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int t = it; t < n_items; t += gridDim.x) {
        const int j = FLAT ? me : s_j;
        const Item x = item_of<BM, FLAT, true>(t, me, q.grp, W, j, q.m_loc,
                                               q.crow, tiles, tiles_n);
        const int row0 = x.tile * BM;
        if (x.seg != j) {
          const int c0 = row0 / q.crow;
          if (lane <= (row0 + x.rows - 1) / q.crow - c0)
            tdt_dist::spin_until(
                q.flags.p[me] + x.seg * (q.m_loc / q.crow) + c0 + lane,
                q.epoch);
          __syncwarp();
        }
        if (lane == 0) {
          if (x.seg != j) tdt_sm90::fence_proxy_async_global();
          for (int kt = 0; kt < n_kt; ++kt)
            tdt_gemm90::produce_k_tile<I8, B_NK, TALL>(
                sm, ring, &p.bmap, x.col * BN, kt, me,
                [&](void* dst, uint64_t* bar, int k0) {
                  if (x.seg == j)
                    tdt_sm90::tma_load_3d(dst, &p.amap, bar, k0, row0, me);
                  else
                    tdt_sm90::tma_load_4d(dst, &p.agmap, bar, k0, row0,
                                          x.seg, me);
                });
        }
        __syncwarp();
      }
    } else if (I8) {
      const int mine = it < n_items ? (n_items - it - 1) / gridDim.x + 1 : 0;
      tdt_gemm90::transposer<C>(sm, mine, n_kt, warp - 1);
    }
  } else {
    tdt_sm90::regs_alloc<C::CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    tdt_sm90::Ring<C::NS> ring;
    tdt_sm90::Ring<C::NTS> tring;
    for (int t = it; t < n_items; t += gridDim.x) {
      const Item x = item_of<BM, FLAT, true>(t, me, q.grp, W,
                                             FLAT ? me : s_j, q.m_loc,
                                             q.crow, tiles, tiles_n);
      typename C::Acc acc[C::NACC];
      tdt_gemm90::mma_tile<I8, B_NK, TALL>(acc, sm, ring, tring, n_kt, cw);
      tdt_gemm90::store_tile<I8, B_NK, TALL>(
          acc,
          q.c.p[me] + (static_cast<long long>(x.seg) * q.m_loc +
                       static_cast<long long>(x.tile) * BM) * q.n,
          q.n, x.rows, q.n, x.col * BN, cw);
    }
  }
}

// The bidirectional ring (tdt_ag_gemm_bidir), bf16, B [K][n], on the
// mainloop of ag_gemm_wg_kernel (128 x 256 tiles).  Rank me's list: the
// forwards in step order (step s: the top half's pieces, then the bottom
// half's; step 0 from the input, later steps once the half's flag has
// reached this call), then the pieces of my own segment into my own
// gathered buffer (which no one waits on), all run by every thread of the
// block before the warpgroups split; then the GEMM tiles step by step
// (step s: the top half of slot me - s and the bottom half of slot me +
// s), column band by column band, both halves' row tiles inside a band
// (the file's header: the reference's order, half, row tile, then
// column, ran gate/up 1.3x slower).  A half's rows are tiled on their own
// (`hp` tiles of up to 128 rows, the last masked), so a GEMM tile never
// spans the two halves.  Producer warp 0's lane 0 waits on
// the half's flag for s > 0, issues fence.proxy.async.global (the peers'
// forwards are generic-proxy stores) and loads A from the input at s = 0
// or from the gathered buffer after that, B from the rank's weight.  The A
// maps' rows are bounded at the half ({K, m_loc / 2, 2 halves, ...}), so
// a ragged last tile of a half reads zeros, never the other half's rows,
// which may still be in flight.
struct BidirParams {
  CUtensorMap amap;   // a  {K, m_loc / 2, 2 halves, W}
  CUtensorMap agmap;  // ag {K, m_loc / 2, 2 halves, W segments, W ranks}
  CUtensorMap bmap;   // b  {n, K, W}
  Params<bf16, bf16, bf16> q;
};

// (me + d) mod world for |d| < world.
__device__ __forceinline__ int ring_slot(int me, int d, int world) {
  const int r = me + d;
  return r < 0 ? r + world : (r >= world ? r - world : r);
}

// Copy item `it` of rank me's bidir list (hp pieces a half, n_fwd
// forwards first), by the whole block.
__device__ __forceinline__ void bidir_copy(const Params<bf16, bf16, bf16>& p,
                                           int me, int it, int hp,
                                           int n_fwd) {
  constexpr int BM = tdt_gemm90::BM;
  const long long seg = static_cast<long long>(p.m_loc) * p.k;
  if (it >= n_fwd) {
    // my own segment into my own gathered buffer
    const int row0 = (it - n_fwd) * BM;
    tdt_dist::putmem(
        p.ag.p[me] + me * seg + static_cast<long long>(row0) * p.k,
        p.a.p[me] + static_cast<long long>(row0) * p.k,
        static_cast<long long>(min(BM, p.m_loc - row0)) * p.k * 2);
    return;
  }
  // forward (step, half, piece): the half's slot at this step
  const int sh = it / hp, piece = it - sh * hp;
  const int step = sh / 2, h = sh - 2 * step;
  const int slot = ring_slot(me, h == 0 ? -step : step, p.world);
  const int half = p.m_loc / 2;
  const long long row0 = h * half + piece * BM;
  const long long off = slot * seg + row0 * p.k;
  if (step > 0) tdt_dist::wait(p.flags.p[me] + h * p.world + slot, p.epoch);
  const int to = ring_slot(me, h == 0 ? 1 : -1, p.world);
  tdt_dist::putmem(p.ag.p[to] + off,
                   step == 0 ? p.a.p[me] + row0 * p.k : p.ag.p[me] + off,
                   static_cast<long long>(min(BM, half - piece * BM)) *
                       p.k * 2);
  count_signal(p.cnt.p[to] + h * p.world + slot, hp,
               p.flags.p[to] + h * p.world + slot, p.epoch);
}

// GEMM item t of rank me's bidir list: step s, then column tile `col`,
// then half h and row tile `tile` of the half (the half's slot at step s).
struct BidirTile {
  int s, h, slot, tile, col;
};

__device__ __forceinline__ BidirTile bidir_tile(int t, int me, int world,
                                                int hp, int tiles_n) {
  BidirTile x;
  const int per = 2 * hp * tiles_n;  // GEMM items a step
  x.s = t / per;
  const int rest = t - x.s * per;
  x.col = rest / (2 * hp);
  const int r = rest - x.col * (2 * hp);
  x.h = r / hp;
  x.tile = r - x.h * hp;
  x.slot = ring_slot(me, x.h == 0 ? -x.s : x.s, world);
  return x;
}

__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
ag_gemm_bidir_wg_kernel(const __grid_constant__ BidirParams p) {
  using C = tdt_gemm90::Cfg<false, false>;
  using tdt_gemm90::BM;
  using tdt_gemm90::BN;
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  const auto& q = p.q;
  const int me = blockIdx.y, W = q.world;
  if (threadIdx.x == 0) tdt_gemm90::init_barriers(sm);
  tdt_dist::barrier_all(q.bar, me, W, q.epoch);  // syncs the block too

  const int half = q.m_loc / 2;
  const int hp = (half + BM - 1) / BM;  // pieces (row tiles) a half
  const int n_fwd = (W - 1) * 2 * hp;
  const int n_copy = n_fwd + (q.m_loc + BM - 1) / BM;
  const int tiles_n = (q.n + BN - 1) / BN;
  const int n_items = n_copy + W * 2 * hp * tiles_n;
  // the copies: a block takes its items of the list in order, so it
  // finishes its copies before its GEMM tiles
  int it = blockIdx.x;
  for (; it < n_copy; it += gridDim.x) bidir_copy(q, me, it, hp, n_fwd);
  const int n_kt = (q.k + C::BK - 1) / C::BK;
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int t = it; t < n_items; t += gridDim.x) {
        const BidirTile x = bidir_tile(t - n_copy, me, W, hp, tiles_n);
        if (x.s > 0) {
          tdt_dist::spin_until(q.flags.p[me] + x.h * W + x.slot, q.epoch);
          tdt_sm90::fence_proxy_async_global();
        }
        const int r0 = x.tile * BM;
        for (int kt = 0; kt < n_kt; ++kt)
          tdt_gemm90::produce_k_tile<false, false>(
              sm, ring, &p.bmap, x.col * BN, kt, me,
              [&](void* dst, uint64_t* bar, int k0) {
                if (x.s == 0)
                  tdt_sm90::tma_load_4d(dst, &p.amap, bar, k0, r0, x.h, me);
                else
                  tdt_sm90::tma_load_5d(dst, &p.agmap, bar, k0, r0, x.h,
                                        x.slot, me);
              });
      }
    }
    return;
  }
  tdt_sm90::regs_alloc<C::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1;
  tdt_sm90::Ring<C::NS> ring;
  tdt_sm90::Ring<C::NTS> tring;
  for (int t = it; t < n_items; t += gridDim.x) {
    float acc[C::NACC];
    tdt_gemm90::mma_tile<false, false>(acc, sm, ring, tring, n_kt, cw);
    const BidirTile x = bidir_tile(t - n_copy, me, W, hp, tiles_n);
    const long long row0 =
        static_cast<long long>(x.slot) * q.m_loc + x.h * half + x.tile * BM;
    tdt_gemm90::store_tile<false, false>(acc, q.c.p[me] + row0 * q.n, q.n,
                                         half - x.tile * BM, q.n,
                                         x.col * BN, cw);
  }
}

template <class TA, class TB, class OutT>
Params<TA, TB, OutT> make_params(const long long* a, const long long* s,
                                 const long long* b, const long long* ag,
                                 const long long* ag_s, const long long* c,
                                 const long long* flags,
                                 const long long* cnt, const long long* bar,
                                 int world, int m_loc, int n, int k,
                                 int crow, unsigned epoch,
                                 const tdt_dist::Group& grp) {
  Params<TA, TB, OutT> p;
  p.a = peers<const TA>(a, world);
  p.s = s ? peers<const float>(s, world) : Peers<const float>{};
  p.b = peers<const TB>(b, world);
  p.ag = peers<TA>(ag, world);
  p.ag_s = ag_s ? peers<float>(ag_s, world) : Peers<float>{};
  p.c = peers<OutT>(c, world);
  p.flags = peers<unsigned>(flags, world);
  p.cnt = peers<unsigned>(cnt, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = grp;
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.crow = crow;
  p.epoch = epoch;
  return p;
}

bool bad_shape(int world, int m_loc, int crow) {
  return world < 1 || world > MAX_RANKS || m_loc < 1 || crow < 1 ||
         m_loc % crow;
}

// The map over the rank-stacked weight (b_rs: its rank stride in bytes):
// b [W][n][K] (B_NK), K-major boxes of TN rows; b [W][K][n], bf16
// 64-column boxes, int8 the raw tile (sm90_gemm.cuh).
template <bool I8, bool B_NK, bool TALL = false>
int b_map(CUtensorMap* map, const void* b, int world, int n, int k,
          long long b_rs) {
  using C = tdt_gemm90::Cfg<I8, B_NK, TALL>;
  constexpr int E = sizeof(typename C::T);
  const CUtensorMapDataType dt = I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (B_NK) {
    const long long bd[3] = {k, n, world}, bs[3] = {1, k, b_rs / E};
    const int bbox[3] = {C::BK, C::TN, 1};
    return tdt_sm90::make_map_t(map, dt, E, CU_TENSOR_MAP_SWIZZLE_128B, b, 3,
                                bd, bs, bbox);
  }
  const long long bd[3] = {n, k, world}, bs[3] = {1, n, b_rs / E};
  const int bbox[3] = {I8 ? C::TN : 64, C::BK, 1};
  return tdt_sm90::make_map_t(
      map, dt, E,
      I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, b, 3, bd,
      bs, bbox);
}

// Launch the warp-specialised uni kernel over the group `g` (the flat
// world: flat_group): the three tensor maps over the rank-stacked a,
// gathered A [W][G m_loc][K] and b (see ag_gemm_wg_kernel), then the
// cooperative grid.  crow: a row tile waits on at most 32 chunks.
template <bool I8, bool B_NK, bool FLAT, bool TALL = false>
int launch_wg(const long long* a, const long long* b, const long long* ag,
              const long long* c, const long long* flags,
              const long long* cnt, const long long* bar, int world,
              int m_loc, int n, int k, int crow, unsigned epoch,
              void* stream, const tdt_dist::Group& g) {
  using C = tdt_gemm90::Cfg<I8, B_NK, TALL>;
  using T = typename C::T;
  constexpr int TM = C::TM, TN = C::TN;
  if (bad_shape(world, m_loc, crow) || tdt_dist::bad_group(g, world) ||
      (FLAT && g.G != world) ||
      (m_loc / crow > 32 && (TM - 2 + crow) / crow + 1 > 32))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long E = sizeof(T);
  const long long a_rs = tdt_dist::rank_stride(a, world, E * m_loc * k);
  const long long ag_rs =
      tdt_dist::rank_stride(ag, world, E * g.G * m_loc * k);
  const long long b_rs = tdt_dist::rank_stride(b, world, E * k * n);
  if (a_rs < 0 || ag_rs < 0 || b_rs < 0 || a_rs % E || ag_rs % E || b_rs % E)
    return static_cast<int>(cudaErrorInvalidValue);
  WgParams<I8, B_NK> p;
  p.q = make_params<T, T, typename std::conditional<I8, int, bf16>::type>(
      a, nullptr, b, ag, nullptr, c, flags, cnt, bar, world, m_loc, n, k,
      crow, epoch, g);
  const CUtensorMapDataType dt = I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long ad[3] = {k, m_loc, world};
  const long long as[3] = {1, k, a_rs / E};
  const int abox[3] = {C::BK, TM, 1};
  const long long gd[4] = {k, m_loc, g.G, world};
  const long long gs[4] = {1, k, static_cast<long long>(m_loc) * k,
                           ag_rs / E};
  const int gbox[4] = {C::BK, TM, 1, 1};
  int err = tdt_sm90::make_map_t(&p.amap, dt, E, sw, p.q.a.p[0], 3, ad, as,
                                 abox);
  if (!err)
    err = tdt_sm90::make_map_t(&p.agmap, dt, E, sw, p.q.ag.p[0], 4, gd, gs,
                               gbox);
  if (!err)
    err = b_map<I8, B_NK, TALL>(&p.bmap, p.q.b.p[0], world, n, k, b_rs);
  if (err) return err;
  const int items = g.G * (m_loc / crow) * ((crow + TM - 1) / TM) +
                    g.G * ((m_loc + TM - 1) / TM) * ((n + TN - 1) / TN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_gemm_wg_kernel<I8, B_NK, FLAT, TALL>, p,
                               tdt_gemm90::NT, tdt_gemm90::smem_bytes<C>(),
                               world, items, attr,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses of one rank-stacked tensor (equally
// spaced: the kernel's tensor maps span them).  bf16 throughout; m_loc >=
// 1, k % 8 == 0 and n % 8 == 0, every base 16-byte aligned (the wrapper
// checks); crow: rows per chunk, dividing m_loc; flags and cnt: W *
// (m_loc / crow) per rank (cnt zero between calls); epoch: this call's,
// from the workspace.
extern "C" int tdt_ag_gemm(const long long* a, const long long* b,
                           const long long* ag, const long long* c,
                           const long long* flags, const long long* cnt,
                           const long long* bar, int world, int m_loc,
                           int n, int k, int crow, int b_nk, unsigned epoch,
                           void* stream) {
  const tdt_dist::Group g = tdt_dist::flat_group(world);
  return b_nk ? launch_wg<false, true, true>(a, b, ag, c, flags, cnt, bar,
                                             world, m_loc, n, k, crow, epoch,
                                             stream, g)
              : launch_wg<false, false, true>(a, b, ag, c, flags, cnt, bar,
                                              world, m_loc, n, k, crow,
                                              epoch, stream, g);
}

// The int8 wire: a int8 rows and s their f32 scales per rank; ag / ag_s the
// gathered int8 rows [W m_loc][k] and scales [W m_loc]; b bf16 [k][n]; c
// bf16.  k % 16 == 0 (whole 16-byte int8 rows and loads), n % 8 == 0.
extern "C" int tdt_ag_gemm_wire(const long long* a, const long long* s,
                                const long long* b, const long long* ag,
                                const long long* ag_s, const long long* c,
                                const long long* flags, const long long* cnt,
                                const long long* bar, int world, int m_loc,
                                int n, int k, int crow, unsigned epoch,
                                void* stream) {
  using tdt_bf16::BM;
  using tdt_bf16::BN;
  if (bad_shape(world, m_loc, crow))
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = make_params<int8_t, bf16, bf16>(a, s, b, ag, ag_s, c, flags, cnt,
                                           bar, world, m_loc, n, k, crow,
                                           epoch,
                                           tdt_dist::flat_group(world));
  const int items = world * (m_loc / crow) * ((crow + BM - 1) / BM) +
                    world * ((m_loc + BM - 1) / BM) * ((n + BN - 1) / BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_gemm_kernel, p,
                               tdt_bf16::NT, tdt_bf16::Tiles<false>::SMEM_I8,
                               world, items, attr,
                               static_cast<cudaStream_t>(stream));
}

// The bidirectional ring: bf16, b [k][n]; m_loc even (the halves' rows,
// m_loc / 2, any positive count), k % 8 == 0 and n % 8 == 0, every base
// 16-byte aligned and the ranks equally spaced (TMA's rules: the wrapper
// checks); flags and cnt: 2 W per rank.
extern "C" int tdt_ag_gemm_bidir(const long long* a, const long long* b,
                                 const long long* ag, const long long* c,
                                 const long long* flags,
                                 const long long* cnt, const long long* bar,
                                 int world, int m_loc, int n, int k,
                                 unsigned epoch, void* stream) {
  using C = tdt_gemm90::Cfg<false, false>;
  constexpr int BM = tdt_gemm90::BM, BN = tdt_gemm90::BN;
  if (bad_shape(world, m_loc, 1) || world < 2 || m_loc % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long a_rs = tdt_dist::rank_stride(a, world, 2LL * m_loc * k);
  const long long ag_rs =
      tdt_dist::rank_stride(ag, world, 2LL * world * m_loc * k);
  const long long b_rs = tdt_dist::rank_stride(b, world, 2LL * k * n);
  if (a_rs < 0 || ag_rs < 0 || b_rs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  BidirParams p;
  p.q = make_params<bf16, bf16, bf16>(a, nullptr, b, ag, nullptr, c, flags,
                                      cnt, bar, world, m_loc, n, k, m_loc,
                                      epoch, tdt_dist::flat_group(world));
  const auto dt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long half = m_loc / 2;
  const long long ad[4] = {k, half, 2, world};
  const long long as[4] = {1, k, half * k, a_rs / 2};
  const int abox[4] = {C::BK, BM, 1, 1};
  const long long gd[5] = {k, half, 2, world, world};
  const long long gs[5] = {1, k, half * k, static_cast<long long>(m_loc) * k,
                           ag_rs / 2};
  const int gbox[5] = {C::BK, BM, 1, 1, 1};
  int err = tdt_sm90::make_map_t(&p.amap, dt, 2, sw, p.q.a.p[0], 4, ad, as,
                                 abox);
  if (!err)
    err = tdt_sm90::make_map_t(&p.agmap, dt, 2, sw, p.q.ag.p[0], 5, gd, gs,
                               gbox);
  if (!err) err = b_map<false, false>(&p.bmap, p.q.b.p[0], world, n, k, b_rs);
  if (err) return err;
  const int hp = (m_loc / 2 + BM - 1) / BM;
  const int items = (world - 1) * 2 * hp + (m_loc + BM - 1) / BM +
                    world * 2 * hp * ((n + BN - 1) / BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_gemm_bidir_wg_kernel, p, tdt_gemm90::NT,
                               tdt_gemm90::smem_bytes<C>(), world, items,
                               attr, static_cast<cudaStream_t>(stream));
}

// The int8 mode: int8 A and B, int32 C; m_loc >= 1, k % 32 == 0 and
// n % 16 == 0; crow as above (pieces of 128 rows); flags and cnt: W *
// (m_loc / crow) per rank.
extern "C" int tdt_ag_gemm_i8(const long long* a, const long long* b,
                              const long long* ag, const long long* c,
                              const long long* flags, const long long* cnt,
                              const long long* bar, int world, int m_loc,
                              int n, int k, int crow, unsigned epoch,
                              void* stream) {
  return launch_wg<true, false, true>(a, b, ag, c, flags, cnt, bar, world,
                                      m_loc, n, k, crow, epoch, stream,
                                      tdt_dist::flat_group(world));
}

// The torus AG-GEMM (the TPU `_torus_ag_gemm_kernel`, allgather_gemm.py
// :428, launched from `_torus_ag_gemm_shard` :580): the uni kernel
// (ag_gemm_wg_kernel) over the joint group `group` ([n, size0..2,
// stride0..2], 2 or 3 axes; dist_verbs.cuh `Group`) instead of the flat
// world.  The TPU kernel rings slots over its first axis, lines over its
// second and planes over its third, each phase's DMA riding under the
// GEMMs of what arrived before; NVLink (and one card) joins every rank of
// the group to every other, so here each rank pushes its segment to every
// member of its group at once, one flag per segment, and its GEMM tiles
// take its own segment first (the reference's step 0) and then the others
// in joint order as they land.  The gathered A comes out flat axes-major
// (segment j = the rows of joint index j), C = gathered A @ B_r.  bf16
// (b_nk as tdt_ag_gemm) or, in tdt_ag_gemm_torus_i8, int8 A and B with
// the exact int32 C (K % 32, n % 16) on TORUS_I8_TALL's tile; the ranks
// equally spaced and every base 16-byte aligned (TMA's rules: the wrapper
// checks); flags and cnt: G per rank.
constexpr bool TORUS_I8_TALL = true;

extern "C" int tdt_ag_gemm_torus(const long long* a, const long long* b,
                                 const long long* ag, const long long* c,
                                 const long long* flags,
                                 const long long* cnt, const long long* bar,
                                 const int* group, int world, int m_loc,
                                 int n, int k, int b_nk, unsigned epoch,
                                 void* stream) {
  const tdt_dist::Group g = tdt_dist::group_from(group);
  return b_nk ? launch_wg<false, true, false>(a, b, ag, c, flags, cnt, bar,
                                              world, m_loc, n, k, m_loc,
                                              epoch, stream, g)
              : launch_wg<false, false, false>(a, b, ag, c, flags, cnt, bar,
                                               world, m_loc, n, k, m_loc,
                                               epoch, stream, g);
}

extern "C" int tdt_ag_gemm_torus_i8(const long long* a, const long long* b,
                                    const long long* ag, const long long* c,
                                    const long long* flags,
                                    const long long* cnt,
                                    const long long* bar, const int* group,
                                    int world, int m_loc, int n, int k,
                                    unsigned epoch, void* stream) {
  return launch_wg<true, false, false, TORUS_I8_TALL>(
      a, b, ag, c, flags, cnt, bar, world, m_loc, n, k, m_loc, epoch, stream,
      tdt_dist::group_from(group));
}
