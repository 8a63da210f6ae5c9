// ag_group_gemm: the overlapped AllGather-GroupGEMM of a tensor-parallel
// MoE feed-forward (experts sharded over their F dimension) for Hopper
// (sm_90a), on the wgmma / TMA mainloop of sm90_gemm.cuh and the
// distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/allgather_group_gemm.py
// `_ag_group_gemm_kernel` (:103, launched from `ag_group_gemm_shard` at
// :214).  Same contract, for every rank r of a world of W: each rank's
// tokens arrive sorted by expert into a padded segment xs_r [m_pad, K]
// (row tile i of segment s belongs to expert te[s][i], the per-segment
// plans every rank derives alike); rank r returns the gathered segments
// AG [W m_pad, K] (segment s = rank s's, the same on every rank) and C_r
// [W m_pad, n], row tile i of segment s = that tile @ w_r[te[s][i]], where
// w_r [E][K][n] is rank r's F shard of the expert slabs (slab e at
// e * e_stride elements, rows ldb apart: a column block of the whole
// [E, K, F] stack, read in place).  bf16 with f32 accumulation, rounded
// once to bf16, as the TPU kernel writes `acc.astype(out_dtype)`.
//
// The point of the TPU design (:11-19), kept: a token's top-k rows never
// leave its source rank's segment, so every GEMM tile depends on exactly
// ONE segment, and waits on that segment's flag alone.
//
// Schedule: full mesh, as ag_gemm.cu (NVLink joins every card of a host,
// so each rank pushes its own segment straight into every rank's gathered
// buffer, where the TPU forwards it round a ring).  The push moves in
// pieces of one 128-row tile, each pushed by one block and counted at the
// receiver; the last piece of a segment raises the segment's flag with
// this call's epoch.  Padding tiles are computed as the reference computes
// them: zero rows against the clamped expert E - 1 give zeros (skipping
// them is later work).  On one card (the virtual world) the pushes are
// device-memory copies, not NVLink transfers.
//
// What bounds it on an H100: Mixtral-8x7B's gate projection at TP 4 (K
// 4096, F 14336, E 8, top-2) over a 2,048-token prefill is 2 T topk K F =
// 481 GFLOP of useful work (0.486 ms at the 989 TFLOP/s bf16 peak), but
// the static sort pads each segment to m_pad = 5,120 rows at block_m 512,
// so the kernel computes 2.4 TFLOP (2.43 ms); the 940 MB of expert slabs
// take 0.28 ms at 3.35 TB/s, which binds at decode widths.
//
// Design (ag_group_gemm_wg_kernel): one cooperative launch, one block of
// 384 threads an SM, the blocks split evenly among the ranks (launch_coop),
// every block past barrier_all on entry (the reference's neighbour
// barrier: no rank writes into a peer that has not entered the kernel).
// - Copy items first, run by every thread of the block before the
//   warpgroups split: the pieces of my segment for the peers me + 1,
//   me + 2, ..., then my own gathered buffer (which no one waits on).
// - Then the GEMM tiles, 128 x 256, on sm90_gemm.cuh's mainloop (Cfg<bf16,
//   B [K][n]>): producer warp 0's lane 0 waits on the tile's segment flag
//   (not for my own segment), issues fence.proxy.async.global (the peers'
//   pushes are generic-proxy stores; the TMA that reads them is the async
//   proxy), and loads A through {K, m_pad, W} over xs (my own segment) or
//   {K, m_pad, W segments, W ranks} over the gathered buffer, and B, slab
//   te[s][i 128 / block_m] (block_m % 128 == 0, so a 128-row tile lies in
//   one expert), through the 4-D map {n, K, E, W} over the strided slab
//   view; two consumer warpgroups run `wgmma m64n256k16` and store C from
//   the registers, masked to n (n % 256 may be 128: those columns load as
//   zeros and are dropped).
// - The tile order, expert-major: for each expert, its row tiles of every
//   segment (my own first, then me - 1, me - 2, ...: the reference's
//   segment order, :134-135) in tile_rc's groups of GROUP = 8 row tiles,
//   each group walked column band by column band.  te[s] is nondecreasing
//   (sort_align: searchsorted, then a clamp to E - 1), so an expert's
//   tiles in a segment form one run; the block finds the runs' starts from
//   te at entry (build_walk, shared memory; nothing is read back to the
//   host) and traps on a map it cannot walk.  A B band in flight then
//   serves every segment's rows of its expert, and a rank reads each slab
//   about once a call (940 MB at Mixtral TP 4), where the segment-major
//   order read it once a segment (4 x 940 MB).  A/B at Mixtral TP 4,
//   balanced routing (PERF.md row 19, ms at block_m 512 / 128 / T 32;
//   NVIDIA H100 80GB HBM3, 700 W): segment-major, tile_rc's groups of 4
//   within a segment (row 20's winner) 3.88 / 3.03 / 1.94; expert-major
//   band by band over all of an expert's tiles 4.11 / 1.62 / 0.86 (the
//   A stripe of an expert's ~16 row tiles a rank outgrows L2 across the
//   bands at block_m 512); in groups of 8 3.78 / 1.61 / 0.87 (kept).
// - Free of deadlock, in either order: in every rank's list every copy
//   item comes before every GEMM item and no copy waits, so each block
//   finishes its copies before it waits on anything, and every wait is
//   on copies (every block resident: a cooperative launch).
// The tile loop it replaced (128 x 128 mma.sync tiles of bf16_tile.cuh,
// two blocks an SM, segment-major) ran 10.05 / 3.80 / 2.18 ms.  SASS
// (`chip_smoke.py`'s build phase): 4 HGMMA, 168 registers at launch
// (setmaxnreg 40 / 232), 0 spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"
#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;
using tdt_gemm90::BM;
using tdt_gemm90::BN;
using C = tdt_gemm90::Cfg<false, false>;

// The tile order (the file's header): each expert's row tiles of every
// segment in tile_rc's groups of GROUP, walked band by band.
constexpr int GROUP = 8;
constexpr int MAX_E = 256;  // experts the expert-major tables hold

struct Params {
  CUtensorMap amap;        // xs {K, m_pad, W}: [64 k][128 rows] boxes
  CUtensorMap agmap;       // ag {K, m_pad, W segments, W ranks}
  CUtensorMap bmap;        // w  {n, K, E, W}: [64 k][64 n] boxes
  Peers<const bf16> xs;    // rank r's sorted segment [m_pad][k]
  Peers<bf16> ag;          // rank r's gathered segments [W m_pad][k]
  Peers<bf16> c;           // rank r's grouped products [W m_pad][n]
  Peers<unsigned> flags;   // rank r's [W]: segment s has arrived
  Peers<unsigned> cnt;     // rank r's [W] piece counters (0 between calls)
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  const int* te;           // [W][m_pad / block_m], the same on every rank
  int world, m_pad, n, k, block_m, n_experts, tiles_m, tiles_n;
  unsigned epoch;
};

// The expert-major walk's tables, built by the block at entry from te
// (nondecreasing in each segment: sort_align's searchsorted and clamp):
// start[q][e], the first 128-row tile of expert e in segment me - q (so
// start[q][e + 1] - start[q][e] tiles of it), and base[e], the first GEMM
// item of expert e (the tiles of the experts before it times tiles_n).
struct Walk {
  int start[MAX_RANKS][MAX_E + 1];
  int base[MAX_E + 1];
};

__device__ __forceinline__ void build_walk(Walk& wk, const Params& p,
                                           int me) {
  const int E = p.n_experts, n_bt = p.m_pad / p.block_m;
  const int per_bt = p.block_m / BM;
  // a map the walk cannot take (an id out of range, a segment out of
  // order) would leave tiles unwritten: fail the launch instead
  for (int i = threadIdx.x; i < p.world * n_bt; i += blockDim.x) {
    const int e = __ldg(p.te + i);
    if (e < 0 || e >= E || (i % n_bt > 0 && __ldg(p.te + i - 1) > e))
      __trap();
  }
  for (int i = threadIdx.x; i < p.world * (E + 1); i += blockDim.x) {
    const int q = i / (E + 1), e = i - q * (E + 1);
    const int seg = me - q < 0 ? me - q + p.world : me - q;
    const int* t = p.te + seg * n_bt;
    int lo = 0, hi = n_bt;  // the first block tile of an expert >= e
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(t + mid) < e) lo = mid + 1; else hi = mid;
    }
    wk.start[q][e] = lo * per_bt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = 0;
    for (int e = 0; e < E; ++e) {
      wk.base[e] = b;
      for (int q = 0; q < p.world; ++q)
        b += (wk.start[q][e + 1] - wk.start[q][e]) * p.tiles_n;
    }
    wk.base[E] = b;
  }
}

// GEMM item t of rank me's list: segment `seg`, its row tile `tile`,
// column tile `col`, and the tile's expert `e`.
struct Tile {
  int seg, tile, col, e;
};

__device__ __forceinline__ Tile tile_of(const Params& p, const Walk& wk,
                                        int t, int me) {
  Tile x;
  int lo = 0, hi = p.n_experts;  // the last expert whose base is <= t
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (wk.base[mid] <= t) lo = mid; else hi = mid;
  }
  x.e = lo;
  const int rows = (wk.base[lo + 1] - wk.base[lo]) / p.tiles_n;
  const tdt_gemm90::TileRC rc =
      tdt_gemm90::tile_rc(t - wk.base[lo], rows, p.tiles_n, GROUP);
  x.col = rc.col;
  int r = rc.row, q = 0;
  for (; q < p.world - 1; ++q) {
    const int n = wk.start[q][lo + 1] - wk.start[q][lo];
    if (r < n) break;
    r -= n;
  }
  x.seg = me - q < 0 ? me - q + p.world : me - q;
  x.tile = wk.start[q][lo] + r;
  return x;
}

__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
ag_group_gemm_wg_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  __shared__ Walk wk;
  const int me = blockIdx.y, W = p.world;
  if (threadIdx.x == 0) tdt_gemm90::init_barriers(sm);
  build_walk(wk, p, me);
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);  // syncs the block too

  const int n_copy = W * p.tiles_m;
  const int n_items = n_copy + wk.base[p.n_experts];
  const long long seg_elems = static_cast<long long>(p.m_pad) * p.k;
  int it = blockIdx.x;
  for (; it < n_copy; it += gridDim.x) {
    // piece `piece` of my segment into rank `to`'s slot me
    const int q = it / p.tiles_m, piece = it - q * p.tiles_m;
    int to = me + 1 + q;
    if (to >= W) to -= W;
    const long long off = static_cast<long long>(piece) * BM * p.k;
    tdt_dist::putmem(p.ag.p[to] + me * seg_elems + off, p.xs.p[me] + off,
                     static_cast<long long>(BM) * p.k * 2);
    tdt_dist::count_signal(p.cnt.p[to] + me, p.tiles_m, p.flags.p[to] + me,
                           p.epoch);
  }
  const int n_kt = p.k / C::BK;
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int t = it; t < n_items; t += gridDim.x) {
        const Tile x = tile_of(p, wk, t - n_copy, me);
        if (x.seg != me) {
          tdt_dist::spin_until(p.flags.p[me] + x.seg, p.epoch);
          tdt_sm90::fence_proxy_async_global();
        }
        const int row0 = x.tile * BM;
        for (int kt = 0; kt < n_kt; ++kt)
          tdt_gemm90::produce_k_tile<false, false>(
              sm, ring, &p.bmap, x.col * BN, kt, me,
              [&](void* dst, uint64_t* bar, int k0) {
                if (x.seg == me)
                  tdt_sm90::tma_load_3d(dst, &p.amap, bar, k0, row0, me);
                else
                  tdt_sm90::tma_load_4d(dst, &p.agmap, bar, k0, row0, x.seg,
                                        me);
              },
              x.e);
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
    const Tile x = tile_of(p, wk, t - n_copy, me);
    tdt_gemm90::store_tile<false, false>(
        acc,
        p.c.p[me] + (static_cast<long long>(x.seg) * p.m_pad +
                     static_cast<long long>(x.tile) * BM) * p.n,
        p.n, BM, p.n, x.col * BN, cw);
  }
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses, equally spaced (the tensor maps span the
// rank-stacked tensors and views); te: the [world][m_pad / block_m] tile
// map on the device, each segment's row nondecreasing with expert ids
// below n_experts (<= 256; sort_align's plans).  bf16; block_m % 128 ==
// 0, m_pad % block_m == 0, n % 128 == 0 and k % 128 == 0; every base
// 16-byte aligned and ldb, e_stride and the rank strides multiples of 8
// elements (the wrapper checks: TMA's rules); flags and cnt: W per rank
// (cnt zero between calls); epoch: this call's, from the workspace.
// Returns a cudaError_t, or tdt_sm90::MAP_ERROR when a tensor map cannot
// be encoded.
extern "C" int tdt_ag_group_gemm(const long long* xs, const long long* w,
                                 const long long* ag, const long long* c,
                                 const long long* flags,
                                 const long long* cnt, const long long* bar,
                                 const void* te, int world, int m_pad,
                                 int n, int k, int block_m, int n_experts,
                                 int ldb, long long e_stride, unsigned epoch,
                                 void* stream) {
  if (world < 1 || world > MAX_RANKS || block_m < BM || block_m % BM ||
      m_pad < block_m || m_pad % block_m || n < 128 || n % 128 || k < 128 ||
      k % 128 || n_experts < 1 || n_experts > MAX_E)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long xs_rs = tdt_dist::rank_stride(xs, world, 2LL * m_pad * k);
  const long long ag_rs =
      tdt_dist::rank_stride(ag, world, 2LL * world * m_pad * k);
  const long long w_rs =
      tdt_dist::rank_stride(w, world, 2LL * n_experts * e_stride);
  if (xs_rs < 0 || ag_rs < 0 || w_rs < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xs = peers<const bf16>(xs, world);
  p.ag = peers<bf16>(ag, world);
  p.c = peers<bf16>(c, world);
  p.flags = peers<unsigned>(flags, world);
  p.cnt = peers<unsigned>(cnt, world);
  p.bar = peers<unsigned>(bar, world);
  p.te = static_cast<const int*>(te);
  p.world = world;
  p.m_pad = m_pad;
  p.n = n;
  p.k = k;
  p.block_m = block_m;
  p.n_experts = n_experts;
  p.tiles_m = m_pad / BM;
  p.tiles_n = (n + BN - 1) / BN;
  p.epoch = epoch;
  const auto dt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long ad[3] = {k, m_pad, world};
  const long long as[3] = {1, k, xs_rs / 2};
  const int abox[3] = {C::BK, BM, 1};
  const long long gd[4] = {k, m_pad, world, world};
  const long long gs[4] = {1, k, static_cast<long long>(m_pad) * k,
                           ag_rs / 2};
  const int gbox[4] = {C::BK, BM, 1, 1};
  const long long bd[4] = {n, k, n_experts, world};
  const long long bs[4] = {1, ldb, e_stride, w_rs / 2};
  const int bbox[4] = {64, C::BK, 1, 1};
  int err = tdt_sm90::make_map_t(&p.amap, dt, 2, sw, p.xs.p[0], 3, ad, as,
                                 abox);
  if (!err)
    err = tdt_sm90::make_map_t(&p.agmap, dt, 2, sw, p.ag.p[0], 4, gd, gs,
                               gbox);
  if (!err)
    err = tdt_sm90::make_map_t(&p.bmap, dt, 2, sw,
                               reinterpret_cast<const void*>(w[0]), 4, bd,
                               bs, bbox);
  if (err) return err;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_group_gemm_wg_kernel, p, tdt_gemm90::NT,
                               tdt_gemm90::smem_bytes<C>(), world,
                               world * p.tiles_m * (1 + p.tiles_n), attr,
                               static_cast<cudaStream_t>(stream));
}
