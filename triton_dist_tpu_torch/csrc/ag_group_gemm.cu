// ag_group_gemm: the overlapped AllGather-GroupGEMM of a tensor-parallel
// MoE feed-forward (experts sharded over their F dimension) for Hopper
// (sm_90a), over the distributed verbs of dist_verbs.cuh.
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
// this call's epoch.  The GEMM tiles of rank r go in the reference's order
// (:134-135): its own segment first, read from its input without waiting,
// then the segments r - 1, r - 2, ... (the first pieces the peers push).
// Padding tiles are computed as the reference computes them: zero rows
// against the clamped expert E - 1 (skipping them is later work).  On one
// card (the virtual world) the pushes are device-memory copies, not
// NVLink transfers.
//
// What bounds it on an H100: Mixtral-8x7B's gate projection at TP 4 (K
// 4096, F 14336, E 8, top-2) over a 2,048-token prefill is 2 T topk K F =
// 481 GFLOP of useful work (0.486 ms at the 989 TFLOP/s bf16 peak), but
// the static sort pads each segment to m_pad = 5,120 rows at block_m 512,
// so the kernel computes 2.4 TFLOP (2.43 ms); the 940 MB of expert slabs
// take 0.28 ms at 3.35 TB/s, which binds at decode widths.
//
// Design (right and simple first): one cooperative launch holds every
// rank of the virtual world, a persistent grid from the occupancy
// calculator split evenly among the ranks (launch_coop).  A rank's blocks
// walk its item list in strides: the copies first (the peers me + 1,
// me + 2, ... then its own buffer, which no one waits on), then the GEMM
// tiles, 128 x 128 on the tile loop of bf16_tile.cuh with B's base offset
// by te[s][i] * e_stride per 128-row tile (block_m is a multiple of 128,
// so a 128-row tile lies in one expert tile), as group_gemm.cu offsets by
// its tile map.  Every wait is on copies at earlier places of another
// rank's list, so no wait can close a cycle; every block passes
// barrier_all on entry (the reference's neighbour barrier), so no rank
// writes into a peer that has not entered the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "dist_verbs.cuh"

namespace {

using namespace tdt_frag;
using tdt_bf16::BM;
using tdt_bf16::BN;
using tdt_bf16::NT;
using tdt_bf16::Tiles;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

struct Params {
  Peers<const bf16> xs;    // rank r's sorted segment [m_pad][k]
  Peers<const bf16> w;     // rank r's slabs: e at e * e_stride, [k][n]
  Peers<bf16> ag;          // rank r's gathered segments [W m_pad][k]
  Peers<bf16> c;           // rank r's grouped products [W m_pad][n]
  Peers<unsigned> flags;   // rank r's [W]: segment s has arrived
  Peers<unsigned> cnt;     // rank r's [W] piece counters (0 between calls)
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  const int* te;           // [W][m_pad / block_m], the same on every rank
  long long e_stride;
  int ldb, world, m_pad, n, k, block_m;
  unsigned epoch;
};

// Two blocks per SM, as the ring GEMMs: 128 registers.
__global__ void __launch_bounds__(NT, 2)
ag_group_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, W = p.world;
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);

  const int tiles = p.m_pad / BM, tiles_n = p.n / BN;
  const int per_seg = tiles * tiles_n, n_copy = W * tiles;
  const long long seg_elems = static_cast<long long>(p.m_pad) * p.k;
  for (int it = blockIdx.x; it < n_copy + W * per_seg; it += gridDim.x) {
    if (it < n_copy) {
      // piece `piece` of my segment into rank `to`'s slot `me`
      const int q = it / tiles, piece = it - q * tiles;
      int to = me + 1 + q;
      if (to >= W) to -= W;
      const long long off = static_cast<long long>(piece) * BM * p.k;
      tdt_dist::putmem(p.ag.p[to] + me * seg_elems + off, p.xs.p[me] + off,
                       static_cast<long long>(BM) * p.k * 2);
      tdt_dist::count_signal(p.cnt.p[to] + me, tiles, p.flags.p[to] + me,
                             p.epoch);
      continue;
    }
    // GEMM tile (step, row tile, column tile); step s takes segment me - s
    const int t = it - n_copy, step = t / per_seg, rest = t - step * per_seg;
    int seg = me - step;
    if (seg < 0) seg += W;
    const int tile = rest / tiles_n, col = rest - tile * tiles_n;
    const long long row0 = static_cast<long long>(tile) * BM;
    const bf16* src;
    if (seg == me) {
      src = p.xs.p[me] + row0 * p.k;
    } else {
      tdt_dist::wait(p.flags.p[me] + seg, p.epoch);
      src = p.ag.p[me] + seg * seg_elems + row0 * p.k;
    }
    const int e = p.te[seg * (p.m_pad / p.block_m) + tile * BM / p.block_m];
    float acc[4][4][4];
    tdt_bf16::mma_tile<false, true>(acc, smem, src, p.k,
                                    p.w.p[me] + e * p.e_stride, p.ldb, BM,
                                    p.n, p.k, 0, col * BN);
    tdt_bf16::store_tile(
        acc, p.c.p[me] + (static_cast<long long>(seg) * p.m_pad + row0) * p.n,
        p.n, BM, p.n, 0, col * BN);
  }
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses; te: the [world][m_pad / block_m] tile
// map on the device.  bf16; block_m % 128 == 0, m_pad % block_m == 0,
// n % 128 == 0 and k % 128 == 0; every row 16-byte aligned (ldb and
// e_stride multiples of 8: the wrapper checks); flags and cnt: W per rank
// (cnt zero between calls); epoch: this call's, from the workspace.
extern "C" int tdt_ag_group_gemm(const long long* xs, const long long* w,
                                 const long long* ag, const long long* c,
                                 const long long* flags,
                                 const long long* cnt, const long long* bar,
                                 const void* te, int world, int m_pad,
                                 int n, int k, int block_m, int ldb,
                                 long long e_stride, unsigned epoch,
                                 void* stream) {
  if (world < 1 || world > MAX_RANKS || block_m < BM || block_m % BM ||
      m_pad < block_m || m_pad % block_m || n < BN || n % BN || k < BN ||
      k % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.xs = peers<const bf16>(xs, world);
  p.w = peers<const bf16>(w, world);
  p.ag = peers<bf16>(ag, world);
  p.c = peers<bf16>(c, world);
  p.flags = peers<unsigned>(flags, world);
  p.cnt = peers<unsigned>(cnt, world);
  p.bar = peers<unsigned>(bar, world);
  p.te = static_cast<const int*>(te);
  p.ldb = ldb;
  p.e_stride = e_stride;
  p.world = world;
  p.m_pad = m_pad;
  p.n = n;
  p.k = k;
  p.block_m = block_m;
  p.epoch = epoch;
  const int items = world * (m_pad / BM) * (1 + n / BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_group_gemm_kernel, p, NT,
                               Tiles<false>::SMEM, world, items, attr,
                               static_cast<cudaStream_t>(stream));
}
