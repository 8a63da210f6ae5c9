// moe_rs: the overlapped GroupGEMM-ReduceScatter of a tensor-parallel MoE
// down projection (experts sharded over their F dimension) for Hopper
// (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/moe_reduce_rs.py
// `_moe_rs_kernel` (:106, launched from `moe_reduce_rs_shard` at :223).
// Same contract, for every rank q of a world of W: rank q holds its F shard
// of the sorted hidden states of every segment, h_q [W m_pad, k] (segment c
// = rank c's tokens sorted by expert, row tile i of it on expert te[c][i];
// rows lda apart: a column block of the whole [W m_pad, F], read in
// place), and its F shard of the down-projection slabs, w_q [E][k][n]
// (slab e at e * e_stride, rows ldb apart).  Rank c gets OUT_c [m_pad, n]
// = sum over q of the grouped partial of segment c on rank q, bf16.
//
// Summation order, the reference's ring (:144-186): segment c's partial
// starts at rank c + 1 and travels right; every hop rounds its own partial
// tile to bf16 and adds the running sum it received, `acc = local + recv`
// in bf16 (one rounding, `_add_body` :97-100); rank c adds its own partial
// last.  So given the same partials the sums are bit for bit the
// reference's and the plain version's (moe_reduce_rs.moe_rs_ref), as in
// gemm_rs.cu's bidirectional ring.
//
// Schedule: rank me's items in step order, (step s, tile t) over the 128 x
// 128 tiles of [m_pad, n]: at step s it forms the partial tile of segment
// me - 1 - s (its own segment at the last step) on the tile loop of
// bf16_tile.cuh, B's base offset by te[c][i] * e_stride per 128-row tile
// (as group_gemm.cu does), and stores it rounded into its destination: its
// next peer's landing slot s, or its output at the last step; then, for
// s >= 1, it waits for the running sum its previous peer left in its own
// landing slot s - 1 and adds it in place (fold_add), and raises the
// tile's flag in its next peer.  W - 1 landing slots per rank, from the
// world's workspace, take the place of the reference's credit semaphore
// (no slot is reused within a call; no per-call allocation).  An item of
// step s waits only on the item (s - 1, t) of the previous rank, at an
// earlier place of that rank's list, so no wait can close a cycle; every
// block passes barrier_all on entry.  On one card (the virtual world) the
// landing-slot stores are device-memory stores, not NVLink transfers.
//
// What bounds it on an H100: Mixtral-8x7B's down projection at TP 4 (F_loc
// 3584, D 4096, E 8, top-2) over a 2,048-token prefill is 481 GFLOP of
// useful work (0.486 ms at 989 TFLOP/s), 2.4 TFLOP as padded at block_m 512
// (2.43 ms); the 940 MB of slabs take 0.28 ms at 3.35 TB/s and bind at
// decode widths.  Padding tiles are computed (zero rows give zeros).
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
  Peers<const bf16> h;     // rank q's rows [W m_pad][k], lda apart
  Peers<const bf16> w;     // rank q's slabs: e at e * e_stride, [k][n]
  Peers<bf16> land;        // rank q's [W - 1 slots][m_pad][n] running sums
  Peers<bf16> out;         // rank q's reduced segment [m_pad][n]
  Peers<unsigned> flags;   // rank q's [W - 1 slots][tiles of m_pad x n]
  Peers<unsigned> bar;     // rank q's [W] barrier slots
  const int* te;           // [W][m_pad / block_m], the same on every rank
  long long e_stride;
  int lda, ldb, world, m_pad, n, k, block_m;
  unsigned epoch;
};

// Two blocks per SM, as the ring GEMMs: 128 registers.
__global__ void __launch_bounds__(NT, 2)
moe_rs_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, W = p.world;
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);

  const int tiles_n = p.n / BN, per = p.m_pad / BM * tiles_n;
  const long long slot = static_cast<long long>(p.m_pad) * p.n;
  const int next = me + 1 == W ? 0 : me + 1;
  for (int it = blockIdx.x; it < W * per; it += gridDim.x) {
    const int s = it / per, t = it - s * per;
    const int i = t / tiles_n, j = t - i * tiles_n;
    const bool last = s == W - 1;
    int chunk = last ? me : me - 1 - s;
    if (chunk < 0) chunk += W;
    const int e = p.te[chunk * (p.m_pad / p.block_m) + i * BM / p.block_m];
    float acc[4][4][4];
    const long long a_row = static_cast<long long>(chunk) * p.m_pad + i * BM;
    tdt_bf16::mma_tile<false, true>(acc, smem, p.h.p[me] + a_row * p.lda,
                                    p.lda, p.w.p[me] + e * p.e_stride, p.ldb,
                                    BM, p.n, p.k, 0, j * BN);
    // my rounded partial into its destination, then + the running sum
    // from my landing slot s - 1
    const long long tile0 = static_cast<long long>(i) * BM * p.n;
    bf16* dst = (last ? p.out.p[me] : p.land.p[next] + s * slot) + tile0;
    tdt_bf16::store_tile(acc, dst, p.n, BM, p.n, 0, j * BN);
    if (s > 0) {
      tdt_dist::wait(p.flags.p[me] + (s - 1) * per + t, p.epoch);
      tdt_bf16::fold_add(dst, p.n, p.land.p[me] + (s - 1) * slot + tile0,
                         p.n, BM, p.n, j * BN);
    }
    if (!last) tdt_dist::signal(p.flags.p[next] + s * per + t, p.epoch);
  }
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses; te: the [world][m_pad / block_m] tile
// map on the device.  bf16; block_m % 128 == 0, m_pad % block_m == 0,
// n % 128 == 0 and k % 128 == 0; every row 16-byte aligned (lda, ldb and
// e_stride multiples of 8: the wrapper checks); land: (W - 1) m_pad n per
// rank; flags: (W - 1) (m_pad / 128) (n / 128) per rank; epoch: this
// call's, from the workspace.
extern "C" int tdt_moe_rs(const long long* h, const long long* w,
                          const long long* land, const long long* out,
                          const long long* flags, const long long* bar,
                          const void* te, int world, int m_pad, int n,
                          int k, int block_m, int lda, int ldb,
                          long long e_stride, unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || block_m < BM || block_m % BM ||
      m_pad < block_m || m_pad % block_m || n < BN || n % BN || k < BN ||
      k % BN)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = peers<const bf16>(h, world);
  p.w = peers<const bf16>(w, world);
  p.land = peers<bf16>(land, world);
  p.out = peers<bf16>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.te = static_cast<const int*>(te);
  p.lda = lda;
  p.ldb = ldb;
  p.e_stride = e_stride;
  p.world = world;
  p.m_pad = m_pad;
  p.n = n;
  p.k = k;
  p.block_m = block_m;
  p.epoch = epoch;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(moe_rs_kernel, p, NT, Tiles<false>::SMEM,
                               world, world * (m_pad / BM) * (n / BN), attr,
                               static_cast<cudaStream_t>(stream));
}
