// ag_gemm: the overlapped AllGather-GEMM of the tensor-parallel linears for
// Hopper (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/allgather_gemm.py
// `_ag_gemm_kernel` (:240, launched from `ag_gemm_shard` at :828), its
// uni-directional ring.  Same contract, for every rank r of a world of W:
// given the rank's rows A_r [m_loc, K] and its weight shard B_r [K, n]
// (or B_r^T stored [n][K], the backward's transposed operand, read in
// place), it returns the gathered A_full [W m_loc, K] (segment s = rank s's
// rows, on every rank) and C_r = A_full @ B_r [W m_loc, n], bf16 with f32
// accumulation.
//
// Schedule: full mesh, not the TPU's ring.  A TPU chip reaches its two
// ring neighbours over ICI, so the reference forwards each segment one hop
// per step; NVLink joins every H100 of a host to every other, so here each
// rank pushes its own segment straight into every rank's gathered buffer
// (putmem, 128 rows at a time) and signals a flag per (receiving rank,
// segment, 128-row tile).  The GEMM tiles of rank r start on r's own
// segment, read from its input without waiting (the reference's step 0),
// then walk the segments r + 1, r + 2, ... and wait only on the flag of
// the rows they read.  On one card (the virtual world) the pushes are
// device-memory copies, not NVLink transfers.
//
// What bounds it on an H100: Llama-3-8B's gate/up projection at TP 4
// (m_loc 512, K 4096, n 3584) is 240.5 GFLOP over the four ranks, 0.243 ms
// at the 989 TFLOP/s bf16 peak, against 260 MB that must move (A, B, the
// gathered A and C): operations bound it.  The gather moves 16 x 4 MB.
//
// Design (right and simple first).  One cooperative launch holds every
// rank of the virtual world: a persistent grid, sized by the occupancy calculator so every
// block is resident (a spin-wait is safe only then), split evenly among
// the ranks.  A rank's blocks walk its item list in strides: the copies
// first, then the 128 x 128 GEMM tiles on the tile loop of bf16_tile.cuh,
// so no block waits before every copy has a block working on it.  Every
// block passes barrier_all on entry (the reference's neighbour barrier,
// :339-344): no rank writes into a peer that has not entered the kernel.
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

// the larger of the two B layouts' shared memory (one launch helper)
constexpr int SMEM = Tiles<true>::SMEM > Tiles<false>::SMEM
                         ? Tiles<true>::SMEM : Tiles<false>::SMEM;

struct Params {
  Peers<const bf16> a;     // rank r's rows [m_loc][K]
  Peers<const bf16> b;     // rank r's weight [K][n], or [n][K] (B_NK)
  Peers<bf16> ag;          // rank r's gathered A [W m_loc][K]: peers write
  Peers<bf16> c;           // rank r's C [W m_loc][n]
  Peers<unsigned> flags;   // rank r's [W segments][m_loc / BM] tile flags
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  int world, m_loc, n, k;
  unsigned epoch;
};

// two blocks per SM: 128 registers, no spills (ptxas), 10-30% faster
// than the one block that 167-213 registers allow (PERF.md)
template <bool B_NK>
__global__ void __launch_bounds__(NT, 2)
ag_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, lb = blockIdx.x;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);

  const int chunks = p.m_loc / BM, tiles_n = (p.n + BN - 1) / BN;
  const long long chunk = static_cast<long long>(BM) * p.k;   // elements
  const int n_copy = p.world * chunks;
  const int n_items = n_copy + p.world * chunks * tiles_n;
  for (int it = lb; it < n_items; it += gridDim.x) {
    if (it < n_copy) {
      // 128 rows of my segment into rank `peer`'s gathered buffer (the
      // peers first; no block waits on my own copy)
      const int peer = (me + 1 + it / chunks) % p.world, c = it % chunks;
      tdt_dist::putmem_signal(
          p.ag.p[peer] + (static_cast<long long>(me) * chunks + c) * chunk,
          p.a.p[me] + c * chunk, chunk * 2,
          p.flags.p[peer] + me * chunks + c, p.epoch);
      continue;
    }
    const int t = it - n_copy;
    const int seg = (me + t / (chunks * tiles_n)) % p.world;
    const int c = (t / tiles_n) % chunks, j = t % tiles_n;
    const bf16* src;
    if (seg == me) {
      src = p.a.p[me] + c * chunk;   // my own rows: the input, no wait
    } else {
      tdt_dist::wait(p.flags.p[me] + seg * chunks + c, p.epoch);
      src = p.ag.p[me] + (static_cast<long long>(seg) * chunks + c) * chunk;
    }
    float acc[4][4][4];
    tdt_bf16::mma_tile<B_NK, true>(acc, smem, src, p.k, p.b.p[me],
                                   B_NK ? p.k : p.n, BM, p.n, p.k, 0,
                                   j * BN);
    tdt_bf16::store_tile(
        acc, p.c.p[me] + (static_cast<long long>(seg) * chunks + c) * BM *
                             p.n,
        p.n, BM, p.n, 0, j * BN);
  }
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses.  bf16 throughout; m_loc % 128 == 0,
// k % 8 == 0 and n % 8 == 0, every row 16-byte aligned (the wrapper
// checks); epoch: this call's, from the workspace.
extern "C" int tdt_ag_gemm(const long long* a, const long long* b,
                           const long long* ag, const long long* c,
                           const long long* flags, const long long* bar,
                           int world, int m_loc, int n, int k, int b_nk,
                           unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.a = peers<const bf16>(a, world);
  p.b = peers<const bf16>(b, world);
  p.ag = peers<bf16>(ag, world);
  p.c = peers<bf16>(c, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  const int chunks = m_loc / BM, tiles_n = (n + BN - 1) / BN;
  const int items = world * chunks * (1 + tiles_n);
  const auto s = static_cast<cudaStream_t>(stream);
  static unsigned attr_kn = 0, attr_nk = 0;
  return b_nk ? tdt_dist::launch_coop(ag_gemm_kernel<true>, p, NT, SMEM,
                                      world, items, attr_nk, s)
              : tdt_dist::launch_coop(ag_gemm_kernel<false>, p, NT, SMEM,
                                      world, items, attr_kn, s);
}
