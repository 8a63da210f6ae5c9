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
// Schedule: full mesh, not the TPU's ring.  A TPU chip reaches its two
// ring neighbours over ICI, so the reference forwards each segment one hop
// per step; NVLink joins every H100 of a host to every other, so here each
// rank pushes its own segment straight into every rank's gathered buffer
// (putmem, one row tile at a time: 128 rows in bf16, 64 in int8) and
// signals a flag per (receiving rank, segment, row tile).  The GEMM tiles
// of rank r start on r's own segment, read from its input without waiting
// (the reference's step 0), then walk the segments r + 1, r + 2, ... and
// wait only on the flag of the rows they read.  On one card (the virtual
// world) the pushes are device-memory copies, not NVLink transfers.
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
// operations still bound it.
//
// Design (right and simple first).  One cooperative launch holds every
// rank of the virtual world: a persistent grid, sized by the occupancy
// calculator so every block is resident (a spin-wait is safe only then),
// split evenly among the ranks.  A rank's blocks walk its item list in
// strides: the copies first, then the GEMM tiles (128 x 128 on the tile
// loop of bf16_tile.cuh; 64 x 128 on the int8 one of i8_tile.cuh), so no
// block waits before every copy has a block working on it.  Every block
// passes barrier_all on entry (the reference's neighbour barrier,
// :339-344): no rank writes into a peer that has not entered the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "dist_verbs.cuh"
#include "i8_tile.cuh"

namespace {

using namespace tdt_frag;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

// the larger of the two bf16 B layouts' shared memory (one launch helper)
constexpr int BF16_SMEM = tdt_bf16::Tiles<true>::SMEM >
                                  tdt_bf16::Tiles<false>::SMEM
                              ? tdt_bf16::Tiles<true>::SMEM
                              : tdt_bf16::Tiles<false>::SMEM;

template <class T, class OutT>
struct Params {
  Peers<const T> a;        // rank r's rows [m_loc][K]
  Peers<const T> b;        // rank r's weight [K][n], or [n][K] (B_NK)
  Peers<T> ag;             // rank r's gathered A [W m_loc][K]: peers write
  Peers<OutT> c;           // rank r's C [W m_loc][n]
  Peers<unsigned> flags;   // rank r's [W segments][tiles] tile flags
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  int world, m_loc, n, k;
  unsigned epoch;
};

// One item of rank `me`'s list of n_copy + world * tiles * tiles_n: a copy
// (it < n_copy) of row tile `tile` of my segment into rank `peer`'s
// gathered buffer (the peers first, my own buffer last, so no block waits
// on my own copy), or a GEMM tile (segment `seg`, row tile `tile`, column
// tile `col`) walking the segments from my own.  `rows`: the rows the row
// tile holds (the last one of a segment may hold fewer than BM).
struct Item {
  bool copy;
  int peer, seg, tile, col, rows;
};

template <int BM>
__device__ __forceinline__ Item item_of(int it, int me, int world,
                                        int m_loc, int tiles, int tiles_n) {
  Item x{};
  const int n_copy = world * tiles;
  x.copy = it < n_copy;
  if (x.copy) {
    x.peer = (me + 1 + it / tiles) % world;
    x.tile = it % tiles;
  } else {
    const int t = it - n_copy;
    x.seg = (me + t / (tiles * tiles_n)) % world;
    x.tile = (t / tiles_n) % tiles;
    x.col = t % tiles_n;
  }
  x.rows = min(BM, m_loc - x.tile * BM);
  return x;
}

// The rows a GEMM tile reads: my own input for my own segment (no wait),
// else my gathered buffer once the tile's flag has reached this call.
template <int BM, class T, class OutT>
__device__ __forceinline__ const T* tile_rows(const Params<T, OutT>& p,
                                              int me, const Item& x,
                                              int tiles) {
  const long long off = static_cast<long long>(x.tile) * BM * p.k;
  if (x.seg == me) return p.a.p[me] + off;
  tdt_dist::wait(p.flags.p[me] + x.seg * tiles + x.tile, p.epoch);
  return p.ag.p[me] + static_cast<long long>(x.seg) * p.m_loc * p.k + off;
}

// Push row tile x.tile of my segment into rank x.peer's gathered buffer
// and raise its flag there.
template <int BM, class T, class OutT>
__device__ __forceinline__ void push_tile(const Params<T, OutT>& p, int me,
                                          const Item& x, int tiles) {
  const long long off = static_cast<long long>(x.tile) * BM * p.k;
  tdt_dist::putmem_signal(
      p.ag.p[x.peer] + static_cast<long long>(me) * p.m_loc * p.k + off,
      p.a.p[me] + off,
      static_cast<long long>(x.rows) * p.k * static_cast<int>(sizeof(T)),
      p.flags.p[x.peer] + me * tiles + x.tile, p.epoch);
}

// bf16.  Two blocks per SM: 128 registers, no spills (ptxas), 10-30%
// faster than the one block that 167-213 registers allow (PERF.md).
template <bool B_NK>
__global__ void __launch_bounds__(tdt_bf16::NT, 2)
ag_gemm_kernel(const __grid_constant__ Params<bf16, bf16> p) {
  constexpr int BM = tdt_bf16::BM, BN = tdt_bf16::BN;
  extern __shared__ __align__(128) char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);

  const int tiles = (p.m_loc + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int n_items = p.world * tiles * (1 + tiles_n);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item x = item_of<BM>(it, me, p.world, p.m_loc, tiles, tiles_n);
    if (x.copy) {
      push_tile<BM>(p, me, x, tiles);
      continue;
    }
    const bf16* src = tile_rows<BM>(p, me, x, tiles);
    float acc[4][4][4];
    tdt_bf16::mma_tile<B_NK, true>(acc, smem, src, p.k, p.b.p[me],
                                   B_NK ? p.k : p.n, x.rows, p.n, p.k, 0,
                                   x.col * BN);
    tdt_bf16::store_tile(acc,
               p.c.p[me] + (static_cast<long long>(x.seg) * p.m_loc +
                            static_cast<long long>(x.tile) * BM) * p.n,
               p.n, x.rows, p.n, 0, x.col * BN);
  }
}

// int8: 64 x 128 int32 tiles of i8_tile.cuh (4 warps, static shared
// memory), summed exactly over the whole contraction.
__global__ void __launch_bounds__(tdt_i8::NT)
ag_gemm_i8_kernel(const __grid_constant__ Params<int8_t, int> p) {
  constexpr int BM = tdt_i8::BM, BN = tdt_i8::BN;
  __shared__ __align__(128) int8_t smem[tdt_i8::SMEM];
  const int me = blockIdx.y;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);

  const int tiles = (p.m_loc + BM - 1) / BM, tiles_n = (p.n + BN - 1) / BN;
  const int n_items = p.world * tiles * (1 + tiles_n);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const Item x = item_of<BM>(it, me, p.world, p.m_loc, tiles, tiles_n);
    if (x.copy) {
      push_tile<BM>(p, me, x, tiles);
      continue;
    }
    const int8_t* src = tile_rows<BM>(p, me, x, tiles);
    int acc[BM / 16][4][4];
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
            acc[mt][nt][3] = 0;
    tdt_i8::mma_tile(acc, smem, src, p.b.p[me], x.rows, p.n, p.k, 0,
                     x.col * BN, 0, p.k);
    tdt_i8::store_tile(acc,
               p.c.p[me] + (static_cast<long long>(x.seg) * p.m_loc +
                            static_cast<long long>(x.tile) * BM) * p.n,
               x.rows, p.n, 0, x.col * BN, false);
  }
}

template <class T, class OutT>
Params<T, OutT> make_params(const long long* a, const long long* b,
                            const long long* ag, const long long* c,
                            const long long* flags, const long long* bar,
                            int world, int m_loc, int n, int k,
                            unsigned epoch) {
  Params<T, OutT> p;
  p.a = peers<const T>(a, world);
  p.b = peers<const T>(b, world);
  p.ag = peers<T>(ag, world);
  p.c = peers<OutT>(c, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  return p;
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses.  bf16 throughout; m_loc >= 1, k % 8 == 0
// and n % 8 == 0, every row 16-byte aligned (the wrapper checks); flags:
// W * ceil(m_loc / 128) per rank; epoch: this call's, from the workspace.
extern "C" int tdt_ag_gemm(const long long* a, const long long* b,
                           const long long* ag, const long long* c,
                           const long long* flags, const long long* bar,
                           int world, int m_loc, int n, int k, int b_nk,
                           unsigned epoch, void* stream) {
  using tdt_bf16::BM;
  using tdt_bf16::BN;
  if (world < 1 || world > MAX_RANKS || m_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = make_params<bf16, bf16>(a, b, ag, c, flags, bar, world, m_loc,
                                   n, k, epoch);
  const int items = world * ((m_loc + BM - 1) / BM) * (1 + (n + BN - 1) /
                                                       BN);
  const auto s = static_cast<cudaStream_t>(stream);
  static unsigned attr_kn = 0, attr_nk = 0;
  return b_nk ? tdt_dist::launch_coop(ag_gemm_kernel<true>, p,
                                      tdt_bf16::NT, BF16_SMEM, world, items,
                                      attr_nk, s)
              : tdt_dist::launch_coop(ag_gemm_kernel<false>, p,
                                      tdt_bf16::NT, BF16_SMEM, world, items,
                                      attr_kn, s);
}

// The int8 mode: int8 A and B, int32 C; m_loc >= 1, k % 32 == 0 and
// n % 16 == 0 (whole 16-byte copies, the int8 tile's); flags: W *
// ceil(m_loc / 64) per rank.
extern "C" int tdt_ag_gemm_i8(const long long* a, const long long* b,
                              const long long* ag, const long long* c,
                              const long long* flags, const long long* bar,
                              int world, int m_loc, int n, int k,
                              unsigned epoch, void* stream) {
  using tdt_i8::BM;
  using tdt_i8::BN;
  if (world < 1 || world > MAX_RANKS || m_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = make_params<int8_t, int>(a, b, ag, c, flags, bar, world, m_loc,
                                    n, k, epoch);
  const int items = world * ((m_loc + BM - 1) / BM) * (1 + (n + BN - 1) /
                                                       BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(ag_gemm_i8_kernel, p, tdt_i8::NT, 0, world,
                               items, attr,
                               static_cast<cudaStream_t>(stream));
}
