// moe_rs: the overlapped GroupGEMM-ReduceScatter of a tensor-parallel MoE
// down projection (experts sharded over their F dimension) for Hopper
// (sm_90a), on the wgmma / TMA mainloop of sm90_gemm.cuh and the
// distributed verbs of dist_verbs.cuh.
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
// reference's and the plain version's (moe_reduce_rs.moe_rs_ref); only
// the partials may round differently (another f32 order over k).
//
// Design (moe_rs_wg_kernel): one cooperative launch, one block of 384
// threads an SM, the blocks split evenly among the ranks, every block past
// barrier_all on entry.
// - Items: rank me's in step order, (step s, tile t) over the 128 x 256
//   tiles of [m_pad, n]: at step s the partial of segment me - 1 - s, its
//   own segment at the last step.  Within a step the persistent GEMM's
//   order (sm90_gemm.cuh `tile_rc`), groups of GROUP = 4 row tiles walked
//   column band by column band, so the ~33 blocks of a rank that run
//   together share one A stripe and each B tile (one expert at block_m
//   512).  A/B at Mixtral TP 4 (PERF.md row 20, bm512 / bm128 / T 32 ms,
//   NVIDIA H100 80GB HBM3, 700 W):
//   band by band over the whole segment (gemm_rs.cu's `wg_item` order)
//   5.43 / 2.98 / 1.90, A read again for every band; groups of 16 4.09 /
//   2.90 / 1.83, 8 3.65 / 2.74 / 1.89, 4 3.41 / 2.65 / 1.79, 2 5.17 /
//   2.69 / 1.72.
// - Mainloop (sm90_gemm.cuh, Cfg<bf16, B [K][n]>): producer warp 0's lane
//   0 loads A, row tile i of segment c, through the map {k, W m_pad, W}
//   over the rank-stacked strided view of h, and B, slab te[c][i 128 /
//   block_m] of the rank's stack, through the 4-D map {n, k, E, W}
//   (block_m % 128 == 0, so a tile lies in one expert), into the 4-stage
//   ring; two consumer warpgroups run `wgmma m64n256k16`.  Columns past n
//   (n % 256 may be 128) load as zeros and the stores drop them.
// - The hop, in the registers (the int8 bidir GEMM-RS's hop of
//   gemm_rs.cu in bf16): the consumers round the partial to bf16 (64
//   packed words a thread), for s >= 1 wait on the previous peer's flag of
//   (s - 1, t), add the running sum it left in this rank's landing slot s
//   - 1 (the accumulator's fragment order; eight 16-byte vectors loaded
//   ahead of their adds) as bf16(float(local) + float(recv)), and store
//   the sum into the next peer's landing slot s in fragment order, or at
//   the last step into OUT row-major, masked to n.  Each tile crosses
//   global memory once out and once in (the tile loop's kernel stored its
//   partial, read it back beside the running sum and wrote it again).
// - The flags: producer warp 1 (the signal warp, idle otherwise) waits on
//   the consumers' `staged` mbarrier and raises each landing tile's flag,
//   a system fence and a release store, as gemm_rs_wg_kernel does; a
//   consumer thread spins on the flag it needs after its product.  A/B
//   in groups of 4: a consumer thread raising the flags behind a named
//   barrier 3.57 / 2.64 / 1.85 (3% slower at the default block_m, 4%
//   faster at 128; band by band, where A's traffic set the time, it won
//   5.25 against 5.83); producer warp 2 spinning ahead on each item's flag
//   and handing it over on an mbarrier 3.40 / 2.74 / 1.85 (1.5% at bm512
//   for a second handshake: not taken).
// - Every wait is safe: a consumer waits while it holds its tile, which is
//   safe only because every block is resident (cooperative launch) and an
//   item waits only on an earlier step's item of the previous rank, whose
//   flag is raised before that item's block waits on anything (its flag
//   depends on its own stores alone).
// W - 1 landing slots per rank, from the world's workspace, take the place
// of the reference's credit semaphore (no slot is reused within a call;
// no per-call allocation).  On one card (the virtual world) the
// landing-slot stores are device-memory stores, not NVLink transfers.
//
// What bounds it on an H100: Mixtral-8x7B's down projection at TP 4 (F_loc
// 3584, D 4096, E 8, top-2) over a 2,048-token prefill is 481 GFLOP of
// useful work (0.486 ms at 989 TFLOP/s), 2.4 TFLOP as padded at block_m 512
// (2.43 ms); the 940 MB of slabs take 0.28 ms at 3.35 TB/s and bind at
// decode widths.  Padding tiles are computed (zero rows give zeros).  The
// ring's steps read the slabs again at every step (up to 3.76 GB a call,
// 1.12 ms), which sets block_m 128 and T 32, where an expert's few row
// tiles a segment share each B tile.  SASS (`chip_smoke.py`'s build
// phase): 4 HGMMA, 168 registers at launch (setmaxnreg 40 / 232), 0
// spills.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"
#include "sm90_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;
using tdt_gemm90::bf16_hi;
using tdt_gemm90::bf16_lo;
using tdt_gemm90::BM;
using tdt_gemm90::BN;
using tdt_sm90::pack_bf16;
using C = tdt_gemm90::Cfg<false, false>;

constexpr int TILE_U4 = BM * BN / 8;  // 16-byte vectors of a bf16 tile
constexpr int GROUP = 4;  // row tiles a group of tile_rc's order (header)

struct Params {
  CUtensorMap amap;       // h {k, W m_pad, W}: [64 k][128 rows] boxes
  CUtensorMap bmap;       // w {n, k, E, W}: [64 k][64 n] boxes
  Peers<uint4> land;      // rank q's [W - 1 slots][tiles][TILE_U4]
  Peers<bf16> out;        // rank q's reduced segment [m_pad][n]
  Peers<unsigned> flags;  // rank q's [W - 1 slots][tiles]
  Peers<unsigned> bar;    // rank q's [W] barrier slots
  const int* te;          // [W][m_pad / block_m], the same on every rank
  int world, m_pad, n, k, block_m, tiles_m, tiles_n;
  unsigned epoch;
};

// Item `it` of rank me's list: step s, tile t of segment `seg` (row tile
// i, column tile j: tile_rc's order, groups of GROUP row tiles walked
// column band by column band).
struct Item {
  int s, t, i, j, seg;
};

__device__ __forceinline__ Item item_of(const Params& p, int it, int me) {
  const int per = p.tiles_m * p.tiles_n;
  Item x;
  x.s = it / per;
  x.t = it - x.s * per;
  const tdt_gemm90::TileRC rc =
      tdt_gemm90::tile_rc(x.t, p.tiles_m, p.tiles_n, GROUP);
  x.i = rc.row;
  x.j = rc.col;
  const int c = x.s == p.world - 1 ? me : me - 1 - x.s;
  x.seg = c < 0 ? c + p.world : c;
  return x;
}

// A consumer's half of a tile, its partial packed to bf16 (vector v of
// the fragment order = w[4 v .. 4 v + 3] = pack_bf16 of acc[8 v .. 8 v +
// 7]; thread t's vector v of consumer cw at uint4 (16 cw + v) x 128 + t of
// the tile), plus (`from` not null) the running sum staged at `from`,
// added as bf16(float(local) + float(recv)); stored in fragment order at
// `to`, or (`to` null) into OUT at c (the tile's row 0, row stride n) at
// columns col0.., masked to n.  Eight vectors at a time, their loads
// first; `from` never aliases the destination.
__device__ __forceinline__ void hop_out(unsigned (&w)[64], int cw,
                                        const uint4* __restrict__ from,
                                        uint4* __restrict__ to,
                                        bf16* __restrict__ c, int n,
                                        int col0) {
  const int off = cw * (TILE_U4 / 2) + (threadIdx.x & 127);
  constexpr int GV = 8;  // vectors a group
#pragma unroll
  for (int v0 = 0; v0 < 16; v0 += GV) {
    if (from != nullptr) {
      uint4 y[GV];
#pragma unroll
      for (int u = 0; u < GV; ++u) y[u] = __ldcg(from + off + (v0 + u) * 128);
#pragma unroll
      for (int u = 0; u < GV; ++u) {
        const unsigned r[4] = {y[u].x, y[u].y, y[u].z, y[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned& a = w[4 * (v0 + u) + e];
          a = pack_bf16(bf16_lo(a) + bf16_lo(r[e]),
                        bf16_hi(a) + bf16_hi(r[e]));
        }
      }
    }
    if (to != nullptr) {
#pragma unroll
      for (int u = 0; u < GV; ++u) {
        const int v = v0 + u;
        to[off + v * 128] =
            make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
      }
    }
  }
  if (to != nullptr) return;
  // word 2 j: row r, columns frag_col(j) and + 1 (column tile j); word
  // 2 j + 1: row r + 8, the same columns
  const int r = tdt_gemm90::frag_row<C>(0, cw);
  bf16* dst = c + static_cast<long long>(r) * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + tdt_gemm90::frag_col<C>(j);
    if (col >= n) continue;
    *reinterpret_cast<unsigned*>(dst + col) = w[2 * j];
    *reinterpret_cast<unsigned*>(dst + 8 * n + col) = w[2 * j + 1];
  }
}

__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
moe_rs_wg_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char wg_smem[];
  auto& sm = tdt_gemm90::smem_of<C>(wg_smem);
  // staged[n & 1]: landing tile n's stores done (the 256 consumer threads
  // arrive); raised[n & 1]: its flag raised (the signal warp); two of each
  // in turn
  __shared__ __align__(8) uint64_t staged[2], raised[2];
  const int me = blockIdx.y, W = p.world;
  const int next = me + 1 == W ? 0 : me + 1;
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      tdt_sm90::mbar_init(&staged[q], 256);
      tdt_sm90::mbar_init(&raised[q], 1);
    }
    tdt_gemm90::init_barriers(sm);  // fences the inits
  }
  tdt_dist::barrier_all(p.bar, me, W, p.epoch);  // syncs the block too

  const int per = p.tiles_m * p.tiles_n, n_items = W * per;
  const int n_kt = p.k / C::BK;
  if (threadIdx.x < 128) {
    tdt_sm90::regs_dealloc<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tdt_sm90::Ring<C::NS> ring;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const Item x = item_of(p, it, me);
        const int row0 = x.seg * p.m_pad + x.i * BM;
        const int e =
            p.te[x.seg * (p.m_pad / p.block_m) + x.i * BM / p.block_m];
        for (int kt = 0; kt < n_kt; ++kt)
          tdt_gemm90::produce_k_tile<false, false>(
              sm, ring, &p.bmap, x.j * BN, kt, me,
              [&](void* dst, uint64_t* bar, int k0) {
                tdt_sm90::tma_load_3d(dst, &p.amap, bar, k0, row0, me);
              },
              e);
      }
    } else if (threadIdx.x == 32) {
      // the flags of this block's landing tiles, in the consumers' order
      int n = 0;
      for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
        const Item x = item_of(p, it, me);
        if (x.s == W - 1) continue;
        tdt_sm90::mbar_wait(&staged[n & 1], (n >> 1) & 1);
        __threadfence_system();
        tdt_dist::st_release(
            p.flags.p[next] + static_cast<long long>(x.s) * per + x.t,
            p.epoch);
        tdt_sm90::mbar_arrive(&raised[n & 1]);
        ++n;
      }
    }
    return;
  }
  tdt_sm90::regs_alloc<C::CONSUMER_REGS>();
  const int cw = threadIdx.x / 128 - 1, wt = threadIdx.x & 127;
  tdt_sm90::Ring<C::NS> ring;
  tdt_sm90::Ring<C::NTS> tring;
  int n = 0;  // landing tiles stored
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    float acc[C::NACC];
    tdt_gemm90::mma_tile<false, false>(acc, sm, ring, tring, n_kt, cw);
    unsigned w[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) w[e] = pack_bf16(acc[2 * e], acc[2 * e + 1]);
    const Item x = item_of(p, it, me);  // after the product
    const uint4* from = nullptr;
    if (x.s > 0) {
      const long long f = static_cast<long long>(x.s - 1) * per + x.t;
      if (wt == 0) tdt_dist::spin_until(p.flags.p[me] + f, p.epoch);
      tdt_sm90::named_sync(1 + cw, 128);
      from = p.land.p[me] + f * TILE_U4;
    }
    const long long to = static_cast<long long>(x.s) * per + x.t;
    if (x.s == W - 1) {
      hop_out(w, cw, from, nullptr,
              p.out.p[me] + static_cast<long long>(x.i) * BM * p.n, p.n,
              x.j * BN);
      continue;
    }
    hop_out(w, cw, from, p.land.p[next] + to * TILE_U4, nullptr, p.n, 0);
    // staged[n & 1] is free once the signal warp raised tile n - 2
    if (n >= 2) tdt_sm90::mbar_wait(&raised[n & 1], ((n >> 1) - 1) & 1);
    tdt_sm90::mbar_arrive(&staged[n & 1]);
    ++n;
  }
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses, equally spaced (the tensor maps span the
// rank-stacked views); te: the [world][m_pad / block_m] tile map on the
// device, expert ids below n_experts.  bf16; block_m % 128 == 0, m_pad %
// block_m == 0, n % 128 == 0 and k % 128 == 0; every base 16-byte aligned
// and lda, ldb, e_stride and the rank strides multiples of 8 elements (the
// wrapper checks: TMA's rules); land: (W - 1) tiles 128 x 256 per rank,
// tiles = (m_pad / 128) ceil(n / 256); flags: (W - 1) tiles per rank;
// epoch: this call's, from the workspace.  Returns a cudaError_t, or
// tdt_sm90::MAP_ERROR when a tensor map cannot be encoded.
extern "C" int tdt_moe_rs(const long long* h, const long long* w,
                          const long long* land, const long long* out,
                          const long long* flags, const long long* bar,
                          const void* te, int world, int m_pad, int n,
                          int k, int block_m, int n_experts, int lda,
                          int ldb, long long e_stride, unsigned epoch,
                          void* stream) {
  if (world < 1 || world > MAX_RANKS || block_m < BM || block_m % BM ||
      m_pad < block_m || m_pad % block_m || n < 128 || n % 128 || k < 128 ||
      k % 128 || n_experts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long h_rs =
      tdt_dist::rank_stride(h, world, 2LL * world * m_pad * lda);
  const long long w_rs =
      tdt_dist::rank_stride(w, world, 2LL * n_experts * e_stride);
  if (h_rs < 0 || w_rs < 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.land = peers<uint4>(land, world);
  p.out = peers<bf16>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.te = static_cast<const int*>(te);
  p.world = world;
  p.m_pad = m_pad;
  p.n = n;
  p.k = k;
  p.block_m = block_m;
  p.tiles_m = m_pad / BM;
  p.tiles_n = (n + BN - 1) / BN;
  p.epoch = epoch;
  const auto dt = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long ad[3] = {k, static_cast<long long>(world) * m_pad, world};
  const long long as[3] = {1, lda, h_rs / 2};
  const int abox[3] = {C::BK, BM, 1};
  const long long bd[4] = {n, k, n_experts, world};
  const long long bs[4] = {1, ldb, e_stride, w_rs / 2};
  const int bbox[4] = {64, C::BK, 1, 1};
  int err = tdt_sm90::make_map_t(&p.amap, dt, 2, sw,
                                 reinterpret_cast<const void*>(h[0]), 3, ad,
                                 as, abox);
  if (!err)
    err = tdt_sm90::make_map_t(&p.bmap, dt, 2, sw,
                               reinterpret_cast<const void*>(w[0]), 4, bd,
                               bs, bbox);
  if (err) return err;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(moe_rs_wg_kernel, p, tdt_gemm90::NT,
                               tdt_gemm90::smem_bytes<C>(), world,
                               world * p.tiles_m * p.tiles_n, attr,
                               static_cast<cudaStream_t>(stream));
}
