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
// Rounding: each rank's partial is staged in bf16, as the reference stages
// its partials in the output dtype (:764-772); the W partials of a tile are
// summed in f32 in the fixed order q = 0 .. W-1 and rounded once.  The
// reference instead adds in bf16 at every ring step (`_add_body`, :100),
// rounding W - 1 times in a rank-dependent order; this kernel's sum is the
// same on every run and closer to the exact one.
//
// Schedule: full mesh.  Rank q computes the partial of chunk c for every
// chunk, in the reference's order (c = q - 1, q - 2, ..., its own chunk
// last), and its epilogue stores each 128 x 128 partial tile straight into
// slot q of rank c's staging buffer (a push: on NVLink a remote store) and
// signals a flag per (slot, tile) there.  Then each rank reduces its own
// chunk tile by tile, waiting on the W flags of the tile.  On one card (the
// virtual world) the pushes are device-memory stores, not NVLink traffic.
//
// What bounds it on an H100: Llama-3-8B's down projection at TP 4 (M 2048,
// k 3584, N 4096) is 240.5 GFLOP over the four ranks, 0.243 ms at the 989
// TFLOP/s bf16 peak, against 192 MB of operands and output: operations
// bound it.  The staging adds 4 x 16 MB of partials written and read.
//
// Row tails: m_loc is any positive count.  A chunk's tiles are indexed by
// (row tile, column tile), ceil(m_loc / 128) row tiles per chunk, the last
// masked to the rows it holds (loads past them zero-filled, stores and the
// reduction past them skipped), so a partial tile never reaches into the
// next chunk's rows.
//
// Design (right and simple first): one cooperative launch of a persistent
// grid per call, as ag_gemm.cu: every block resident, split evenly among
// the world's ranks, each rank's blocks walking its items in strides: the
// GEMM tiles first, then the reduction tiles (which wait only on GEMM
// tiles), after barrier_all on entry (the reference's neighbour barrier,
// :144-149).
//
// The int8 mode (tdt_gemm_rs_i8, the reference's `quantized` path
// :700-702): int8 A and B, exact int32 partials on the int8 tile loop of
// i8_tile.cuh (64 x 128 tiles), staged in int32 and summed in rank order:
// int32 adds are exact in any order, so the result is the exact product.
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
// partials, the sums are bit for bit the reference's.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "dist_verbs.cuh"
#include "i8_tile.cuh"

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

constexpr int SMEM = Tiles<true>::SMEM > Tiles<false>::SMEM
                         ? Tiles<true>::SMEM : Tiles<false>::SMEM;

struct Params {
  Peers<const bf16> a;     // rank r's A [W m_loc][k]
  Peers<const bf16> b;     // rank r's weight [k][N], or [N][k] (B_NK)
  Peers<bf16> stage;       // rank r's [W slots][m_loc][N]: rank q writes q
  Peers<bf16> out;         // rank r's C [m_loc][N]
  Peers<unsigned> flags;   // rank r's [W slots][tiles of m_loc x N]
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  Group grp;               // uni, torus: the ranks that reduce (slot = index)
  int part_end[6];         // torus: column part q ends at tile part_end[q]
  int world, m_loc, n, k;
  unsigned epoch;
};

// The torus order's add: the f32 sum of two bf16 values rounded to bf16.
struct AddBf16 {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __bfloat162float(__float2bfloat16_rn(a + b));
  }
};

// two blocks per SM: 128 registers, no spills (ptxas), 10-30% faster
// than the one block that 167-213 registers allow (PERF.md)
// Who reduces: FLAT, the whole world in rank order (tdt_gemm_rs); GROUP,
// the ranks of `p.grp` in index order (the uni kernel over one axis of a
// larger mesh); TORUS, the joint group, its partials folded in the
// reference's torus order (see tdt_gemm_rs_group).
enum Mode { FLAT = 0, GROUP = 1, TORUS = 2 };

// Rank `me`, of index jm in its group of G (FLAT: me of W), computes its
// partial of every chunk and stages it in slot jm of the chunk owner's
// stage.  Off the flat world, jm lives in shared memory and is read again
// after each tile's product, so no group state is held in registers
// across the product (its two blocks per SM leave none to spare).
template <bool B_NK, int MODE>
__global__ void __launch_bounds__(NT, 2)
gemm_rs_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  __shared__ FoldPlan plans[6];
  __shared__ int s_jm;
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int me = blockIdx.y, lb = blockIdx.x;
  const int G = MODE == FLAT ? p.world : p.grp.G;
  if (MODE == FLAT) {
    tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  } else {
    const int jm = tdt_dist::group_index(p.grp, me);
    if (threadIdx.x == 0) s_jm = jm;
    if (MODE == TORUS && threadIdx.x < 2 * p.grp.n)
      plans[threadIdx.x] = tdt_dist::fold_plan(p.grp, jm, threadIdx.x);
    tdt_dist::barrier_group(p.bar, me, p.grp, p.epoch);
  }

  const int tiles_n = (p.n + BN - 1) / BN;
  const int per = (p.m_loc + BM - 1) / BM * tiles_n;   // tiles of a chunk
  const long long slot = static_cast<long long>(p.m_loc) * p.n;
  const int n_gemm = G * per;
  for (int it = lb; it < n_gemm + per; it += gridDim.x) {
    if (it < n_gemm) {
      // partial of chunk `oj`, tile (i, j), into my slot of its stage
      const int t = it % per, i = t / tiles_n, j = t % tiles_n;
      const int rows = min(BM, p.m_loc - i * BM);
      const int oj = ((MODE == FLAT ? me : s_jm) + 2 * G - 1 - it / per) % G;
      float acc[4][4][4];
      tdt_bf16::mma_tile<B_NK, true>(
          acc, smem,
          p.a.p[me] + (static_cast<long long>(oj) * p.m_loc + i * BM) *
                          p.k,
          p.k, p.b.p[me], B_NK ? p.k : p.n, rows, p.n, p.k, 0, j * BN);
      const int jm = MODE == FLAT ? me : s_jm;
      const int owner =
          MODE == FLAT
              ? (me + 2 * G - 1 - it / per) % G
              : tdt_dist::group_rank(p.grp, me,
                                     (jm + 2 * G - 1 - it / per) % G);
      tdt_bf16::store_tile(
          acc, p.stage.p[owner] + jm * slot + static_cast<long long>(i) *
                                                  BM * p.n,
          p.n, rows, p.n, 0, j * BN);
      tdt_dist::signal(p.flags.p[owner] + jm * per + t, p.epoch);
      continue;
    }
    // my chunk's tile (i, j): the G partials summed
    const int t = it - n_gemm, i = t / tiles_n, j = t % tiles_n;
    const int rows = min(BM, p.m_loc - i * BM);
    tdt_dist::wait(p.flags.p[me] + t, p.epoch, G, per);
    const bf16* st = p.stage.p[me];
    bf16* out = p.out.p[me];
    FoldPlan f{0u, 0u, 0u};
    if constexpr (MODE == TORUS) {
      int q = 0;
      while (j >= p.part_end[q]) ++q;
      f = plans[q];
    }
    for (int v = threadIdx.x; v < rows * (BN / 8); v += NT) {
      const int row = i * BM + v / (BN / 8);
      const int col = j * BN + (v % (BN / 8)) * 8;
      if (col >= p.n) continue;
      const long long off = static_cast<long long>(row) * p.n + col;
      if constexpr (MODE == TORUS) {
        // in the plan's order, each add rounded to bf16 (`_add_body`),
        // one source at a time (its two blocks per SM leave no registers
        // for all G at once)
        float acc[8][3] = {};
#pragma unroll
        for (int k = 0; k < MAX_RANKS; ++k) {
          if (k < G) {
            const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
                st + tdt_dist::plan_src(f, k) * slot + off));
            const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              tdt_dist::fold_step(f, k, __bfloat162float(x[e]), acc[e],
                                  AddBf16());
          }
        }
        unsigned w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = pack_bf16(tdt_dist::fold_result(acc[2 * e], p.grp.n),
                           tdt_dist::fold_result(acc[2 * e + 1], p.grp.n));
        *reinterpret_cast<uint4*>(out + off) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        // in f32 in index order, rounded once
        float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < G; ++k) {
          const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(
              st + k * slot + off));
          const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum[e] += __bfloat162float(x[e]);
        }
        *reinterpret_cast<uint4*>(out + off) =
            make_uint4(pack_bf16(sum[0], sum[1]), pack_bf16(sum[2], sum[3]),
                       pack_bf16(sum[4], sum[5]), pack_bf16(sum[6], sum[7]));
      }
    }
  }
}

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

struct ParamsI8 {
  Peers<const int8_t> a;   // rank r's A [W m_loc][k]
  Peers<const int8_t> b;   // rank r's weight [k][N]
  Peers<int> stage;        // rank r's [W slots][m_loc][N]: rank q writes q
  Peers<int> out;          // rank r's C [m_loc][N]
  Peers<unsigned> flags;   // rank r's [W slots][tiles of m_loc x N]
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  Group grp;               // the ranks that reduce (slot = index)
  int world, m_loc, n, k;
  unsigned epoch;
};

// The int8 mode: as gemm_rs_kernel on 64 x 128 int32 tiles, the partials
// staged in int32 and summed exactly (so in any order: the torus order's
// sums are these); FLAT: the whole world, else the group `p.grp`.
template <bool FLAT>
__global__ void __launch_bounds__(tdt_i8::NT)
gemm_rs_i8_kernel(const __grid_constant__ ParamsI8 p) {
  constexpr int BM8 = tdt_i8::BM, BN8 = tdt_i8::BN, NT8 = tdt_i8::NT;
  __shared__ __align__(128) int8_t smem[tdt_i8::SMEM];
  const int me = blockIdx.y, G = FLAT ? p.world : p.grp.G;
  const int jm = FLAT ? me : tdt_dist::group_index(p.grp, me);
  if (FLAT)
    tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  else
    tdt_dist::barrier_group(p.bar, me, p.grp, p.epoch);

  const int tiles_n = (p.n + BN8 - 1) / BN8;
  const int per = (p.m_loc + BM8 - 1) / BM8 * tiles_n;
  const long long slot = static_cast<long long>(p.m_loc) * p.n;
  const int n_gemm = G * per;
  for (int it = blockIdx.x; it < n_gemm + per; it += gridDim.x) {
    if (it < n_gemm) {
      const int oj = (jm + 2 * G - 1 - it / per) % G;
      const int owner = FLAT ? oj : tdt_dist::group_rank(p.grp, me, oj);
      const int t = it % per, i = t / tiles_n, j = t % tiles_n;
      const int rows = min(BM8, p.m_loc - i * BM8);
      int acc[BM8 / 16][4][4];
#pragma unroll
      for (int mt = 0; mt < BM8 / 16; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
              acc[mt][nt][3] = 0;
      tdt_i8::mma_tile(
          acc, smem,
          p.a.p[me] + (static_cast<long long>(oj) * p.m_loc + i * BM8) *
                          p.k,
          p.b.p[me], rows, p.n, p.k, 0, j * BN8, 0, p.k);
      tdt_i8::store_tile(acc, p.stage.p[owner] + jm * slot +
                                  static_cast<long long>(i) * BM8 * p.n,
                         rows, p.n, 0, j * BN8, false);
      tdt_dist::signal(p.flags.p[owner] + jm * per + t, p.epoch);
      continue;
    }
    // my chunk's tile (i, j): the G partials summed in index order
    const int t = it - n_gemm, i = t / tiles_n, j = t % tiles_n;
    const int rows = min(BM8, p.m_loc - i * BM8);
    tdt_dist::wait(p.flags.p[me] + t, p.epoch, G, per);
    const int* st = p.stage.p[me];
    int* out = p.out.p[me];
    for (int v = threadIdx.x; v < rows * (BN8 / 4); v += NT8) {
      const int row = i * BM8 + v / (BN8 / 4);
      const int col = j * BN8 + (v % (BN8 / 4)) * 4;
      if (col >= p.n) continue;
      const long long off = static_cast<long long>(row) * p.n + col;
      int4 sum = make_int4(0, 0, 0, 0);
      for (int q = 0; q < G; ++q) {
        const int4 x = __ldcg(reinterpret_cast<const int4*>(st + q * slot +
                                                            off));
        sum.x += x.x;
        sum.y += x.y;
        sum.z += x.z;
        sum.w += x.w;
      }
      *reinterpret_cast<int4*>(out + off) = sum;
    }
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
  p.grp = tdt_dist::flat_group(world);
  for (int q = 0; q < 6; ++q) p.part_end[q] = 0;
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  return p;
}

}  // namespace

// One call for every rank of a world of `world` (<= 8): each pointer table
// holds `world` device addresses.  bf16 throughout; m_loc >= 1, k % 8 ==
// 0 and n % 8 == 0, every row 16-byte aligned (the wrapper checks); flags:
// W * ceil(m_loc / 128) * ceil(n / 128) per rank; epoch: this call's, from
// the workspace.
extern "C" int tdt_gemm_rs(const long long* a, const long long* b,
                           const long long* stage, const long long* out,
                           const long long* flags, const long long* bar,
                           int world, int m_loc, int n, int k, int b_nk,
                           unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || m_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(a, b, stage, out, flags, bar, world, m_loc, n, k,
                         epoch);
  const int per = (m_loc + BM - 1) / BM * ((n + BN - 1) / BN);
  const int items = (world + 1) * per;
  const auto s = static_cast<cudaStream_t>(stream);
  static unsigned attr_kn = 0, attr_nk = 0;
  return b_nk ? tdt_dist::launch_coop(gemm_rs_kernel<true, FLAT>, p, NT,
                                      SMEM, world, items, attr_nk, s)
              : tdt_dist::launch_coop(gemm_rs_kernel<false, FLAT>, p, NT,
                                      SMEM, world, items, attr_kn, s);
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

// The int8 mode: int8 A and B, int32 stage and C; m_loc >= 1, k % 32 == 0
// and n % 16 == 0 (the int8 tile's); flags: W * ceil(m_loc / 64) *
// ceil(n / 128) per rank.
extern "C" int tdt_gemm_rs_i8(const long long* a, const long long* b,
                              const long long* stage, const long long* out,
                              const long long* flags, const long long* bar,
                              int world, int m_loc, int n, int k,
                              unsigned epoch, void* stream) {
  if (world < 1 || world > MAX_RANKS || m_loc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  ParamsI8 p;
  p.a = peers<const int8_t>(a, world);
  p.b = peers<const int8_t>(b, world);
  p.stage = peers<int>(stage, world);
  p.out = peers<int>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = tdt_dist::flat_group(world);
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  const int per = (m_loc + tdt_i8::BM - 1) / tdt_i8::BM *
                  ((n + tdt_i8::BN - 1) / tdt_i8::BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(gemm_rs_i8_kernel<true>, p, tdt_i8::NT, 0,
                               world, (world + 1) * per, attr,
                               static_cast<cudaStream_t>(stream));
}

// The torus GEMM-RS (the TPU `_torus_gemm_rs_kernel`, gemm_reduce_scatter.py
// :326, launched from `_torus_gemm_rs_shard` :580) and the uni kernels over
// one axis of a larger mesh: gemm_rs_kernel / gemm_rs_i8_kernel over the
// joint group `group` ([n, size0..2, stride0..2]; dist_verbs.cuh `Group`)
// instead of the flat world.  A's rows are the group's G chunks in joint
// order (flat axes-major), and rank r of joint index j gets chunk j.
//
// torus = 1 (bf16, 2 or 3 axes; N % 128 == 0): the reference's torus
// order.  It cuts the N columns into 2n parts in 128-column units
// (`_split_parts(N // 128, 2n)`, :591-597), part q taking path flavor q;
// phase 0 rings along the flavor's first axis with the GEMM as producer,
// later phases ring the order-major sub-bands (:415-561), every hop adding
// `acc = local + recv` in bf16 (`_add_body`).  NVLink joins every rank of
// the group to every other, so the schedule is the uni kernel's (every
// rank stages its bf16 partial of every chunk in the owner's slot, the
// owner reduces), and the owner folds its G staged partials of a tile in
// that order and rounding (dist_verbs.cuh `fold_plan`): given the same
// partials, the sums are bit for bit the reference's.  part_end: the 2n
// parts' ends in 128-column tiles (the last = N / 128).
// torus = 0: the uni kernel's f32 sum in index order (part_end unused).
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
      (torus && (g.n < 2 || n % BN || part_end[2 * g.n - 1] != n / BN)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(a, b, stage, out, flags, bar, world, m_loc, n, k,
                         epoch);
  p.grp = g;
  for (int q = 0; q < 6; ++q)
    p.part_end[q] = torus && q < 2 * g.n ? part_end[q] : n / BN;
  const int per = (m_loc + BM - 1) / BM * ((n + BN - 1) / BN);
  const int items = (g.G + 1) * per;
  const auto s = static_cast<cudaStream_t>(stream);
  static unsigned attr[4] = {0, 0, 0, 0};
  if (torus)
    return b_nk ? tdt_dist::launch_coop(gemm_rs_kernel<true, TORUS>, p, NT,
                                        SMEM, world, items, attr[0], s)
                : tdt_dist::launch_coop(gemm_rs_kernel<false, TORUS>, p, NT,
                                        SMEM, world, items, attr[1], s);
  return b_nk ? tdt_dist::launch_coop(gemm_rs_kernel<true, GROUP>, p, NT,
                                      SMEM, world, items, attr[2], s)
              : tdt_dist::launch_coop(gemm_rs_kernel<false, GROUP>, p, NT,
                                      SMEM, world, items, attr[3], s);
}

extern "C" int tdt_gemm_rs_group_i8(const long long* a, const long long* b,
                                    const long long* stage,
                                    const long long* out,
                                    const long long* flags,
                                    const long long* bar, const int* group,
                                    int world, int m_loc, int n, int k,
                                    unsigned epoch, void* stream) {
  const Group g = tdt_dist::group_from(group);
  if (world < 1 || world > MAX_RANKS || m_loc < 1 ||
      tdt_dist::bad_group(g, world))
    return static_cast<int>(cudaErrorInvalidValue);
  ParamsI8 p;
  p.a = peers<const int8_t>(a, world);
  p.b = peers<const int8_t>(b, world);
  p.stage = peers<int>(stage, world);
  p.out = peers<int>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = g;
  p.world = world;
  p.m_loc = m_loc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  const int per = (m_loc + tdt_i8::BM - 1) / tdt_i8::BM *
                  ((n + tdt_i8::BN - 1) / tdt_i8::BN);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(gemm_rs_i8_kernel<false>, p, tdt_i8::NT, 0,
                               world, (g.G + 1) * per, attr,
                               static_cast<cudaStream_t>(stream));
}
