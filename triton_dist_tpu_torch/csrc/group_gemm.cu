// group_gemm: the grouped (expert-blocked) GEMM of the MoE family for
// Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/group_gemm.py `_kernel`
// (in `_group_gemm_fwd_impl`, launched from `group_gemm`).  Same contract:
// the expert-sorted token buffer x [M_pad, K] is cut into row tiles of
// `block_m` rows, each of which belongs to one expert; row tile i is
// `x_tile @ w[tile_expert[i]]` with w [E, K, N] row-major (the reference's
// layout, never copied or transposed).  Three modes, one kernel
// (`group_gemm_wg_kernel<I8, B_NK, TALL>`):
//
// - bf16: f32 accumulation, rounded once to bf16 (the TPU kernel writes
//   `acc.astype(out_dtype)`);
// - bf16 with the slab transposed (`b_nk`): dx = dy [M_pad, N] @ w[e]^T,
//   the reference VJP's grouped GEMM on `swapaxes(w, 1, 2)`.  w[e] stored
//   [K][N] row-major is already the K-major [n][k] operand wgmma wants for
//   that product, so this mode loads it in place with K-major boxes;
// - int8: exact s8 x s8 -> s32; the slab [K][N] is staged as it lies and
//   transposed in shared memory by the producer's warps 1-3.
//
// What bounds it on an H100: at Mixtral-8x7B's expert FFN (E 8, K 4096,
// N 14336) and a 2048-token top-2 batch (M_pad 5120 at block_m 128) one
// projection is 601 GFLOP, 0.61 ms at the 989 TFLOP/s bf16 peak, against
// 1.13 GB of operands (0.34 ms at 3.35 TB/s): operations bound it.  At
// decode width (M_pad 1152) the expert slabs (117 MB each) dominate and
// bytes bound it.
//
// Design: the persistent GEMM of sm90_gemm.cuh (`persistent_gemm`): one
// block of a TMA producer warpgroup and two wgmma consumer warpgroups on
// each SM, 128 x 256 output tiles, walked in groups of GROUP row tiles
// and column band by column band within a group.  Rows are expert-sorted,
// so neighbouring row tiles mostly share an expert: the blocks in flight
// share a few 2 MB B bands (256 columns x K 4096) of one or two slabs and
// one A stripe, where row-major tiles would stream every band of the 117
// MB slab each wave.  block_m is a multiple of the tile's rows (the
// wrapper checks), so a tile lies in one expert: the producer reads
// tile_expert once a tile and loads B from the 3-D map {N, K, E} (or {K,
// N, E}) at that expert.  The last column band may be ragged: TMA reads
// zeros past N and the store masks columns at N.  int8 takes the 256 x
// 128 tile of matmul_i8.cu where block_m % 256 == 0 (half the B bytes
// transposed for the same products), else 128 x 256, and block_m % 64:
// where block_m % 128 != 0 a tile is 64 rows (the second consumer's rows
// are computed and dropped).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

using tdt_gemm90::Gemm;

// Row tiles a group of the tile order.  A/B at Mixtral gate/up, T 2,048:
// PERF.md row 9.
constexpr int GROUP = 8;

// The entries carry no expert count (their ABI predates this kernel): the
// B map's slab extent is this bound, and the tile map names only the
// plan's experts, as the earlier kernel's pointer offsets did.
constexpr long long MAX_SLABS = 1 << 16;

template <bool I8, bool B_NK, bool TALL>
__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
group_gemm_wg_kernel(const __grid_constant__ Gemm p) {
  extern __shared__ __align__(128) char gg_smem[];
  tdt_gemm90::persistent_gemm<I8, B_NK, TALL>(p, gg_smem);
}

template <bool I8, bool B_NK, bool TALL = false>
int launch(const void* x, const void* w, const void* tile_expert, void* y,
           int M, int N, int K, int block_m, void* stream) {
  constexpr int TM = tdt_gemm90::Cfg<I8, B_NK, TALL>::TM;
  Gemm p;
  p.slab = static_cast<const int*>(tile_expert);
  p.c = y;
  p.slab_rows = block_m;
  p.rows = block_m % TM == 0 ? TM : TM / 2;
  if (block_m <= 0 || block_m % p.rows || M % block_m || (!I8 && p.rows != TM))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned attr = 0;
  return tdt_gemm90::launch_gemm<I8, B_NK, TALL>(
      group_gemm_wg_kernel<I8, B_NK, TALL>, p, x, w, M, N, K, MAX_SLABS,
      static_cast<long long>(K) * N, GROUP, attr,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// y [M, N] bf16 = x [M, K] bf16 @ slab; b_nk = 0: slab w[e] [K][N]
// (forward), b_nk = 1: slab w[e]^T of w [E, N, K] (dx).  M % 128, N % 128,
// K % 32 == 0 and block_m % 128 == 0; x, w and y contiguous with 16-byte
// aligned bases (the wrapper checks).
extern "C" int tdt_group_gemm_bf16(const void* x, const void* w,
                                   const void* tile_expert, void* y, int M,
                                   int N, int K, int block_m, int b_nk,
                                   void* stream) {
  return b_nk ? launch<false, true>(x, w, tile_expert, y, M, N, K, block_m,
                                    stream)
              : launch<false, false>(x, w, tile_expert, y, M, N, K,
                                     block_m, stream);
}

// y [M, N] int32 = x [M, K] int8 @ w[e] [K][N] int8, exact.  M % 64,
// N % 128, K % 32 == 0 and block_m % 64 == 0 (the wrapper checks).
extern "C" int tdt_group_gemm_i8(const void* x, const void* w,
                                 const void* tile_expert, void* y, int M,
                                 int N, int K, int block_m, void* stream) {
  return block_m % tdt_gemm90::Cfg<true, false, true>::TM == 0
             ? launch<true, false, true>(x, w, tile_expert, y, M, N, K,
                                         block_m, stream)
             : launch<true, false>(x, w, tile_expert, y, M, N, K, block_m,
                                   stream);
}
