// matmul: the dense bf16 GEMM for Hopper (sm_90a), C = A @ B with f32
// accumulation, for any (M, N, K).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/gemm.py `_matmul_kernel`
// (launched from `matmul`, gemm.py:229).  Same contract: A [M, K] and B
// [K, N] row-major bf16, the sum over K in f32, rounded once to the output
// type (bf16 or f32, the reference's `out_dtype`); the K tail is masked to
// zero as the TPU kernel masks it (gemm.py:198-215) and the M / N edges
// are neither read nor written past the arrays.
//
// What bounds it on an H100: at (M, K, N) = (2048, 4096, 14336) one call is
// 240.5 GFLOP, 0.243 ms at the 989 TFLOP/s bf16 peak, against 193 MB of
// operands and output (0.058 ms at 3.35 TB/s): operations bound it, as
// they do every projection of a 2048-token step.
//
// Two kernels; the wrapper picks by the shape before the launch
// (kernels/gemm.py `matmul_kernel_for`):
// - matmul_wg_kernel<OutT>, wherever TMA takes the operands (K % 8 == 0,
//   N % 8 == 0, 16-byte aligned bases): the persistent GEMM of
//   sm90_gemm.cuh (`persistent_gemm`, group_gemm.cu's), one block of a TMA
//   producer warpgroup and two wgmma consumer warpgroups on each SM, 128 x
//   256 output tiles walked in groups of GROUP row tiles and column band
//   by column band within a group, A [M][K] and B [K][N] (the MN-major
//   operand) read in place by tensor maps.  TMA loads zeros past M, N and
//   K, so ragged edges and the K tail cost nothing extra; the stores are
//   masked to M and N.
// - matmul_kernel<OutT>, any other shape (an odd K or N row, a misaligned
//   view): the element-wise tile loop of bf16_tile.cuh, one block of 8
//   warps per 128 x 128 tile, each value loaded alone and masked.  TMA
//   takes neither rows of a byte length not a multiple of 16 nor bases off
//   16 bytes, so these shapes keep it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace tdt_frag;
using tdt_bf16::BM;
using tdt_bf16::BN;
using tdt_bf16::NT;
using tdt_bf16::Tiles;
using tdt_gemm90::Gemm;

// Row tiles a group of the persistent GEMM's tile order (group_gemm.cu's).
constexpr int GROUP = 8;

template <class OutT>
__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
matmul_wg_kernel(const __grid_constant__ Gemm p) {
  extern __shared__ __align__(128) char mm_smem[];
  tdt_gemm90::persistent_gemm<false, false, false, OutT>(p, mm_smem);
}

template <class OutT>
__global__ void __launch_bounds__(NT)
matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
              OutT* __restrict__ c, int M, int N, int K) {
  extern __shared__ __align__(128) char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[4][4][4];
  tdt_bf16::mma_tile<false, false>(acc, reinterpret_cast<bf16*>(smem_raw),
                                   a, K, b, N, M, N, K, m0, n0);
  tdt_bf16::store_tile(acc, c, N, M, N, m0, n0);
}

template <class OutT>
int launch_wg(const void* a, const void* b, void* c, int M, int N, int K,
              cudaStream_t stream) {
  Gemm p;
  p.slab = nullptr;
  p.c = c;
  p.rows = tdt_gemm90::BM;
  p.slab_rows = tdt_gemm90::BM;
  static unsigned attr = 0;
  return tdt_gemm90::launch_gemm<false, false>(
      matmul_wg_kernel<OutT>, p, a, b, M, N, K, 1,
      static_cast<long long>(K) * N, GROUP, attr, stream);
}

template <class OutT>
int launch_tile(const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t stream) {
  static unsigned attr_set = 0;
  const auto kernel = matmul_kernel<OutT>;
  const cudaError_t err =
      tdt_bf16::allow_smem(kernel, Tiles<false>::SMEM, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NT, Tiles<false>::SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<OutT*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c [M, N] (bf16, or f32 with out_f32) = a [M, K] bf16 @ b [K, N] bf16,
// all row-major and contiguous.  wg = 1 (the persistent wgmma kernel) only
// when K % 8 == 0, N % 8 == 0 and the three base addresses are 16-byte
// aligned (the wrapper checks); wg = 0 the tile loop, any shape.
extern "C" int tdt_matmul(const void* a, const void* b, void* c, int M,
                          int N, int K, int wg, int out_f32, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (wg)
    return out_f32 ? launch_wg<float>(a, b, c, M, N, K, s)
                   : launch_wg<bf16>(a, b, c, M, N, K, s);
  return out_f32 ? launch_tile<float>(a, b, c, M, N, K, s)
                 : launch_tile<bf16>(a, b, c, M, N, K, s);
}
