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
// Design (right and simple first; wgmma + TMA are later work): one block
// of 8 warps per 128 x 128 output tile on the tile loop of bf16_tile.cuh,
// which the grouped GEMM and the two ring kernels (ag_gemm.cu, gemm_rs.cu)
// share, so this kernel is also that loop's standalone check against
// cuBLAS.  Rows 16-byte aligned with K and N multiples of 8 take the
// cp.async path; any other shape the element-wise loads of the same loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"

namespace {

using namespace tdt_frag;
using tdt_bf16::BM;
using tdt_bf16::BN;
using tdt_bf16::NT;
using tdt_bf16::Tiles;

template <bool VEC, class OutT>
__global__ void __launch_bounds__(NT)
matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
              OutT* __restrict__ c, int M, int N, int K) {
  extern __shared__ __align__(128) char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[4][4][4];
  tdt_bf16::mma_tile<false, VEC>(acc, reinterpret_cast<bf16*>(smem_raw), a,
                                 K, b, N, M, N, K, m0, n0);
  tdt_bf16::store_tile(acc, c, N, M, N, m0, n0);
}

template <bool VEC, class OutT>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t stream) {
  static unsigned attr_set = 0;
  const auto kernel = matmul_kernel<VEC, OutT>;
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
// all row-major and contiguous.  vec = 1 only when K % 8 == 0, N % 8 == 0
// and the three base addresses are 16-byte aligned (the wrapper checks).
extern "C" int tdt_matmul(const void* a, const void* b, void* c, int M,
                          int N, int K, int vec, int out_f32, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    return out_f32 ? launch<true, float>(a, b, c, M, N, K, s)
                   : launch<true, bf16>(a, b, c, M, N, K, s);
  return out_f32 ? launch<false, float>(a, b, c, M, N, K, s)
                 : launch<false, bf16>(a, b, c, M, N, K, s);
}
