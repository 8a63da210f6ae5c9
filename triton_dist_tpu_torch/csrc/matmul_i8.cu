// matmul_i8: exact int8 x int8 -> int32 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/quant.py
// `_matmul_i8_kernel` (launched from `matmul_i8`).  Same contract:
// C[m, n] int32 = A[m, k] int8 @ B[k, n] int8, both row-major, summed
// exactly in int32.  The TPU version takes only m % 32 == 0 and leaves
// decode-width rows to XLA; here one kernel takes every m (the row tail
// is masked), k % 32 == 0 and n % 16 == 0 (rows are whole 16-byte
// copies).
//
// What bounds it on an H100: the W8A8 projections of the serving path.
// At decode width (m <= 8) the weight is read once and little else, so
// device memory bounds it (k * n bytes at 3.35 TB/s: 58.7 MB -> 17.5 us
// for gate/up of Llama-3-8B); a 512-row prefill chunk does 2 m n k int8
// operations, 60 G at the 1,979 TOP/s int8 tensor-core peak = 30 us.
//
// Two kernels, chosen by the wrapper from (m, n, k) alone (`quant.
// matmul_i8_kernel_for`, the crossover measured on the card):
//
// - above the crossover, `matmul_i8_wg_kernel`: the persistent GEMM of
//   sm90_gemm.cuh (a TMA producer warpgroup, two consumer warpgroups, one
//   block an SM) on 256 x 128 tiles: each consumer takes 128 rows, two
//   `wgmma m64n128k32.s32.s8.s8` a k-step on one B tile.  B [k][n] is
//   staged as it lies and transposed in shared memory by the producer's
//   warps 1-3 (wgmma takes 8-bit operands K-major only; the weight keeps
//   its layout and no pass over it runs per call), and the transposers
//   set the int8 rate: a 256 x 128 tile transposes half the B bytes a
//   128 x 256 one does for the same products (0.0845 against 0.1004 ms
//   at m 512, PERF.md row 8);
// - at decode width (few rows), `matmul_i8_kernel`: one block of 4 warps
//   per 64 x 128 output tile on the tile loop of i8_tile.cuh (mma.sync
//   m16n8k32 over a two-stage cp.async ring, each B tile transposed in
//   shared memory).  Few output tiles (decode width, n = 4096) would
//   leave SMs idle, so the wrapper may split the k loop across blocks
//   (grid.z): the partial sums meet by int32 atomics into a zeroed
//   output, which is exact in any order.  The weight is read once; this
//   kernel reaches ~58% of that bytes bound, and no library call takes
//   m <= 16.
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_tile.cuh"
#include "sm90_gemm.cuh"

namespace {

using namespace tdt_i8;

struct Params {
  const int8_t* a;
  const int8_t* b;
  int* c;
  int M, N, K, k_split;
};

__global__ void __launch_bounds__(NT)
matmul_i8_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(128) int8_t smem[SMEM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.k_split;
  const int ke = min(p.K, kb + p.k_split);
  int acc[BM / 16][4][4];
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
  mma_tile(acc, smem, p.a, p.b, p.M, p.N, p.K, m0, n0, kb, ke);
  store_tile(acc, p.c, p.M, p.N, m0, n0, gridDim.z > 1);
}

// The persistent wgmma kernel: one slab, 256 x 128 tiles (the last row
// tile masked at m), groups of row tiles as the grouped GEMM's.
constexpr int WG_GROUP = 8;

__global__ void __launch_bounds__(tdt_gemm90::NT, 1)
matmul_i8_wg_kernel(const __grid_constant__ tdt_gemm90::Gemm p) {
  extern __shared__ __align__(128) char wg_smem[];
  tdt_gemm90::persistent_gemm<true, false, true>(p, wg_smem);
}

}  // namespace

// C [M, N] int32 = A [M, K] int8 @ B [K, N] int8 on the persistent wgmma
// kernel.  K % 32 == 0, N % 16 == 0, A, B and C contiguous with 16-byte
// aligned bases (the wrapper checks).
extern "C" int tdt_matmul_i8_wg(const void* a, const void* b, void* c, int M,
                                int N, int K, void* stream) {
  tdt_gemm90::Gemm p;
  p.slab = nullptr;
  p.c = c;
  p.rows = p.slab_rows = tdt_gemm90::Cfg<true, false, true>::TM;
  static unsigned attr = 0;
  return tdt_gemm90::launch_gemm<true, false, true>(
      matmul_i8_wg_kernel, p, a, b, M, N, K, 1, static_cast<long long>(K) * N,
      WG_GROUP, attr, static_cast<cudaStream_t>(stream));
}

// The split-K tile loop: any M, K % 32 == 0, N % 16 == 0; k_split a
// multiple of 64 (the k loop's share of one block).
extern "C" int tdt_matmul_i8(const void* a, const void* b, void* c, int M,
                             int N, int K, int k_split, void* stream) {
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.c = static_cast<int*>(c);
  p.M = M;
  p.N = N;
  p.K = K;
  p.k_split = k_split;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  (K + k_split - 1) / k_split);
  matmul_i8_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
