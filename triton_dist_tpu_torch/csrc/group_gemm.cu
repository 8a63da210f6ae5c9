// group_gemm: the grouped (expert-blocked) GEMM of the MoE family for
// Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/group_gemm.py `_kernel`
// (in `_group_gemm_fwd_impl`, launched from `group_gemm`).  Same contract:
// the expert-sorted token buffer x [M_pad, K] is cut into row tiles of
// `block_m` rows, each of which belongs to one expert; row tile i is
// `x_tile @ w[tile_expert[i]]` with w [E, K, N] row-major (the reference's
// layout, never copied or transposed).  Three modes:
//
// - bf16: f32 accumulation, rounded once to bf16 (the TPU kernel writes
//   `acc.astype(out_dtype)`);
// - bf16 with the slab transposed (`b_nk`): dx = dy [M_pad, N] @ w[e]^T,
//   the reference VJP's grouped GEMM on `swapaxes(w, 1, 2)`.  w[e] stored
//   [K][N] row-major is already the [n][k] operand the tensor cores want
//   for that product, so this mode is the same kernel loading B with plain
//   ldmatrix instead of ldmatrix.trans;
// - int8: exact s8 x s8 -> s32, the tile loop of i8_tile.cuh (shared with
//   matmul_i8.cu) with a per-row-tile B base.
//
// What bounds it on an H100: at Mixtral-8x7B's expert FFN (E 8, K 4096,
// N 14336) and a 2048-token top-2 batch (M_pad 5120 at block_m 128) one
// projection is 601 GFLOP, 0.61 ms at the 989 TFLOP/s bf16 peak, against
// 1.13 GB of operands (0.34 ms at 3.35 TB/s): operations bound it.  At
// decode width (M_pad 1152) the expert slabs (117 MB each) dominate and
// bytes bound it.
//
// Design (right and simple first; wgmma + TMA are later work).  bf16: one
// block of 8 warps per 128 x 128 output tile on the tile loop of
// bf16_tile.cuh (shared with gemm.cu and the ring kernels: 4 x 4
// mma.sync.m16n8k16 per warp and 16-deep step, a 4-stage cp.async ring of
// 32-deep A and B tiles in dynamic shared memory).  Every block
// lies in one expert tile (block_m is a multiple of 128, the wrapper
// checks), so it reads tile_expert once and offsets B by e K N.  int8: one
// block of 4 warps per 64 x 128 tile (block_m a multiple of 64).  Rows are
// never masked: M_pad, N and K are multiples of the tiles (the wrapper
// raises otherwise) and padding rows are zeros that come out as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "i8_tile.cuh"
#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;
using tdt_bf16::BM;
using tdt_bf16::BN;
using tdt_bf16::NT;
using tdt_bf16::Tiles;

struct Params {
  const void* x;           // [M, K] (K = contraction length)
  const void* w;           // [E, K, N], or [E, N, K] read as [n][k]
  const int* tile_expert;  // [M / block_m]
  void* y;                 // [M, N]
  int M, N, K, block_m;
};

template <bool B_NK>
__global__ void __launch_bounds__(NT)
group_gemm_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) char smem_raw[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int e = p.tile_expert[m0 / p.block_m];
  const bf16* b = static_cast<const bf16*>(p.w) +
                  static_cast<long long>(e) * p.K * p.N;
  float acc[4][4][4];
  // every dimension is a multiple of its tile: nothing is masked
  tdt_bf16::mma_tile<B_NK, true>(acc, reinterpret_cast<bf16*>(smem_raw),
                                 static_cast<const bf16*>(p.x), p.K, b,
                                 B_NK ? p.K : p.N, p.M, p.N, p.K, m0, n0);
  tdt_bf16::store_tile(acc, static_cast<bf16*>(p.y), p.N, p.M, p.N, m0,
                       n0);
}

__global__ void __launch_bounds__(tdt_i8::NT)
group_gemm_i8_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(128) int8_t smem[tdt_i8::SMEM];
  const int n0 = blockIdx.x * tdt_i8::BN, m0 = blockIdx.y * tdt_i8::BM;
  const int e = p.tile_expert[m0 / p.block_m];
  const int8_t* b = static_cast<const int8_t*>(p.w) +
                    static_cast<long long>(e) * p.K * p.N;
  int acc[tdt_i8::BM / 16][4][4];
#pragma unroll
  for (int mt = 0; mt < tdt_i8::BM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
  tdt_i8::mma_tile(acc, smem, static_cast<const int8_t*>(p.x), b, p.M, p.N,
                   p.K, m0, n0, 0, p.K);
  tdt_i8::store_tile(acc, static_cast<int*>(p.y), p.M, p.N, m0, n0, false);
}

template <bool B_NK>
int launch_bf16(const Params& p, cudaStream_t stream) {
  static unsigned attr_set = 0;
  const cudaError_t err = tdt_bf16::allow_smem(
      group_gemm_bf16_kernel<B_NK>, Tiles<B_NK>::SMEM, attr_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.N / BN, p.M / BM);
  group_gemm_bf16_kernel<B_NK><<<grid, NT, Tiles<B_NK>::SMEM, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* x, const void* w, const void* tile_expert,
                   void* y, int M, int N, int K, int block_m) {
  Params p;
  p.x = x;
  p.w = w;
  p.tile_expert = static_cast<const int*>(tile_expert);
  p.y = y;
  p.M = M;
  p.N = N;
  p.K = K;
  p.block_m = block_m;
  return p;
}

}  // namespace

// y [M, N] bf16 = x [M, K] bf16 @ slab; b_nk = 0: slab w[e] [K][N]
// (forward), b_nk = 1: slab w[e]^T of w [E, N, K] (dx).  M % 128, N % 128,
// K % 32 == 0 and block_m % 128 == 0 (the wrapper checks).
extern "C" int tdt_group_gemm_bf16(const void* x, const void* w,
                                   const void* tile_expert, void* y, int M,
                                   int N, int K, int block_m, int b_nk,
                                   void* stream) {
  const Params p = make_params(x, w, tile_expert, y, M, N, K, block_m);
  const auto s = static_cast<cudaStream_t>(stream);
  return b_nk ? launch_bf16<true>(p, s) : launch_bf16<false>(p, s);
}

// y [M, N] int32 = x [M, K] int8 @ w[e] [K][N] int8, exact.  M % 64,
// N % 128, K % 64 == 0 and block_m % 64 == 0 (the wrapper checks).
extern "C" int tdt_group_gemm_i8(const void* x, const void* w,
                                 const void* tile_expert, void* y, int M,
                                 int N, int K, int block_m, void* stream) {
  const Params p = make_params(x, w, tile_expert, y, M, N, K, block_m);
  const dim3 grid(N / tdt_i8::BN, M / tdt_i8::BM);
  group_gemm_i8_kernel<<<grid, tdt_i8::NT, 0,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
