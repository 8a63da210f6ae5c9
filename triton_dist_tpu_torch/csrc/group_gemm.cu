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
// block of 8 warps per 128 x 128 output tile (warps 2 x 4, each 64 rows x
// 32 columns: 4 x 4 mma.sync.m16n8k16 per 16-deep step), a 4-stage
// cp.async ring of 32-deep A and B tiles in dynamic shared memory, padded
// rows so each ldmatrix hits 8 distinct 16-byte bank groups.  Every block
// lies in one expert tile (block_m is a multiple of 128, the wrapper
// checks), so it reads tile_expert once and offsets B by e K N.  int8: one
// block of 4 warps per 64 x 128 tile (block_m a multiple of 64).  Rows are
// never masked: M_pad, N and K are multiples of the tiles (the wrapper
// raises otherwise) and padding rows are zeros that come out as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "i8_tile.cuh"
#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;

constexpr int BM = 128;        // output rows per block (bf16 modes)
constexpr int BN = 128;        // output columns per block
constexpr int BK = 32;         // contraction depth per stage
constexpr int NT = 256;        // 8 warps
constexpr int STAGES = 4;
constexpr int LDA = BK + 8;    // [rows][k] tiles: 80-byte rows
constexpr int LDKN = BN + 8;   // [k][n] B tiles: 272-byte rows

template <bool B_NK>
struct Tiles {
  static constexpr int A = BM * LDA;                     // elements
  static constexpr int B = B_NK ? BN * LDA : BK * LDKN;  // elements
  static constexpr int SMEM = STAGES * (A + B) * 2;      // bytes
};

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
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);     // [STAGES][BM][LDA]
  bf16* sB = sA + STAGES * Tiles<B_NK>::A;          // [STAGES][B tile]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int e = p.tile_expert[m0 / p.block_m];
  const bf16* a = static_cast<const bf16*>(p.x) +
                  static_cast<long long>(m0) * p.K;
  const bf16* b = static_cast<const bf16*>(p.w) +
                  static_cast<long long>(e) * p.K * p.N;
  const int n_k = p.K / BK;

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* dA = sA + st * Tiles<B_NK>::A;
    bf16* dB = sB + st * Tiles<B_NK>::B;
#pragma unroll
    for (int i = 0; i < BM * (BK / 8) / NT; ++i) {
      const int j = tid + i * NT, r = j / (BK / 8), c = j % (BK / 8);
      cp_async16(dA + r * LDA + c * 8,
                 a + static_cast<long long>(r) * p.K + k0 + c * 8, a);
    }
    if constexpr (B_NK) {
      // slab rows are output columns: B[n][k] at n * K + k
#pragma unroll
      for (int i = 0; i < BN * (BK / 8) / NT; ++i) {
        const int j = tid + i * NT, r = j / (BK / 8), c = j % (BK / 8);
        cp_async16(dB + r * LDA + c * 8,
                   b + static_cast<long long>(n0 + r) * p.K + k0 + c * 8, b);
      }
    } else {
      // slab rows are contraction steps: B[k][n] at k * N + n
#pragma unroll
      for (int i = 0; i < BK * (BN / 8) / NT; ++i) {
        const int j = tid + i * NT, r = j / (BN / 8), c = j % (BN / 8);
        cp_async16(dB + r * LDKN + c * 8,
                   b + static_cast<long long>(k0 + r) * p.N + n0 + c * 8, b);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
          0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();         // and every warp is done with stage kt - 1
    if (kt + STAGES - 1 < n_k) load(kt + STAGES - 1, (kt + STAGES - 1) %
                                                         STAGES);
    cp_commit();

    const int st = kt % STAGES;
    const bf16* tA = sA + st * Tiles<B_NK>::A;
    const bf16* tB = sB + st * Tiles<B_NK>::B;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      unsigned bfr[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b4[4];
        if constexpr (B_NK)
          load_b_nk(b4, tB, LDA, wn * 32 + np * 16, ks * 16);
        else
          load_b_kn(b4, tB, LDKN, ks * 16, wn * 32 + np * 16);
        bfr[2 * np][0] = b4[0];
        bfr[2 * np][1] = b4[1];
        bfr[2 * np + 1][0] = b4[2];
        bfr[2 * np + 1][1] = b4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned af[4];
        load_a(af, tA, LDA, wm * 64 + mt * 16, ks * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma16816(acc[mt][nt], af, bfr[nt][0], bfr[nt][1]);
      }
    }
  }

  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + gq + h * 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * tq;
        *reinterpret_cast<unsigned*>(y + static_cast<long long>(row) * p.N +
                                     col) =
            pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
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

// cudaFuncSetAttribute once per kernel, device and process (outside any
// graph capture: the first call of each wrapper is an eager one).
template <class Kern>
cudaError_t allow_smem(Kern kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (done & (1u << dev)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= 1u << dev;
  return err;
}

template <bool B_NK>
int launch_bf16(const Params& p, cudaStream_t stream) {
  static unsigned attr_set = 0;
  const cudaError_t err = allow_smem(group_gemm_bf16_kernel<B_NK>,
                                     Tiles<B_NK>::SMEM, attr_set);
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
