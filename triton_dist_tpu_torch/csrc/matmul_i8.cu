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
// Design (right and simple first; wgmma + TMA are later work).  One
// block of 4 warps per 64 x 128 output tile; each warp owns 32 columns
// and up to four 16-row m-tiles (m-tiles wholly past m are skipped, so a
// decode row costs one).  The k loop walks 64-deep tiles through a
// two-stage cp.async ring; products are `mma.sync.m16n8k32` s8 x s8 ->
// s32 with ldmatrix-fed fragments.  The tensor cores want B as [n][k]
// (k contiguous), while the weight is [k][n] and ldmatrix cannot
// transpose bytes, so each staged B tile is transposed in shared memory
// (4 x 4 byte blocks by byte permutes) before the products; the weight
// layout in device memory stays the reference's.  Few output tiles
// (decode width, n = 4096) would leave SMs idle, so the wrapper may split
// the k loop across blocks (grid.z): the partial sums meet by int32
// atomics into a zeroed output, which is exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;

constexpr int BM = 64;         // output rows per block
constexpr int BN = 128;        // output columns per block (32 per warp)
constexpr int BK = 64;         // k bytes per tile
constexpr int NT = 128;        // 4 warps
constexpr int LDA = BK + 16;   // A row stride in shared memory (bytes)
constexpr int LDB = BN + 16;   // staged B row stride, [k][n] (bytes)
constexpr int LDT = BK + 16;   // transposed B row stride, [n][k] (bytes)
// 80-byte rows put the 8 rows of an ldmatrix on distinct banks
constexpr int SMEM = 2 * (BM * LDA + BK * LDB) + BN * LDT;  // 38,912 B

struct Params {
  const int8_t* a;
  const int8_t* b;
  int* c;
  int M, N, K, k_split;
};

// The four bytes-columns of a 4 x 4 byte block held as four row words:
// out[j] = (w0.b_j, w1.b_j, w2.b_j, w3.b_j).
__device__ inline void transpose4x4(const unsigned (&w)[4],
                                    unsigned (&out)[4]) {
  const unsigned lo01 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned hi01 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned lo23 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned hi23 = __byte_perm(w[2], w[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

__global__ void __launch_bounds__(NT)
matmul_i8_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(128) int8_t smem[SMEM];
  int8_t* sA = smem;                    // [2][BM][LDA]
  int8_t* sB = sA + 2 * BM * LDA;       // [2][BK][LDB]
  int8_t* sT = sB + 2 * BK * LDB;       // [BN][LDT]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * p.k_split;
  const int ke = min(p.K, kb + p.k_split);
  const int n_k = (ke - kb + BK - 1) / BK;
  const int live_mt = min(BM / 16, (p.M - m0 + 15) / 16);

  auto load = [&](int kt, int st) {
    const int k0 = kb + kt * BK;
    int8_t* dA = sA + st * BM * LDA;
    int8_t* dB = sB + st * BK * LDB;
#pragma unroll
    for (int i = 0; i < BM * (BK / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (BK / 16), c = j % (BK / 16);
      const int row = m0 + r, col = k0 + c * 16;
      cp_async16(dA + r * LDA + c * 16,
                 row < p.M && col < ke
                     ? p.a + static_cast<long long>(row) * p.K + col
                     : nullptr, p.a);
    }
#pragma unroll
    for (int i = 0; i < BK * (BN / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (BN / 16), c = j % (BN / 16);
      const int kk = k0 + r, col = n0 + c * 16;
      cp_async16(dB + r * LDB + c * 16,
                 kk < ke && col < p.N
                     ? p.b + static_cast<long long>(kk) * p.N + col
                     : nullptr, p.b);
    }
  };

  int acc[BM / 16][4][4];
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  if (n_k > 0) {
    load(0, 0);
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_k) {
      load(kt + 1, st ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // B stage [BK][BN] -> sT [BN][BK]: each thread moves four 4 x 4 byte
    // blocks (k rows 4 kq .. 4 kq + 3, n columns 4 nq .. 4 nq + 3)
    const int8_t* srcB = sB + st * BK * LDB;
#pragma unroll
    for (int i = 0; i < (BK / 4) * (BN / 4) / NT; ++i) {
      const int kq = (tid & 3) + 4 * i, nq = tid >> 2;
      unsigned w[4], t[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const unsigned*>(
            srcB + (4 * kq + r) * LDB + 4 * nq);
      transpose4x4(w, t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<unsigned*>(sT + (4 * nq + c) * LDT + 4 * kq) = t[c];
    }
    __syncthreads();

    const bf16* tA = reinterpret_cast<const bf16*>(sA + st * BM * LDA);
    const bf16* tT = reinterpret_cast<const bf16*>(sT);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      unsigned bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned b4[4];
        load_b_nk(b4, tT, LDT / 2, warp * 32 + np * 16, ks * 16);
        bf[2 * np][0] = b4[0];
        bf[2 * np][1] = b4[1];
        bf[2 * np + 1][0] = b4[2];
        bf[2 * np + 1][1] = b4[3];
      }
#pragma unroll
      for (int mt = 0; mt < BM / 16; ++mt) {
        if (mt < live_mt) {
          unsigned a[4];
          load_a(a, tA, LDA / 2, mt * 16, ks * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16832_s8(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();  // stage st and sT are refilled next
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt) {
    if (mt >= live_mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + gq + h * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + warp * 32 + nt * 8 + 2 * tq;
        if (col >= p.N) continue;
        int* dst = p.c + static_cast<long long>(row) * p.N + col;
        const int v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (split) {
          atomicAdd(dst, v0);
          atomicAdd(dst + 1, v1);
        } else {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        }
      }
    }
  }
}

}  // namespace

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
