// The int8 tile loop shared by matmul_i8.cu (its split-K path for the
// W8A8 projections' few-tile shapes) and ag_gemm.cu (the int8 torus
// AG-GEMM, row 14i): one block of 4 warps sums a 64 x 128 int32 output
// tile over a k range, exactly.
//
// Each warp owns 32 columns and up to four 16-row m-tiles (m-tiles wholly
// past M are skipped, so a decode row costs one).  The k loop walks 64-deep
// tiles through a two-stage cp.async ring; products are
// `mma.sync.m16n8k32` s8 x s8 -> s32 with ldmatrix-fed fragments.  The
// tensor cores want B as [n][k] (k contiguous), while the weight is [k][n]
// and ldmatrix cannot transpose bytes, so each staged B tile is transposed
// in shared memory (4 x 4 byte blocks by byte permutes) before the
// products; the weight layout in device memory stays the reference's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace tdt_i8 {

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

// m-tiles of 16 rows of the block at m0 that hold rows below M.
__device__ inline int live_mtiles(int M, int m0) {
  return min(BM / 16, (M - m0 + 15) / 16);
}

// acc += A[m0 : m0 + BM, kb : ke] @ B[kb : ke, n0 : n0 + BN] over rows < M
// and columns < N.  a: row-major, row stride lda bytes; b: row-major
// [.][N] (the caller points it at the weight slab); smem: SMEM bytes.
__device__ __forceinline__ void mma_tile(int (&acc)[BM / 16][4][4],
                                         int8_t* smem, const int8_t* a,
                                         const int8_t* b, int M, int N,
                                         int lda, int m0, int n0, int kb,
                                         int ke) {
  int8_t* sA = smem;                    // [2][BM][LDA]
  int8_t* sB = sA + 2 * BM * LDA;       // [2][BK][LDB]
  int8_t* sT = sB + 2 * BK * LDB;       // [BN][LDT]
  const int tid = threadIdx.x, warp = tid / 32;
  const int n_k = (ke - kb + BK - 1) / BK;
  const int live_mt = live_mtiles(M, m0);

  auto load = [&](int kt, int st) {
    const int k0 = kb + kt * BK;
    int8_t* dA = sA + st * BM * LDA;
    int8_t* dB = sB + st * BK * LDB;
#pragma unroll
    for (int i = 0; i < BM * (BK / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (BK / 16), c = j % (BK / 16);
      const int row = m0 + r, col = k0 + c * 16;
      cp_async16(dA + r * LDA + c * 16,
                 row < M && col < ke
                     ? a + static_cast<long long>(row) * lda + col
                     : nullptr, a);
    }
#pragma unroll
    for (int i = 0; i < BK * (BN / 16) / NT; ++i) {
      const int j = tid + i * NT, r = j / (BN / 16), c = j % (BN / 16);
      const int kk = k0 + r, col = n0 + c * 16;
      cp_async16(dB + r * LDB + c * 16,
                 kk < ke && col < N
                     ? b + static_cast<long long>(kk) * N + col
                     : nullptr, b);
    }
  };

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
          unsigned af[4];
          load_a(af, tA, LDA / 2, mt * 16, ks * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma16832_s8(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();  // stage st and sT are refilled next
  }
}

// Write the tile's sums to c [M][N] int32 (rows < M, columns < N); with
// `atomic` they are added into a zeroed c (split-K partial sums, exact in
// any order).
__device__ __forceinline__ void store_tile(const int (&acc)[BM / 16][4][4],
                                           int* c, int M, int N, int m0,
                                           int n0, bool atomic) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int live_mt = live_mtiles(M, m0);
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt) {
    if (mt >= live_mt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + gq + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + warp * 32 + nt * 8 + 2 * tq;
        if (col >= N) continue;
        int* dst = c + static_cast<long long>(row) * N + col;
        const int v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (atomic) {
          atomicAdd(dst, v0);
          atomicAdd(dst + 1, v1);
        } else {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        }
      }
    }
  }
}

}  // namespace tdt_i8
