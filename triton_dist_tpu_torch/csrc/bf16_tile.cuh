// The bf16 tile loop shared by gemm.cu (the dense matmul's shapes that TMA
// does not take: rows of K or N not a multiple of 8, bases off 16 bytes)
// and the modes of the two tensor-parallel ring kernels still on it
// (ag_gemm.cu's int8 wire, gemm_rs.cu's bf16 bidir ring): one block of 8
// warps sums a 128 x 128 f32 output tile over the whole contraction.  The
// counterpart of the TPU's `gemm_pipeline_body`
// (triton_dist_tpu/kernels/gemm.py:128), the inner loop of its
// `_matmul_kernel` and of the ring kernels.
//
// Warps 2 x 4, each 64 rows x 32 columns: 4 x 4 mma.sync.m16n8k16 per
// 16-deep step, a 4-stage cp.async ring of 32-deep A and B tiles in dynamic
// shared memory, padded rows so each ldmatrix hits 8 distinct 16-byte bank
// groups.  B comes in either layout: [k][n] (ldmatrix.trans fragments), or
// [n][k] (plain ldmatrix), the transposed operand of a backward product
// read in place, never copied.
//
// Edges: rows of A at or past M, columns of B at or past N and the K tail
// past K are loaded as zeros (the TPU kernel masks its K tail to zero,
// gemm.py:198-215, and drops the M/N padding on store), and store_tile
// writes only rows < M and columns < N.  With VEC every row of A and B is
// 16-byte aligned and K (and N for a [k][n] B) is a multiple of 8, so each
// 8-element vector lies wholly inside or outside and loads as one cp.async
// that zero-fills; without VEC the tiles are loaded element by element.
//
// A_I8 (the AG-GEMM's int8 wire): A arrives as int8 rows with an f32
// scale per row and is dequantized in the A-tile load, as the TPU's
// `wire_gemm_pipeline_body` does at its MXU feed (gemm.py:163-165): each
// value becomes bf16(float(q) * scale), rounded once, in shared memory;
// the product is the bf16 one.  No bf16 A is written to device memory.
// Those loads are plain (L1-bypassing) loads, not cp.async: each k step
// fetches a later stage's int8 values into registers before its products
// and dequantizes them into shared memory after.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace tdt_bf16 {

using namespace tdt_frag;

constexpr int BM = 128;        // output rows per block
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
  // A_I8: the A tile's row scales after the stages
  static constexpr int SMEM_I8 = SMEM + BM * 4;          // bytes
};

// Eight consecutive values of `row` from column `col` into shared memory,
// zeros for a dead row and for columns at or past `limit`.
template <bool VEC>
__device__ __forceinline__ void load8(bf16* dst, const bf16* row, int col,
                                      int limit, bool live,
                                      const void* any) {
  if constexpr (VEC) {
    cp_async16(dst, live && col < limit ? row + col : nullptr, any);
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = col + 2 * e;
      const unsigned lo = live && c0 < limit ? src[c0] : 0u;
      const unsigned hi = live && c0 + 1 < limit ? src[c0 + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The int8 wire's A loads (A_I8): a thread's sixteen int8 values of a row
// at column `col` (zeros for a dead row or past K, K % 16 == 0), then,
// once the stage's buffer is free, those values times the row's scale as
// sixteen bf16 in shared memory.
__device__ __forceinline__ uint4 fetch16_i8(const int8_t* row, int col,
                                            int limit, bool live) {
  return live && col < limit
             ? __ldcg(reinterpret_cast<const uint4*>(row + col))
             : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void put16_i8(bf16* dst, uint4 raw, float scale) {
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    d[h] = make_uint4(pack_bf16(q[8 * h] * scale, q[8 * h + 1] * scale),
                      pack_bf16(q[8 * h + 2] * scale, q[8 * h + 3] * scale),
                      pack_bf16(q[8 * h + 4] * scale, q[8 * h + 5] * scale),
                      pack_bf16(q[8 * h + 6] * scale, q[8 * h + 7] * scale));
}

// acc = A[m0 : m0 + BM, 0 : K] @ B[0 : K, n0 : n0 + BN] in f32.  a: row
// 0 of a row-major A (row stride lda elements; bf16, or int8 with A_I8 and
// then a_scale[row] the scale of each row); b: a row-major [K][N] B (row
// stride ldb), or with B_NK a row-major [N][K] B^T.  smem:
// Tiles<B_NK>::SMEM bytes, 128-byte aligned.  Every thread of the block
// calls it; it begins with a __syncthreads, so a block may loop over tiles.
template <bool B_NK, bool VEC, bool A_I8 = false>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4], bf16* smem,
                                         const void* a_any, long long lda,
                                         const bf16* b, long long ldb, int M,
                                         int N, int K, int m0, int n0,
                                         const float* a_scale = nullptr) {
  const bf16* a = static_cast<const bf16*>(a_any);
  bf16* sA = smem;                                  // [STAGES][BM][LDA]
  bf16* sB = sA + STAGES * Tiles<B_NK>::A;          // [STAGES][B tile]
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n_k = (K + BK - 1) / BK;

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] =
          0.f;
  __syncthreads();   // every warp is done with the previous tile's stages

  // A_I8: the tile's row scales are read once into shared memory (after
  // the stages: Tiles::SMEM_I8); each thread owns 16 values of one row per
  // stage (BM * BK / NT = 16).  The int8 values of stage kt + STAGES - 1
  // are fetched into registers before stage kt's products and stored
  // (dequantized) after them, so the loads' latency hides behind the MMAs
  static_assert(BM * BK == 16 * NT, "one 16-value group per thread");
  float* s_scale = reinterpret_cast<float*>(sB + STAGES * Tiles<B_NK>::B);
  const int a8_row = tid / (BK / 16), a8_col = (tid % (BK / 16)) * 16;
  const int8_t* a8 = static_cast<const int8_t*>(a_any) +
                     static_cast<long long>(m0 + a8_row) * lda;
  if constexpr (A_I8) {
    if (tid < BM)
      s_scale[tid] = m0 + tid < M ? __ldcg(a_scale + m0 + tid) : 0.f;
    __syncthreads();
  }
  auto put_a8 = [&](uint4 raw, int st) {
    put16_i8(sA + st * Tiles<B_NK>::A + a8_row * LDA + a8_col, raw,
             s_scale[a8_row]);
  };

  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    bf16* dA = sA + st * Tiles<B_NK>::A;
    bf16* dB = sB + st * Tiles<B_NK>::B;
    if constexpr (!A_I8) {
#pragma unroll
      for (int i = 0; i < BM * (BK / 8) / NT; ++i) {
        const int j = tid + i * NT, r = j / (BK / 8), c = j % (BK / 8);
        const int row = m0 + r;
        load8<VEC>(dA + r * LDA + c * 8,
                   a + static_cast<long long>(row) * lda, k0 + c * 8, K,
                   row < M, a);
      }
    }
    if constexpr (B_NK) {
      // B^T rows are output columns: B[k][n] at n * ldb + k
#pragma unroll
      for (int i = 0; i < BN * (BK / 8) / NT; ++i) {
        const int j = tid + i * NT, r = j / (BK / 8), c = j % (BK / 8);
        const int row = n0 + r;
        load8<VEC>(dB + r * LDA + c * 8,
                   b + static_cast<long long>(row) * ldb, k0 + c * 8, K,
                   row < N, b);
      }
    } else {
      // B rows are contraction steps: B[k][n] at k * ldb + n
#pragma unroll
      for (int i = 0; i < BK * (BN / 8) / NT; ++i) {
        const int j = tid + i * NT, r = j / (BN / 8), c = j % (BN / 8);
        const int row = k0 + r;
        load8<VEC>(dB + r * LDKN + c * 8,
                   b + static_cast<long long>(row) * ldb, n0 + c * 8, N,
                   row < K, b);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) {
      load(s, s);
      if constexpr (A_I8)
        put_a8(fetch16_i8(a8, s * BK + a8_col, K, m0 + a8_row < M), s);
    }
    cp_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_wait<STAGES - 2>();   // stage kt has landed
    __syncthreads();         // and every warp is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    uint4 raw;
    if constexpr (A_I8) {
      if (nk < n_k) raw = fetch16_i8(a8, nk * BK + a8_col, K, m0 + a8_row < M);
    }
    if (nk < n_k) load(nk, nk % STAGES);
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
    if constexpr (A_I8) {
      // stage nk's buffer held stage kt - 1, which every warp finished
      // before this step's __syncthreads
      if (nk < n_k) put_a8(raw, nk % STAGES);
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

// y[m0 + i][n0 + j] = acc (rounded to OutT once) for rows < M and columns
// < N; y row-major with row stride ldy.
template <class OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4][4],
                                           OutT* y, long long ldy, int M,
                                           int N, int m0, int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  // column pairs are one aligned store when every row starts aligned
  const bool pairs = ldy % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(y) % (2 * sizeof(OutT)) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 64 + mt * 16 + gq + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * tq;
        OutT* p = y + static_cast<long long>(row) * ldy + col;
        const float x0 = acc[mt][nt][2 * h], x1 = acc[mt][nt][2 * h + 1];
        if (pairs && col + 1 < N) {
          store2(p, x0, x1);
        } else {
          if (col < N) store1(p, x0);
          if (col + 1 < N) store1(p + 1, x1);
        }
      }
    }
}

// y += recv over rows < M, columns < N of a tile (both row-major, row
// strides ldy and ldr; N % 8 == 0), each sum rounded to bf16 once: the
// reference's ring add `dst = dst + recv` (gemm_reduce_scatter.py
// `_add_body` :97-100).  y holds the block's own rounded partial
// (store_tile), so the partial leaves the registers before the caller
// waits for recv: an add from registers spilled.
__device__ __forceinline__ void fold_add(bf16* y, long long ldy,
                                         const bf16* recv, long long ldr,
                                         int M, int N, int n0) {
  for (int v = threadIdx.x; v < M * (BN / 8); v += NT) {
    const int row = v / (BN / 8), col = n0 + (v % (BN / 8)) * 8;
    if (col >= N) continue;
    uint4* dst = reinterpret_cast<uint4*>(y + row * ldy + col);
    const uint4 raw_y = __ldcg(dst);
    const uint4 raw_r = __ldcg(reinterpret_cast<const uint4*>(
        recv + row * ldr + col));
    const bf16* x = reinterpret_cast<const bf16*>(&raw_y);
    const bf16* r = reinterpret_cast<const bf16*>(&raw_r);
    unsigned w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = pack_bf16(__bfloat162float(x[2 * e]) +
                           __bfloat162float(r[2 * e]),
                       __bfloat162float(x[2 * e + 1]) +
                           __bfloat162float(r[2 * e + 1]));
    *dst = make_uint4(w[0], w[1], w[2], w[3]);
  }
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

}  // namespace tdt_bf16
