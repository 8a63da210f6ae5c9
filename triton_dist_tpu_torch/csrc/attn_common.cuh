// Body of the decode kernels (decode.cu): contiguous and paged caches.
//
// One thread block of NT threads owns R query rows (R a power of two,
// 16..128) of one (batch, kv-head) pair and walks a range of key
// positions in tiles of BN:
//
//   S = Q K^T     tensor cores (WMMA bf16 16x16x16, f32 accumulate)
//   online softmax on S in f32 (scale, soft-cap, mask; running m and l)
//   O = O * alpha + P V   tensor cores, P cast to bf16 first
//
// Q, the K/V tile, S, P and the f32 accumulator O all live in shared
// memory; the softmax statistics too; K/V tiles arrive by cp.async.
// Keeping O in shared memory (not in WMMA register fragments, whose row
// mapping is opaque) is what lets every thread rescale its rows by
// alpha.  It costs one extra pass over O per tile, which is the first
// thing a faster version (wgmma with the accumulator in registers, TMA
// loads) removes.
//
// A problem type supplies the global address of key / value row `pos`
// (nullptr = zero-fill), whether a tile needs the per-element mask, and
// the visibility rule mask(row, pos).  Masked logits become NEG_INF and
// their probability an explicit 0, exactly as the TPU kernels do.
//
// int8 K/V (the I8 instantiation; the port of the TPU `_decode_kernel_i8`
// recipe): each tile's int8 rows and their per-position f32 scales
// arrive by cp.async (half the bytes of bf16 rows) and convert to bf16 in
// shared memory (|q| <= 127 is exact in bf16), so the same tensor-core
// products run; K's scale multiplies the logit columns after Q K^T, V's
// scale folds into P before P is rounded to bf16 for P V, where the TPU
// kernel rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace tdt {

using bf16 = __nv_bfloat16;

constexpr int D = 128;          // head dim
constexpr int BN = 64;          // key positions per tile
constexpr int LDH = D + 8;      // bf16 row stride of the Q / K / V tiles
constexpr int LDS = BN + 4;     // f32 row stride of the score tile
constexpr int LDP = BN + 8;     // bf16 row stride of the probability tile
constexpr int LDO = D + 4;      // f32 row stride of the output accumulator
constexpr int LD8 = D + 16;     // byte row stride of the staged int8 tiles
constexpr float NEG_INF = -1.0e30f;  // finite -inf proxy, as on the TPU

struct Smem {
  bf16* q;
  bf16* k;
  bf16* v;
  float* s;
  bf16* p;
  float* o;
  float* m;
  float* l;
  int8_t* k8;  // int8 staging tiles and their scales (I8 only)
  int8_t* v8;
  float* ks;
  float* vs;
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~static_cast<size_t>(127);
}

__host__ __device__ inline size_t smem_bytes(int R, bool i8 = false) {
  return align128(static_cast<size_t>(R) * LDH * 2)      // q
         + 2 * align128(static_cast<size_t>(BN) * LDH * 2)  // k, v
         + align128(static_cast<size_t>(R) * LDS * 4)     // s
         + align128(static_cast<size_t>(R) * LDP * 2)     // p
         + align128(static_cast<size_t>(R) * LDO * 4)     // o
         + 2 * align128(static_cast<size_t>(R) * 4)       // m, l
         + (i8 ? 2 * align128(static_cast<size_t>(BN) * LD8)  // k8, v8
                     + 2 * align128(static_cast<size_t>(BN) * 4)  // ks, vs
               : 0);
}

__device__ inline Smem carve(char* base, int R, bool i8 = false) {
  Smem sm;
  size_t off = 0;
  sm.q = reinterpret_cast<bf16*>(base + off);
  off += align128(static_cast<size_t>(R) * LDH * 2);
  sm.k = reinterpret_cast<bf16*>(base + off);
  off += align128(static_cast<size_t>(BN) * LDH * 2);
  sm.v = reinterpret_cast<bf16*>(base + off);
  off += align128(static_cast<size_t>(BN) * LDH * 2);
  sm.s = reinterpret_cast<float*>(base + off);
  off += align128(static_cast<size_t>(R) * LDS * 4);
  sm.p = reinterpret_cast<bf16*>(base + off);
  off += align128(static_cast<size_t>(R) * LDP * 2);
  sm.o = reinterpret_cast<float*>(base + off);
  off += align128(static_cast<size_t>(R) * LDO * 4);
  sm.m = reinterpret_cast<float*>(base + off);
  off += align128(static_cast<size_t>(R) * 4);
  sm.l = reinterpret_cast<float*>(base + off);
  off += align128(static_cast<size_t>(R) * 4);
  sm.k8 = sm.v8 = nullptr;
  sm.ks = sm.vs = nullptr;
  if (i8) {
    sm.k8 = reinterpret_cast<int8_t*>(base + off);
    off += align128(static_cast<size_t>(BN) * LD8);
    sm.v8 = reinterpret_cast<int8_t*>(base + off);
    off += align128(static_cast<size_t>(BN) * LD8);
    sm.ks = reinterpret_cast<float*>(base + off);
    off += align128(static_cast<size_t>(BN) * 4);
    sm.vs = reinterpret_cast<float*>(base + off);
  }
  return sm;
}

// Copy `rows` rows of D bf16 values into a shared tile, 16 bytes per
// thread per step; row_ptr(i) == nullptr zero-fills row i.
template <int NT, class RowPtr>
__device__ inline void load_rows(bf16* tile, int rows, const RowPtr& row_ptr) {
  constexpr int VEC = D / 8;  // uint4 per row
  for (int j = threadIdx.x; j < rows * VEC; j += NT) {
    const int r = j / VEC;
    const int c = j % VEC;
    const bf16* src = row_ptr(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + c * 8);
    *reinterpret_cast<uint4*>(tile + r * LDH + c * 8) = val;
  }
}

// Start an asynchronous copy (cp.async, 16 bytes per thread per step) of
// BN rows of D bf16 values into a shared tile; row_ptr(i) == nullptr
// zero-fills row i (a zero-byte source read of the valid `any` address).
// Every source address is computed before the first copy is issued, so
// the copies — and any loads the addressing needs, like a block-table
// lookup — are all in flight together instead of one round trip each.
// Complete with wait_async() and a barrier.
template <int NT, class RowPtr>
__device__ inline void load_tile_async(bf16* tile, const bf16* any,
                                       const RowPtr& row_ptr) {
  constexpr int VEC = D / 8;  // 16-byte chunks per row
  constexpr int PER = BN * VEC / NT;
  static_assert(BN * VEC % NT == 0, "tile chunks must divide by threads");
  const bf16* src[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) src[i] = row_ptr((threadIdx.x + i * NT) / VEC);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * NT;
    const int r = j / VEC, c = j % VEC;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(tile + r * LDH + c * 8));
    const bf16* g = src[i] != nullptr ? src[i] + c * 8 : any;
    const int n = src[i] != nullptr ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(g), "r"(n) : "memory");
  }
}

// The int8 twin of load_tile_async: BN rows of D int8 values (D / 16
// chunks of 16 bytes each) into a staging tile of row stride LD8.
template <int NT, class RowPtr>
__device__ inline void load_tile_i8_async(int8_t* tile, const void* any,
                                          const RowPtr& row_ptr) {
  constexpr int VEC = D / 16;
  constexpr int PER = BN * VEC / NT;
  static_assert(BN * VEC % NT == 0, "tile chunks must divide by threads");
  const int8_t* src[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) src[i] = row_ptr((threadIdx.x + i * NT) / VEC);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = threadIdx.x + i * NT;
    const int r = j / VEC, c = j % VEC;
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(tile + r * LD8 + c * 16));
    const void* g = src[i] != nullptr ? src[i] + c * 16 : any;
    const int n = src[i] != nullptr ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(g), "r"(n) : "memory");
  }
}

// The tile's BN K and BN V scales, one 4-byte cp.async per thread
// (nullptr = 0).
template <int NT, class Prob>
__device__ inline void load_scales_async(const Smem& sm, const Prob& prob,
                                         int t0) {
  static_assert(NT == 2 * BN, "one scale per thread");
  const int r = threadIdx.x % BN;
  const bool is_v = threadIdx.x >= BN;
  const float* src = is_v ? prob.v_scale(t0 + r) : prob.k_scale(t0 + r);
  const unsigned dst = static_cast<unsigned>(
      __cvta_generic_to_shared((is_v ? sm.vs : sm.ks) + r));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src != nullptr ? src : prob.any_scale),
                  "r"(src != nullptr ? 4 : 0) : "memory");
}

// Staged int8 tile -> bf16 tile (exact), 16 values per thread per step.
template <int NT>
__device__ inline void int8_to_bf16_tile(bf16* tile, const int8_t* src) {
  constexpr int VEC = D / 16;
  for (int j = threadIdx.x; j < BN * VEC; j += NT) {
    const int r = j / VEC, c = j % VEC;
    tdt_frag::cvt_i8x16_bf16(tile + r * LDH + c * 16, src + r * LD8 + c * 16);
  }
}

__device__ inline void wait_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// S[R, BN] = Q[R, D] @ K[BN, D]^T
template <int NT>
__device__ inline void qk_tile(const Smem& sm, int R) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  constexpr int n_ct = BN / 16;
  const int n_tiles = (R / 16) * n_ct;
  for (int t = warp; t < n_tiles; t += NT / 32) {
    const int rt = t / n_ct;
    const int ct = t % n_ct;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, sm.q + rt * 16 * LDH + kk, LDH);
      wmma::load_matrix_sync(b, sm.k + ct * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sm.s + rt * 16 * LDS + ct * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// O[R, D] += P[R, BN] @ V[BN, D]   (O already rescaled by alpha)
template <int NT>
__device__ inline void pv_tile(const Smem& sm, int R) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  constexpr int n_ct = D / 16;
  const int n_tiles = (R / 16) * n_ct;
  for (int t = warp; t < n_tiles; t += NT / 32) {
    const int rt = t / n_ct;
    const int ct = t % n_ct;
    float* o = sm.o + rt * 16 * LDO + ct * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, sm.p + rt * 16 * LDP + kk, LDP);
      wmma::load_matrix_sync(b, sm.v + kk * LDH + ct * 16, LDH);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o, acc, LDO, wmma::mem_row_major);
  }
}

// Threads per row and the row / sub-lane of this thread.  R * tpr == NT
// for every power-of-two R in [NT / 32 * 4 ... NT], and a row's tpr
// lanes are neighbours in one warp, so shuffles reduce over them.  A
// row's columns are interleaved over its lanes (column c belongs to lane
// c % tpr), so neighbouring lanes touch neighbouring words.
template <int NT>
struct RowLane {
  int tpr, row, sub;
  __device__ inline explicit RowLane(int R) {
    tpr = NT / R;
    row = threadIdx.x / tpr;
    sub = threadIdx.x % tpr;
  }
};

__device__ inline float lane_max(float x, int tpr) {
  for (int off = tpr / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ inline float lane_sum(float x, int tpr) {
  for (int off = tpr / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Online-softmax update of one tile (the TPU kernels' m/l/alpha rule):
// scaled (and soft-capped) logits, mask, row max, p = exp(x - m_new) in
// f32 summed into l, P stored as bf16 for the PV product, O rescaled.
// I8: column c's logit is scaled by k_scale[c] * scale, and p by
// v_scale[c] before it is rounded (l sums the unscaled p).
template <int NT, bool I8, class Mask>
__device__ inline void softmax_tile(const Smem& sm, int R, int tile_start,
                                    float scale, float soft_cap,
                                    bool need_mask, const Mask& mask) {
  const RowLane<NT> rl(R);
  float* srow = sm.s + rl.row * LDS;
  bf16* prow = sm.p + rl.row * LDP;
  const float m_old = sm.m[rl.row];
  const float l_old = sm.l[rl.row];
  float mx = NEG_INF;
  for (int c = rl.sub; c < BN; c += rl.tpr) {
    float x = srow[c] * (I8 ? sm.ks[c] * scale : scale);
    if (soft_cap > 0.0f) x = soft_cap * tanhf(x / soft_cap);
    if (need_mask && !mask(rl.row, tile_start + c)) x = NEG_INF;
    srow[c] = x;
    mx = fmaxf(mx, x);
  }
  mx = lane_max(mx, rl.tpr);  // also orders every lane's m/l read first
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.0f;
  for (int c = rl.sub; c < BN; c += rl.tpr) {
    const float x = srow[c];
    const float p = (x > 0.5f * NEG_INF) ? expf(x - m_new) : 0.0f;
    sum += p;
    prow[c] = __float2bfloat16(I8 ? p * sm.vs[c] : p);
  }
  sum = lane_sum(sum, rl.tpr);
  const float alpha = expf(m_old - m_new);
  if (rl.sub == 0) {
    sm.m[rl.row] = m_new;
    sm.l[rl.row] = l_old * alpha + sum;
  }
  float* orow = sm.o + rl.row * LDO;
  for (int c = rl.sub; c < D; c += rl.tpr) orow[c] *= alpha;
}

// The key loop of one block over positions [pos_lo, pos_hi), tile-aligned
// from below.  Prob provides:
//   const bf16* k_row(int pos), const bf16* v_row(int pos)  (nullptr = 0)
//   const bf16* any   a valid global address (source of zero-fills)
//   bool full(int tile_start)   tile needs no per-element mask
//   bool operator()(int row, int pos)   visibility
// and for I8 instead of k_row / v_row / any:
//   const int8_t* k_row8(int pos), v_row8(int pos)
//   const float* k_scale(int pos), v_scale(int pos)
//   const void* any8, const float* any_scale
// Q must already sit in sm.q; on return sm.o / sm.m / sm.l hold the
// unnormalised output and the softmax statistics of every row.
template <int NT, bool I8, class Prob>
__device__ inline void attend(const Smem& sm, int R, const Prob& prob,
                              int pos_lo, int pos_hi, float scale,
                              float soft_cap) {
  for (int i = threadIdx.x; i < R * LDO; i += NT) sm.o[i] = 0.0f;
  for (int i = threadIdx.x; i < R; i += NT) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.0f;
  }
  const int first = (pos_lo / BN) * BN;
  for (int t0 = first; t0 < pos_hi; t0 += BN) {
    __syncthreads();  // previous tile's readers are done with k/v/s/p
    if constexpr (I8) {
      load_tile_i8_async<NT>(sm.k8, prob.any8,
                             [&](int r) { return prob.k_row8(t0 + r); });
      load_tile_i8_async<NT>(sm.v8, prob.any8,
                             [&](int r) { return prob.v_row8(t0 + r); });
      load_scales_async<NT>(sm, prob, t0);
      wait_async();
      __syncthreads();
      int8_to_bf16_tile<NT>(sm.k, sm.k8);
      int8_to_bf16_tile<NT>(sm.v, sm.v8);
    } else {
      load_tile_async<NT>(sm.k, prob.any,
                          [&](int r) { return prob.k_row(t0 + r); });
      load_tile_async<NT>(sm.v, prob.any,
                          [&](int r) { return prob.v_row(t0 + r); });
      wait_async();
    }
    __syncthreads();
    qk_tile<NT>(sm, R);
    __syncthreads();
    softmax_tile<NT, I8>(sm, R, t0, scale, soft_cap, !prob.full(t0), prob);
    __syncthreads();
    pv_tile<NT>(sm, R);
  }
  __syncthreads();
}

}  // namespace tdt
