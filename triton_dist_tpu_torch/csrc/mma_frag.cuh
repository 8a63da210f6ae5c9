// Register-tile building blocks of the decode kernel (decode.cu), the
// int8 flash forward's converters (flash_fwd.cu) and the bf16 / int8 GEMM
// tile loops (bf16_tile.cuh, i8_tile.cuh): cp.async copies into shared
// memory, ldmatrix fragment loads, the bf16 mma.sync.m16n8k16 product
// with f32 accumulation and the int8 m16n8k32 one with int32, and the
// exact int8 -> f32 / bf16 conversions.
//
// Fragment layout of m16n8k16 (lane = 4 * gq + tq): A rows gq and gq + 8,
// columns 2tq, 2tq + 1 (+ 8); B columns gq, rows 2tq, 2tq + 1 (+ 8); C rows
// gq and gq + 8, columns 2tq, 2tq + 1.  Two neighbouring 8-column C tiles
// of one product are therefore the A fragment of the next product over
// those 16 columns (pack_bf16 of c[0..1], c[2..3] of each).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt_frag {

using bf16 = __nv_bfloat16;

__device__ inline unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src == nullptr zero-fills (a zero-byte read of the
// valid address `any`).
__device__ inline void cp_async16(void* dst, const void* src,
                                  const void* any) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src ? src : any),
                  "r"(src ? 16 : 0) : "memory");
}

// 4-byte async copy (one f32 scale); src == nullptr zero-fills.
__device__ inline void cp_async4(void* dst, const void* src,
                                 const void* any) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src ? src : any),
                  "r"(src ? 4 : 0) : "memory");
}

__device__ inline void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ inline void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ inline void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] @ b[16 x 8], bf16 in, f32 accumulate.
__device__ inline void mma16816(float (&c)[4], const unsigned (&a)[4],
                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16 x 8] += a[16 x 32] @ b[32 x 8], int8 in, exact int32 accumulate.
// Fragments as m16n8k16 bf16 with each 32-bit register holding four
// int8 values instead of two bf16: a row-major int8 tile viewed as bf16
// (half the row stride, half the column) loads with load_a, and an
// int8 tile laid out [n][k] with load_b_nk.
__device__ inline void mma16832_s8(int (&c)[4], const unsigned (&a)[4],
                                   unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment (16 rows x 16 columns) of columns 16 ks .. 16 ks + 15 of
// a row tile held as C accumulators c[n-tile][4], rounded to bf16.
template <int N>
__device__ inline void acc_to_a(unsigned (&a)[4], const float (&c)[N][4],
                                int ks) {
  a[0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
  a[1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
  a[2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  a[3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

// The A fragment of rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a
// row-major bf16 tile in shared memory (row stride ld).
__device__ inline void load_a(unsigned (&a)[4], const bf16* tile, int ld,
                              int r0, int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column n-tiles (rows n0 .. n0 + 15 of the tile),
// depth k0 .. k0 + 15, for a product X @ T^T where T is a row-major tile
// [n][k] (the keys of Q K^T): b[0..1] serve n-tile n0, b[2..3] n0 + 8.
__device__ inline void load_b_nk(unsigned (&b)[4], const bf16* tile, int ld,
                                 int n0, int k0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column n-tiles (columns n0 .. n0 + 15), depth
// k0 .. k0 + 15, for a product X @ T where T is a row-major tile [k][n]
// (V of P V): b[0..1] serve n-tile n0, b[2..3] n0 + 8.
__device__ inline void load_b_kn(unsigned (&b)[4], const bf16* tile, int ld,
                                 int k0, int n0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                           n0 + (lane >> 4) * 8);
}

// Four int8 values (one 32-bit word, byte i = value i) -> f32, exact and
// without the quarter-rate I2F: byte i, biased by 128, is permuted into
// the low mantissa bits of 2^23, and one subtraction takes 2^23 + 128
// back out.
__device__ inline void i8x4_to_f32(unsigned w, float (&f)[4]) {
  const unsigned u = w ^ 0x80808080u;  // x + 128 in each byte
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.0f;
}

// Two f32 that bf16 holds exactly (|x| <= 127 integers, as i8x4_to_f32
// gives) -> bf16x2 by truncation: one byte permute.
__device__ inline unsigned pack_bf16_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tdt_frag
