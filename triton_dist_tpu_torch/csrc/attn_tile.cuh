// The consumer's tile body of flash_fwd.cu's kernel (bf16 and int8 K /
// V), on the pieces of sm90.cuh: one 64-row consumer warpgroup's step of
// the online softmax over one 128-key K / V tile in shared memory, and
// the store of its finished rows.  It is ring_attn.cu's consumer body,
// lifted out; the ring kernel keeps its own copy, because built on this
// header it ran 1-2% slower on an H100 in interleaved runs against its own
// copy (the same SASS instruction mix, another schedule at the 168
// registers ptxas gives a consumer; PERF.md has the numbers).
//
// A tile step (the reference's `_block_update`):
// - S[64 x 128] = Q K^T by wgmma.m64n128k16 (Q and K from shared memory,
//   K-major, as the producer's TMA wrote them: 128-byte swizzled halves
//   of 64 columns, `HALF` bytes apart);
// - the online softmax on the accumulator registers in f32 and base 2
//   (logits times log2(e), exp2): scale and cap every logit, then mask
//   the tiles that need it, each pass a loop of its own (interleaved per
//   element, the common path ran 4x slower);
// - P rounded to bf16 in registers (as the TPU kernels cast it to q's
//   dtype) is the register A operand of O += P V, V's tile the MN-major
//   B.
// The row state (O in the m64n128 accumulator layout, m in the base-2
// domain, l) stays in the caller's registers across tiles.
//
// int8 K / V (the I8 instantiation; the tiles arrive converted to bf16,
// exact): `scl` holds the tile's f32 K scales [BN] and then its V scales
// [BN].  K's scale multiplies each logit column after Q K^T (a thread's
// accumulator columns are fixed, so it reads their scales from shared
// memory); V's folds into P before P is rounded to the bf16 A operand,
// where the TPU kernel rounds (l sums the unscaled P).
//
// Positions.  Row r (0, 1) of this thread has local index row_i[r] (rows
// at or past n_q are padding and see nothing) and global position
// row_pos[r].  Key `key` of the tile (local index t0 .. t0 + 127) sits at
// key + (key < split ? run0 : run1): one run, or two runs that meet at
// `split` (zigzag's chunk seam, or a 64-row start-vector block), so the
// mask needs no load.  Keys at or past n_k are padding (TMA read zeros).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace tdt_attn {

using namespace tdt_sm90;
using bf16 = __nv_bfloat16;

constexpr int D = 128;                  // head dim
constexpr int BN = 128;                 // keys per tile
constexpr uint32_t HALF = 128 * 128;    // bytes of a 128-row tile's half
constexpr float NEG_INF = -1.0e30f;     // finite -inf proxy, as on the TPU
constexpr float LN2 = 0.6931471805599453f;

struct Mask {
  int causal, window;
  float scale, soft_cap;
};

// One tile step of the consumer warpgroup holding 64 rows at `sq` (a
// 64-row slice of a Q tile stored as two halves HALF bytes apart).
// `full`: `_block_full`, every (row, key) pair of the tile visible, so
// the mask pass is skipped.
template <bool I8 = false>
__device__ __forceinline__ void tile_step(
    float (&o)[64], float (&m_r)[2], float (&l_r)[2], const bf16* sq,
    const bf16* sk, const bf16* sv, bool full, const int (&row_i)[2],
    const int (&row_pos)[2], int n_q, int t0, int n_k, int split, int run0,
    int run1, const Mask& mk, const float* scl = nullptr) {
  const int tq = (threadIdx.x % 32) & 3;

  // S[64 x 128] = Q K^T.
  float sc[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n128<0>(sc, desc_k(sq, kk, HALF), desc_k(sk, kk, HALF), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);

  if constexpr (I8) {  // K's scale too, column 8 j + 2 tq + e % 2
    if (mk.soft_cap > 0.f) {
      const float in = mk.scale / mk.soft_cap, out = mk.soft_cap * LOG2E;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(scl + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] =
              out * tanh_fast(sc[4 * j + e] * ((e & 1) ? k2.y : k2.x) * in);
      }
    } else {
      const float sl = mk.scale * LOG2E;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(scl + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[4 * j + e] *= ((e & 1) ? k2.y : k2.x) * sl;
      }
    }
  } else if (mk.soft_cap > 0.f) {
    const float in = mk.scale / mk.soft_cap, out = mk.soft_cap * LOG2E;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = out * tanh_fast(sc[i] * in);
  } else {
    const float sl = mk.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] *= sl;
  }
  if (!full) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = t0 + 8 * j + 2 * tq + (e & 1);
        const int kpos = key + (key < split ? run0 : run1);
        const bool vis = row_i[r] < n_q && key < n_k &&
                         (!mk.causal || row_pos[r] >= kpos) &&
                         (!mk.window || row_pos[r] - kpos < mk.window);
        if (!vis) sc[4 * j + e] = NEG_INF;
      }
    }
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
    alpha[r] = exp2_approx(m_r[r] - m_new);
    m_r[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
  if constexpr (I8) {  // V's scale folds into P before its rounding
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 v2 =
          *reinterpret_cast<const float2*>(scl + BN + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float x = sc[4 * j + e];
        const float pe = x > 0.5f * NEG_INF ? exp2_approx(x - m_r[r]) : 0.f;
        sum[r] += pe;
        sc[4 * j + e] = pe * ((e & 1) ? v2.y : v2.x);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      const float x = sc[i];
      const float pe = x > 0.5f * NEG_INF ? exp2_approx(x - m_r[r]) : 0.f;
      sum[r] += pe;
      sc[i] = pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];

  // O[64 x 128] += P[64 x 128] V[128 x 128], P in registers.
  unsigned pa[BN / 16][4];
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) acc_to_a(pa[ks], sc, ks);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks)
    wgmma_rs_n128<1>(o, pa[ks], desc_mn(sv, ks, HALF), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int ks = 0; ks < BN / 16; ++ks) fence_regs(pa[ks]);
}

// Row r of O / l in bf16 at `dst` (the row's first element; l the quad's
// sum, so a row with nothing visible, l = 0, stays 0).
__device__ __forceinline__ void store_row(const float (&o)[64], int r,
                                          float l, bf16* dst) {
  const int tq = (threadIdx.x % 32) & 3;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  dst += 2 * tq;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
        __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                              o[4 * j + 2 * r + 1] * inv);
}

}  // namespace tdt_attn
