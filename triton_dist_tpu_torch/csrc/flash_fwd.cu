// flash_fwd: causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/flash_attention.py
// `_flash_kernel` (launched from `_flash_pallas`).  Same contract:
// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] in bf16 (any b/h/s strides, unit
// d stride) -> out [B, Hq, Sq, D] bf16 plus lse [B, Hq, Sq] f32; global
// positions q_offset + i and kv_offset + j; causal, sliding window,
// soft-cap; rows with nothing visible give out 0 and lse NEG_INF.
//
// Segmented positions (the zigzag context-parallel shard: rows made of
// several position runs) ride per-block start vectors, as the TPU
// kernel's scalar-prefetch `qoffs` / `koffs` do: qoffs [B][Sq / SEG] and
// koffs [B][Sk / SEG] int32 (batch stride qoffs_sb / koffs_sb, 0 to share
// one vector) give the global position of row SEG j, and rows within a
// block of SEG are contiguous.  Each batch row has its own vectors, so the
// W ranks of one ring step fold into the batch and one launch serves
// them all.  A null vector is the contiguous closed form
// q_offset + i / kv_offset + j.  Every tile of the kernels (64 keys, 64 /
// G query positions) lies inside one block of SEG, so a tile's positions
// are its first position plus the row offset, and the key loop tests each
// tile for liveness (`_block_live`) where the contiguous mode takes one
// key range: over two runs the live tiles need not be contiguous.
//
// Design.  One block of 4 warps per (q-tile, kv-head, batch).  As on the
// TPU the q-tile folds all G = Hq / Hkv heads of the group into its rows
// (row r = g * BQ + i, 64 rows, so BQ = 64 / G query positions), so every
// K/V tile read from device memory serves the whole group.  The key loop
// visits only live tiles (`_block_live`: for contiguous keys the causal
// and window bounds give the tile range directly, segmented keys test
// each tile) and drops the per-element mask on tiles that are wholly
// visible (`_block_full`).  Ragged Sq / Sk edges are masked here, so any
// length works.
//
// What bounds it on an H100: causal prefill at the main path's shapes
// (Sq 512..1024, Hq 32, D 128) does 2 * 2 * Sq * Sk * D * Hq / 2 flops
// against (q + k + v + out) bytes, far above the card's 295 flop/byte
// balance, so the tensor cores bound it (989 TFLOP/s bf16 dense).  The
// design keeps everything a warp computes in registers, the
// FlashAttention-2 layout: each warp owns 16 query rows; their Q
// fragments, the 16 x 64 score tile S, the 16 x 128 accumulator O and the
// softmax statistics live in registers; S = Q K^T and O += P V are
// `mma.sync.m16n8k16` bf16 products (f32 accumulate) fed by `ldmatrix`;
// P goes from the S accumulators straight into the A fragments of the PV
// product (cast to bf16, as the TPU kernel casts P to V's dtype).  K/V
// tiles stream through a two-stage cp.async ring in shared memory.
// wgmma, TMA and warp specialisation are the next steps (PERF.md has the
// measured time beside the bound).
//
// int8 K/V (the I8 instantiation, the port of `_flash_kernel_i8`: chunked
// prefill against an int8 cache, forward only): the int8 K/V tiles and
// their per-position f32 scales [B, Hkv, Sk] stream through the two-stage
// cp.async ring (half the bytes), and each tile converts to bf16 in
// shared memory ahead of the same ldmatrix / mma.sync path (|q| <= 127 is
// exact in bf16).  K's scale applies per S column after Q K^T: a thread's
// C fragment holds columns 2 (lane % 4) + {0, 1} + 8 j, whose scales it
// reads from shared memory; V's scale folds into P before P is rounded to
// the bf16 A fragment of P V, where the TPU kernel rounds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

using namespace tdt_frag;

constexpr int D = 128;       // head dim
constexpr int BM = 64;       // q-tile rows (16 per warp)
constexpr int BN = 64;       // keys per tile
constexpr int NT = 128;      // 4 warps
constexpr int LD = D + 8;    // bf16 row stride in shared memory (272 B)
constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
constexpr int LD8 = D + 16;    // int8 staging row stride (bytes)
constexpr float NEG_INF = -1.0e30f;  // finite -inf proxy, as on the TPU
constexpr int SEG = 64;      // positions per entry of a start vector

struct FlashParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int8_t* k8;   // I8: int8 K/V and their f32 scales [B, Hkv, Sk]
  const int8_t* v8;
  const float* ksc;
  const float* vsc;
  bf16* out;
  float* lse;
  int Sq, Sk, Hq, Hkv, G, BQ;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long ks_sb, ks_sh, ks_ss;
  long long vs_sb, vs_sh, vs_ss;
  const int* qoffs;  // [B][Sq / SEG] block starts, or null (contiguous)
  const int* koffs;  // [B][Sk / SEG]
  long long qoffs_sb, koffs_sb;
  int q_offset, kv_offset, causal, window;
  float scale, soft_cap;
};

// Global position of local row i of batch row b (see the header).
__device__ inline int pos_of(const int* offs, long long sb, int base, int b,
                             int i) {
  return offs ? offs[b * sb + i / SEG] + i % SEG : base + i;
}

// bf16: Q and a two-stage K/V ring.  I8: Q, one bf16 K/V tile, and a
// two-stage ring of int8 K/V tiles with their scales.
constexpr size_t SMEM_BYTES = static_cast<size_t>(BM + 4 * BN) * LD * 2;
constexpr size_t SMEM_BYTES_I8 =
    static_cast<size_t>(BM + 2 * BN) * LD * 2 + 4 * BN * LD8 + 4 * BN * 4;

// SEGM: the segmented mode (a start vector on either side); without it
// the kernel is the contiguous closed form, its own instantiation, so the
// serving and training launches pay nothing for the segmented mode.
template <bool I8, bool SEGM>
__global__ void __launch_bounds__(NT, 2)
flash_fwd_kernel(const __grid_constant__ FlashParams p) {
  extern __shared__ __align__(128) char smem_raw[];
  constexpr int KV_STAGES = I8 ? 1 : 2;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* sK = sQ + BM * LD;                       // [KV_STAGES][BN][LD]
  bf16* sV = sK + KV_STAGES * BN * LD;           // [KV_STAGES][BN][LD]
  int8_t* sK8 = reinterpret_cast<int8_t*>(sV + KV_STAGES * BN * LD);
  int8_t* sV8 = sK8 + 2 * BN * LD8;              // I8: [2][BN][LD8] each
  float* sKs = reinterpret_cast<float*>(sV8 + 2 * BN * LD8);  // I8: [2][BN]
  float* sVs = sKs + 2 * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment row / column pair
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * p.BQ;
  const int n_rows = min(p.BQ, p.Sq - q0);
  const int q_first =
      SEGM ? pos_of(p.qoffs, p.qoffs_sb, p.q_offset, b, q0) : p.q_offset + q0;
  const int q_last = q_first + n_rows - 1;
  auto k_pos = [&](int key) {
    return SEGM ? pos_of(p.koffs, p.koffs_sb, p.kv_offset, b, key)
                : p.kv_offset + key;
  };

  // `_block_live` per key tile t: causal stops past the last row's
  // position, a window starts at the first row's earliest visible key.
  // Contiguous keys take the closed-form live range [t_begin, t_end),
  // every tile of which is live, and test no tile; segmented keys test
  // each tile.
  int t_begin = 0, t_end = (p.Sk + BN - 1) / BN;
  if (!SEGM || !p.koffs) {
    int hi = p.Sk;
    if (p.causal) hi = min(hi, q_last - p.kv_offset + 1);
    int lo = 0;
    if (p.window) lo = max(lo, q_first - p.window + 1 - p.kv_offset);
    t_begin = lo / BN;
    t_end = hi > t_begin * BN ? (hi + BN - 1) / BN : t_begin;
  }
  auto live = [&](int t) {
    const int kf = k_pos(t * BN), nk = min(BN, p.Sk - t * BN);
    return (!p.causal || kf <= q_last) &&
           (!p.window || kf + nk - 1 > q_first - p.window);
  };
  auto next_live = [&](int t) {
    if (SEGM && p.koffs)
      while (t < t_end && !live(t)) ++t;
    return t;
  };

  auto load_kv = [&](int t0, int buf) {
    if constexpr (I8) {
      int8_t* dk = sK8 + buf * BN * LD8;
      int8_t* dv = sV8 + buf * BN * LD8;
#pragma unroll
      for (int i = 0; i < BN * (D / 16) / NT; ++i) {
        const int j = tid + i * NT, r = j / (D / 16), c = j % (D / 16);
        const int key = t0 + r;
        const bool ok = key < p.Sk;
        cp_async16(dk + r * LD8 + c * 16,
                   ok ? p.k8 + b * p.k_sb + h * p.k_sh + key * p.k_ss + c * 16
                      : nullptr, p.k8);
        cp_async16(dv + r * LD8 + c * 16,
                   ok ? p.v8 + b * p.v_sb + h * p.v_sh + key * p.v_ss + c * 16
                      : nullptr, p.k8);
      }
      static_assert(NT == 2 * BN, "one scale per thread");
      const int r = tid % BN, key = t0 + r;
      const bool ok = key < p.Sk;
      if (tid < BN)
        cp_async4(sKs + buf * BN + r,
                  ok ? p.ksc + b * p.ks_sb + h * p.ks_sh + key * p.ks_ss
                     : nullptr, p.ksc);
      else
        cp_async4(sVs + buf * BN + r,
                  ok ? p.vsc + b * p.vs_sb + h * p.vs_sh + key * p.vs_ss
                     : nullptr, p.ksc);
      return;
    }
    bf16* dk = sK + buf * BN * LD;
    bf16* dv = sV + buf * BN * LD;
#pragma unroll
    for (int i = 0; i < BN * CHUNKS / NT; ++i) {
      const int j = tid + i * NT, r = j / CHUNKS, c = j % CHUNKS;
      const int key = t0 + r;
      const bool ok = key < p.Sk;
      cp_async16(dk + r * LD + c * 8,
                 ok ? p.k + b * p.k_sb + h * p.k_sh + key * p.k_ss + c * 8
                    : nullptr, p.k);
      cp_async16(dv + r * LD + c * 8,
                 ok ? p.v + b * p.v_sb + h * p.v_sh + key * p.v_ss + c * 8
                    : nullptr, p.k);
    }
  };

  // Each thread's two rows of the warp's 16: gq and gq + 8.
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};

  int t = next_live(t_begin);
  if (t < t_end) {
#pragma unroll
    for (int i = 0; i < BM * CHUNKS / NT; ++i) {
      const int j = tid + i * NT, r = j / CHUNKS, c = j % CHUNKS;
      const int qi = q0 + r % p.BQ;
      cp_async16(sQ + r * LD + c * 8,
                 qi < p.Sq ? p.q + b * p.q_sb + (h * p.G + r / p.BQ) * p.q_sh
                                 + qi * p.q_ss + c * 8
                           : nullptr, p.k);
    }
    load_kv(t * BN, 0);
    cp_commit();
  }

  unsigned qf[D / 16][4];  // the warp's Q fragments, one per k-step
  for (int it = 0; t < t_end; ++it) {
    const int t0 = t * BN, buf = it & 1;
    const int tn = next_live(t + 1);
    if (tn < t_end) {
      load_kv(tn * BN, buf ^ 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16);
    }
    const bf16* k_t = sK + (I8 ? 0 : buf) * BN * LD;
    const bf16* v_t = sV + (I8 ? 0 : buf) * BN * LD;
    const float* ks_t = sKs + buf * BN;
    const float* vs_t = sVs + buf * BN;
    if constexpr (I8) {
      // the staged int8 tiles -> the bf16 tiles the fragments read
#pragma unroll
      for (int i = 0; i < BN * (D / 16) / NT; ++i) {
        const int j = tid + i * NT, r = j / (D / 16), c = j % (D / 16);
        cvt_i8x16_bf16(sK + r * LD + c * 16, sK8 + buf * BN * LD8 + r * LD8
                                                 + c * 16);
        cvt_i8x16_bf16(sV + r * LD + c * 16, sV8 + buf * BN * LD8 + r * LD8
                                                 + c * 16);
      }
      __syncthreads();
    }

    // S[16 x 64] = Q K^T: 8 key n-tiles of 8, 8 k-steps of 16 over D.
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BN / 16; ++jp) {
        unsigned kb[4];
        load_b_nk(kb, k_t, LD, jp * 16, kk * 16);
        mma16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Online softmax on the two rows this thread holds (the TPU kernels'
    // m / l / alpha rule; masked logits NEG_INF, their p an explicit 0).
    const int k_first = k_pos(t0);
    const bool full =
        t0 + BN <= p.Sk && q0 + p.BQ <= p.Sq &&
        (!p.causal || q_first >= k_first + BN - 1) &&
        (!p.window || q_last - k_first < p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 ks2 = make_float2(1.f, 1.f);
      if constexpr (I8)
        ks2 = *reinterpret_cast<const float2*>(ks_t + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = I8 ? s[j][e] * ((e & 1 ? ks2.y : ks2.x) * p.scale)
                     : s[j][e] * p.scale;
        if (p.soft_cap > 0.f) x = p.soft_cap * tanhf(x / p.soft_cap);
        if (!full) {
          // `_visibility_mask`
          const int row = warp * 16 + gq + (e >> 1) * 8;
          const int i = q0 + row % p.BQ;
          const int key = t0 + j * 8 + 2 * tq + (e & 1);
          const int qpos = q_first + (i - q0), kpos = k_first + (key - t0);
          const bool vis = i < p.Sq && key < p.Sk &&
                           (!p.causal || qpos >= kpos) &&
                           (!p.window || qpos - kpos < p.window);
          if (!vis) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_r[r], quad_max(mx[r]));
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 vs2 = make_float2(1.f, 1.f);
      if constexpr (I8)
        vs2 = *reinterpret_cast<const float2*>(vs_t + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float pe = x > 0.5f * NEG_INF ? expf(x - m_r[e >> 1]) : 0.f;
        sum[e >> 1] += pe;
        // I8: V's scale folds into P before its bf16 rounding
        s[j][e] = I8 ? pe * (e & 1 ? vs2.y : vs2.x) : pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O[16 x 128] += P[16 x 64] V[64 x 128]: P's A fragments come from
    // the S accumulators (n-tiles 2ks, 2ks + 1 = keys 16ks .. 16ks + 15).
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      unsigned a[4];
      acc_to_a(a, s, ks);
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        unsigned vb[4];
        load_b_kn(vb, v_t, LD, ks * 16, jp * 16);
        mma16816(o[2 * jp], a, vb[0], vb[1]);
        mma16816(o[2 * jp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it refills
    t = tn;
  }

  // Epilogue: out = O / l in bf16, lse = m + log(l) (NEG_INF when empty).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const int row = warp * 16 + gq + r * 8;
    const int i = q0 + row % p.BQ;
    if (i >= p.Sq) continue;
    const long long o_row =
        (static_cast<long long>(b) * p.Hq + h * p.G + row / p.BQ) * p.Sq + i;
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    bf16* dst = p.out + o_row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (tq == 0) p.lse[o_row] = l > 0.f ? m_r[r] + logf(l) : NEG_INF;
  }
}

template <bool I8, bool SEGM>
int launch_mode(FlashParams& p, int B, void* stream) {
  constexpr size_t smem = I8 ? SMEM_BYTES_I8 : SMEM_BYTES;
  // once per device, process and instantiation (outside graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(attr_set & (1u << dev))) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<I8, SEGM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  const dim3 grid((p.Sq + p.BQ - 1) / p.BQ, p.Hkv, B);
  flash_fwd_kernel<I8, SEGM><<<grid, NT, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool I8>
int launch_flash(FlashParams& p, int B, void* stream) {
  return p.qoffs || p.koffs ? launch_mode<I8, true>(p, B, stream)
                            : launch_mode<I8, false>(p, B, stream);
}

void fill_params(FlashParams& p, const void* q, const void* k,
                 const void* v, void* out, void* lse, int Hq, int Hkv,
                 int Sq, int Sk, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh,
                 long long k_ss, long long v_sb, long long v_sh,
                 long long v_ss, const void* qoffs, long long qoffs_sb,
                 const void* koffs, long long koffs_sb, int q_offset,
                 int kv_offset, int causal, int window, float scale,
                 float soft_cap) {
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.k8 = static_cast<const int8_t*>(k);
  p.v8 = static_cast<const int8_t*>(v);
  p.ksc = p.vsc = nullptr;
  p.ks_sb = p.ks_sh = p.ks_ss = p.vs_sb = p.vs_sh = p.vs_ss = 0;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.BQ = BM / p.G;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.qoffs = static_cast<const int*>(qoffs);
  p.koffs = static_cast<const int*>(koffs);
  p.qoffs_sb = qoffs_sb;
  p.koffs_sb = koffs_sb;
  p.q_offset = q_offset;
  p.kv_offset = kv_offset;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.soft_cap = soft_cap;
}

}  // namespace

extern "C" int tdt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int Hq, int Hkv,
                             int Sq, int Sk, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, const void* qoffs,
                             long long qoffs_sb, const void* koffs,
                             long long koffs_sb, int q_offset, int kv_offset,
                             int causal, int window, float scale,
                             float soft_cap, void* stream) {
  FlashParams p;
  fill_params(p, q, k, v, out, lse, Hq, Hkv, Sq, Sk, q_sb, q_sh, q_ss, k_sb,
              k_sh, k_ss, v_sb, v_sh, v_ss, qoffs, qoffs_sb, koffs, koffs_sb,
              q_offset, kv_offset, causal, window, scale, soft_cap);
  return launch_flash<false>(p, B, stream);
}

// The int8 twin: k/v int8 (strides in bytes) with f32 scale planes
// k_scale / v_scale [B, Hkv, Sk] and their strides.  qoffs / koffs: the
// per-block start vectors (header), or null for q_offset / kv_offset.
extern "C" int tdt_flash_fwd_i8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, void* out, void* lse, int B, int Hq, int Hkv,
    int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long ks_sb, long long ks_sh,
    long long ks_ss, long long vs_sb, long long vs_sh, long long vs_ss,
    const void* qoffs, long long qoffs_sb, const void* koffs,
    long long koffs_sb, int q_offset, int kv_offset, int causal, int window,
    float scale, float soft_cap, void* stream) {
  FlashParams p;
  fill_params(p, q, k, v, out, lse, Hq, Hkv, Sq, Sk, q_sb, q_sh, q_ss, k_sb,
              k_sh, k_ss, v_sb, v_sh, v_ss, qoffs, qoffs_sb, koffs, koffs_sb,
              q_offset, kv_offset, causal, window, scale, soft_cap);
  p.ksc = static_cast<const float*>(k_scale);
  p.vsc = static_cast<const float*>(v_scale);
  p.ks_sb = ks_sb; p.ks_sh = ks_sh; p.ks_ss = ks_ss;
  p.vs_sb = vs_sb; p.vs_sh = vs_sh; p.vs_ss = vs_ss;
  return launch_flash<true>(p, B, stream);
}
