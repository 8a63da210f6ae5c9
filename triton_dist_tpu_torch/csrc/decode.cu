// decode / decode_paged: GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernels triton_dist_tpu/kernels/flash_decode.py
// `_decode_kernel` (contiguous cache, launched from `gqa_decode_shard`),
// `_decode_kernel_paged` (block-table pools, launched from
// `gqa_decode_paged_shard`) and their int8-KV twin `_decode_kernel_i8`.
// One device function serves all; the C entries differ only in how the
// address of key position `pos` is found (contiguous caches
// [B, Hkv, S, D] are walked by stride, paged pools [N, Hkv, page, D] read
// the page id from block_table[b, pos / page]) and in the cache type:
// bf16, or int8 with f32 per-position scales [B, Hkv, S] (paged:
// [N, Hkv, page], indexed by the same page id as the data).  The int8
// pages have no Pallas kernel in the reference, which computes them as
// XLA math (`_paged_gather` + `_local_decode_xla`); the port gives them
// the same device body.
//
// Contract (the TPU kernels'): q rows are the T * G queries of one
// (batch, kv-head) pair, row r = t * G + g; lens arrive in the
// `_pack_lens_arg` layouts [B] / [2, B] / [3, B] (valid rows, window end,
// live query count) and the visibility rule is `_chunk_valid`: query t of
// request b sits at wlen - (qlen - 1 - t), dead rows (t >= qlen) see
// nothing and return out 0 and lse NEG_INF.  Out is f32 [B, T, Hq, D],
// lse f32 [B, T, Hq].
//
// What bounds it on an H100: decode is a stream of the K/V cache.  At the
// main path's engine shape (B 8, S ~2048, Hkv 8, D 128, bf16) it must read
// 2 * 8 * 8 * 2048 * 128 * 2 B = 67.1 MB, 20.0 us at 3.35 TB/s, and does
// only ~2 * T * G flops per byte read, so device memory bounds it.  An
// int8 cache moves (128 + 4) / 256 of those bytes; the int8 -> bf16
// conversion happens in shared memory (attn_common.cuh).
//
// Design.  B * Hkv pairs alone (64 at B 8) cannot keep 132 SMs streaming,
// so the sequence is split across blocks (split-KV, as the GPU reference
// does; the TPU kernel walks it sequentially instead): grid (split,
// kv-head, batch), each block walks its span in 64-position tiles (for
// paged pools a tile spans 64 / page pages, each row's page id looked up
// in the table) and writes a normalised partial (o, lse); a second pass
// merges the splits by log-sum-exp (the reference's `combine_partials`
// rule; empty splits carry lse NEG_INF and drop out).  With one split the
// first pass writes the result directly.  The T * G rows, padded to a
// power of two >= 16, go through the tensor cores (WMMA), so a 32-token
// verify chunk costs little more than one token.  Tile loads use
// cp.async with all of a tile's addresses (and table lookups) resolved
// first; double-buffering them against the compute, or TMA, is later
// work.
#include "attn_common.cuh"

namespace tdt {

constexpr int DEC_NT = 128;

struct DecodeParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const int8_t* k8;   // int8 caches (I8) and their scales
  const int8_t* v8;
  const float* ksc;
  const float* vsc;
  const int* table;
  const int* lens;
  float* out;
  float* lse;
  float* o_part;    // [B, Hkv, n_split, R, D] when n_split > 1
  float* lse_part;  // [B, Hkv, n_split, R]
  int B, T, Hq, Hkv, G, R;
  int S_total;  // cache positions addressable: S, or n_pages * page
  int page, n_pages, paged;
  int n_split, split_len;
  long long k_s0, k_s1, k_s2;  // (b, h, s) or (page, h, row)
  long long v_s0, v_s1, v_s2;
  long long ks_s0, ks_s1, ks_s2;  // scales: (b, h, s) or (page, h, row)
  long long vs_s0, vs_s1, vs_s2;
  int lens_rows, use_qlens, window;
  float scale, soft_cap;
};

struct DecodeProb {
  const DecodeParams* p;
  const bf16* any;
  const void* any8;
  const float* any_scale;
  int b, h, llen, wlen, qlen;

  template <class T>
  __device__ const T* row_ptr(const T* base, long long s0, long long s1,
                              long long s2, int pos) const {
    if (pos >= llen || pos >= p->S_total) return nullptr;
    if (p->paged) {
      const int pg = p->table[b * p->n_pages + pos / p->page];
      return base + pg * s0 + h * s1 + (pos % p->page) * s2;
    }
    return base + b * s0 + h * s1 + pos * s2;
  }
  __device__ const bf16* k_row(int pos) const {
    return row_ptr(p->k, p->k_s0, p->k_s1, p->k_s2, pos);
  }
  __device__ const bf16* v_row(int pos) const {
    return row_ptr(p->v, p->v_s0, p->v_s1, p->v_s2, pos);
  }
  __device__ const int8_t* k_row8(int pos) const {
    return row_ptr(p->k8, p->k_s0, p->k_s1, p->k_s2, pos);
  }
  __device__ const int8_t* v_row8(int pos) const {
    return row_ptr(p->v8, p->v_s0, p->v_s1, p->v_s2, pos);
  }
  __device__ const float* k_scale(int pos) const {
    return row_ptr(p->ksc, p->ks_s0, p->ks_s1, p->ks_s2, pos);
  }
  __device__ const float* v_scale(int pos) const {
    return row_ptr(p->vsc, p->vs_s0, p->vs_s1, p->vs_s2, pos);
  }
  __device__ bool full(int) const { return false; }
  // `_chunk_valid`
  __device__ bool operator()(int row, int pos) const {
    if (row >= p->R || pos >= llen || pos >= p->S_total) return false;
    if (p->use_qlens) {
      const int d = qlen - 1 - row / p->G;
      if (d < 0 || pos >= wlen - d) return false;
      if (p->window && pos < wlen - d - p->window) return false;
    } else if (p->window && pos < wlen - p->window) {
      return false;
    }
    return true;
  }
};

// Index of query row r of (b, h) in the [B, T, Hq] output layout.
__device__ inline long long out_row(const DecodeParams& p, int b, int h,
                                    int r) {
  const int t = r / p.G, g = r % p.G;
  return (static_cast<long long>(b) * p.T + t) * p.Hq + h * p.G + g;
}

template <bool I8>
__global__ void __launch_bounds__(DEC_NT)
decode_kernel(const __grid_constant__ DecodeParams p, int R_pad) {
  extern __shared__ __align__(128) char smem_raw[];
  const Smem sm = carve(smem_raw, R_pad, I8);
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;

  // `_read_lens`
  DecodeProb prob{&p, p.k, p.k8, p.ksc, b, h, 0, 0, p.T};
  prob.llen = p.lens[b];
  prob.wlen = p.lens_rows >= 2 ? p.lens[p.B + b] : prob.llen;
  if (p.lens_rows == 3) prob.qlen = p.lens[2 * p.B + b];

  // Live positions: below llen and, with a window, not wholly before the
  // earliest query's window (the TPU kernel's skip rule) — cut to this
  // block's split.
  int hi = min(prob.llen, p.S_total);
  int lo = 0;
  if (p.window) lo = max(0, prob.wlen - (p.T - 1) - p.window);
  lo = max(lo, s * p.split_len);
  hi = min(hi, (s + 1) * p.split_len);

  if (lo < hi) {
    load_rows<DEC_NT>(sm.q, R_pad, [&](int r) -> const bf16* {
      return r < p.R ? p.q + out_row(p, b, h, r) * D : nullptr;
    });
    attend<DEC_NT, I8>(sm, R_pad, prob, lo, hi, p.scale, p.soft_cap);
  } else {
    for (int i = threadIdx.x; i < R_pad; i += DEC_NT) sm.l[i] = 0.0f;
    __syncthreads();
  }

  const RowLane<DEC_NT> rl(R_pad);
  if (rl.row >= p.R) return;
  const float l = sm.l[rl.row];
  const float lse = l > 0.0f ? sm.m[rl.row] + logf(l) : NEG_INF;
  const float* orow = sm.o + rl.row * LDO;
  float* dst;
  float* lse_dst;
  if (p.n_split == 1) {
    const long long o = out_row(p, b, h, rl.row);
    dst = p.out + o * D;
    lse_dst = p.lse + o;
  } else {
    const long long o =
        ((static_cast<long long>(b) * p.Hkv + h) * p.n_split + s) * p.R +
        rl.row;
    dst = p.o_part + o * D;
    lse_dst = p.lse_part + o;
  }
  for (int c = rl.sub; c < D; c += rl.tpr)
    dst[c] = l > 0.0f ? orow[c] / l : 0.0f;
  if (rl.sub == 0) *lse_dst = lse;
}

// Merge the splits' partials by log-sum-exp; rows no split saw keep the
// dead-row contract (out 0, lse NEG_INF).
__global__ void __launch_bounds__(DEC_NT)
decode_combine_kernel(const __grid_constant__ DecodeParams p) {
  const int h = blockIdx.x, b = blockIdx.y;
  const long long base =
      (static_cast<long long>(b) * p.Hkv + h) * p.n_split * p.R;
  for (int i = threadIdx.x; i < p.R * D; i += DEC_NT) {
    const int r = i / D, c = i % D;
    float m = NEG_INF;
    for (int s = 0; s < p.n_split; ++s)
      m = fmaxf(m, p.lse_part[base + s * p.R + r]);
    const long long o = out_row(p, b, h, r);
    if (m <= 0.5f * NEG_INF) {
      p.out[o * D + c] = 0.0f;
      if (c == 0) p.lse[o] = NEG_INF;
      continue;
    }
    float wsum = 0.0f, acc = 0.0f;
    for (int s = 0; s < p.n_split; ++s) {
      const long long j = base + s * p.R + r;
      const float w = expf(p.lse_part[j] - m);
      wsum += w;
      acc += w * p.o_part[j * D + c];
    }
    p.out[o * D + c] = acc / wsum;
    if (c == 0) p.lse[o] = m + logf(wsum);
  }
}

template <bool I8>
int launch_decode(DecodeParams& p, void* stream) {
  int R_pad = 16;
  while (R_pad < p.R) R_pad *= 2;
  if (R_pad > 128) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(R_pad, I8);
  // once per device, process and instantiation (outside any graph capture)
  static unsigned attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaError_t err;
  if (!(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(
        decode_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(128, I8)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_kernel<I8><<<dim3(p.n_split, p.Hkv, p.B), DEC_NT, smem, st>>>(
      p, R_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return static_cast<int>(err);
  decode_combine_kernel<<<dim3(p.Hkv, p.B), DEC_NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

void set_contiguous(DecodeParams& p, int S, long long k_sb, long long k_sh,
                    long long k_ss, long long v_sb, long long v_sh,
                    long long v_ss) {
  p.table = nullptr;
  p.S_total = S;
  p.page = 1;
  p.n_pages = 0;
  p.paged = 0;
  p.k_s0 = k_sb; p.k_s1 = k_sh; p.k_s2 = k_ss;
  p.v_s0 = v_sb; p.v_s1 = v_sh; p.v_s2 = v_ss;
}

void set_paged(DecodeParams& p, const void* table, int page, int n_pages,
               long long k_sn, long long k_sh, long long k_sp,
               long long v_sn, long long v_sh, long long v_sp) {
  p.table = static_cast<const int*>(table);
  p.S_total = page * n_pages;
  p.page = page;
  p.n_pages = n_pages;
  p.paged = 1;
  p.k_s0 = k_sn; p.k_s1 = k_sh; p.k_s2 = k_sp;
  p.v_s0 = v_sn; p.v_s1 = v_sh; p.v_s2 = v_sp;
}

void set_scales(DecodeParams& p, const void* ks, const void* vs,
                long long ks_0, long long ks_1, long long ks_2,
                long long vs_0, long long vs_1, long long vs_2) {
  p.ksc = static_cast<const float*>(ks);
  p.vsc = static_cast<const float*>(vs);
  p.ks_s0 = ks_0; p.ks_s1 = ks_1; p.ks_s2 = ks_2;
  p.vs_s0 = vs_0; p.vs_s1 = vs_1; p.vs_s2 = vs_2;
}

void fill_common(DecodeParams& p, const void* q, const void* k,
                 const void* v, const void* lens, void* out, void* lse,
                 void* o_part, void* lse_part, int B, int T, int Hq,
                 int Hkv, int n_split, int split_len, int lens_rows,
                 int use_qlens, int window, float scale, float soft_cap) {
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.k8 = static_cast<const int8_t*>(k);
  p.v8 = static_cast<const int8_t*>(v);
  p.ksc = p.vsc = nullptr;
  p.ks_s0 = p.ks_s1 = p.ks_s2 = p.vs_s0 = p.vs_s1 = p.vs_s2 = 0;
  p.lens = static_cast<const int*>(lens);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_part = static_cast<float*>(o_part);
  p.lse_part = static_cast<float*>(lse_part);
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.R = T * p.G;
  p.n_split = n_split;
  p.split_len = split_len;
  p.lens_rows = lens_rows;
  p.use_qlens = use_qlens;
  p.window = window;
  p.scale = scale;
  p.soft_cap = soft_cap;
}

}  // namespace tdt

extern "C" int tdt_decode(const void* q, const void* k, const void* v,
                          const void* lens, void* out, void* lse,
                          void* o_part, void* lse_part, int B, int T,
                          int Hq, int Hkv, int S, int n_split,
                          int split_len, long long k_sb, long long k_sh,
                          long long k_ss, long long v_sb, long long v_sh,
                          long long v_ss, int lens_rows, int use_qlens,
                          int window, float scale, float soft_cap,
                          void* stream) {
  using namespace tdt;
  DecodeParams p;
  fill_common(p, q, k, v, lens, out, lse, o_part, lse_part, B, T, Hq, Hkv,
              n_split, split_len, lens_rows, use_qlens, window, scale,
              soft_cap);
  set_contiguous(p, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  return launch_decode<false>(p, stream);
}

extern "C" int tdt_decode_paged(const void* q, const void* k_pool,
                                const void* v_pool, const void* table,
                                const void* lens, void* out, void* lse,
                                void* o_part, void* lse_part, int B, int T,
                                int Hq, int Hkv, int page, int n_pages,
                                int n_split, int split_len, long long k_sn,
                                long long k_sh, long long k_sp,
                                long long v_sn, long long v_sh,
                                long long v_sp, int lens_rows,
                                int use_qlens, int window, float scale,
                                float soft_cap, void* stream) {
  using namespace tdt;
  DecodeParams p;
  fill_common(p, q, k_pool, v_pool, lens, out, lse, o_part, lse_part, B, T,
              Hq, Hkv, n_split, split_len, lens_rows, use_qlens, window,
              scale, soft_cap);
  set_paged(p, table, page, n_pages, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp);
  return launch_decode<false>(p, stream);
}

// The int8 twins: int8 k/v (same layouts and strides, in bytes) plus the
// f32 scale planes k_scale / v_scale with their own strides.
extern "C" int tdt_decode_i8(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* lens, void* out, void* lse,
                             void* o_part, void* lse_part, int B, int T,
                             int Hq, int Hkv, int S, int n_split,
                             int split_len, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long ks_b, long long ks_h,
                             long long ks_s, long long vs_b, long long vs_h,
                             long long vs_s, int lens_rows, int use_qlens,
                             int window, float scale, float soft_cap,
                             void* stream) {
  using namespace tdt;
  DecodeParams p;
  fill_common(p, q, k, v, lens, out, lse, o_part, lse_part, B, T, Hq, Hkv,
              n_split, split_len, lens_rows, use_qlens, window, scale,
              soft_cap);
  set_contiguous(p, S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss);
  set_scales(p, k_scale, v_scale, ks_b, ks_h, ks_s, vs_b, vs_h, vs_s);
  return launch_decode<true>(p, stream);
}

extern "C" int tdt_decode_paged_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lens, void* out, void* lse, void* o_part, void* lse_part,
    int B, int T, int Hq, int Hkv, int page, int n_pages, int n_split,
    int split_len, long long k_sn, long long k_sh, long long k_sp,
    long long v_sn, long long v_sh, long long v_sp, long long ks_n,
    long long ks_h, long long ks_p, long long vs_n, long long vs_h,
    long long vs_p, int lens_rows, int use_qlens, int window, float scale,
    float soft_cap, void* stream) {
  using namespace tdt;
  DecodeParams p;
  fill_common(p, q, k_pool, v_pool, lens, out, lse, o_part, lse_part, B, T,
              Hq, Hkv, n_split, split_len, lens_rows, use_qlens, window,
              scale, soft_cap);
  set_paged(p, table, page, n_pages, k_sn, k_sh, k_sp, v_sn, v_sh, v_sp);
  set_scales(p, k_scale, v_scale, ks_n, ks_h, ks_p, vs_n, vs_h, vs_p);
  return launch_decode<true>(p, stream);
}
