// sp_combine: the inter-rank combine of sequence-parallel decode for
// Hopper (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/flash_decode.py
// `_sp_combine_kernel` (:851, launched from `sp_combine_shard` at :885).
// Same contract, for every rank r of a world of W: rank r's decode
// partials out [BH][D] f32 and lse [BH] f32 in (BH = batch x query heads,
// each rank's partial over its own span of the KV cache); rank r's merged
// final [BH][D] f32 out, the log-sum-exp merge of all W partials:
//   m = max_s lse_s,  w_s = exp(lse_s - m),
//   final = (sum_s out_s * w_s) / (sum_s w_s).
// A rank whose span holds nothing of a row sends out 0 and lse NEG_INF
// (-1e30, finite) and drops out (w = 0); a row dead on every rank gives
// m = NEG_INF, w = 1 on every rank, and final 0 (never NaN), as the
// reference's rule does.
//
// What the TPU kernel does, and what this one keeps of it: an entry
// barrier_all, so no rank writes into a peer still outside; the merge in
// rank order 0..W-1, so every rank's final is bit for bit the same.  The
// TPU kernel's fcollect (every rank's plane into every peer, every rank
// merging every row) moves the planes W^2 times; this kernel is an owner
// merge instead, the schedule of a reduce-scatter followed by an
// all-gather, which moves each byte the function needs about once:
//
// 1. entry barrier (the gather slots are reused from call to call);
// 2. scatter to owners: the rows are cut into chunks of chunk_rows, and
//    rank o owns chunks [o cpo, (o + 1) cpo) (cpo = ceil(n_chunk / W);
//    when BH < W the last owners' bands are empty).  Each rank pushes its
//    rows of every chunk into slot `me` of the chunk's owner's gather
//    buffer and sets the flag (me, chunk) there to the call's epoch.  The
//    packing happens in the push: out and lse are read where they lie (a
//    rank reads only its own per-call partials, which are not symmetric
//    memory), and a plane row is [D + 4] f32: out's D floats, then lse
//    and three zero pad floats, a whole number of 16-byte vectors;
// 3. owner merge: a merge item is merge_rows rows of one owned chunk (V
//    float4s of a row a thread), so the merge spreads over many blocks
//    whatever the flag granularity.  It waits on its chunk's W flags,
//    merges in rank order with the arithmetic above, and
// 4. writes its rows into every rank's final buffer; the owner counts the
//    chunk's merge items (`count` below) and the last one raises the
//    chunk's final flag on every rank;
// 5. closing wait: each rank's first block waits on the final flags of
//    every chunk before the launch ends.  On one card the end of the
//    launch already orders this; across cards it is what makes a rank's
//    final complete when its kernel ends.
// The flag counts are fixed by the shapes: an owner waits on W flags per
// owned chunk, every rank on n_chunk final flags, and nobody waits for a
// chunk nobody sends (`combine_schedule` in kernels/flash_decode.py makes
// the plan and the tests hold these counts).
//
// What bounds it on an H100: bytes.  The function needs every rank's
// partial read once and every rank's final written once: at the SP-4
// decode of 8 sequences of Llama-3-8B (BH 8 x 32, D 128) ~1 MB, ~0.3 us
// at 3.35 TB/s, so the launch, the barrier and the two flag waits set the
// time; at the engine's 512-token chunk (BH 512 x 32) ~67 MB, ~0.02 ms.
// This kernel moves that plus one extra copy of the inputs (the owners'
// gather slots written and read once): ~135 MB at the chunk shape.  On
// one card (the virtual world) the peers' buffers are slices of one
// allocation and the pushes are device-memory copies, not NVLink.
//
// One cooperative launch per call with a 2-D grid (blockIdx.y = rank),
// every block resident (a spin-wait is safe only then), as many blocks a
// rank as the occupancy calculator allows and the items need.  A block
// takes its scatter items, then its merge items, then (the first block of
// a rank) the closing wait: merges wait only on scatters, which never
// wait, and the closing wait only on merges.  Each thread moves V 16-byte
// vectors at once (loads in flight before the stores).  A block publishes
// each phase once: all its scatter items, one system-scope fence, then
// their flags; all its merge items, one fence, then their counts.  A
// fence waits for the block's writes to drain, which under this kernel's
// write traffic takes longer than a merge item's own work: with a fence
// and a release per flag, as the verbs' signal() does, one per merge
// item, they set the kernel's time (PERF.md).  The epoch is a host
// counter, so a launch cannot be captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr int V = 4;    // 16-byte vectors a thread moves at once
constexpr int PAD = 4;  // floats after out's D in a plane row: lse, 0, 0, 0

struct Params {
  Peers<const float> out;  // rank r's partial out [BH][D]
  Peers<const float> lse;  // rank r's partial lse [BH]
  Peers<float> gath;       // owner r's gather [W src][cpo chunk_rows][D + PAD]
  Peers<float> fin;        // rank r's merged final [BH][D]
  Peers<unsigned> flags;   // rank r's [W src][n_chunk] scatter, [n_chunk] final
  Peers<unsigned> count;   // owner r's [n_chunk] merge-item counters
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  int world, bh, d, chunk_rows, n_chunk, cpo, merge_rows;
  int per_chunk, merge_items;  // merge items a chunk, and an owner
  unsigned epoch;
};

// Publication at system scope with one fence for many flags: after a
// __syncthreads, thread 0's fence.acq_rel.sys followed by relaxed stores
// (or atomics) of flags is a release of the whole block's writes (the
// barrier orders them before the fence); a relaxed atomic followed by the
// fence is an acquire.  The verbs' signal() pairs a fence.sc.sys with a
// release store for each flag: two system-scope fences a flag.
__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;\n" ::: "memory");
}

__device__ __forceinline__ void st_relaxed_sys(unsigned* flag, unsigned v) {
  asm volatile("st.relaxed.sys.global.u32 [%0], %1;\n"
               :: "l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned add_relaxed_sys(unsigned* cnt) {
  unsigned old;
  asm volatile("atom.relaxed.sys.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(cnt) : "memory");
  return old;
}

__global__ void __launch_bounds__(NT) sp_combine_kernel(
    const __grid_constant__ Params p) {
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  const int dv = p.d / 4;     // float4s of out in a row
  const int pv = dv + 1;      // float4s of a plane row
  const long long plane_row = p.d + PAD;
  const long long band = static_cast<long long>(p.cpo) * p.chunk_rows;
  const int fin_flags = p.world * p.n_chunk;  // where the final flags start

  // scatter: my rows of every chunk into slot `me` of its owner, V
  // 16-byte loads in flight a thread
  for (int c = lb; c < p.n_chunk; c += nb) {
    const int o = c / p.cpo;
    const int r0 = c * p.chunk_rows;
    const int r1 = min(r0 + p.chunk_rows, p.bh);
    const float4* src =
        reinterpret_cast<const float4*>(p.out.p[me] + r0 * (long long)p.d);
    const float* lse = p.lse.p[me] + r0;
    float4* g = reinterpret_cast<float4*>(
        p.gath.p[o] + (me * band + r0 - o * band) * plane_row);
    const int n = (r1 - r0) * pv;
    for (int i0 = threadIdx.x; i0 < n; i0 += NT * V) {
      float4 v[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int i = min(i0 + u * NT, n - 1);
        const int row = i / pv, j = i - row * pv;
        v[u] = j < dv ? __ldg(src + row * dv + j)
                      : make_float4(__ldg(lse + row), 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < V; ++u)
        if (i0 + u * NT < n) g[i0 + u * NT] = v[u];
    }
  }
  // one fence for all of this block's pushes, then their flags
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_sys();
    for (int c = lb; c < p.n_chunk; c += nb)
      st_relaxed_sys(p.flags.p[c / p.cpo] + me * p.n_chunk + c, p.epoch);
  }

  // merge: items of merge_rows rows of my chunks (V float4s a thread),
  // each chunk once its W slots have landed, in rank order (the loop's
  // bounds come from the parameters: ptxas spilled them when they were
  // computed here)
  const float* gath = p.gath.p[me];
  for (int it = lb; it < p.merge_items; it += nb) {
    const int c = me * p.cpo + it / p.per_chunk;
    if (c >= p.n_chunk) break;  // past the last chunk: an empty band
    const int r0c = c * p.chunk_rows;
    const int rows_c = min(p.chunk_rows, p.bh - r0c);
    const int pieces = (rows_c + p.merge_rows - 1) / p.merge_rows;
    const int piece = it % p.per_chunk;
    if (piece >= pieces) continue;  // the short last chunk
    tdt_dist::wait(p.flags.p[me] + c, p.epoch, p.world, p.n_chunk);
    const int r0 = r0c + piece * p.merge_rows;
    const int r1 = min(r0 + p.merge_rows, r0c + rows_c);
    const int n = (r1 - r0) * dv;
    for (int i0 = threadIdx.x; i0 < n; i0 += NT * V) {
      long long lrow[V];  // rows within my band
      int j[V];
      float m[V], den[V];
      float4 acc[V];
#pragma unroll
      for (int u = 0; u < V; ++u) {
        const int i = min(i0 + u * NT, n - 1);
        lrow[u] = r0 + i / dv - me * band;
        j[u] = i % dv;
        m[u] = gath[lrow[u] * plane_row + p.d];
        den[u] = 0.f;
        acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int s = 1; s < p.world; ++s)
#pragma unroll
        for (int u = 0; u < V; ++u)
          m[u] = fmaxf(m[u], gath[(s * band + lrow[u]) * plane_row + p.d]);
      for (int s = 0; s < p.world; ++s) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float* slot = gath + (s * band + lrow[u]) * plane_row;
          const float w = expf(slot[p.d] - m[u]);
          const float4 x = reinterpret_cast<const float4*>(slot)[j[u]];
          den[u] += w;
          acc[u].x += x.x * w;
          acc[u].y += x.y * w;
          acc[u].z += x.z * w;
          acc[u].w += x.w * w;
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
        if (i0 + u * NT >= n) continue;
        // approximate division (2 ulp; den is in [1, W]): the IEEE one's
        // slow-path call would spill
        const float4 f = make_float4(
            __fdividef(acc[u].x, den[u]), __fdividef(acc[u].y, den[u]),
            __fdividef(acc[u].z, den[u]), __fdividef(acc[u].w, den[u]));
        const long long at = (lrow[u] + me * band) * p.d + 4 * j[u];
        for (int dst = 0; dst < p.world; ++dst)
          *reinterpret_cast<float4*>(p.fin.p[dst] + at) = f;
      }
    }
  }
  // one fence for all of this block's merged rows; then each item counts
  // at its chunk's counter, and the chunk's last raises its final flag
  // on every rank
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_sys();
    for (int it = lb; it < p.merge_items; it += nb) {
      const int c = me * p.cpo + it / p.per_chunk;
      if (c >= p.n_chunk) break;
      const int rows_c = min(p.chunk_rows, p.bh - c * p.chunk_rows);
      const int pieces = (rows_c + p.merge_rows - 1) / p.merge_rows;
      if (it % p.per_chunk >= pieces) continue;
      unsigned* cnt = p.count.p[me] + c;
      if (pieces == 1 ||
          add_relaxed_sys(cnt) == static_cast<unsigned>(pieces - 1)) {
        if (pieces > 1) *cnt = 0u;
        fence_acq_rel_sys();  // the other items' rows, acquired: released
        for (int dst = 0; dst < p.world; ++dst)
          st_relaxed_sys(p.flags.p[dst] + fin_flags + c, p.epoch);
      }
    }
  }

  // closing wait: every chunk's final has landed in my buffer
  if (lb == 0)
    for (int c = 0; c < p.n_chunk; c += NT)
      tdt_dist::wait(p.flags.p[me] + fin_flags + c, p.epoch,
                     min(NT, p.n_chunk - c));
}

}  // namespace

// One call for every rank of a world of `world` (2..8): each pointer table
// holds `world` device addresses (out [BH][D], lse [BH], gath [W][cpo
// chunk_rows][D + 4], fin [BH][D] f32; flags [(W + 1) n_chunk]; count
// [n_chunk], zero before the first call; bar [W]).  d % 4 == 0, every
// out, gath and fin address 16-byte aligned; a chunk is chunk_rows rows,
// n_chunk = ceil(bh / chunk_rows), cpo = ceil(n_chunk / world) chunks an
// owner, merge_rows rows a merge item.  epoch: this call's, from the
// workspace.
extern "C" int tdt_sp_combine(const long long* out, const long long* lse,
                              const long long* gath, const long long* fin,
                              const long long* flags, const long long* count,
                              const long long* bar, int world, int bh, int d,
                              int chunk_rows, int n_chunk, int cpo,
                              int merge_rows, unsigned epoch, void* stream) {
  if (world < 2 || world > MAX_RANKS || bh < 1 || d < 4 || d % 4 ||
      chunk_rows < 1 || n_chunk != (bh + chunk_rows - 1) / chunk_rows ||
      cpo != (n_chunk + world - 1) / world || merge_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = peers<const float>(out, world);
  p.lse = peers<const float>(lse, world);
  p.gath = peers<float>(gath, world);
  p.fin = peers<float>(fin, world);
  p.flags = peers<unsigned>(flags, world);
  p.count = peers<unsigned>(count, world);
  p.bar = peers<unsigned>(bar, world);
  p.world = world;
  p.bh = bh;
  p.d = d;
  p.chunk_rows = chunk_rows;
  p.n_chunk = n_chunk;
  p.cpo = cpo;
  p.merge_rows = merge_rows;
  p.per_chunk = (chunk_rows + merge_rows - 1) / merge_rows;
  p.merge_items = cpo * p.per_chunk;
  p.epoch = epoch;
  const int items = max(n_chunk, p.merge_items);
  static unsigned attr = 0;
  return tdt_dist::launch_coop(sp_combine_kernel, p, NT, 0, world, items,
                               attr, static_cast<cudaStream_t>(stream));
}
