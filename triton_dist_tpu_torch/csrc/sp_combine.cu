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
// What the TPU kernel does, and what this one keeps of it:
// - an entry barrier_all, so no rank writes into a peer still outside;
// - an fcollect: each rank pushes its packed (out, lse) plane into slot r
//   of every peer's gather buffer, its own slot included;
// - every rank merges its W slots in rank order 0..W-1, so every rank's
//   final is bit for bit the same (the same operations on the same values
//   in the same order).
// The plane is [BH][D + 4] f32: out's D floats, then lse and three zero
// pad floats.  The TPU kernel broadcasts lse over 128 lanes (its register
// layout); here the pad keeps every row a whole number of 16-byte vectors,
// which is what the copy moves, and the packing happens in the push (out
// and lse are read where they lie; no packed input is materialised).
//
// The DMAs and semaphores become copies and flags: a rank's blocks copy
// chunks of ~64 KB of its plane (chunk_rows rows) into every peer's slot,
// then each chunk sets a flag per (source, chunk) on the receiving rank to
// the call's epoch.  A block merging chunk c waits on the W flags of chunk
// c alone, so merging overlaps the pushes of other chunks.  The number of
// flags a rank waits on (W x n_chunk) is fixed by the shapes, so no rank
// waits for a chunk nobody sends.  On one card (the virtual world) the
// peers' buffers are slices of one allocation and the pushes are
// device-memory copies, not NVLink.
//
// What bounds it on an H100: bytes.  The function needs every rank's
// partial read once and every rank's final written once: at the SP-4
// decode of 8 sequences of Llama-3-8B (BH 8 x 32, D 128) ~1 MB, ~0.3 us
// at 3.35 TB/s, so the launch and the barrier dominate; at the engine's
// 512-token chunk (BH 512 x 32) ~67 MB, ~0.02 ms.  This kernel moves more:
// W^2 plane pushes read and written, the merge's reads of W slots on
// every rank and the finals' writes (~7 MB at the decode, ~0.45 GB at the
// chunk), the traffic an exchange between cards needs, which on one card
// is device-memory copies.
//
// Design (right and simple first): one cooperative launch per call with a
// 2-D grid (blockIdx.y = rank), every block resident (a spin-wait is safe
// only then), the grid bounded by the occupancy calculator and the blocks
// looping over items: first every push item of the rank (peers first, its
// own slot last), then the merge of its chunks, so no block waits before
// its own pushes are done.  The epoch is a host counter, so a launch
// cannot be captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr int PAD = 4;  // floats after out's D in a plane row: lse, 0, 0, 0

struct Params {
  Peers<const float> out;  // rank r's partial out [BH][D]
  Peers<const float> lse;  // rank r's partial lse [BH]
  Peers<float> gath;       // rank r's gather [W src][BH][D + PAD]
  Peers<float> fin;        // rank r's merged final [BH][D]
  Peers<unsigned> flags;   // rank r's [W src][n_chunk] flags
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  int world, bh, d, chunk_rows, n_chunk;
  unsigned epoch;
};

__global__ void __launch_bounds__(NT) sp_combine_kernel(
    const __grid_constant__ Params p) {
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  const int dv = p.d / 4;     // float4s of out in a row
  const int pv = dv + 1;      // float4s of a plane row
  const long long plane_row = p.d + PAD;

  // push: my plane, chunk by chunk, into slot `me` of every rank
  const int n_push = p.world * p.n_chunk;
  for (int it = lb; it < n_push; it += nb) {
    const int dst = (me + 1 + it / p.n_chunk) % p.world;
    const int c = it % p.n_chunk;
    const int r0 = c * p.chunk_rows;
    const int r1 = min(r0 + p.chunk_rows, p.bh);
    const float4* src =
        reinterpret_cast<const float4*>(p.out.p[me] + r0 * (long long)p.d);
    const float* lse = p.lse.p[me] + r0;
    float4* g = reinterpret_cast<float4*>(
        p.gath.p[dst] + (static_cast<long long>(me) * p.bh + r0) * plane_row);
    const int n = (r1 - r0) * pv;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int row = i / pv, j = i - row * pv;
      g[i] = j < dv ? __ldg(src + row * dv + j)
                    : make_float4(__ldg(lse + row), 0.f, 0.f, 0.f);
    }
    tdt_dist::signal(p.flags.p[dst] + me * p.n_chunk + c, p.epoch);
  }

  // merge: each of my chunks once its W slots have landed, in rank order
  const float* gath = p.gath.p[me];
  float* fin = p.fin.p[me];
  for (int c = lb; c < p.n_chunk; c += nb) {
    tdt_dist::wait(p.flags.p[me] + c, p.epoch, p.world, p.n_chunk);
    const int r0 = c * p.chunk_rows;
    const int r1 = min(r0 + p.chunk_rows, p.bh);
    const int n = (r1 - r0) * dv;
    for (int i = threadIdx.x; i < n; i += NT) {
      const int row = r0 + i / dv, j = i % dv;
      float m = gath[row * plane_row + p.d];
      for (int s = 1; s < p.world; ++s)
        m = fmaxf(m, gath[(static_cast<long long>(s) * p.bh + row) *
                              plane_row + p.d]);
      float den = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < p.world; ++s) {
        const float* slot =
            gath + (static_cast<long long>(s) * p.bh + row) * plane_row;
        const float w = expf(slot[p.d] - m);
        const float4 v = reinterpret_cast<const float4*>(slot)[j];
        den += w;
        acc.x += v.x * w;
        acc.y += v.y * w;
        acc.z += v.z * w;
        acc.w += v.w * w;
      }
      // approximate division (2 ulp; den is in [1, W]): the IEEE one's
      // slow-path call would spill
      reinterpret_cast<float4*>(fin + row * (long long)p.d)[j] =
          make_float4(__fdividef(acc.x, den), __fdividef(acc.y, den),
                      __fdividef(acc.z, den), __fdividef(acc.w, den));
    }
  }
}

}  // namespace

// One call for every rank of a world of `world` (2..8): each pointer table
// holds `world` device addresses (out [BH][D], lse [BH], gath [W][BH][D+4],
// fin [BH][D] f32; flags [W][n_chunk]; bar [W]).  d % 4 == 0, every out,
// gath and fin address 16-byte aligned; a chunk is chunk_rows rows and
// n_chunk = ceil(bh / chunk_rows).  epoch: this call's, from the workspace.
extern "C" int tdt_sp_combine(const long long* out, const long long* lse,
                              const long long* gath, const long long* fin,
                              const long long* flags, const long long* bar,
                              int world, int bh, int d, int chunk_rows,
                              int n_chunk, unsigned epoch, void* stream) {
  if (world < 2 || world > MAX_RANKS || bh < 1 || d < 4 || d % 4 ||
      chunk_rows < 1 || n_chunk != (bh + chunk_rows - 1) / chunk_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = peers<const float>(out, world);
  p.lse = peers<const float>(lse, world);
  p.gath = peers<float>(gath, world);
  p.fin = peers<float>(fin, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.world = world;
  p.bh = bh;
  p.d = d;
  p.chunk_rows = chunk_rows;
  p.n_chunk = n_chunk;
  p.epoch = epoch;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(sp_combine_kernel, p, NT, 0, world,
                               world * n_chunk, attr,
                               static_cast<cudaStream_t>(stream));
}
