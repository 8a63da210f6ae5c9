// torus: the all-gather and reduce-scatter over a joint group of two or
// three mesh axes (the reference's tuple `axis`), for Hopper (sm_90a), over
// the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernels of triton_dist_tpu/kernels/torus.py:
// - `_torus_ag_kernel` (:104, launched from `_torus_ag` :193): tdt_torus_ag;
// - `_torus_rs_kernel` (:311, launched from `_torus_rs` :541): tdt_torus_rs.
// Same contract, for every rank r of a world of W and its joint group of G
// ranks (dist_verbs.cuh `Group`: the ranks that agree on the mesh's other
// axes, ordered flat axes-major over the tuple, its first axis slowest):
// - all-gather: rank r's x [rows][row] in; rank r's out [G][rows][row],
//   slot j the rows of the group's rank of joint index j, bit for bit;
// - reduce-scatter: rank r's full partial x [G][rows][row] in (slot j its
//   share of joint index j's band); rank r's band [rows][row] out, the
//   group's partials of r's slot summed in the reference's order and
//   rounding (below).
//
// The TPU kernels run 2n concurrent rings on the 2n link directions of an
// ICI torus (n axes), one per path flavor: the band is cut into 2n row
// parts, part q rings along its cyclic axis order in its direction.  One
// card, or an NVSwitch domain, has no torus: every rank reaches every
// other at one hop.  So the schedule is a pull from the peers' buffers
// over the joint group, not a ring, and keeps only what the result owes
// to the reference:
// - the all-gather's flat axes-major order (exact in any schedule);
// - the reduce-scatter's sums in the reference's order and rounding: row
//   part q of `_split_parts(rows, 2n)` takes path flavor q (`_paths_for`
//   :93), each phase ring-reduces along its axis with `acc = local + acc`
//   in the tensor's dtype at every hop (`_fold_tiles` :294), group c's sum
//   starting at the rank c + d.  dist_verbs.cuh `fold_plan` is that
//   order; each rank reads the G partials of its own band and folds them
//   by the plan, so an f32 or bf16 result is bit for bit the interpret-
//   mode Pallas kernel's (and the plain version's, which computes the same
//   order).  The reference's composition of per-axis ring RS kernels above
//   Mosaic's scoped-VMEM ceiling (:521-537) is a TPU compile limit: this
//   kernel takes every shape in the fused order.
//
// What bounds it on an H100: bytes.  Each function reads every input once
// and writes every output once: at Llama-3-8B TP-8 widths the all-gather
// of [256, 4096] bf16 over 8 ranks reads 16 MiB and writes 128 MiB (0.0451
// ms at 3.35 TB/s), the reduce-scatter of [2048, 4096] f32 partials reads
// 256 MiB and writes 32 MiB (0.0901 ms).  The pull reads each input byte
// exactly once in the reduce-scatter; the all-gather reads each input G
// times (the L2 holds them at these sizes).  No landing slots: nothing is
// pushed.
//
// Design (right and simple first): one cooperative launch per call with a
// 2-D grid (blockIdx.y = rank), every block of every rank resident; each
// block passes the group barrier on entry (so every peer has entered the
// kernel, and its input, written before its launch, is complete), then
// walks its rank's items in strides: 64 KB pieces of the gathered slots,
// or 16-byte vectors of the band (4 f32 or 8 bf16 elements of one row, G
// loads in flight per thread; a row whose length is no multiple of the
// vector takes one element at a time).  In the virtual world of one card
// the launch holds every rank, so no peer can change its input before the
// launch ends; a backend of one process per card needs the inputs in
// symmetric memory and a barrier on exit (ROADMAP Queue 1's tenth entry).
// The epoch is a host counter, so a launch cannot be captured in a CUDA
// graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::FoldPlan;
using tdt_dist::Group;
using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr long long PIECE = 1 << 16;  // bytes a block copies per item

struct AgParams {
  Peers<const unsigned char> x;  // rank r's x [seg bytes]
  Peers<unsigned char> out;      // rank r's out [G][seg]
  Peers<unsigned> bar;           // rank r's [W] barrier slots
  Group grp;
  long long seg;
  int n_piece;
  unsigned epoch;
};

__global__ void __launch_bounds__(NT) torus_ag_kernel(
    const __grid_constant__ AgParams p) {
  const int me = blockIdx.y;
  tdt_dist::barrier_group(p.bar, me, p.grp, p.epoch);
  const int n_items = p.grp.G * p.n_piece;
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int j = it / p.n_piece;
    const long long off = (it - j * p.n_piece) * PIECE;
    const long long n = off + PIECE < p.seg ? PIECE : p.seg - off;
    tdt_dist::copy_bytes(p.out.p[me] + j * p.seg + off,
                         p.x.p[tdt_dist::group_rank(p.grp, me, j)] + off,
                         n);
  }
}

struct RsParams {
  Peers<const void> x;   // rank r's partial [G][rows][row]
  Peers<void> out;       // rank r's band [rows][row]
  Peers<unsigned> bar;   // rank r's [W] barrier slots
  Group grp;
  int rows, row;         // the band's rows, the elements of one row
  int part_end[6];       // row part q ends at part_end[q] (2n parts)
  unsigned epoch;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* d) { *d = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* d) {
  *d = __float2bfloat16_rn(v);
}

// The add in the tensor's dtype: f32, or the f32 sum rounded to bf16.
template <class T>
struct AddIn {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return a + b;
  }
};
template <>
struct AddIn<__nv_bfloat16> {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return __bfloat162float(__float2bfloat16_rn(a + b));
  }
};

// V elements of one row per item (V * sizeof(T) = 16 bytes, or V = 1).
template <class T, int V>
__global__ void __launch_bounds__(NT) torus_rs_kernel(
    const __grid_constant__ RsParams p) {
  constexpr bool VEC = V * sizeof(T) == 16;
  __shared__ FoldPlan plans[6];
  __shared__ const T* src[MAX_RANKS];
  const int me = blockIdx.y;
  const Group& g = p.grp;
  const int t = tdt_dist::group_index(g, me);
  const long long band = static_cast<long long>(p.rows) * p.row;
  if (threadIdx.x < 2 * g.n)
    plans[threadIdx.x] = tdt_dist::fold_plan(g, t, threadIdx.x);
  if (threadIdx.x < g.G)
    src[threadIdx.x] =
        static_cast<const T*>(
            p.x.p[tdt_dist::group_rank(g, me, threadIdx.x)]) + t * band;
  tdt_dist::barrier_group(p.bar, me, g, p.epoch);

  T* out = static_cast<T*>(p.out.p[me]);
  const long long n_vec = band / V;
  const AddIn<T> add{};
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
       i < n_vec; i += static_cast<long long>(gridDim.x) * NT) {
    const int r = static_cast<int>(i * V / p.row);
    int q = 0;
    while (r >= p.part_end[q]) ++q;
    const FoldPlan f = plans[q];
    // the G sources' values in the plan's order
    uint4 raw[VEC ? MAX_RANKS : 1];
    T one[VEC ? 1 : MAX_RANKS];
#pragma unroll
    for (int k = 0; k < MAX_RANKS; ++k) {
      if (k < g.G) {
        const T* s = src[tdt_dist::plan_src(f, k)] + i * V;
        if constexpr (VEC)
          raw[k] = __ldcg(reinterpret_cast<const uint4*>(s));
        else
          one[k] = s[0];
      }
    }
    uint4 res;
    T* r_el = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float v[MAX_RANKS];
#pragma unroll
      for (int k = 0; k < MAX_RANKS; ++k) {
        if constexpr (VEC)
          v[k] = k < g.G ? to_f(reinterpret_cast<const T*>(&raw[k])[e])
                         : 0.f;
        else
          v[k] = k < g.G ? to_f(one[k]) : 0.f;
      }
      from_f(tdt_dist::fold(f, g.G, g.n, v, add), r_el + e);
    }
    if constexpr (VEC)
      *reinterpret_cast<uint4*>(out + i * V) = res;
    else
      out[i] = r_el[0];
  }
}

}  // namespace

// One call for every rank of a world of `world` (2..8) over the joint
// group `group` ([n, size0..2, stride0..2], 2 or 3 axes): x [W][seg
// bytes], out [W][G][seg], bar [W] (`world` addresses each).
extern "C" int tdt_torus_ag(const long long* x, const long long* out,
                            const long long* bar, const int* group,
                            long long seg, int world, unsigned epoch,
                            void* stream) {
  const Group g = tdt_dist::group_from(group);
  if (world < 2 || world > MAX_RANKS || tdt_dist::bad_group(g, world) ||
      g.n < 2 || seg < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  AgParams p;
  p.x = peers<const unsigned char>(x, world);
  p.out = peers<unsigned char>(out, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = g;
  p.seg = seg;
  p.n_piece = static_cast<int>((seg + PIECE - 1) / PIECE);
  p.epoch = epoch;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(torus_ag_kernel, p, NT, 0, world,
                               g.G * p.n_piece, attr,
                               static_cast<cudaStream_t>(stream));
}

// The reduce-scatter: x [W][G][rows][row], out [W][rows][row] of dtype 0
// (f32) or 1 (bf16); part_end: the 2n row parts' ends (the last = rows).
extern "C" int tdt_torus_rs(const long long* x, const long long* out,
                            const long long* bar, const int* group,
                            const int* part_end, int rows, int row,
                            int dtype, int world, unsigned epoch,
                            void* stream) {
  const Group g = tdt_dist::group_from(group);
  if (world < 2 || world > MAX_RANKS || tdt_dist::bad_group(g, world) ||
      g.n < 2 || rows < 1 || row < 1 || dtype < 0 || dtype > 1 ||
      part_end[2 * g.n - 1] != rows)
    return static_cast<int>(cudaErrorInvalidValue);
  RsParams p;
  p.x = peers<const void>(x, world);
  p.out = peers<void>(out, world);
  p.bar = peers<unsigned>(bar, world);
  p.grp = g;
  p.rows = rows;
  p.row = row;
  for (int q = 0; q < 6; ++q) p.part_end[q] = q < 2 * g.n ? part_end[q] : rows;
  p.epoch = epoch;
  const int vec = dtype == 0 ? 4 : 8;
  const long long band = static_cast<long long>(rows) * row;
  const bool vector = row % vec == 0;
  const long long items = (band / (vector ? vec : 1) + NT - 1) / NT;
  const int per_rank = items > (1 << 20) ? (1 << 20) : static_cast<int>(items);
  const auto s = static_cast<cudaStream_t>(stream);
  static unsigned attr[4] = {0, 0, 0, 0};
  if (dtype == 0)
    return vector ? tdt_dist::launch_coop(torus_rs_kernel<float, 4>, p, NT,
                                          0, world, per_rank, attr[0], s)
                  : tdt_dist::launch_coop(torus_rs_kernel<float, 1>, p, NT,
                                          0, world, per_rank, attr[1], s);
  return vector
             ? tdt_dist::launch_coop(torus_rs_kernel<__nv_bfloat16, 8>, p,
                                     NT, 0, world, per_rank, attr[2], s)
             : tdt_dist::launch_coop(torus_rs_kernel<__nv_bfloat16, 1>, p,
                                     NT, 0, world, per_rank, attr[3], s);
}
