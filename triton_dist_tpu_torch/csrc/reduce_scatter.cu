// reduce_scatter: the ring reduce-scatter over one mesh axis, for Hopper
// (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernels of triton_dist_tpu/kernels/reduce_scatter.py:
// - `_ring_rs_kernel` (:73, `pallas_call` at :264): mode RING;
// - `_bidir_ring_rs_kernel` (:134, `pallas_call` at :243): mode BIDIR,
//   the first ra = rows / 2 rows of every chunk reduced along the
//   rightward ring and the other rows along the leftward one, at once.
// Same contract, for every rank r of a world of W on an axis of T ranks
// `stride` apart (r at coordinate c): rank r's partial x [T][rows][row]
// in; rank r's out [rows][row], the sum over its group of every rank's
// chunk c, out.
//
// The summation order is the reference's, so an f32 result is bit-equal
// to the TPU kernel's and to the plain version (reference :101-131,
// :160-206): in direction d (+1 rightward, -1 leftward) chunk c starts at
// rank c + d with acc = x[c + d][c], and every later rank of the ring
// folds it in as acc = local + acc, c + 2d, ..., ending at rank c itself.
// bf16 adds round each sum to bf16 once (f32 add, then round to nearest
// even), as XLA and PyTorch do.  The host passes that order as a table
// (`order`: for each coordinate and direction the T coordinates in fold
// order, kernels/reduce_scatter.py `ring_fold_order`), so the CPU tests
// hold the very order the card folds in.
//
// What bounds it on an H100: bytes.  The function reads every rank's
// partial once and writes every rank's band once: at the hierarchical
// gradient all-reduce of Mistral-7B at dcn 2 x pp 2 x tp 2 (a plane of
// 2,049,056 x 128 f32 per rank, T 2) 8 x (1.05 + 0.52) GB, 3.758 ms at
// 3.35 TB/s.
//
// Design: a pull, as torus.cu's reduce-scatter.  A TPU chip reaches its
// two ring neighbours over ICI, so the reference passes running sums one
// hop a step; one card, or an NVSwitch domain, joins every rank to every
// other, so each rank at coordinate c reads its band of chunk c from the
// T partials of its axis group itself and folds them in the ring's order
// and rounding, and writes its band once.  Nothing is pushed: no landing
// slots, no flags, (T + 1) / T of the input moved where the push moved
// (3T - 1) / T.  One cooperative launch per call with a 2-D grid
// (blockIdx.y = rank), every block resident; each block passes the entry
// barrier over the axis (the reference's barrier semaphore), so every
// peer has entered the kernel and its input, written before its launch,
// is complete; then the rank's blocks walk its band in 16-byte vectors (4
// f32 or 8 bf16 of one row; a row of no multiple of the vector takes one
// element at a time), each thread issuing the loads of all T sources of
// U vectors before its adds (IN_FLIGHT: U T <= 8 loads in flight a
// thread).  Measured (PERF.md rows 12r / 12b, NVIDIA H100 80GB HBM3, 700
// W): the plane in 4.28 ms eager, 3.81 on the card (99% of the memory
// rate); 1-D bulk copies of 4 KB pieces of the T sources into a ring on
// mbarriers read the same within the spread of repeated runs (4.27
// against 4.28-4.31 ms), so the plain loads stayed; U = 8 / T against U =
// 1: T4 0.4641 against 0.4774 ms, the plane the same.  In the virtual
// world of one card the launch holds every rank, so no peer can change its
// input before the launch ends; a backend of one process per card needs
// the inputs in symmetric memory and a barrier on exit (ROADMAP Queue 1's
// tenth entry).  The epoch is a host counter, so a launch cannot be
// captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
// Trial constant (PERF.md rows 12r / 12b): the 16-byte loads a thread
// keeps in flight; a thread takes U = max(1, IN_FLIGHT / T) vectors of
// the band an iteration, and issues the loads of all T sources of all U
// before its adds.
constexpr int IN_FLIGHT = 8;

struct Params {
  Peers<const void> x;     // rank r's partial [T][chunk elements]
  Peers<void> out;         // rank r's band [chunk elements]
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  long long chunk;         // elements of one chunk (rows * row)
  long long split;         // elements folded rightward (ra * row; chunk in
                           // RING)
  int size, stride;
  // order[c][d][k]: the coordinate whose partial is the k-th folded into
  // chunk c in direction d (0 rightward, 1 leftward)
  signed char order[MAX_RANKS][2][MAX_RANKS];
  unsigned epoch;
};

// One element's add (T) and one 32-bit word's (1 f32 or 2 packed bf16),
// worked in registers: f32 adds round to nearest, bf16 sums are taken in
// f32 and rounded to bf16 once.
template <class T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ unsigned word(unsigned a, unsigned b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ unsigned lane16(unsigned a, unsigned b) {
    return __bfloat16_as_ushort(add(__ushort_as_bfloat16(a & 0xffffu),
                                    __ushort_as_bfloat16(b & 0xffffu)));
  }
  static __device__ __forceinline__ unsigned word(unsigned a, unsigned b) {
    return lane16(a, b) | (lane16(a >> 16, b >> 16) << 16);
  }
};

// V elements per vector: 16 bytes, or 1 (a row of no multiple of 16 B).
// A thread folds vectors i + u NT (u < U) of its block's U NT an
// iteration, from at most MS = MAX_RANKS / U sources (U MS registers of
// loads in flight, whatever T).
template <class T, int V, int U>
__global__ void __launch_bounds__(NT) reduce_scatter_kernel(
    const __grid_constant__ Params p) {
  constexpr bool VEC = V * sizeof(T) == 16;
  constexpr int MS = MAX_RANKS / U;
  using Vec = typename std::conditional<VEC, uint4, T>::type;
  __shared__ const T* src[2][MAX_RANKS];  // [d][k]: chunk c of each source
  const int me = blockIdx.y, S = p.size;
  const int c = tdt_dist::axis_coord(me, S, p.stride);
  if (threadIdx.x < 2 * S) {
    const int d = threadIdx.x / S, k = threadIdx.x - d * S;
    src[d][k] = static_cast<const T*>(p.x.p[tdt_dist::axis_peer(
                    me, c, p.order[c][d][k], p.stride)]) + c * p.chunk;
  }
  tdt_dist::barrier_axis(p.bar, me, S, p.stride, p.epoch);  // syncs too

  T* out = static_cast<T*>(p.out.p[me]);
  const long long n_vec = p.chunk / V;
  for (long long i0 = blockIdx.x * static_cast<long long>(U * NT) +
                      threadIdx.x;
       i0 < n_vec; i0 += static_cast<long long>(gridDim.x) * U * NT) {
    Vec v[U][MS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e0 = (i0 + u * NT) * V;
      const int d = e0 < p.split ? 0 : 1;
#pragma unroll
      for (int k = 0; k < MS; ++k)
        if (k < S && e0 < p.chunk) {
          if constexpr (VEC)
            v[u][k] = __ldcg(reinterpret_cast<const uint4*>(src[d][k] + e0));
          else
            v[u][k] = src[d][k][e0];
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e0 = (i0 + u * NT) * V;
      if (e0 >= p.chunk) break;
      Vec acc = v[u][0];
#pragma unroll
      for (int k = 1; k < MS; ++k) {
        if (k < S) {
          if constexpr (VEC) {
            acc.x = Num<T>::word(v[u][k].x, acc.x);
            acc.y = Num<T>::word(v[u][k].y, acc.y);
            acc.z = Num<T>::word(v[u][k].z, acc.z);
            acc.w = Num<T>::word(v[u][k].w, acc.w);
          } else {
            acc = Num<T>::add(v[u][k], acc);
          }
        }
      }
      *reinterpret_cast<Vec*>(out + e0) = acc;
    }
  }
}

// One launch of reduce_scatter_kernel<T, V, U>: U the largest of 4, 2, 1
// with U T <= IN_FLIGHT (1 past it).
template <class T, int V>
int launch(const Params& p, int world, long long n_vec, cudaStream_t s) {
  static unsigned attr[3] = {0, 0, 0};
  const int u = IN_FLIGHT / p.size >= 4 ? 4
                                        : (IN_FLIGHT / p.size >= 2 ? 2 : 1);
  const long long items = (n_vec + u * NT - 1) / (u * NT);
  const int per_rank = items > (1 << 20) ? (1 << 20) : static_cast<int>(items);
  Params q = p;
  if (u == 4)
    return tdt_dist::launch_coop(reduce_scatter_kernel<T, V, 4>, q, NT, 0,
                                 world, per_rank, attr[2], s);
  if (u == 2)
    return tdt_dist::launch_coop(reduce_scatter_kernel<T, V, 2>, q, NT, 0,
                                 world, per_rank, attr[1], s);
  return tdt_dist::launch_coop(reduce_scatter_kernel<T, V, 1>, q, NT, 0,
                               world, per_rank, attr[0], s);
}

}  // namespace

// One call for every rank of a world of `world` (2..8) over an axis of
// `size` >= 2 ranks `stride` apart: x [W][size][chunk], out [W][chunk]
// elements of `dtype` (0 f32, 1 bf16), bar [W] (`world` addresses each).
// split: elements folded rightward, chunk in RING and (rows / 2) * row <
// chunk in BIDIR.  row: the elements of one row (16-byte vectors when it
// is a multiple of them).  order: [MAX_RANKS][2][MAX_RANKS] coordinates,
// order[c][d][0 .. size) the fold order of chunk c in direction d.
extern "C" int tdt_reduce_scatter(const long long* x, const long long* out,
                                  const long long* bar, const int* order,
                                  long long chunk, long long split, int row,
                                  int dtype, int world, int size, int stride,
                                  unsigned epoch, void* stream) {
  if (world < 2 || world > MAX_RANKS || size < 2 || size > MAX_RANKS ||
      stride < 1 || world % (size * stride) != 0 || chunk < 1 ||
      split < 0 || split > chunk || row < 1 || chunk % row || split % row ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = peers<const void>(x, world);
  p.out = peers<void>(out, world);
  p.bar = peers<unsigned>(bar, world);
  p.chunk = chunk;
  p.split = split;
  p.size = size;
  p.stride = stride;
  for (int c = 0; c < MAX_RANKS; ++c)
    for (int d = 0; d < 2; ++d)
      for (int k = 0; k < MAX_RANKS; ++k) {
        const int o = order[(c * 2 + d) * MAX_RANKS + k];
        if (c < size && k < size && (o < 0 || o >= size))
          return static_cast<int>(cudaErrorInvalidValue);
        p.order[c][d][k] = static_cast<signed char>(o);
      }
  p.epoch = epoch;
  const int vec = dtype == 0 ? 4 : 8;
  const auto s = static_cast<cudaStream_t>(stream);
  if (row % vec)  // the scalar path
    return dtype == 0 ? launch<float, 1>(p, world, chunk, s)
                      : launch<__nv_bfloat16, 1>(p, world, chunk, s);
  return dtype == 0 ? launch<float, 4>(p, world, chunk / 4, s)
                    : launch<__nv_bfloat16, 8>(p, world, chunk / 8, s);
}
