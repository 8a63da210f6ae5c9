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
// :160-206): chunk c starts at rank c + d (d = +1 rightward, -1 leftward)
// with acc = x[c + d][c], and every later rank of the ring folds it in as
// acc = local + recv, c + 2d, ..., ending at rank c itself.  Step s of a
// rank sends chunk (c - d (1 + s)) mod T.  bf16 adds round each sum to
// bf16 once (f32 add, then round to nearest even), as XLA and PyTorch do.
//
// Backpressure: the TPU kernel keeps one landing buffer and a credit
// semaphore (:17-20).  This one holds T - 1 landing slots per rank
// instead (slot s receives step s, `land` [T - 1][rows][row], allocated by
// the wrapper per call) and drops the credit, as ring_attn does: no slot
// is ever written twice in a call, so no sender waits for a receiver.
// The slots are a per-call allocation, not the world's symmetric
// workspace: the peer table reaches them only because the virtual world's
// ranks are slices of one allocation (see the wrapper's docstring).
//
// Per piece of ~64 KB of a chunk's half: step s waits on the flag of
// landing slot s - 1 (s > 0), adds its local rows, writes the sum into the
// next rank's landing slot s and sets that rank's flag (slot, half, piece)
// to the call's epoch; the last item adds the local chunk c to slot T - 2
// into out.  An entry barrier over the axis (the reference's barrier
// semaphore) keeps every rank from writing into a peer that has not
// entered the kernel.  On one card (the virtual world) the peers' buffers
// are slices of one allocation and the pushes are device-memory writes.
//
// What bounds it on an H100: bytes.  The function reads every rank's
// partial once and writes every rank's band once: at the hierarchical
// gradient all-reduce of Mistral-7B at dcn 2 x pp 2 x tp 2 (a plane of
// 2,049,056 x 128 f32 per rank, T 2) 8 x (1.05 + 0.52) GB, 3.8 ms at
// 3.35 TB/s; the ring also writes and reads the T - 1 landing slots.
//
// Design (right and simple first): one cooperative launch per call with a
// 2-D grid (blockIdx.y = rank), every block resident; each rank's blocks
// walk its items step-major (each depends only on a lower-numbered item of
// another rank), 16-byte vectors where the ranges allow.  The epoch is a
// host counter, so a launch cannot be captured in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr long long PIECE_BYTES = 1 << 16;

struct Params {
  Peers<const void> x;     // rank r's partial [T][chunk elements]
  Peers<void> out;         // rank r's band [chunk elements]
  Peers<void> land;        // rank r's landing [T - 1][chunk elements]
  Peers<unsigned> flags;   // rank r's [T - 1][parts][n_piece] flags
  Peers<unsigned> bar;     // rank r's [W] barrier slots
  long long chunk;         // elements of one chunk (rows * row)
  long long split;         // elements of the rightward half (ra * row)
  long long piece;         // elements per piece
  int size, stride, parts, n_piece;   // parts: 1 in RING, 2 in BIDIR
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

// dst[i] = a[i] + b[i] (b null: dst = a) over n elements, by the block;
// 16-byte vectors when every pointer is 16-byte aligned.
template <class T>
__device__ __forceinline__ void block_add(T* dst, const T* a, const T* b,
                                          long long n) {
  constexpr int V = 16 / sizeof(T);
  long long done = 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  if ((bits & 15) == 0) {
    const long long nv = n / V;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nv; i += NT) {
      uint4 v = a4[i];
      if (b != nullptr) {
        const uint4 w = b4[i];
        v.x = Num<T>::word(v.x, w.x);
        v.y = Num<T>::word(v.y, w.y);
        v.z = Num<T>::word(v.z, w.z);
        v.w = Num<T>::word(v.w, w.w);
      }
      d4[i] = v;
    }
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += NT)
    dst[i] = b != nullptr ? Num<T>::add(a[i], b[i]) : a[i];
}

template <class T>
__global__ void __launch_bounds__(NT) reduce_scatter_kernel(
    const __grid_constant__ Params p) {
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  const int S = p.size;
  const int c = tdt_dist::axis_coord(me, S, p.stride);
  tdt_dist::barrier_axis(p.bar, me, S, p.stride, p.epoch);
  const T* x = static_cast<const T*>(p.x.p[me]);
  T* land = static_cast<T*>(p.land.p[me]);
  const int per_step = p.parts * p.n_piece;
  const int n_items = S * per_step;

  for (int it = lb; it < n_items; it += nb) {
    const int step = it / per_step;
    const int r = it - step * per_step;
    const int h = r >= p.n_piece ? 1 : 0;
    const int k = r - h * p.n_piece;
    // half h of the chunk: [lo, hi) elements (RING: h = 0, the whole)
    const long long lo = h == 0 ? 0 : p.split;
    const long long hi = h == 0 ? p.split : p.chunk;
    const long long b0 = lo + k * p.piece;
    const long long b1 = b0 + p.piece < hi ? b0 + p.piece : hi;
    const long long n = b1 > b0 ? b1 - b0 : 0;
    const int d = h == 0 ? 1 : -1;
    const T* recv = nullptr;
    if (step > 0) {
      tdt_dist::wait(p.flags.p[me] + (step - 1) * per_step + h * p.n_piece +
                         k, p.epoch);
      recv = land + (step - 1) * p.chunk + b0;
    }
    if (step == S - 1) {
      // the last arrival is my own chunk's: out = local + recv
      if (n > 0)
        block_add(static_cast<T*>(p.out.p[me]) + b0, x + c * p.chunk + b0,
                  recv, n);
      continue;
    }
    const int chunk = ((c - d * (1 + step)) % S + S) % S;
    const int to = ((c + d) % S + S) % S;
    const int dst = tdt_dist::axis_peer(me, c, to, p.stride);
    if (n > 0)
      block_add(static_cast<T*>(p.land.p[dst]) + step * p.chunk + b0,
                x + chunk * p.chunk + b0, recv, n);
    tdt_dist::signal(p.flags.p[dst] + step * per_step + h * p.n_piece + k,
                     p.epoch);
  }
}

}  // namespace

// One call for every rank of a world of `world` (1..8) over an axis of
// `size` >= 2 ranks `stride` apart: x [W][size][chunk], out [W][chunk],
// land [W][size - 1][chunk] elements of `dtype` (0 f32, 1 bf16),
// flags [W][(size - 1) * parts * n_piece], bar [W] (`world` addresses
// each).  split: elements of the rightward half, chunk in RING (one part)
// and (rows / 2) * row < chunk in BIDIR (two parts).
extern "C" int tdt_reduce_scatter(const long long* x, const long long* out,
                                  const long long* land,
                                  const long long* flags,
                                  const long long* bar, long long chunk,
                                  long long split, int dtype, int world,
                                  int size, int stride, unsigned epoch,
                                  void* stream) {
  if (world < 2 || world > MAX_RANKS || size < 2 || stride < 1 ||
      world % (size * stride) != 0 || chunk < 1 || split < 0 ||
      split > chunk || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = peers<const void>(x, world);
  p.out = peers<void>(out, world);
  p.land = peers<void>(land, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.chunk = chunk;
  p.split = split;
  const long long esize = dtype == 0 ? 4 : 2;
  p.piece = PIECE_BYTES / esize;
  const long long longest = split > chunk - split ? split : chunk - split;
  p.n_piece = static_cast<int>((longest + p.piece - 1) / p.piece);
  if (p.n_piece < 1) p.n_piece = 1;
  p.parts = split < chunk ? 2 : 1;
  p.size = size;
  p.stride = stride;
  p.epoch = epoch;
  const int items = size * p.parts * p.n_piece;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static unsigned attr[2] = {0, 0};
  if (dtype == 0)
    return tdt_dist::launch_coop(reduce_scatter_kernel<float>, p, NT, 0,
                                 world, items, attr[0], s);
  return tdt_dist::launch_coop(reduce_scatter_kernel<__nv_bfloat16>, p, NT,
                               0, world, items, attr[1], s);
}

// The flags a call needs per rank (the wrapper sizes the workspace).
extern "C" int tdt_reduce_scatter_flags(long long chunk, long long split,
                                        int dtype, int size) {
  const long long piece = PIECE_BYTES / (dtype == 0 ? 4 : 2);
  const long long longest = split > chunk - split ? split : chunk - split;
  long long n_piece = (longest + piece - 1) / piece;
  if (n_piece < 1) n_piece = 1;
  const int parts = split < chunk ? 2 : 1;
  return static_cast<int>((size - 1) * parts * n_piece);
}
