// Device verbs of the distributed runtime over a rank-indexed pointer
// table: the counterparts of triton_dist_tpu/language/primitives.py's
// `wait` (:37), `notify` (:50), `putmem` (:100), `putmem_signal` (:112)
// and `barrier_all` (:270).
//
// A rank's symmetric buffers (its flags, its barrier slots, the buffers its
// peers write into) are reached through `Peers<T>`, one pointer per rank.
// In the virtual world of one card every rank's buffer is a slice of one
// device allocation; a multi-card backend fills the same table with the
// peers' mapped addresses, and nothing here changes.
//
// Flags hold call epochs.  Each call of a kernel gets a new epoch from its
// workspace (a host counter): a flag is set to the epoch of the call that
// set it, and a wait passes once the flag has reached this call's epoch
// (wrap-safe: a later epoch passes too, a stale one from an earlier call
// never does).  So flags are never cleared between calls.
//
// Ordering, at system scope so the same code is right across cards:
// - signal: every thread's writes, then __syncthreads, then thread 0's
//   __threadfence_system and a release store of the flag;
// - wait: thread 0's acquire loads until the flag has reached the epoch,
//   then __syncthreads before any thread (or cp.async) reads what the flag
//   guards.
// A spin-wait is safe only when the block it waits on is resident: the
// kernels that use these verbs launch cooperatively (every block of every
// rank resident at once) and order each block's work so that no block
// waits before the work others wait on.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt_dist {

constexpr int MAX_RANKS = 8;

template <class T>
struct Peers {
  T* p[MAX_RANKS];
};

__device__ __forceinline__ bool reached(unsigned flag, unsigned epoch) {
  return static_cast<int>(flag - epoch) >= 0;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* flag) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(flag) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* flag, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;\n"
               :: "l"(flag), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait that has not passed after SPIN_LIMIT_NS traps: the launch fails
// with an error instead of holding the card forever (a protocol fault,
// never a slow peer: every block a wait depends on is resident).
constexpr unsigned long long SPIN_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void spin_until(const unsigned* flag,
                                           unsigned epoch) {
  if (reached(ld_acquire(flag), epoch)) return;
  const unsigned long long t0 = global_ns();
  while (!reached(ld_acquire(flag), epoch)) {
    __nanosleep(64);
    if (global_ns() - t0 > SPIN_LIMIT_NS) __trap();
  }
}

// notify / signal: publish what the whole block wrote, then set the flag.
__device__ __forceinline__ void signal(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    st_release(flag, epoch);
  }
}

// wait on `count` flags `stride` apart (count <= blockDim.x): thread i
// spins on flag i, then the block syncs.
__device__ __forceinline__ void wait(const unsigned* flags, unsigned epoch,
                                     int count = 1, int stride = 1) {
  if (static_cast<int>(threadIdx.x) < count)
    spin_until(flags + threadIdx.x * stride, epoch);
  __syncthreads();
}

// putmem: the block copies `bytes` (a multiple of 16, both ends 16-byte
// aligned) from src to dst, which may be a peer's buffer.
__device__ __forceinline__ void putmem(void* dst, const void* src,
                                       long long bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const long long n = bytes / 16;
  long long i = threadIdx.x;
  for (; i + 3 * blockDim.x < n; i += 4 * blockDim.x) {
    const uint4 v0 = s[i], v1 = s[i + blockDim.x];
    const uint4 v2 = s[i + 2 * blockDim.x], v3 = s[i + 3 * blockDim.x];
    d[i] = v0;
    d[i + blockDim.x] = v1;
    d[i + 2 * blockDim.x] = v2;
    d[i + 3 * blockDim.x] = v3;
  }
  for (; i < n; i += blockDim.x) d[i] = s[i];
}

// putmem_signal: the copy, then the flag (on the receiving rank).
__device__ __forceinline__ void putmem_signal(void* dst, const void* src,
                                              long long bytes,
                                              unsigned* flag,
                                              unsigned epoch) {
  putmem(dst, src, bytes);
  signal(flag, epoch);
}

// count_signal: count one piece of a chunk at the receiver (after the
// block's copy of it); the piece that brings the counter to `pieces`
// resets it to 0 for the next call and raises the chunk's flag with this
// call's epoch.  A chunk pushed by several blocks signals once, and a
// counter is 0 between calls.
__device__ __forceinline__ void count_signal(unsigned* cnt, int pieces,
                                             unsigned* flag,
                                             unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    if (pieces == 1 ||
        atomicAdd_system(cnt, 1u) == static_cast<unsigned>(pieces - 1)) {
      if (pieces > 1) *cnt = 0u;
      __threadfence_system();
      st_release(flag, epoch);
    }
  }
}

// barrier_all: every rank stores the epoch into its slot of every peer's
// barrier array and waits until its own array holds the epoch in every
// slot (thread p serves peer p).  Every block of a rank calls it on entry,
// so no block writes into a peer that has not entered the kernel.
__device__ __forceinline__ void barrier_all(const Peers<unsigned>& bar,
                                            int me, int world,
                                            unsigned epoch) {
  const int p = threadIdx.x;
  if (p < world) {
    st_release(bar.p[p] + me, epoch);
    spin_until(bar.p[me] + p, epoch);
  }
  __syncthreads();
}

// Peers along one mesh axis.  The world's ranks are the row-major indices
// of a mesh's coordinates, so an axis of `size` ranks `stride` apart puts
// rank `me` at coordinate (me / stride) % size, and its peer at coordinate
// c' is me + (c' - c) * stride: one pointer table of W ranks serves every
// group of the axis, and one launch runs every group.
__device__ __forceinline__ int axis_coord(int me, int size, int stride) {
  return (me / stride) % size;
}

__device__ __forceinline__ int axis_peer(int me, int c, int to, int stride) {
  return me + (to - c) * stride;
}

// barrier over one axis: barrier_all among the `size` ranks of me's group
// (the slots are indexed by world rank, so groups never share a slot).
__device__ __forceinline__ void barrier_axis(const Peers<unsigned>& bar,
                                             int me, int size, int stride,
                                             unsigned epoch) {
  const int p = threadIdx.x;
  if (p < size) {
    const int peer = axis_peer(me, axis_coord(me, size, stride), p, stride);
    st_release(bar.p[peer] + me, epoch);
    spin_until(bar.p[me] + peer, epoch);
  }
  __syncthreads();
}

// Peers over a joint group of up to three axes (the reference's tuple
// `axis`, e.g. ("x", "y") of a (2, 4) mesh): the ranks that agree on the
// mesh's other axes.  A rank's joint index is its coordinates on the
// tuple's axes read in mixed radix, the tuple's first axis slowest (the
// flat axes-major order of `lax.all_gather` over the joint axes), whatever
// the mesh's own axis order; so ("y", "x") of a (2, 4) mesh is a valid
// group whose joint index is not the world rank.  One axis of `size` ranks
// `stride` apart is the group of axis_coord / axis_peer; `flat_group(W)`
// is the whole world of W ranks in rank order.
struct Group {
  int n;          // axes, 1..3
  int size[3];    // each axis' ranks, in the tuple's order
  int stride[3];  // each axis' distance in world ranks
  int G;          // the group's ranks: the product of the sizes
};

__host__ __device__ __forceinline__ int group_coord(const Group& g, int me,
                                                    int i) {
  return (me / g.stride[i]) % g.size[i];
}

__host__ __device__ __forceinline__ int group_index(const Group& g,
                                                    int me) {
  int j = 0;
  for (int i = 0; i < g.n; ++i) j = j * g.size[i] + group_coord(g, me, i);
  return j;
}

// The world rank of joint index j in me's group.
__host__ __device__ __forceinline__ int group_rank(const Group& g, int me,
                                                   int j) {
  int r = me;
  for (int i = g.n - 1; i >= 0; --i) {
    const int c = j % g.size[i];
    j /= g.size[i];
    r += (c - group_coord(g, me, i)) * g.stride[i];
  }
  return r;
}

// barrier over me's group (the slots are indexed by world rank, so groups
// never share a slot).
__device__ __forceinline__ void barrier_group(const Peers<unsigned>& bar,
                                              int me, const Group& g,
                                              unsigned epoch) {
  const int p = threadIdx.x;
  if (p < g.G) {
    const int peer = group_rank(g, me, p);
    st_release(bar.p[peer] + me, epoch);
    spin_until(bar.p[me] + peer, epoch);
  }
  __syncthreads();
}

// The order in which the reference's torus reduce-scatter folds a joint
// group's G values for one target (triton_dist_tpu/kernels/torus.py
// `_torus_rs_kernel` :311, and the torus GEMM-RS :300).  The band is cut
// into 2n parts; part q takes path flavor (s, d) = (q / 2, q odd ? -1 :
// 1): phase l ring-reduces along axis (s + l) % n of the group in
// direction d, and within a ring the sum for coordinate c starts at the
// rank c + d and each hop adds the local value to the incoming sum (`acc =
// local + acc`), ending at c.  So the value of target t is a nested ring
// sum, the phase-0 axis innermost.  Position p of the G adds (3 bits each
// in `src` and `first`, 2 in `carry`, so a plan is three registers) takes
// source src_p; bit l of first_p says level l starts a new sum there (no
// add); carry_p levels complete at p, each folded into the level above.
struct FoldPlan {
  unsigned src, first, carry;
};

__host__ __device__ __forceinline__ FoldPlan fold_plan(const Group& g,
                                                       int t, int q) {
  const int s = q / 2, d = q % 2 ? -1 : 1;
  int ax[3], w[3], c[3], jst[3];
  int js = 1;
  for (int i = g.n - 1; i >= 0; --i) {
    jst[i] = js;
    js *= g.size[i];
  }
  for (int l = 0; l < g.n; ++l) {
    ax[l] = (s + l) % g.n;
    w[l] = g.size[ax[l]];
    c[l] = (t / jst[ax[l]]) % w[l];
  }
  FoldPlan f{0u, 0u, 0u};
  int k[3] = {1, 1, 1};  // ring step of each level, 1..w
  for (int p = 0; p < g.G; ++p) {
    unsigned src = 0, first = 0, carry = 0;
    for (int l = 0; l < g.n; ++l) {
      src += ((c[l] + k[l] * d) % w[l] + w[l]) % w[l] * jst[ax[l]];
      if (k[l] == 1) first |= 1u << l;
    }
    while (carry < static_cast<unsigned>(g.n - 1) && k[carry] == w[carry])
      ++carry;
    f.src |= src << (3 * p);
    f.first |= first << (3 * p);
    f.carry |= carry << (2 * p);
    for (int l = 0; l < g.n && ++k[l] > w[l]; ++l) k[l] = 1;
  }
  return f;
}

__host__ __device__ __forceinline__ int plan_src(const FoldPlan& f, int p) {
  return (f.src >> (3 * p)) & 7;
}

// One position of a fold: x, the value of source plan_src(f, p), into the
// running sums acc (levels 0..2), with the rounding add `add` (the
// tensor's dtype at every hop, as `_fold_tiles` :294 adds).  After
// position G - 1 the result is acc[n - 1].  T: a value (float), or a
// word of packed values that `add` adds lane by lane.
template <class T, class Add>
__device__ __forceinline__ void fold_step(const FoldPlan& f, int p, T x,
                                          T (&acc)[3], Add add) {
  const unsigned first = (f.first >> (3 * p)) & 7;
  const unsigned carry = (f.carry >> (2 * p)) & 3;
  acc[0] = (first & 1) ? x : add(x, acc[0]);
#pragma unroll
  for (int l = 0; l < 2; ++l)
    if (l < static_cast<int>(carry))
      acc[l + 1] = (first >> (l + 1) & 1) ? acc[l] : add(acc[l], acc[l + 1]);
}

// The fold's result: the sum of its outermost level (n axes).
template <class T>
__device__ __forceinline__ T fold_result(const T (&acc)[3], int n) {
  return n == 3 ? acc[2] : (n == 2 ? acc[1] : acc[0]);
}

// The fold of `f` over v, the G values in the plan's order (v[p] is
// source plan_src(f, p)'s).  Unrolled over MAX_RANKS so v and the sums
// stay in registers.
template <class Add>
__device__ __forceinline__ float fold(const FoldPlan& f, int G, int n,
                                      const float* v, Add add) {
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < MAX_RANKS; ++p)
    if (p < G) fold_step(f, p, v[p], acc, add);
  return fold_result(acc, n);
}

// The block copies n bytes from src to dst: 16-byte vectors (four in
// flight per thread) when both ends are 16-byte aligned, then the tail.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           long long n) {
  const int nt = blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long nv = n / 16;
    long long i = threadIdx.x;
    for (; i + 3 * nt < nv; i += 4 * nt) {
      const uint4 v0 = s[i], v1 = s[i + nt], v2 = s[i + 2 * nt],
                  v3 = s[i + 3 * nt];
      d[i] = v0;
      d[i + nt] = v1;
      d[i + 2 * nt] = v2;
      d[i + 3 * nt] = v3;
    }
    for (; i < nv; i += nt) d[i] = s[i];
    done = nv * 16;
  }
  for (long long i = done + threadIdx.x; i < n; i += nt) dst[i] = src[i];
}

// Host side.  A joint group from its packed form [n, size0..2,
// stride0..2] (the wrappers' `group_args`), or the flat world.
inline Group group_from(const int* a) {
  Group g{};
  g.n = a[0];
  g.G = 1;
  for (int i = 0; i < 3; ++i) {
    g.size[i] = i < g.n ? a[1 + i] : 1;
    g.stride[i] = i < g.n ? a[4 + i] : 1;
    g.G *= g.size[i];
  }
  return g;
}

inline Group flat_group(int world) {
  const int a[7] = {1, world, 1, 1, 1, 1, 1};
  return group_from(a);
}

// A group the kernels take: 1-3 axes of at least one rank, at most
// MAX_RANKS ranks, every rank of the world in a group of its own.
inline bool bad_group(const Group& g, int world) {
  if (g.n < 1 || g.n > 3 || g.G < 1 || g.G > MAX_RANKS) return true;
  for (int i = 0; i < g.n; ++i)
    if (g.size[i] < 1 || g.stride[i] < 1 ||
        world % (g.size[i] * g.stride[i]) != 0)
      return true;
  return false;
}

// Host side.  The pointer table of one buffer from `world` addresses.
template <class T>
Peers<T> peers(const long long* ptrs, int world) {
  Peers<T> out{};
  for (int r = 0; r < world; ++r)
    out.p[r] = reinterpret_cast<T*>(static_cast<uintptr_t>(ptrs[r]));
  return out;
}

// Host side.  The byte stride between consecutive ranks of a pointer
// table: the rank-stacked tensor's outermost stride (`whole` at world 1,
// where it is never stepped), or -1 when the ranks are not equally spaced
// or the stride is not a positive multiple of 16 (TMA's rule: a tensor map
// spans the ranks).
inline long long rank_stride(const long long* t, int world,
                             long long whole) {
  const long long s = world > 1 ? t[1] - t[0] : (whole + 15) / 16 * 16;
  for (int r = 2; r < world; ++r)
    if (t[r] - t[r - 1] != s) return -1;
  return s > 0 && s % 16 == 0 ? s : -1;
}

// A cooperative launch of `kernel(p)` for `n_ranks` ranks: as many blocks
// as can be resident at once (the occupancy calculator), the same number
// for each rank, at most one per item, as a grid [blocks per rank][ranks]
// (blockIdx.y is the rank); cudaLaunchCooperativeKernel
// refuses a grid that could not be co-resident.  Sets the kernel's dynamic
// shared memory limit once per device (`attr_set`).
template <class Kern, class Params>
int launch_coop(Kern kernel, Params& p, int threads, int smem, int n_ranks,
                int items_per_rank, unsigned& attr_set,
                cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (!(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bpr = per_sm * sms / n_ranks;
  if (bpr > items_per_rank) bpr = items_per_rank;
  if (bpr < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(bpr, n_ranks), dim3(threads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The flat-grid variant: one cooperative 1-D grid of as many resident
// blocks as the card holds (at most one per item) that walks ONE item
// list over every rank (the item names its rank), instead of a fixed
// share of blocks per rank.
template <class Kern, class Params>
int launch_coop_flat(Kern kernel, Params& p, int threads, int smem,
                     int items, unsigned& attr_set, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaError_t err = cudaSuccess;
  if (!(attr_set & (1u << dev))) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set |= 1u << dev;
  }
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = per_sm * sms;
  if (blocks > items) blocks = items;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdt_dist
