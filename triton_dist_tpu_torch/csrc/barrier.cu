// barrier: a barrier across every rank of one mesh axis, for Hopper
// (sm_90a), over the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/common_ops.py
// `_barrier_kernel` (:34, launched from `_barrier_shard` at :40 for the
// host barrier `barrier_all_on_mesh` at :52).  Same contract, for every
// rank r of a world of W on a mesh axis of `size` ranks `stride` apart:
// rank r's int32 x[r] in, out[r] = x[r] out, written only after every
// rank of r's group along the axis has entered the kernel.
//
// The TPU kernel is `barrier_all(axis)` (a semaphore signal to every peer
// of the axis, then a wait for all of them) and a copy of its one SMEM
// word.  Here each rank's block stores the call's epoch into its slot of
// every group peer's barrier array and spins until its own array holds the
// epoch in every peer's slot (barrier_axis: thread p serves peer p), then
// copies its word.  One cooperative launch serves every group of the axis
// (grid [1][W], blockIdx.y = rank), so every block is resident and no
// spin-wait can hang on an unscheduled peer (a wait that has not passed in
// 10 s traps).
//
// What bounds it on an H100: nothing moves but W words (0 bytes of
// payload to speak of), so its time is the launch and the flag round trip:
// latency, reported as such.  The epoch is a host counter, so a launch
// cannot be captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 32;

struct Params {
  Peers<unsigned> bar;  // rank r's [W] barrier slots
  const int* x;         // [W]
  int* out;             // [W]
  int size, stride;
  unsigned epoch;
};

__global__ void __launch_bounds__(NT) barrier_kernel(
    const __grid_constant__ Params p) {
  const int me = blockIdx.y;
  tdt_dist::barrier_axis(p.bar, me, p.size, p.stride, p.epoch);
  if (threadIdx.x == 0) p.out[me] = p.x[me];
}

}  // namespace

// One call for every rank of a world of `world` (1..8) over an axis of
// `size` ranks `stride` apart (size * stride divides world): x, out [W]
// int32; bar: `world` addresses of the [W] barrier slots.
extern "C" int tdt_barrier(const void* x, void* out, const long long* bar,
                           int world, int size, int stride, unsigned epoch,
                           void* stream) {
  if (world < 1 || world > MAX_RANKS || size < 1 || stride < 1 ||
      world % (size * stride) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.bar = peers<unsigned>(bar, world);
  p.x = static_cast<const int*>(x);
  p.out = static_cast<int*>(out);
  p.size = size;
  p.stride = stride;
  p.epoch = epoch;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(barrier_kernel, p, NT, 0, world, 1, attr,
                               static_cast<cudaStream_t>(stream));
}
