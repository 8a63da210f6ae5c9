// all_to_all: the expert-parallel token shuffle of MoE dispatch and
// combine, for Hopper (sm_90a).
//
// Replaces the TPU kernel triton_dist_tpu/kernels/all_to_all.py
// `_a2a_kernel` (launched from `fast_all_to_all_shard`).  Same contract, at
// shard level: send [world, max_tokens, H] (row block p goes to peer p) and
// splits [world] int32 (the valid rows of each block) in; recv [world,
// max_tokens, H] (row block p came from peer p) and recv_splits [world]
// out.  This kernel is the part of the shuffle that stays on the card: rank
// `me`'s own segment send[me] -> recv[me], whole (padding rows included,
// as the TPU kernel's local DMA copies it), and splits[me] ->
// recv_splits[me].  At world 1 that is the whole shuffle, and recv equals
// send.  The peer segments need peers' buffers mapped into this process
// (not ported: the wrapper refuses world > 1).
//
// What bounds it on an H100: bytes.  At Mixtral-8x7B's dispatch of a
// 2048-token top-2 batch (max_tokens 4096, H 4096, bf16) the segment is
// 33.6 MB, read once and written once: 20 us at 3.35 TB/s.
//
// Design (right and simple first): a grid-stride copy in 16-byte vectors
// over a grid of a few blocks per SM, then the byte tail (a segment whose
// size or base is not a multiple of 16 bytes copies bytewise), and thread
// 0 copies the split count.  The payload's type does not matter: the
// wrapper passes bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int BLOCKS_PER_SM = 8;

struct A2aParams {
  const unsigned char* src;  // send[me]
  unsigned char* dst;        // recv[me]
  long long n_bytes;         // one segment: max_tokens * H * element size
  long long n_vec;           // 16-byte vectors copied before the tail
  const int* splits;
  int* recv_splits;
  int me;
};

__global__ void __launch_bounds__(NT) a2a_local_kernel(const A2aParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  const long long t0 = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const uint4* src4 = reinterpret_cast<const uint4*>(p.src);
  uint4* dst4 = reinterpret_cast<uint4*>(p.dst);
  for (long long i = t0; i < p.n_vec; i += stride) dst4[i] = __ldg(src4 + i);
  for (long long i = p.n_vec * 16 + t0; i < p.n_bytes; i += stride)
    p.dst[i] = p.src[i];
  if (t0 == 0) p.recv_splits[p.me] = p.splits[p.me];
}

}  // namespace

// recv[me] = send[me] (seg_bytes bytes at offset me * seg_bytes of each
// buffer) and recv_splits[me] = splits[me], on `stream`.
extern "C" int tdt_a2a_local(const void* send, const void* splits,
                             void* recv, void* recv_splits,
                             long long seg_bytes, int me, void* stream) {
  A2aParams p;
  p.src = static_cast<const unsigned char*>(send) + me * seg_bytes;
  p.dst = static_cast<unsigned char*>(recv) + me * seg_bytes;
  p.n_bytes = seg_bytes;
  const bool aligned = (reinterpret_cast<uintptr_t>(p.src) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(p.dst) % 16 == 0);
  p.n_vec = aligned ? seg_bytes / 16 : 0;
  p.splits = static_cast<const int*>(splits);
  p.recv_splits = static_cast<int*>(recv_splits);
  p.me = me;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = p.n_vec > 0 ? p.n_vec : seg_bytes;
  long long blocks = (work + NT - 1) / NT;
  if (blocks > static_cast<long long>(sms) * BLOCKS_PER_SM)
    blocks = static_cast<long long>(sms) * BLOCKS_PER_SM;
  if (blocks < 1) blocks = 1;
  a2a_local_kernel<<<static_cast<int>(blocks), NT, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
