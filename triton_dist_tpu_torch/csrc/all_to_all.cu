// all_to_all: the expert-parallel token shuffle of MoE dispatch and
// combine, for Hopper (sm_90a), over the distributed verbs of
// dist_verbs.cuh.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/all_to_all.py
// `_a2a_kernel` (:108, launched from `fast_all_to_all_shard` at :253).
// Same contract, for every rank r of a world of W: rank r's send
// [W][max_tokens][H] (row block p goes to peer p) and splits [W] int32
// (the valid rows of each block) in; rank r's recv [W][max_tokens][H]
// (row block s came from peer s) and recv_splits [W] out:
// recv[p][r] = send[r][p] on the rows below the split, and
// recv_splits[p][r] = splits[r][p].
//
// What the TPU kernel does, and what this one keeps of it:
// - the rank's own segment is copied whole, padding rows included
//   (`tdt_a2a_local`; at world 1 that is the whole shuffle and recv equals
//   send);
// - an entry barrier_all, so no rank writes into a peer that has not
//   entered the kernel;
// - the split counts travel to every peer beside the payload, and the
//   receiver takes its recv_splits from what arrived, only after every
//   segment has landed;
// - the payload moves in proportion to the splits: a peer segment ships
//   min(split, max_tokens) rows (a split above max_tokens is clamped before
//   the count, as the reference does at :174-177).  The TPU kernel ships
//   whole 128-row blocks (ceil(split / block) * block rows, the DMA's
//   static size); here exactly the split's rows move, which both consumers
//   allow: they read only rows below the split.  Receive rows past that are
//   undefined (recv comes from torch.empty).  `poison` writes a sentinel
//   (NaN, or the integer maximum) into them, so a consumer that misses the
//   recv_splits mask fails loudly (the reference's debug_poison).
//
// The DMAs and semaphores become copies and flags: a rank's blocks copy
// 64 KB chunks of its W outgoing segments straight into the peers' receive
// rows (16-byte vectors and a byte tail; the payload is raw bytes, so bf16,
// f32, fp8 and int32 move alike), then each chunk sets a flag per (src,
// chunk) on the receiving rank to the call's epoch, empty chunks too (a
// split of 0 still signals, or the receiver would wait forever; the 10 s
// trap of dist_verbs.cuh catches a protocol fault instead of hanging the
// card).  On one card (the virtual world) the peers' buffers are slices of
// one allocation and the pushes are device-memory copies, not NVLink.
//
// What bounds it on an H100: bytes.  Mixtral-8x7B's dispatch of a
// 2048-token top-2 batch over 4 ranks (max_tokens 1024, H 4096 bf16) at
// balanced routing ships ~256 rows per segment: 16 x 256 rows of 8 KB read
// once and written once, 67 MB, 20 us at 3.35 TB/s.
//
// Design (right and simple first): one cooperative launch per call with a
// 2-D grid (blockIdx.y = rank), every block resident (a spin-wait is safe
// only then); each rank's blocks walk its chunks in strides, the peers'
// segments first and its own last, and never wait before their copies are
// done.  Then block 0 of each rank waits for its W x n_chunk flags and
// writes recv_splits; with `poison` every block waits and fills its share
// of the unshipped rows.  The epoch is a host counter, so a launch cannot
// be captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr int BLOCKS_PER_SM = 8;

// ---------------------------------------------------------------------------
// world 1: the local segment
// ---------------------------------------------------------------------------

struct LocalParams {
  const unsigned char* src;  // send[me]
  unsigned char* dst;        // recv[me]
  long long n_bytes;         // one segment: max_tokens * H * element size
  long long n_vec;           // 16-byte vectors copied before the tail
  const int* splits;
  int* recv_splits;
  int me;
};

__global__ void __launch_bounds__(NT) a2a_local_kernel(const LocalParams p) {
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  const long long t0 = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const uint4* src4 = reinterpret_cast<const uint4*>(p.src);
  uint4* dst4 = reinterpret_cast<uint4*>(p.dst);
  for (long long i = t0; i < p.n_vec; i += stride) dst4[i] = __ldg(src4 + i);
  for (long long i = p.n_vec * 16 + t0; i < p.n_bytes; i += stride)
    p.dst[i] = p.src[i];
  if (t0 == 0) p.recv_splits[p.me] = p.splits[p.me];
}

// ---------------------------------------------------------------------------
// world > 1: every rank's segments
// ---------------------------------------------------------------------------

struct PeerParams {
  Peers<const unsigned char> send;  // rank r's send [W][max_tokens][row]
  Peers<unsigned char> recv;        // rank r's recv [W][max_tokens][row]
  Peers<const int> splits;          // rank r's splits [W]
  Peers<int> recv_splits;           // rank r's recv_splits [W]
  Peers<int> staged;                // rank r's [W] split counts: peers write
  Peers<unsigned> flags;            // rank r's [W src][n_chunk] flags
  Peers<unsigned> bar;              // rank r's [W] barrier slots
  long long row_bytes;
  int world, max_tokens, chunk_rows, n_chunk;
  unsigned epoch;
  int poison;                        // fill unshipped rows with `pattern`
  int elem_bytes;                    // 1, 2, 4 or 8: the pattern's period
  unsigned long long pattern;        // one element's bytes, little-endian
};

// The block copies n bytes from src to dst: 16-byte vectors (four in
// flight per thread) when both ends are 16-byte aligned, then the tail.
__device__ __forceinline__ void block_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           long long n) {
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long nv = n / 16;
    long long i = threadIdx.x;
    for (; i + 3 * NT < nv; i += 4 * NT) {
      const uint4 v0 = s[i], v1 = s[i + NT], v2 = s[i + 2 * NT],
                  v3 = s[i + 3 * NT];
      d[i] = v0;
      d[i + NT] = v1;
      d[i + 2 * NT] = v2;
      d[i + 3 * NT] = v3;
    }
    for (; i < nv; i += NT) d[i] = s[i];
    done = nv * 16;
  }
  for (long long i = done + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// Byte b of the poison pattern repeated every elem_bytes bytes.
__device__ __forceinline__ unsigned char pattern_byte(const PeerParams& p,
                                                      long long off) {
  return static_cast<unsigned char>(p.pattern >>
                                    (8 * (off % p.elem_bytes)));
}

// Rows [r0, r1) of one receive segment of rank `me` filled with the pattern
// by `nb` blocks, this one being `lb` (a segment starts on an element, so
// the pattern's phase is the byte offset in the segment).
__device__ void poison_rows(const PeerParams& p, unsigned char* seg, int r0,
                            int r1, int lb, int nb) {
  const long long b0 = r0 * p.row_bytes, b1 = r1 * p.row_bytes;
  const long long stride = static_cast<long long>(nb) * NT;
  long long start = b0;
  if ((reinterpret_cast<uintptr_t>(seg + b0) & 15) == 0 && b0 % 16 == 0) {
    uint4 v;
    unsigned char* vb = reinterpret_cast<unsigned char*>(&v);
    for (int i = 0; i < 16; ++i) vb[i] = pattern_byte(p, i);
    uint4* d = reinterpret_cast<uint4*>(seg + b0);
    const long long nv = (b1 - b0) / 16;
    for (long long i = static_cast<long long>(lb) * NT + threadIdx.x; i < nv;
         i += stride)
      d[i] = v;
    start = b0 + nv * 16;
  }
  for (long long i = start + static_cast<long long>(lb) * NT + threadIdx.x;
       i < b1; i += stride)
    seg[i] = pattern_byte(p, i);
}

__global__ void __launch_bounds__(NT) a2a_peer_kernel(
    const __grid_constant__ PeerParams p) {
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  tdt_dist::barrier_all(p.bar, me, p.world, p.epoch);
  const long long seg_bytes = p.max_tokens * p.row_bytes;

  // my W outgoing segments, chunk by chunk: peers first, my own last
  const int n_items = p.world * p.n_chunk;
  for (int it = lb; it < n_items; it += nb) {
    const int dst = (me + 1 + it / p.n_chunk) % p.world;
    const int c = it % p.n_chunk;
    const int split = p.splits.p[me][dst];
    int rows = dst == me ? p.max_tokens : split;
    rows = rows < 0 ? 0 : (rows > p.max_tokens ? p.max_tokens : rows);
    const int r0 = c * p.chunk_rows;
    const int r1 = r0 + p.chunk_rows < rows ? r0 + p.chunk_rows : rows;
    if (r1 > r0)
      block_copy(p.recv.p[dst] + me * seg_bytes + r0 * p.row_bytes,
                 p.send.p[me] + dst * seg_bytes + r0 * p.row_bytes,
                 (r1 - r0) * p.row_bytes);
    if (c == 0 && threadIdx.x == 0) p.staged.p[dst][me] = split;
    tdt_dist::signal(p.flags.p[dst] + me * p.n_chunk + c, p.epoch);
  }

  if (lb != 0 && !p.poison) return;
  // every segment of mine has landed (and its split count with it)
  for (int i = threadIdx.x; i < n_items; i += NT)
    tdt_dist::spin_until(p.flags.p[me] + i, p.epoch);
  __syncthreads();
  if (lb == 0 && threadIdx.x < p.world)
    p.recv_splits.p[me][threadIdx.x] = p.staged.p[me][threadIdx.x];
  if (!p.poison) return;
  for (int src = 0; src < p.world; ++src) {
    if (src == me) continue;
    int rows = p.staged.p[me][src];
    rows = rows < 0 ? 0 : (rows > p.max_tokens ? p.max_tokens : rows);
    poison_rows(p, p.recv.p[me] + src * seg_bytes, rows, p.max_tokens, lb,
                nb);
  }
}

}  // namespace

// recv[me] = send[me] (seg_bytes bytes at offset me * seg_bytes of each
// buffer) and recv_splits[me] = splits[me], on `stream`.
extern "C" int tdt_a2a_local(const void* send, const void* splits,
                             void* recv, void* recv_splits,
                             long long seg_bytes, int me, void* stream) {
  LocalParams p;
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

// One call for every rank of a world of `world` (2..8): each pointer table
// holds `world` device addresses (send, recv [W][max_tokens][row_bytes];
// splits, recv_splits, staged [W] int32; flags [W][n_chunk]; bar [W]).
// A chunk is chunk_rows rows; n_chunk = ceil(max_tokens / chunk_rows) >= 1.
// epoch: this call's, from the workspace.
extern "C" int tdt_a2a(const long long* send, const long long* recv,
                       const long long* splits, const long long* recv_splits,
                       const long long* staged, const long long* flags,
                       const long long* bar, long long row_bytes, int world,
                       int max_tokens, int chunk_rows, int n_chunk,
                       unsigned epoch, int poison, int elem_bytes,
                       unsigned long long pattern, void* stream) {
  if (world < 2 || world > MAX_RANKS || n_chunk < 1 || chunk_rows < 1 ||
      (poison && elem_bytes != 1 && elem_bytes != 2 && elem_bytes != 4 &&
       elem_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  PeerParams p;
  p.send = peers<const unsigned char>(send, world);
  p.recv = peers<unsigned char>(recv, world);
  p.splits = peers<const int>(splits, world);
  p.recv_splits = peers<int>(recv_splits, world);
  p.staged = peers<int>(staged, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.row_bytes = row_bytes;
  p.world = world;
  p.max_tokens = max_tokens;
  p.chunk_rows = chunk_rows;
  p.n_chunk = n_chunk;
  p.epoch = epoch;
  p.poison = poison;
  p.elem_bytes = poison ? elem_bytes : 1;
  p.pattern = pattern;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(a2a_peer_kernel, p, NT, 0, world,
                               world * n_chunk, attr,
                               static_cast<cudaStream_t>(stream));
}
