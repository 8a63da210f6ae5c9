// allgather: the all-gather over one mesh axis, for Hopper (sm_90a), over
// the distributed verbs of dist_verbs.cuh.
//
// Replaces the TPU kernels of triton_dist_tpu/kernels/allgather.py (all
// launched from `_ag_pallas_shard`, `pallas_call` at :220):
// - `_ring_ag_kernel` (:109): mode RING, neighbour hops, step s forwards
//   slot (c - s) mod T to the right neighbour;
// - `_bidir_ring_ag_kernel` (:146): mode BIDIR, each slot's first half of
//   rows travels right as RING does and its second half travels left
//   (slot (c + s) mod T), both directions at once (rows even: the host
//   takes RING on odd rows, as `:216-217` does);
// - `_full_mesh_push_ag_kernel` (:185): mode FULL_MESH, every rank pushes
//   its rows to every peer at once (the `fcollect` verb).
// Same contract, for every rank r of a world of W on an axis of T ranks
// `stride` apart (r at coordinate c): rank r's x [rows][row] in; rank r's
// out [T][rows][row] out, where slot c' holds the rows of its group's
// rank at coordinate c', bit for bit.  The modes differ in who writes
// which slot when, never in the result.
//
// What the TPU kernels do, and what this one keeps of them: the own rows
// copied into the own slot; an entry barrier over the axis (barrier_axis,
// the reference's barrier semaphore), so no rank writes into a peer that
// has not entered the kernel; the modes' schedules.  The DMAs and
// semaphores become copies and flags: every push moves ~64 KB pieces
// straight into the receiving rank's output slot and sets a flag per
// (slot, half, piece) there to the call's epoch.  A ring hop that forwards
// a slot it received waits on that piece's flag first, so the pieces of
// one slot pipeline round the ring.  Every rank ends by waiting on all of
// its own flags (each set exactly once per call), so the kernel's end
// means every slot has landed on every rank.  On one card (the virtual
// world) the peers' buffers are slices of one allocation and the pushes
// are device-memory copies, not NVLink.
//
// What bounds it on an H100: bytes.  The function reads every rank's
// input once and writes every rank's output once: at the hierarchical
// gradient all-reduce of Mistral-7B at dcn 2 x pp 2 x tp 2 (a band of
// 1,024,528 x 128 f32 per rank, T 2) 8 x (0.52 + 1.05) GB, 3.8 ms at
// 3.35 TB/s.  The full-mesh push reads each input once per peer.
//
// Design (right and simple first): one cooperative launch per call with a
// 2-D grid (blockIdx.y = rank), every block resident (a spin-wait is safe
// only then); each rank's blocks walk its items in index order (ring
// modes: step-major, so every item depends only on a lower-numbered item
// of another rank and the lowest unfinished item can always run), the
// local copy last.  The epoch is a host counter, so a launch cannot be
// captured in a CUDA graph.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dist_verbs.cuh"

namespace {

using tdt_dist::MAX_RANKS;
using tdt_dist::Peers;
using tdt_dist::peers;

constexpr int NT = 256;
constexpr long long PIECE = 1 << 16;  // bytes a block copies per flag

enum Mode { RING = 0, BIDIR = 1, FULL_MESH = 2 };

struct Params {
  Peers<const unsigned char> x;  // rank r's x [seg]
  Peers<unsigned char> out;      // rank r's out [T][seg]
  Peers<unsigned> flags;         // rank r's [T][parts][n_piece] flags
  Peers<unsigned> bar;           // rank r's [W] barrier slots
  long long seg;                 // bytes of one rank's rows
  long long part;                // bytes of one half (BIDIR) or of seg
  int size, stride, mode, parts, n_piece;
  unsigned epoch;
};

// Piece k of half `h` of a slot: its byte range inside the slot.
__device__ __forceinline__ void piece_range(const Params& p, int h, int k,
                                            long long& off, long long& n) {
  const long long b0 = k * PIECE;
  const long long b1 = b0 + PIECE < p.part ? b0 + PIECE : p.part;
  off = h * p.part + b0;
  n = b1 > b0 ? b1 - b0 : 0;
}

__global__ void __launch_bounds__(NT) allgather_kernel(
    const __grid_constant__ Params p) {
  const int me = blockIdx.y, lb = blockIdx.x, nb = gridDim.x;
  const int T = p.size;
  const int c = tdt_dist::axis_coord(me, T, p.stride);
  tdt_dist::barrier_axis(p.bar, me, T, p.stride, p.epoch);
  const int per_slot = p.parts * p.n_piece;
  const unsigned char* x = p.x.p[me];
  unsigned char* own = p.out.p[me];
  const int n_items = T * per_slot;

  for (int it = lb; it < n_items; it += nb) {
    const int step = it / per_slot;
    const int h = (it % per_slot) / p.n_piece;
    const int k = it % p.n_piece;
    const int flag = h * p.n_piece + k;
    long long off, n;
    piece_range(p, h, k, off, n);
    if (step == T - 1) {
      // the own rows into the own slot, last
      if (n > 0) tdt_dist::copy_bytes(own + c * p.seg + off, x + off, n);
      tdt_dist::signal(p.flags.p[me] + c * per_slot + flag, p.epoch);
      continue;
    }
    int slot, to;
    const unsigned char* src;
    if (p.mode == FULL_MESH) {
      // step q pushes my rows to the peer q + 1 places on
      slot = c;
      to = (c + 1 + step) % T;
      src = x + off;
    } else {
      // ring hop `step` of direction d: slot (c - d step) to c + d
      const int d = h == 0 ? 1 : -1;
      slot = ((c - d * step) % T + T) % T;
      to = ((c + d) % T + T) % T;
      if (step == 0) {
        src = x + off;
      } else {
        tdt_dist::wait(p.flags.p[me] + slot * per_slot + flag, p.epoch);
        src = own + slot * p.seg + off;
      }
    }
    const int dst = tdt_dist::axis_peer(me, c, to, p.stride);
    if (n > 0)
      tdt_dist::copy_bytes(p.out.p[dst] + slot * p.seg + off, src, n);
    tdt_dist::signal(p.flags.p[dst] + slot * per_slot + flag, p.epoch);
  }

  // every slot of mine has landed
  for (int i = lb * NT + threadIdx.x; i < n_items; i += nb * NT)
    tdt_dist::spin_until(p.flags.p[me] + i, p.epoch);
}

}  // namespace

// One call for every rank of a world of `world` (1..8) over an axis of
// `size` >= 2 ranks `stride` apart: x [W][seg bytes], out [W][size][seg],
// flags [W][size * parts * n_piece], bar [W] (`world` addresses each).
// mode 0 ring, 1 bidir (seg even, halves of seg / 2 bytes), 2 full mesh.
extern "C" int tdt_allgather(const long long* x, const long long* out,
                             const long long* flags, const long long* bar,
                             long long seg, int world, int size, int stride,
                             int mode, unsigned epoch, void* stream) {
  if (world < 2 || world > MAX_RANKS || size < 2 || stride < 1 ||
      world % (size * stride) != 0 || mode < RING || mode > FULL_MESH ||
      seg < 1 || (mode == BIDIR && seg % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = peers<const unsigned char>(x, world);
  p.out = peers<unsigned char>(out, world);
  p.flags = peers<unsigned>(flags, world);
  p.bar = peers<unsigned>(bar, world);
  p.seg = seg;
  p.parts = mode == BIDIR ? 2 : 1;
  p.part = seg / p.parts;
  p.n_piece = static_cast<int>((p.part + PIECE - 1) / PIECE);
  p.size = size;
  p.stride = stride;
  p.mode = mode;
  p.epoch = epoch;
  static unsigned attr = 0;
  return tdt_dist::launch_coop(allgather_kernel, p, NT, 0, world,
                               size * p.parts * p.n_piece, attr,
                               static_cast<cudaStream_t>(stream));
}

// The flags a call needs per rank (the wrapper sizes the workspace).
extern "C" int tdt_allgather_flags(long long seg, int size, int mode) {
  const int parts = mode == BIDIR ? 2 : 1;
  const long long part = seg / parts;
  return size * parts * static_cast<int>((part + PIECE - 1) / PIECE);
}
