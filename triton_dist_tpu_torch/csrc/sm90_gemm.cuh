// A warp-specialised GEMM mainloop for Hopper (sm_90a) on the wgmma / TMA
// pieces of sm90.cuh, for kernels that walk their own list of output
// tiles (ag_gemm.cu's uni AG-GEMM; written so that the other ring GEMMs
// can take it).
//
// A block is three warpgroups (NT = 384 threads, one block an SM):
// - the producer warpgroup: its warp 0 issues every TMA load (lane 0)
//   into a ring of NS stages of full / empty mbarriers; in int8 its warps
//   1-3 transpose each staged B tile (below);
// - two consumer warpgroups, rows 0-63 and 64-127 of a 128 x 256 output
//   tile, each issuing wgmma over its rows against the whole B tile with
//   the accumulator in registers (128 f32 or int32 a thread), then
//   storing its rows straight from the registers (masked to the tile's
//   rows and to n).
// setmaxnreg moves registers from the producer to the consumers.
//
// A k-tile is 128 bytes of K (64 bf16, 128 int8), one 128-byte-swizzled
// row of every operand row, so every descriptor is sm90.cuh's sw128 one:
// - A [128 rows][128 B], K-major: consumer cw's rows start at 64 cw x 128
//   bytes, its k16 (bf16) / k32 (int8) step kk at + 32 kk bytes;
// - bf16 B [n][K] (B^T read in place, B_NK): [256 rows][128 B], K-major;
// - bf16 B [K][n]: the MN-major operand (the transpose bit): four boxes of
//   [64 k rows][64 n] 8 KB apart (LBO), step kk at + 16 kk rows (2 KB);
// - int8 B [K][n]: wgmma takes 8-bit operands K-major only, so the
//   producer's TMA stages the tile as it lies ([128 k][256 n], no
//   swizzle) and warps 1-3 of the producer warpgroup transpose it in
//   shared memory into a K-major swizzled [256 n][128 B] tile (4 x 4 byte
//   blocks by byte permutes, bank-conflict free), publish it to the async
//   proxy (fence.proxy.async.shared::cta) and arrive on its `tfull`
//   barrier.  The weight keeps its layout ([K][n], the reference's) and
//   no pass over it runs per call.
//
// Rings.  bf16: one ring of 4 stages (A 16 KB + B 32 KB).  int8: the TMA
// ring (A 16 KB + staged B 32 KB) has 3 stages, and the transposed B
// tiles a ring of 2 of their own (`tfull` / `tempty`): a TMA stage is
// released once the consumers are done with its A and the transposers
// with its B, a transposed tile once the consumers are done with it, so
// the transposers prepare k-tile i while the consumers multiply i - 1.
// 192 KB and 208 KB.  Rows, columns and K past the operands' ends load as
// zeros (TMA), so a ragged tile computes zeros there and the store drops
// them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace tdt_gemm90 {

using namespace tdt_sm90;

constexpr int BM = 128;  // output rows a tile (64 a consumer)
constexpr int BN = 256;  // output columns a tile
constexpr int NT = 384;  // producer + two consumer warpgroups
constexpr int KB = 128;  // bytes of K a k-tile
constexpr int TRANSPOSERS = 3;  // int8: producer warps 1-3

template <bool I8, bool B_NK>
struct Cfg {
  static_assert(!(I8 && B_NK), "int8 B is [K][n]");
  using T = typename std::conditional<I8, int8_t, __nv_bfloat16>::type;
  using Acc = typename std::conditional<I8, int, float>::type;
  static constexpr int BK = KB / static_cast<int>(sizeof(T));
  static constexpr int NS = I8 ? 3 : 4;     // TMA stages
  static constexpr int NTS = I8 ? 2 : 1;    // transposed B tiles (int8)
  static constexpr int A_BYTES = BM * KB;
  static constexpr int B_BYTES = BN * KB;
  static constexpr unsigned TX = A_BYTES + B_BYTES;  // TMA bytes a stage
  static constexpr int NACC = BN / 2;                // 64 x BN / 128 threads
  // setmaxnreg moves registers within the block's launch allocation (168
  // a thread at 384 threads): what the producer warpgroup frees must cover
  // what the consumers take, or their setmaxnreg.inc never returns (the
  // block then stalls until an mbarrier wait traps).  The int8 producer
  // warpgroup transposes, so it keeps more than 40.
  static constexpr int PRODUCER_REGS = I8 ? 56 : 40;
  static constexpr int CONSUMER_REGS = I8 ? 224 : 232;
  static_assert(128 * (168 - PRODUCER_REGS) >= 256 * (CONSUMER_REGS - 168),
                "the consumers take more registers than the producer frees");
  // arrivals that release a TMA stage: the consumer warps (and in int8
  // the transposer warps)
  static constexpr unsigned EMPTY_COUNT = I8 ? 8 + TRANSPOSERS : 8;
};

template <class C>
struct Smem {
  static constexpr bool I8 = sizeof(typename C::T) == 1;
  alignas(1024) unsigned char a[C::NS][C::A_BYTES];
  // the B tiles wgmma reads: bf16 the TMA stages', int8 the transposed
  alignas(1024) unsigned char b[I8 ? C::NTS : C::NS][C::B_BYTES];
  // int8: B as TMA stages it, [BK][BN]
  alignas(1024) unsigned char raw[I8 ? C::NS : 1][I8 ? C::B_BYTES : 16];
  uint64_t full[C::NS], empty[C::NS], tfull[C::NTS], tempty[C::NTS];
};

template <class C>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(Smem<C>)) + 1024;  // + 1024-byte alignment
}

template <class C>
__device__ __forceinline__ Smem<C>& smem_of(char* raw) {
  return *reinterpret_cast<Smem<C>*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// One thread, before the block's first __syncthreads.
template <class C>
__device__ __forceinline__ void init_barriers(Smem<C>& sm) {
  for (int i = 0; i < C::NS; ++i) {
    mbar_init(&sm.full[i], 1);
    mbar_init(&sm.empty[i], C::EMPTY_COUNT);
  }
  for (int i = 0; i < C::NTS; ++i) {
    mbar_init(&sm.tfull[i], TRANSPOSERS);
    mbar_init(&sm.tempty[i], 8);
  }
  mbar_fence_init();
}

// The producer's lane 0: k-tile kt of a tile into the ring's next stage,
// A by `load_a(dst, bar, k0)` (the caller's map and coordinates), B from
// the map `bmap` over the rank-stacked weight ({n, K, W}, or {K, n, W}
// with B_NK) at columns col0.. of rank `rank`.
template <bool I8, bool B_NK, class LoadA>
__device__ __forceinline__ void produce_k_tile(Smem<Cfg<I8, B_NK>>& sm,
                                               Ring<Cfg<I8, B_NK>::NS>& ring,
                                               const CUtensorMap* bmap,
                                               int col0, int kt, int rank,
                                               LoadA load_a) {
  using C = Cfg<I8, B_NK>;
  const int st = ring.stage;
  mbar_wait(&sm.empty[st], ring.phase ^ 1u);
  mbar_arrive_tx(&sm.full[st], C::TX);
  const int k0 = kt * C::BK;
  load_a(sm.a[st], &sm.full[st], k0);
  if (I8) {
    tma_load_3d(sm.raw[st], bmap, &sm.full[st], col0, k0, rank);
  } else if (B_NK) {
    tma_load_3d(sm.b[st], bmap, &sm.full[st], k0, col0, rank);
  } else {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      tma_load_3d(sm.b[st] + q * 64 * KB, bmap, &sm.full[st], col0 + 64 * q,
                  k0, rank);
  }
  ring.next();
}

// int8: transposer warp tw (0..2) turns the staged [128 k][256 n] B tile
// `raw` into the K-major swizzled [256 n][128 B] one `bt`.  A task is one
// 128-column half h and a skew T: lane l takes columns n0 = 128 h + 4 l ..
// + 3 of the 16 k rows of group g = (T + (l / 2) % 4) % 8, so over T = 0..7
// every lane covers every group once.  Its reads of a k row are word l of
// the warp's 32 (no bank conflict whatever its row); its four 16-byte
// results (column n0 + s, chunk g at swizzled position g ^ (n % 8)) land,
// for each s, on 8 distinct 16-byte bank groups in each 8-lane store
// phase (the skew: (l / 2) % 4 and the column's n % 8 / 4 span the 8
// positions).  8 byte permutes a 4 x 4 byte block.
__device__ __forceinline__ void transpose_k_tile(const unsigned char* raw,
                                                 unsigned char* bt, int tw) {
  const int lane = threadIdx.x & 31;
  for (int task = tw; task < 2 * KB / 16; task += TRANSPOSERS) {
    const int g = ((task >> 1) + ((lane >> 1) & 3)) & 7;
    const int n0 = 128 * (task & 1) + 4 * lane;
    unsigned o[4][4];  // o[s][q]: column n0 + s, k 16 g + 4 q .. + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const unsigned*>(
            raw + (16 * g + 4 * q + r) * BN + n0);
      // the 4 x 4 byte transpose: byte r of o[s][q] = byte s of w[r]
      const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
      const unsigned t1 = __byte_perm(w[0], w[1], 0x7362);
      const unsigned t2 = __byte_perm(w[2], w[3], 0x5140);
      const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
      o[0][q] = __byte_perm(t0, t2, 0x5410);
      o[1][q] = __byte_perm(t0, t2, 0x7632);
      o[2][q] = __byte_perm(t1, t3, 0x5410);
      o[3][q] = __byte_perm(t1, t3, 0x7632);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = n0 + s;
      *reinterpret_cast<uint4*>(bt + n * KB + ((g ^ (n & 7)) << 4)) =
          make_uint4(o[s][0], o[s][1], o[s][2], o[s][3]);
    }
  }
}

// The transposer warps' walk: every k-tile the producer stages, in its
// order (`tiles` output tiles of n_kt k-tiles each).
template <class C>
__device__ __forceinline__ void transposer(Smem<C>& sm, int tiles, int n_kt,
                                           int tw) {
  const bool lead = (threadIdx.x & 31) == 0;
  Ring<C::NS> ring;
  Ring<C::NTS> tring;
  for (int i = 0; i < tiles * n_kt; ++i) {
    mbar_wait(&sm.full[ring.stage], ring.phase);
    mbar_wait(&sm.tempty[tring.stage], tring.phase ^ 1u);
    transpose_k_tile(sm.raw[ring.stage], sm.b[tring.stage], tw);
    fence_proxy_async_shared();  // the stores, before wgmma reads them
    __syncwarp();
    if (lead) {
      mbar_arrive(&sm.tfull[tring.stage]);
      mbar_arrive(&sm.empty[ring.stage]);  // its staged B is read
    }
    ring.next();
    tring.next();
  }
}

// One k16 (bf16) / k32 (int8) step kk of a consumer's product.
template <bool I8, bool B_NK>
__device__ __forceinline__ void mma_step(
    typename Cfg<I8, B_NK>::Acc (&acc)[Cfg<I8, B_NK>::NACC],
    const unsigned char* a, const unsigned char* b, int kk, int accumulate) {
  const uint64_t da = desc_sw128(a + 32 * kk, 16, 1024);
  if constexpr (I8) {
    wgmma_ss_s8_n256(acc, da, desc_sw128(b + 32 * kk, 16, 1024), accumulate);
  } else if constexpr (B_NK) {
    wgmma_ss_n256<0>(acc, da, desc_sw128(b + 32 * kk, 16, 1024), accumulate);
  } else {
    wgmma_ss_n256<1>(acc, da, desc_sw128(b + 2048 * kk, 64 * KB, 1024),
                     accumulate);
  }
}

// A consumer warpgroup's hold on one k-tile: its TMA stage and (int8) its
// transposed B tile.
template <class C>
struct Held {
  int st = -1, tt = -1;
};

template <class C>
__device__ __forceinline__ void release(Smem<C>& sm, const Held<C>& h) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(&sm.empty[h.st]);
    if (Smem<C>::I8) mbar_arrive(&sm.tempty[h.tt]);
  }
}

// A consumer warpgroup (cw = 0, 1): the product of its 64 rows of one
// output tile over n_kt k-tiles into acc.  A k-tile is released once the
// next one's products are issued and its own have completed (one wgmma
// group in flight).
template <bool I8, bool B_NK>
__device__ __forceinline__ void mma_tile(
    typename Cfg<I8, B_NK>::Acc (&acc)[Cfg<I8, B_NK>::NACC],
    Smem<Cfg<I8, B_NK>>& sm, Ring<Cfg<I8, B_NK>::NS>& ring,
    Ring<Cfg<I8, B_NK>::NTS>& tring, int n_kt, int cw) {
  using C = Cfg<I8, B_NK>;
  Held<C> prev;
  for (int kt = 0; kt < n_kt; ++kt) {
    Held<C> cur;
    cur.st = ring.stage;
    mbar_wait(&sm.full[cur.st], ring.phase);
    if (I8) {
      cur.tt = tring.stage;
      mbar_wait(&sm.tfull[cur.tt], tring.phase);
    }
    wgmma_fence();
    const unsigned char* a = sm.a[cur.st] + cw * 64 * KB;
    const unsigned char* b = sm.b[I8 ? cur.tt : cur.st];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_step<I8, B_NK>(acc, a, b, kk, kt > 0 || kk > 0);
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();
      release(sm, prev);
    }
    prev = cur;
    ring.next();
    if (I8) tring.next();
  }
  wgmma_wait<0>();
  fence_regs(acc);
  release(sm, prev);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void store2(int* p, int x, int y) {
  *reinterpret_cast<int2*>(p) = make_int2(x, y);
}

// A consumer's rows of the tile at c (its row 0, column 0 of C; row
// stride ldc), straight from the accumulator: thread (warp w, lane)
// holds rows 64 cw + 16 w + lane / 4 (+ 8) and column pairs 8 j + 2
// (lane % 4) of the tile's columns col0..; rows >= `rows` and columns >=
// n are dropped (n even).
template <bool I8, bool B_NK, class OutT>
__device__ __forceinline__ void store_tile(
    const typename Cfg<I8, B_NK>::Acc (&acc)[Cfg<I8, B_NK>::NACC], OutT* c,
    long long ldc, int rows, int n, int col0, int cw) {
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * cw + 16 * warp + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    OutT* dst = c + r * ldc + col0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      if (col0 + 8 * j + 2 * (lane & 3) < n)
        store2(dst + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

}  // namespace tdt_gemm90
