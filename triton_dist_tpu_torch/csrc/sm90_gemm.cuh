// A warp-specialised GEMM mainloop for Hopper (sm_90a) on the wgmma / TMA
// pieces of sm90.cuh, for kernels that walk their own list of output
// tiles (the ring GEMMs of ag_gemm.cu, gemm_rs.cu, ag_group_gemm.cu and
// moe_rs.cu), and on it the persistent GEMM of gemm.cu, group_gemm.cu and
// matmul_i8.cu (`persistent_gemm`, at the end).
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
//
// The int8 tile may instead be 256 x 128 (Cfg's TALL): each consumer
// takes 128 rows, two m64n128k32 products a k-step on one transposed B
// tile of [128 n][128 B], so a transposed byte serves twice the rows
// (A 32 KB + staged B 16 KB a TMA stage, 176 KB).  The transposers set
// the int8 rate, and this shape ran the int8 GEMM 1.2x faster (PERF.md
// rows 8 and 9).
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

// TALL: the 256 x 128 int8 tile (see the top of the file).
template <bool I8, bool B_NK, bool TALL = false>
struct Cfg {
  static_assert(!(I8 && B_NK), "int8 B is [K][n]");
  static_assert(I8 || !TALL, "the 256 x 128 tile is int8's");
  using T = typename std::conditional<I8, int8_t, __nv_bfloat16>::type;
  using Acc = typename std::conditional<I8, int, float>::type;
  static constexpr int TM = TALL ? 2 * BM : BM;  // tile rows
  static constexpr int TN = TALL ? BN / 2 : BN;  // tile columns
  static constexpr int SUB = TM / BM;  // m64 products a consumer a k-step
  static constexpr int BK = KB / static_cast<int>(sizeof(T));
  static constexpr int NS = I8 ? 3 : 4;     // TMA stages
  static constexpr int NTS = I8 ? 2 : 1;    // transposed B tiles (int8)
  static constexpr int A_BYTES = TM * KB;
  static constexpr int B_BYTES = TN * KB;
  static constexpr unsigned TX = A_BYTES + B_BYTES;  // TMA bytes a stage
  static constexpr int NACC = SUB * TN / 2;  // 64 SUB x TN / 128 threads
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
  // int8: B as TMA stages it, [BK][TN]
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
// with B_NK) at columns col0.. of rank `rank`; with `slab` >= 0 (bf16 B
// [K][n] only) from the 4-D map {n, K, slabs, W} over rank-stacked slab
// stacks, slab `slab` of rank `rank`.
template <bool I8, bool B_NK, bool TALL = false, class LoadA>
__device__ __forceinline__ void produce_k_tile(
    Smem<Cfg<I8, B_NK, TALL>>& sm, Ring<Cfg<I8, B_NK, TALL>::NS>& ring,
    const CUtensorMap* bmap, int col0, int kt, int rank, LoadA load_a,
    int slab = -1) {
  using C = Cfg<I8, B_NK, TALL>;
  const int st = ring.stage;
  mbar_wait(&sm.empty[st], ring.phase ^ 1u);
  mbar_arrive_tx(&sm.full[st], C::TX);
  const int k0 = kt * C::BK;
  load_a(sm.a[st], &sm.full[st], k0);
  if (I8) {
    tma_load_3d(sm.raw[st], bmap, &sm.full[st], col0, k0, rank);
  } else if (B_NK) {
    tma_load_3d(sm.b[st], bmap, &sm.full[st], k0, col0, rank);
  } else if (slab >= 0) {
#pragma unroll
    for (int q = 0; q < C::TN / 64; ++q)
      tma_load_4d(sm.b[st] + q * 64 * KB, bmap, &sm.full[st], col0 + 64 * q,
                  k0, slab, rank);
  } else {
#pragma unroll
    for (int q = 0; q < C::TN / 64; ++q)
      tma_load_3d(sm.b[st] + q * 64 * KB, bmap, &sm.full[st], col0 + 64 * q,
                  k0, rank);
  }
  ring.next();
}

// int8: transposer warp tw (0..2) turns the staged [128 k][TN n] B tile
// `raw` into the K-major swizzled [TN n][128 B] one `bt`.  A task is one
// 128-column half h and a skew T: lane l takes columns n0 = 128 h + 4 l ..
// + 3 of the 16 k rows of group g = (T + (l / 2) % 4) % 8, so over T = 0..7
// every lane covers every group once.  Its reads of a k row are word l of
// the warp's 32 (no bank conflict whatever its row); its four 16-byte
// results (column n0 + s, chunk g at swizzled position g ^ (n % 8)) land,
// for each s, on 8 distinct 16-byte bank groups in each 8-lane store
// phase (the skew: (l / 2) % 4 and the column's n % 8 / 4 span the 8
// positions).  8 byte permutes a 4 x 4 byte block.
template <int TN>
__device__ __forceinline__ void transpose_k_tile(const unsigned char* raw,
                                                 unsigned char* bt, int tw) {
  constexpr int H = TN / 128;  // 128-column halves
  const int lane = threadIdx.x & 31;
  for (int task = tw; task < H * KB / 16; task += TRANSPOSERS) {
    const int g = (task / H + ((lane >> 1) & 3)) & 7;
    const int n0 = 128 * (task % H) + 4 * lane;
    unsigned o[4][4];  // o[s][q]: column n0 + s, k 16 g + 4 q .. + 3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const unsigned*>(
            raw + (16 * g + 4 * q + r) * TN + n0);
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
    transpose_k_tile<C::TN>(sm.raw[ring.stage], sm.b[tring.stage], tw);
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
template <bool I8, bool B_NK, bool TALL = false>
__device__ __forceinline__ void mma_step(
    typename Cfg<I8, B_NK, TALL>::Acc (&acc)[Cfg<I8, B_NK, TALL>::NACC],
    const unsigned char* a, const unsigned char* b, int kk, int accumulate) {
  const uint64_t da = desc_sw128(a + 32 * kk, 16, 1024);
  if constexpr (TALL) {  // rows 0-63 and 64-127 of the consumer's 128
    const uint64_t db = desc_sw128(b + 32 * kk, 16, 1024);
    wgmma_ss_s8_n128(*reinterpret_cast<int(*)[64]>(acc), da, db,
                     accumulate);
    wgmma_ss_s8_n128(*reinterpret_cast<int(*)[64]>(acc + 64),
                     desc_sw128(a + 64 * KB + 32 * kk, 16, 1024), db,
                     accumulate);
  } else if constexpr (I8) {
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
template <bool I8, bool B_NK, bool TALL = false>
__device__ __forceinline__ void mma_tile(
    typename Cfg<I8, B_NK, TALL>::Acc (&acc)[Cfg<I8, B_NK, TALL>::NACC],
    Smem<Cfg<I8, B_NK, TALL>>& sm, Ring<Cfg<I8, B_NK, TALL>::NS>& ring,
    Ring<Cfg<I8, B_NK, TALL>::NTS>& tring, int n_kt, int cw) {
  using C = Cfg<I8, B_NK, TALL>;
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
    const unsigned char* a = sm.a[cur.st] + cw * (C::TM / 2) * KB;
    const unsigned char* b = sm.b[I8 ? cur.tt : cur.st];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_step<I8, B_NK, TALL>(acc, a, b, kk, kt > 0 || kk > 0);
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// The two bf16 halves of a packed word (pack_bf16's), as f32.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The accumulator's fragment order: a consumer's value pairs of its m64
// product i and column tile j (8 columns) are v = i (TN / 8) + j, held
// at acc[4 v], acc[4 v + 1] (row frag_row(v), columns frag_col(v) and
// + 1 of the tile) and acc[4 v + 2], acc[4 v + 3] (row frag_row(v) + 8,
// the same columns): thread (warp w, lane) of consumer cw holds rows TM /
// 2 cw + 64 i + 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1).
template <class C>
__device__ __forceinline__ int frag_row(int v, int cw) {
  const int wt = threadIdx.x & 127;
  return C::TM / 2 * cw + 64 * (v / (C::TN / 8)) + 16 * (wt >> 5) +
         ((wt & 31) >> 2);
}

template <class C>
__device__ __forceinline__ int frag_col(int v) {
  return 8 * (v % (C::TN / 8)) + 2 * (threadIdx.x & 3);
}

// A consumer's rows of the tile at c (its row 0, column 0 of C; row
// stride ldc), straight from the accumulator in fragment order, at the
// tile's columns col0..; rows >= `rows` and columns >= n are dropped (n
// even).
template <bool I8, bool B_NK, bool TALL = false, class OutT>
__device__ __forceinline__ void store_tile(
    const typename Cfg<I8, B_NK, TALL>::Acc (&acc)[Cfg<I8, B_NK, TALL>::NACC],
    OutT* c, long long ldc, int rows, int n, int col0, int cw) {
  using C = Cfg<I8, B_NK, TALL>;
#pragma unroll
  for (int i = 0; i < C::SUB; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int v0 = i * (C::TN / 8);
      const int r = frag_row<C>(v0, cw) + 8 * h;
      if (r >= rows) continue;
      OutT* dst = c + r * ldc + col0;
#pragma unroll
      for (int j = 0; j < C::TN / 8; ++j) {
        const int v = v0 + j, col = frag_col<C>(v);
        if (col0 + col < n)
          store2(dst + col, acc[4 * v + 2 * h], acc[4 * v + 2 * h + 1]);
      }
    }
}

// ------------------------------------------------------ persistent GEMM

// The persistent kernels' tile order: output tile t of tiles_m x tiles_n,
// walked in groups of `group` consecutive row tiles and, within a group,
// column band by column band.  The ~132 tiles in flight then share one A
// stripe (group x 128 rows) and ~132 / group B bands, where a row-major
// walk (group 1) would put every band of B under one wave.
struct TileRC {
  int row, col;
};

__host__ __device__ __forceinline__ TileRC tile_rc(int t, int tiles_m,
                                                   int tiles_n, int group) {
  const int g0 = t / (group * tiles_n) * group;
  const int rows = tiles_m - g0 < group ? tiles_m - g0 : group;
  const int r = t - g0 * tiles_n;
  return {g0 + r % rows, r / rows};
}

// One launch of the persistent GEMM: C [M][N] = A [M][K] @ B, row tile i
// (`rows` rows from row i x rows) against slab `slab[i x rows / slab_rows]`
// of the stacked B (slab 0 where `slab` is null), B [K][N] each (the
// mainloop's MN-major bf16 or staged int8 tile) or [N][K] (B_NK); C
// int32 in int8, bf16 or f32 (OutT) from bf16, rounded once from the f32
// accumulator.
struct Gemm {
  CUtensorMap amap;  // A {K, M, 1}: [BK][128-row] boxes, 128-byte swizzle
  CUtensorMap bmap;  // B {N, K, slabs}, or {K, N, slabs} (B_NK)
  const int* slab;   // [M / slab_rows] or null
  void* c;           // [M][N]: OutT
  int M, N, K, rows, slab_rows, tiles_m, tiles_n, group;
};

// The kernel body (one block an SM, NT threads, smem_bytes<C>() of
// dynamic shared memory at `raw`): every block walks tiles t = blockIdx.x,
// t += gridDim.x in tile_rc's order.  The producer's lane 0 loads each
// tile's k-tiles into the ring with no break between tiles, so it loads
// tile t + gridDim.x while the consumers still multiply and store tile t;
// in int8 producer warps 1-3 transpose every staged B tile.  No block
// waits on another: a plain launch.
template <bool I8, bool B_NK, bool TALL = false,
          class OutT =
              typename std::conditional<I8, int, __nv_bfloat16>::type>
__device__ __forceinline__ void persistent_gemm(const Gemm& p, char* raw) {
  using C = Cfg<I8, B_NK, TALL>;
  static_assert(!I8 || std::is_same<OutT, int>::value, "int8 C is int32");
  auto& sm = smem_of<C>(raw);
  if (threadIdx.x == 0) init_barriers(sm);
  __syncthreads();
  const int tiles = p.tiles_m * p.tiles_n;
  const int n_kt = (p.K + C::BK - 1) / C::BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x < 128) {
    regs_dealloc<C::PRODUCER_REGS>();
    if (warp == 0) {
      if ((threadIdx.x & 31) == 0) {
        Ring<C::NS> ring;
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          const TileRC x = tile_rc(t, p.tiles_m, p.tiles_n, p.group);
          const int row0 = x.row * p.rows;
          const int e = p.slab ? p.slab[row0 / p.slab_rows] : 0;
          for (int kt = 0; kt < n_kt; ++kt)
            produce_k_tile<I8, B_NK, TALL>(
                sm, ring, &p.bmap, x.col * C::TN, kt, e,
                [&](void* dst, uint64_t* bar, int k0) {
                  tma_load_3d(dst, &p.amap, bar, k0, row0, 0);
                });
        }
      }
      __syncwarp();
    } else if (I8) {
      const int mine = static_cast<int>(blockIdx.x) < tiles
                           ? (tiles - blockIdx.x - 1) / gridDim.x + 1
                           : 0;
      transposer<C>(sm, mine, n_kt, warp - 1);
    }
  } else {
    regs_alloc<C::CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    Ring<C::NS> ring;
    Ring<C::NTS> tring;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileRC x = tile_rc(t, p.tiles_m, p.tiles_n, p.group);
      const int row0 = x.row * p.rows;
      typename C::Acc acc[C::NACC];
      mma_tile<I8, B_NK, TALL>(acc, sm, ring, tring, n_kt, cw);
      store_tile<I8, B_NK, TALL>(
          acc, static_cast<OutT*>(p.c) + static_cast<long long>(row0) * p.N,
          p.N, min(p.rows, p.M - row0), p.N, x.col * C::TN, cw);
    }
  }
}

// Host: encode the maps of `p` (A [M][K]; B `slabs` slabs `slab_elems`
// elements apart), size its tiles and launch `kernel` (persistent_gemm's
// __global__ wrapper) on min(tiles, SMs) blocks.  p.slab, p.c,
// p.slab_rows and p.rows set by the caller.  Returns a cudaError_t, or
// MAP_ERROR.
template <bool I8, bool B_NK, bool TALL = false, class Kern>
int launch_gemm(Kern kernel, Gemm& p, const void* a, const void* b, int M,
                int N, int K, long long slabs, long long slab_elems,
                int group, unsigned& attr_set, cudaStream_t stream) {
  using C = Cfg<I8, B_NK, TALL>;
  // make the device's context current on this thread before the encodes:
  // an autograd worker thread may not have one yet (PyTorch sets its
  // device only if it differs), and cuTensorMapEncodeTiled then fails
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaSetDevice(dev);
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.tiles_m = (M + p.rows - 1) / p.rows;
  p.tiles_n = (N + C::TN - 1) / C::TN;
  const CUtensorMapDataType dt =
      I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int E = I8 ? 1 : 2;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const long long ad[3] = {K, M, 1}, as[3] = {1, K, 1LL * M * K};
  const int abox[3] = {C::BK, C::TM, 1};
  int err = make_map_t(&p.amap, dt, E, sw, a, 3, ad, as, abox);
  if (err) return err;
  if (B_NK) {  // [n][K] slabs: K-major boxes of 256 rows
    const long long bd[3] = {K, N, slabs}, bs[3] = {1, K, slab_elems};
    const int bbox[3] = {C::BK, C::TN, 1};
    err = make_map_t(&p.bmap, dt, E, sw, b, 3, bd, bs, bbox);
  } else {     // [K][n] slabs: bf16 64-column boxes; int8 the raw tile
    const long long bd[3] = {N, K, slabs}, bs[3] = {1, N, slab_elems};
    const int bbox[3] = {I8 ? C::TN : 64, C::BK, 1};
    err = make_map_t(&p.bmap, dt, E, I8 ? CU_TENSOR_MAP_SWIZZLE_NONE : sw,
                     b, 3, bd, bs, bbox);
  }
  if (err) return err;
  const int smem = smem_bytes<C>();
  if (!(attr_set & (1u << dev))) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set |= 1u << dev;
  }
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = p.tiles_m * p.tiles_n;
  if (tiles == 0) return 0;
  kernel<<<tiles < sms ? tiles : sms, NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tdt_gemm90
