"""Overlapped AllGather-GEMM: the column-parallel projection of tensor
parallelism (and the row-parallel one's backward), in bf16 and in int8.

Counterpart of ``triton_dist_tpu/kernels/allgather_gemm.py``'s
``ag_gemm_shard`` (:642) over ``_ag_gemm_kernel`` (:240), its
uni-directional ring.  The port runs a world of W ranks on one device
(``runtime/bootstrap.py``): every per-rank operand carries a leading rank
dimension, and one call serves every rank.  For each rank r, given its
rows A_r [m_loc, K] and its weight shard B_r [K, n], the result is the
gathered A_full [W m_loc, K] (rank s's rows at segment s) and C_r = A_full
@ B_r [W m_loc, n].  ``trans_b`` takes B_r^T from a weight stored
[n, K] (the row-parallel backward's ``b_shard.T``), read in place.  As in
the reference (:700-705), A's dtype picks the mode: int8 A and B give the
exact int32 C of the W8A8 column-parallel linear (the gather moves int8).

- :func:`ag_gemm_ref`: the plain version: the concatenation of the ranks'
  rows, then one f32 product per rank cast to A's dtype, or for int8 the
  exact int32 product (``quant.matmul_i8_ref``).
- :func:`ag_gemm`: on CUDA tensors it launches ``csrc/ag_gemm.cu``
  (``tdt_ag_gemm`` for bf16: the ranks' segments pushed into every rank's
  gathered buffer with a flag per 128-row tile, the GEMM tiles starting on
  each rank's own segment; int8 goes to :func:`ag_gemm_i8`) over the
  world's symmetric workspace and counts the launch, or raises on what the
  kernel does not take; on CPU tensors (or with ``plain``) the plain
  version.
- :func:`ag_gemm_i8`: the int8 mode (``tdt_ag_gemm_i8``, the same pushes
  and flags per 64-row tile, the int8 tile loop of ``csrc/i8_tile.cuh``),
  with its own launch count.

Any ``m_loc >= 1`` is taken: the last tile of each segment is masked to
its rows, as the reference runs any row count (its Pallas kernel at
``m_loc % 8 == 0``, its XLA path otherwise, :715-728).  The reference's
``bm`` / ``bn`` / ``bk``, ``chunks``, ``wire_dtype`` and ``ring_mode``
have no counterpart here: the kernel's tiles are its own, its schedule is
a full mesh (NVLink joins every card of a host to every other), and the
int8 wire, the chunked forward and the bidirectional ring are not ported
(ROADMAP Queue 2).  World 1 goes through the kernel as well (one rank, one
segment); the tensor-parallel linears take ``torch.matmul`` there, as the
reference's auto dispatch takes XLA's dot.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.quant import matmul_i8_ref
from triton_dist_tpu_torch.runtime.bootstrap import MAX_RANKS, get_world
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

TILE_M = 128     # csrc/bf16_tile.cuh BM: rows of one segment tile
TILE_M_I8 = 64   # csrc/i8_tile.cuh BM: the int8 mode's
_RING_SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_uint]
             + [ctypes.c_void_p])
_SIG = {"tdt_ag_gemm": _RING_SIG,
        "tdt_ag_gemm_i8": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                           + [ctypes.c_uint] + [ctypes.c_void_p])}


def check_operands(name, a, b, trans_b):
    """The rank-stacked operands' shapes: a [W, rows, K] against b
    [W, K, n] (or [W, n, K] with ``trans_b``); returns (W, K, n)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be rank-stacked [W, ., .]")
    world, k = a.shape[0], a.shape[2]
    kb, n = (b.shape[2], b.shape[1]) if trans_b else (b.shape[1],
                                                      b.shape[2])
    if kb != k:
        raise ValueError(f"{name}: contraction {k} of a against {kb} of b"
                         f"{' (transposed)' if trans_b else ''}")
    return world, k, n


def check_kernel_operands(name, a, b, m_loc, k, n, *, dtype=torch.bfloat16,
                          k_mult=8, n_mult=8):
    """What the ring kernels take, else a raise: ``dtype`` operands on one
    device, at most MAX_RANKS ranks, any m_loc >= 1 (each segment's row
    tail is masked), k % ``k_mult`` == 0 and n % ``n_mult`` == 0 (whole
    16-byte rows; the int8 mode asks 32 and 16, its tile's)."""
    if b.device != a.device:
        raise ValueError(f"{name}: b on {b.device}, a on {a.device}")
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"{name} kernel takes {dtype} operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.shape[0] > MAX_RANKS:
        raise ValueError(f"{name} kernel: at most {MAX_RANKS} ranks, got "
                         f"{a.shape[0]}")
    if m_loc < 1 or k % k_mult or n % n_mult or k == 0 or n == 0:
        mults = (f"{k_mult}" if k_mult == n_mult
                 else f"{k_mult} and {n_mult}")
        raise ValueError(f"{name} kernel: rows per rank {m_loc} must be "
                         f"positive, K={k} and N={n} positive multiples of "
                         f"{mults}")


def ring_tables(*tensors):
    """One ctypes pointer table per rank-stacked tensor."""
    return [(ctypes.c_longlong * t.shape[0])(*peer_table(t))
            for t in tensors]


def _check_mode(a, b, trans_b):
    """int8 A takes int8 B and no ``trans_b`` (the W8A8 path has no
    backward); returns whether the int8 mode is asked for."""
    int8 = a.dtype == torch.int8
    if int8 and (b.dtype != torch.int8 or trans_b):
        raise ValueError(f"ag_gemm: int8 a takes an int8 b [W, K, n] "
                         f"without trans_b, got {b.dtype}"
                         f"{' with trans_b' if trans_b else ''}")
    return int8


def ag_gemm_ref(a, b, *, trans_b: bool = False):
    """Plain (A_full [W, W m_loc, K], C [W, W m_loc, n]): A_full is the
    ranks' rows concatenated (the same on every rank: an expanded view),
    C[r] = A_full @ b[r] (``@ b[r]^T`` with ``trans_b``) in f32, cast to
    a's dtype; int8 a and b give the exact int32 C."""
    world, k, _ = check_operands("ag_gemm", a, b, trans_b)
    int8 = _check_mode(a, b, trans_b)
    a_full = a.reshape(world * a.shape[1], k)
    bt = b.transpose(1, 2) if trans_b else b
    if int8:
        c = torch.stack([matmul_i8_ref(a_full, bt[r]) for r in range(world)])
    else:
        c = torch.stack([(a_full.float() @ bt[r].float()).to(a.dtype)
                         for r in range(world)])
    return a_full.expand(world, -1, -1), c


def _launch(entry, a, b, n, c_dtype, tile_m, flag_name, *extra):
    """One cooperative launch of ``entry`` for every rank: the gathered A
    and C [W, W m_loc, n] allocated, flags per (segment, ``tile_m``-row
    tile) and barrier slots from the world's workspace, this call's
    epoch; ``extra``: the entry's arguments after k."""
    world, m_loc, k = a.shape
    ws = get_world(world, a.device).workspace
    flags = ws.flags(flag_name, world * -(-m_loc // tile_m))
    bar = ws.flags("barrier", world)
    a_full = torch.empty((world, world * m_loc, k), dtype=a.dtype,
                         device=a.device)
    c = torch.empty((world, world * m_loc, n), dtype=c_dtype,
                    device=a.device)
    epoch = ws.next_epoch()
    lib = _build.load("ag_gemm", _SIG)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            *ring_tables(a, b, a_full, c, flags, bar), world, m_loc, n, k,
            *extra, epoch, stream)
    _build.check(err, entry[4:])
    return a_full, c


def ag_gemm(a, b, *, trans_b: bool = False, plain: bool = False):
    """(A_full [W, W m_loc, K], C [W, W m_loc, n]) of rank-stacked a
    [W, m_loc, K] and b [W, K, n] (``trans_b``: b [W, n, K], the product
    taking b[r]^T); int8 a and b take the int8 mode (:func:`ag_gemm_i8`,
    int32 C)."""
    _, k, n = check_operands("ag_gemm", a, b, trans_b)
    if _check_mode(a, b, trans_b):
        return ag_gemm_i8(a, b, plain=plain)
    if plain or a.device.type == "cpu":
        return ag_gemm_ref(a, b, trans_b=trans_b)
    if not a.is_cuda:
        raise ValueError(f"ag_gemm: unsupported device {a.device}")
    check_kernel_operands("ag_gemm", a, b, a.shape[1], k, n)
    out = _launch("tdt_ag_gemm", a.contiguous(), b.contiguous(), n,
                  a.dtype, TILE_M, "ag_gemm", int(trans_b))
    ag_gemm.launches += 1
    return out


def ag_gemm_i8(a, b, *, plain: bool = False):
    """The int8 mode: (A_full [W, W m_loc, K] int8, C [W, W m_loc, n]
    int32, exact) of rank-stacked int8 a [W, m_loc, K] and b [W, K, n].
    CUDA operands launch ``tdt_ag_gemm_i8`` (K % 32 == 0, n % 16 == 0,
    any m_loc); CPU operands (or ``plain``) run :func:`ag_gemm_ref`."""
    _, k, n = check_operands("ag_gemm_i8", a, b, False)
    if plain or a.device.type == "cpu":
        return ag_gemm_ref(a, b)
    if not a.is_cuda:
        raise ValueError(f"ag_gemm_i8: unsupported device {a.device}")
    check_kernel_operands("ag_gemm_i8", a, b, a.shape[1], k, n,
                          dtype=torch.int8, k_mult=32, n_mult=16)
    out = _launch("tdt_ag_gemm_i8", a.contiguous(), b.contiguous(), n,
                  torch.int32, TILE_M_I8, "ag_gemm_i8")
    ag_gemm_i8.launches += 1
    return out


ag_gemm.launches = 0
ag_gemm_i8.launches = 0
