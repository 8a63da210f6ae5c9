"""Overlapped AllGather-GEMM: the column-parallel projection of tensor
parallelism (and the row-parallel one's backward).

Counterpart of ``triton_dist_tpu/kernels/allgather_gemm.py``'s
``ag_gemm_shard`` (:642) over ``_ag_gemm_kernel`` (:240), its
uni-directional ring.  The port runs a world of W ranks on one device
(``runtime/bootstrap.py``): every per-rank operand carries a leading rank
dimension, and one call serves every rank.  For each rank r, given its
rows A_r [m_loc, K] and its weight shard B_r [K, n], the result is the
gathered A_full [W m_loc, K] (rank s's rows at segment s) and C_r = A_full
@ B_r [W m_loc, n].  ``trans_b`` takes B_r^T from a weight stored
[n, K] (the row-parallel backward's ``b_shard.T``), read in place.

- :func:`ag_gemm_ref`: the plain version: the concatenation of the ranks'
  rows, then one f32 product per rank, cast to A's dtype.
- :func:`ag_gemm`: on CUDA tensors it launches ``csrc/ag_gemm.cu``
  (bf16; the ranks' segments pushed into every rank's gathered buffer
  with a flag per 128-row tile, the GEMM tiles starting on each rank's own
  segment) over the world's symmetric workspace and counts the launch, or
  raises on what the kernel does not take; on CPU tensors (or with
  ``plain``) the plain version.

The reference's ``bm`` / ``bn`` / ``bk``, ``chunks``, ``wire_dtype`` and
``ring_mode`` have no counterpart here: the kernel's tiles are its own,
its schedule is a full mesh (NVLink joins every card of a host to every
other), and the int8 wire, the chunked forward and the bidirectional ring
are not ported (ROADMAP Queue 2).  World 1 goes through the kernel as
well (one rank, one segment); the tensor-parallel linears take
``torch.matmul`` there, as the reference's auto dispatch takes XLA's dot.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.bootstrap import MAX_RANKS, get_world
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

TILE_M = 128     # csrc/bf16_tile.cuh BM: rows of one segment tile
_RING_SIG = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_uint]
             + [ctypes.c_void_p])
_SIG = {"tdt_ag_gemm": _RING_SIG}


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


def check_kernel_operands(name, a, b, m_loc, k, n):
    """What the ring kernels take, else a raise: bf16 on one device, at
    most MAX_RANKS ranks, m_loc % 128 == 0 (a tile lies in one segment),
    k % 8 == 0 and n % 8 == 0 (16-byte rows)."""
    if b.device != a.device:
        raise ValueError(f"{name}: b on {b.device}, a on {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.shape[0] > MAX_RANKS:
        raise ValueError(f"{name} kernel: at most {MAX_RANKS} ranks, got "
                         f"{a.shape[0]}")
    if m_loc % TILE_M or k % 8 or n % 8 or m_loc == 0 or k == 0 or n == 0:
        raise ValueError(f"{name} kernel: rows per rank {m_loc} must be a "
                         f"positive multiple of {TILE_M}, K={k} and N={n} "
                         f"positive multiples of 8")


def ring_tables(*tensors):
    """One ctypes pointer table per rank-stacked tensor."""
    return [(ctypes.c_longlong * t.shape[0])(*peer_table(t))
            for t in tensors]


def ag_gemm_ref(a, b, *, trans_b: bool = False):
    """Plain (A_full [W, W m_loc, K], C [W, W m_loc, n]): A_full is the
    ranks' rows concatenated (the same on every rank: an expanded view),
    C[r] = A_full @ b[r] (``@ b[r]^T`` with ``trans_b``) in f32, cast to
    a's dtype."""
    world, k, _ = check_operands("ag_gemm", a, b, trans_b)
    a_full = a.reshape(world * a.shape[1], k)
    bt = b.transpose(1, 2) if trans_b else b
    c = torch.stack([(a_full.float() @ bt[r].float()).to(a.dtype)
                     for r in range(world)])
    return a_full.expand(world, -1, -1), c


def ag_gemm(a, b, *, trans_b: bool = False, plain: bool = False):
    """(A_full [W, W m_loc, K], C [W, W m_loc, n]) of rank-stacked a
    [W, m_loc, K] and b [W, K, n] (``trans_b``: b [W, n, K], the product
    taking b[r]^T)."""
    world, k, n = check_operands("ag_gemm", a, b, trans_b)
    if plain or a.device.type == "cpu":
        return ag_gemm_ref(a, b, trans_b=trans_b)
    if not a.is_cuda:
        raise ValueError(f"ag_gemm: unsupported device {a.device}")
    m_loc = a.shape[1]
    check_kernel_operands("ag_gemm", a, b, m_loc, k, n)
    a, b = a.contiguous(), b.contiguous()
    w = get_world(world, a.device)
    ws = w.workspace
    flags = ws.flags("ag_gemm", world * (m_loc // TILE_M))
    bar = ws.flags("barrier", world)
    a_full = torch.empty((world, world * m_loc, k), dtype=a.dtype,
                         device=a.device)
    c = torch.empty((world, world * m_loc, n), dtype=a.dtype,
                    device=a.device)
    epoch = ws.next_epoch()
    lib = _build.load("ag_gemm", _SIG)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdt_ag_gemm(*ring_tables(a, b, a_full, c, flags, bar),
                              world, m_loc, n, k, int(trans_b), epoch,
                              stream)
    _build.check(err, "ag_gemm")
    ag_gemm.launches += 1
    return a_full, c


ag_gemm.launches = 0
