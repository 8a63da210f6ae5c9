"""Overlapped GEMM-ReduceScatter: the row-parallel projection of tensor
parallelism (and the column-parallel one's backward).

Counterpart of ``triton_dist_tpu/kernels/gemm_reduce_scatter.py``'s
``gemm_rs_shard`` (:657) over ``_gemm_rs_kernel`` (:103), its
uni-directional ring, on the port's virtual world (every per-rank operand
carries a leading rank dimension; one call serves every rank).  Rank q
holds A_q [W m_loc, k] (every row, its shard of the contraction) and B_q
[k, N]; rank r gets C_r = sum over q of A_q[rows of chunk r] @ B_q,
[m_loc, N].  ``trans_b`` takes B_q^T from a weight stored [N, k] (the
column-parallel backward's ``b_shard.T``), read in place.

Rounding: each rank's partial is staged in A's dtype, as the reference
stages in its ``out_dtype`` (:764-772); the W partials are then summed in
f32 in the fixed order q = 0 .. W-1 and rounded once.  The reference's
ring adds in the staging dtype at every hop (``_add_body``, :100), W - 1
roundings in a rank-dependent order: with bf16 operands the two differ by
bf16 rounding; in f32 they agree to f32 rounding.

- :func:`gemm_rs_ref`: the plain version with the same staging, order and
  rounding.
- :func:`gemm_rs`: on CUDA tensors it launches ``csrc/gemm_rs.cu`` (bf16;
  every rank's partial tiles pushed into the owner's staging slots with a
  flag per tile, each owner reducing its chunk) over the world's symmetric
  workspace and counts the launch, or raises on what the kernel does not
  take; on CPU tensors (or with ``plain``) the plain version.  Any
  ``m_loc >= 1`` is taken: the last row tile of each chunk is masked.

As for the AG-GEMM, the reference's block sizes and ``ring_mode`` have no
counterpart (full-mesh schedule; the bidirectional ring is not ported).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    TILE_M,
    _RING_SIG,
    check_kernel_operands,
    check_operands,
    ring_tables,
)
from triton_dist_tpu_torch.runtime.bootstrap import get_world

_SIG = {"tdt_gemm_rs": _RING_SIG}


def _m_loc(a):
    world, rows = a.shape[0], a.shape[1]
    if rows % world:
        raise ValueError(f"gemm_rs: {rows} rows do not split into {world} "
                         f"chunks")
    return rows // world


def gemm_rs_ref(a, b, *, trans_b: bool = False):
    """Plain C [W, m_loc, N]: each rank's partial a[q] @ b[q] (``b[q]^T``
    with ``trans_b``) in f32, staged in a's dtype; chunk r of the W partials
    summed in f32 in rank order, cast to a's dtype."""
    world, _, n = check_operands("gemm_rs", a, b, trans_b)
    m_loc = _m_loc(a)
    bt = b.transpose(1, 2) if trans_b else b
    total = None
    for q in range(world):
        part = (a[q].float() @ bt[q].float()).to(a.dtype)
        part = part.reshape(world, m_loc, n).float()
        total = part if total is None else total + part
    return total.to(a.dtype)


def gemm_rs(a, b, *, trans_b: bool = False, plain: bool = False):
    """C [W, m_loc, N] of rank-stacked a [W, W m_loc, k] and b [W, k, N]
    (``trans_b``: b [W, N, k], the product taking b[q]^T)."""
    world, k, n = check_operands("gemm_rs", a, b, trans_b)
    m_loc = _m_loc(a)
    if plain or a.device.type == "cpu":
        return gemm_rs_ref(a, b, trans_b=trans_b)
    if not a.is_cuda:
        raise ValueError(f"gemm_rs: unsupported device {a.device}")
    check_kernel_operands("gemm_rs", a, b, m_loc, k, n)
    a, b = a.contiguous(), b.contiguous()
    w = get_world(world, a.device)
    ws = w.workspace
    tiles = -(-m_loc // TILE_M) * -(-n // TILE_M)   # 128 x 128 tiles
    stage = ws.get("gemm_rs_stage", (world, m_loc, n), a.dtype)
    flags = ws.flags("gemm_rs", world * tiles)
    bar = ws.flags("barrier", world)
    out = torch.empty((world, m_loc, n), dtype=a.dtype, device=a.device)
    epoch = ws.next_epoch()
    lib = _build.load("gemm_rs", _SIG)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdt_gemm_rs(*ring_tables(a, b, stage, out, flags, bar),
                              world, m_loc, n, k, int(trans_b), epoch,
                              stream)
    _build.check(err, "gemm_rs")
    gemm_rs.launches += 1
    return out


gemm_rs.launches = 0
