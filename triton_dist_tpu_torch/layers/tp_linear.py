"""Differentiable sequence-parallel tensor-parallel linears.

Counterpart of ``triton_dist_tpu/layers/tp_linear.py`` (:38-107) on the
port's virtual world: every operand carries a leading rank dimension
(rank r's shard is ``x[r]``) and one kernel call serves every rank.

* **column-parallel** (QKV, gate/up): a [W, m_loc, K] sequence-sharded
  activation, b [W, K, n_loc] column-sharded weight -> [W, W m_loc, n_loc]:
  the AG-GEMM (``kernels/allgather_gemm.py``).
* **row-parallel** (attention out, down): a [W, W m_loc, k_loc]
  feature-sharded activation, b [W, k_loc, N] row-sharded weight ->
  [W, m_loc, N] summed over the ranks: the GEMM-RS
  (``kernels/gemm_reduce_scatter.py``).

The backward passes are each other's duals, as the reference's custom
VJPs:

  column:  dA = GEMM-RS(dC, B^T),          dB = A_full^T dC
  row:     (dC_full, dA) = AG-GEMM(dC, B^T), dB = A^T dC_full

B^T is the weight read in place by the kernels' transposed mode.  The
local dB products stay ``torch.matmul`` (the reference computes them with
``jnp.dot`` in f32, cast to the weight's dtype; PyTorch's bf16 product
accumulates in f32 and rounds once).

At world 1 (2-D operands) both linears are ``torch.matmul``, as the
reference's auto dispatch takes XLA's dot there
(``allgather_gemm.py:730-748``, ``gemm_reduce_scatter.py:712-721``), so
the world-1 paths keep their numerics.  ``plain`` runs the kernels' plain
versions on any device.

The W8A8 serving variants (:115-153; no backward) quantize activations per
row and contract int8 exactly:

* column-parallel: each rank's rows quantize before the gather, so the
  AG-GEMM's int8 mode moves int8 and returns the exact int32 product; the
  row scales gather alongside (the reference's ``all_gather`` of the
  [m_loc] scales: here the rank-stacked [W, m_loc] scales read in rank
  order, no kernel owed), and the rank-1 dequant follows in the
  reference's order;
* row-parallel: a local ``matmul_i8`` per rank, dequantized per rank (its
  rows' and its weight chunk's scales), then the reference's f32
  ``psum_scatter`` as a sum over the ranks in rank order (no kernel owed:
  the reference uses ``lax.psum_scatter``).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_shard
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs_shard
from triton_dist_tpu_torch.kernels.quant import (
    matmul_i8,
    matmul_i8_ref,
    quantize_rowwise,
)


def _local_dw(a, dc, dtype):
    """Per-rank a[r]^T @ dc[r], accumulated in f32, in the weight's dtype."""
    return torch.matmul(a.transpose(1, 2), dc).to(dtype)


class ColumnParallelLinearFn(torch.autograd.Function):
    """C = AG(A) @ B; saves the gathered A for dB."""

    @staticmethod
    def forward(ctx, a, b, plain):
        a_full, c = ag_gemm_shard(a, b, plain=plain)
        ctx.save_for_backward(a_full, b)
        ctx.plain = plain
        return c

    @staticmethod
    def backward(ctx, dc):
        a_full, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = gemm_rs_shard(dc, b, trans_b=True, plain=ctx.plain)
        return da, _local_dw(a_full, dc, b.dtype), None


class RowParallelLinearFn(torch.autograd.Function):
    """C = RS(A @ B); the backward's AG-GEMM gathers dC once for dA and
    dB."""

    @staticmethod
    def forward(ctx, a, b, plain):
        ctx.save_for_backward(a, b)
        ctx.plain = plain
        return gemm_rs_shard(a, b, plain=plain)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc_full, da = ag_gemm_shard(dc.contiguous(), b, trans_b=True,
                              plain=ctx.plain)
        return da, _local_dw(a, dc_full, b.dtype), None


def _apply(fn, kernel, a, b, plain):
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return fn.apply(a, b, plain)
    return kernel(a, b, plain=plain)


def column_parallel_linear(a, b, *, plain: bool = False):
    """[W, m_loc, K] x [W, K, n_loc] -> [W, W m_loc, n_loc] through the
    AG-GEMM; [m, K] x [K, n] -> a @ b at world 1."""
    if a.dim() == 2:
        return a @ b
    return _apply(ColumnParallelLinearFn, lambda x, w, plain: ag_gemm_shard(
        x, w, plain=plain)[1], a, b, plain)


def row_parallel_linear(a, b, *, plain: bool = False):
    """[W, W m_loc, k_loc] x [W, k_loc, N] -> [W, m_loc, N] through the
    GEMM-RS; [m, k] x [k, N] -> a @ b at world 1."""
    if a.dim() == 2:
        return a @ b
    return _apply(RowParallelLinearFn, gemm_rs_shard, a, b, plain)


def rank_sum(parts, dtype):
    """The reference's ``psum`` over the ranks of a rank-stacked tensor
    [W, ...]: the W partials added in f32 in rank order, cast to ``dtype``
    once (f32 partials: exactly the rank-order sum)."""
    total = parts[0].float()
    for r in range(1, parts.shape[0]):
        total = total + parts[r].float()
    return total.to(dtype)


def column_parallel_linear_w8a8(a, w_q, w_scale, *, plain: bool = False):
    """a [W, m_loc, K] float x int8 w_q [W, K, n_loc] with per-channel
    ``w_scale`` [W, n_loc] -> [W, W m_loc, n_loc] in a's dtype: per-row
    quant of every rank's rows, the AG-GEMM's int8 mode (exact int32),
    ``acc * a_scale_full[:, None] * w_scale[None, :]`` in f32."""
    world, m_loc, k = a.shape
    a_q, a_scale = quantize_rowwise(a.reshape(world * m_loc, k))
    _, acc = ag_gemm_shard(a_q.reshape(world, m_loc, k), w_q, plain=plain)
    y = acc.float() * a_scale[None, :, None] * w_scale[:, None, :]
    return y.to(a.dtype)


def row_parallel_linear_w8a8(a, w_q, w_scale, *, plain: bool = False):
    """a [W, M, k_loc] float x int8 w_q [W, k_loc, N] quantized per output
    channel per rank (``w_scale`` [W, N], rank r's row its own) -> [W,
    M / W, N] in a's dtype: each rank's exact local product, dequantized
    with its own scales, then chunk r of the W f32 partials summed in rank
    order (the cross-rank sum needs dequantized partials: every rank's
    int32 partial carries other scales)."""
    world, rows, _ = a.shape
    if rows % world:
        raise ValueError(f"row_parallel_linear_w8a8: {rows} rows do not "
                         f"split into {world} chunks")
    mm = matmul_i8_ref if plain else matmul_i8
    parts = []
    for r in range(world):
        a_q, a_scale = quantize_rowwise(a[r])
        acc = mm(a_q, w_q[r])
        parts.append(acc.float() * a_scale[:, None] * w_scale[r][None, :])
    parts = torch.stack(parts).reshape(world, world, rows // world, -1)
    return rank_sum(parts, a.dtype)
