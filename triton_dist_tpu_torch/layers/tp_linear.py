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
versions on any device.  The W8A8 variants (:115-153) are not ported.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import gemm_rs


def _local_dw(a, dc, dtype):
    """Per-rank a[r]^T @ dc[r], accumulated in f32, in the weight's dtype."""
    return torch.matmul(a.transpose(1, 2), dc).to(dtype)


class ColumnParallelLinearFn(torch.autograd.Function):
    """C = AG(A) @ B; saves the gathered A for dB."""

    @staticmethod
    def forward(ctx, a, b, plain):
        a_full, c = ag_gemm(a, b, plain=plain)
        ctx.save_for_backward(a_full, b)
        ctx.plain = plain
        return c

    @staticmethod
    def backward(ctx, dc):
        a_full, b = ctx.saved_tensors
        dc = dc.contiguous()
        da = gemm_rs(dc, b, trans_b=True, plain=ctx.plain)
        return da, _local_dw(a_full, dc, b.dtype), None


class RowParallelLinearFn(torch.autograd.Function):
    """C = RS(A @ B); the backward's AG-GEMM gathers dC once for dA and
    dB."""

    @staticmethod
    def forward(ctx, a, b, plain):
        ctx.save_for_backward(a, b)
        ctx.plain = plain
        return gemm_rs(a, b, plain=plain)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        dc_full, da = ag_gemm(dc.contiguous(), b, trans_b=True,
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
    return _apply(ColumnParallelLinearFn, lambda x, w, plain: ag_gemm(
        x, w, plain=plain)[1], a, b, plain)


def row_parallel_linear(a, b, *, plain: bool = False):
    """[W, W m_loc, k_loc] x [W, k_loc, N] -> [W, m_loc, N] through the
    GEMM-RS; [m, k] x [k, N] -> a @ b at world 1."""
    if a.dim() == 2:
        return a @ b
    return _apply(RowParallelLinearFn, gemm_rs, a, b, plain)


def column_parallel_linear_w8a8(*args, **kwargs):
    raise NotImplementedError(
        "W8A8 column-parallel linear: the tensor-parallel half of quantized "
        "serving is not ported yet (ROADMAP Queue 1 item 9)")


def row_parallel_linear_w8a8(*args, **kwargs):
    raise NotImplementedError(
        "W8A8 row-parallel linear: the tensor-parallel half of quantized "
        "serving is not ported yet (ROADMAP Queue 1 item 9)")
