"""Latency-tuned all-gather: one-shot full-mesh push, one or two levels,
and the (out, lse) payload packing.

Counterpart of ``triton_dist_tpu/kernels/low_latency_allgather.py`` on the
port's virtual world (``runtime/bootstrap.Mesh``; per-rank tensors carry
the mesh shape as leading dimensions).  The gather is the full-mesh push
of ``kernels/allgather.py`` (``csrc/allgather.cu``, mode ``full_mesh``)
on CUDA tensors, its plain version (a concatenation) on CPU tensors or
with ``impl="xla"``; two levels gather ``axis`` first, then
``inter_axis`` (slow-major flat order, the reference's push-2D staging).
``impl`` is "auto" (the kernel), "kernel" (the reference's "pallas") or
"xla".
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.allgather import (
    AllGatherMethod,
    all_gather_shard,
    shard_over,
)
from triton_dist_tpu_torch.runtime.bootstrap import Mesh

IMPLS = ("auto", "kernel", "xla")


@dataclass
class FastAllGatherContext:
    """Counterpart of the reference's context (:46)."""

    mesh: Mesh
    axis: str = "tp"
    inter_axis: str | None = None
    impl: str = "auto"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl {self.impl!r} is not one of {IMPLS}")

    @property
    def world(self) -> int:
        w = self.mesh.axis_size(self.axis)
        if self.inter_axis:
            w *= self.mesh.axis_size(self.inter_axis)
        return w


def create_fast_ag_context(mesh, axis="tp", inter_axis=None,
                           impl="auto") -> FastAllGatherContext:
    return FastAllGatherContext(mesh=mesh, axis=axis, inter_axis=inter_axis,
                                impl=impl)


def fast_allgather_shard(x, mesh: Mesh, *, axis="tp", inter_axis=None,
                         impl="auto"):
    """Gather every rank's small shard x [*mesh.shape, rows, ...] over
    ``axis`` (then ``inter_axis``) with the one-shot full-mesh push ->
    [*mesh.shape, world * rows, ...]."""
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} is not one of {IMPLS}")
    method = (AllGatherMethod.XLA if impl == "xla"
              else AllGatherMethod.FULL_MESH_PUSH)
    out = all_gather_shard(x, mesh, axis, method)
    if inter_axis is not None:
        out = all_gather_shard(out, mesh, inter_axis, method)
    return out


def fast_allgather(x, ctx: FastAllGatherContext):
    """Host entry (reference :106): x [world * rows, ...] sharded over
    ``(inter_axis, axis)`` (slow-major) or ``axis`` -> the gathered array
    (rank 0's copy)."""
    axes = (ctx.inter_axis, ctx.axis) if ctx.inter_axis else ctx.axis
    out = fast_allgather_shard(shard_over(x, ctx.mesh, axes), ctx.mesh,
                               axis=ctx.axis, inter_axis=ctx.inter_axis,
                               impl=ctx.impl)
    return out[(0,) * len(ctx.mesh.shape)]


def pack_payload(out, lse):
    """[B, H, D] partials + [B, H] lse -> [B, H, D + 1], one buffer."""
    return torch.cat([out, lse[..., None]], dim=-1)


def unpack_payload(buf):
    """[W, B, H, D + 1] -> ([W, B, H, D], [W, B, H])."""
    return buf[..., :-1], buf[..., -1]
