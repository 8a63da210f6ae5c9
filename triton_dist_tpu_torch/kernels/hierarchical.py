"""Hierarchical (two-tier, slow x fast) collectives.

Counterpart of ``triton_dist_tpu/kernels/hierarchical.py`` on the port's
virtual world (``runtime/bootstrap.Mesh``; per-rank tensors carry the mesh
shape as leading dimensions).  The hierarchy is a composition of the
per-axis kernels with an order-restoring relayout:

- all-gather: the slow axis first, then the fast one, blocks restored to
  flat (slow, fast) order (``hier_all_gather_shard``);
- reduce-scatter: the fast axis first, then the slow one; rank (i, j)
  holds flat band j D + i (``hier_rs_band_index``);
- all-reduce (``hier_all_reduce_shard``): reduce-scatter over the fast
  tier (``kernels/reduce_scatter.py``, the bidirectional ring kernel on
  the card), the slow tier's ``psum`` on the 1/T band (a torch sum over
  that mesh dimension: the reference's is XLA's, so no kernel is owed),
  all-gather over the fast tier (``kernels/allgather.py``: the full-mesh
  push at T 2, the bidirectional ring at T >= 4 past 256 KB per rank);
- ``hier_grad_allreduce``: a tree of per-rank gradients bucketed into ONE
  f32 [n, 128] plane per rank (padded to a multiple of 128 T rows), the
  all-reduce above, each leaf cut out and cast back to its dtype;
- ``hier_all_to_all_shard``: the two-stage token all-to-all (every token
  crosses the slow tier once), each stage on the expert-parallel kernel
  ``csrc/all_to_all.cu`` (``tdt_a2a``) with bundles compacted first
  (``_compact_bundles``).  The kernel's world is one group, so each stage
  launches once per group of its axis: T launches over the slow axis,
  then D over the fast one, D + T per call.  The split counts ride the
  plain shuffle (the reference's ``impl="xla"`` side channel).

``AUTO`` and ``plain``: the reference resolves its methods to XLA off the
TPU (:230-234); the port treats the card as the reference's chip, so on a
CUDA tensor ``AUTO`` picks the kernels, and on a CPU tensor it runs the
kernels' plain versions in the same order.  ``plain=True`` is the
reference's non-interpret CPU path (the XLA methods).
"""

from __future__ import annotations

import math

import torch

from triton_dist_tpu_torch.kernels.all_to_all import fast_all_to_all_shard
from triton_dist_tpu_torch.kernels.allgather import (
    AllGatherMethod,
    all_gather_shard,
)
from triton_dist_tpu_torch.kernels.reduce_scatter import (
    ReduceScatterMethod,
    reduce_scatter_shard,
    resolve_method,
)
from triton_dist_tpu_torch.runtime.bootstrap import Mesh
from triton_dist_tpu_torch.runtime.utils import tree_leaves, tree_map

__all__ = [
    "hier_all_gather_shard",
    "hier_all_reduce_shard",
    "hier_all_to_all_shard",
    "hier_grad_allreduce",
    "hier_reduce_scatter_shard",
    "hier_rs_band_index",
]


def hier_all_gather_shard(x, mesh: Mesh, *, slow_axis: str, fast_axis: str,
                          slow_method=AllGatherMethod.RING_1D,
                          fast_method=AllGatherMethod.AUTO,
                          plain: bool = False):
    """Two-tier all-gather: x [*mesh.shape, rows, ...], each rank's shard
    of an array sharded over (slow, fast), slow-major -> the whole array
    [*mesh.shape, D T rows, ...] in flat order on every rank."""
    nd = len(mesh.shape)
    rows, tail = x.shape[nd], x.shape[nd + 1:]
    d, t = mesh.axis_size(slow_axis), mesh.axis_size(fast_axis)
    x = all_gather_shard(x, mesh, slow_axis, slow_method, plain=plain)
    x = all_gather_shard(x, mesh, fast_axis, fast_method, plain=plain)
    # blocks are [fast][slow]-major: restore flat (slow, fast) order
    x = x.reshape(*mesh.shape, t, d, rows, *tail).transpose(nd, nd + 1)
    return x.reshape(*mesh.shape, d * t * rows, *tail)


def hier_rs_band_index(mesh: Mesh, slow_axis: str, fast_axis: str):
    """The flat band each rank holds after
    :func:`hier_reduce_scatter_shard`: j D + i for rank (i, j), an int64
    tensor of the mesh's shape."""
    return (mesh.axis_index(fast_axis) * mesh.axis_size(slow_axis)
            + mesh.axis_index(slow_axis))


def hier_reduce_scatter_shard(x, mesh: Mesh, *, slow_axis: str,
                              fast_axis: str,
                              slow_method=ReduceScatterMethod.RING_1D,
                              fast_method=ReduceScatterMethod.AUTO,
                              plain: bool = False):
    """Two-tier reduce-scatter of every rank's full-size partial x
    [*mesh.shape, D T rows, ...] -> the rank's band of the sum (band
    :func:`hier_rs_band_index` of D T)."""
    x = reduce_scatter_shard(x, mesh, fast_axis, fast_method, plain=plain)
    return reduce_scatter_shard(x, mesh, slow_axis, slow_method, plain=plain)


def hier_all_reduce_shard(x, mesh: Mesh, *, slow_axis: str, fast_axis: str,
                          fast_rs=ReduceScatterMethod.AUTO,
                          fast_ag=AllGatherMethod.AUTO, plain: bool = False):
    """Two-tier all-reduce, the slow-tier-optimal gradient reduction:
    reduce-scatter over the fast tier, the slow tier's psum on the 1/T
    band, all-gather over the fast tier.  x [*mesh.shape, rows, ...] with
    rows % T == 0 is every rank's full-size partial; returns the total,
    on every rank."""
    if fast_rs is ReduceScatterMethod.AUTO:
        fast_rs = resolve_method(plain)
    if fast_ag is AllGatherMethod.AUTO and plain:
        fast_ag = AllGatherMethod.XLA
    t = mesh.axis_size(fast_axis)
    if t > 1:
        x = reduce_scatter_shard(x, mesh, fast_axis, fast_rs, plain=plain)
    s = mesh.dim(slow_axis)
    x = x.sum(dim=s, keepdim=True).expand(x.shape).contiguous()
    if t > 1:
        x = all_gather_shard(x, mesh, fast_axis, fast_ag, plain=plain)
    return x


def hier_grad_allreduce(grads, mesh: Mesh, *, slow_axis: str,
                        fast_axis: str, plain: bool = False):
    """Tree-wide two-tier gradient all-reduce: every leaf of ``grads`` is a
    per-rank partial [*mesh.shape, *leaf_shape] (any strides, an expanded
    view too); the leaves are flattened into ONE f32 plane per rank,
    [*mesh.shape, n / 128, 128] padded to a multiple of 128 T rows, reduced
    by :func:`hier_all_reduce_shard`, and cut back into leaves of their
    shapes and dtypes (the total, on every rank)."""
    nd = len(mesh.shape)
    leaves = tree_leaves(grads)
    n = sum(math.prod(g.shape[nd:]) for g in leaves)
    row = 128 * mesh.axis_size(fast_axis)
    device = leaves[0].device if leaves else mesh.device
    plane = torch.zeros((*mesh.shape, n + (-n) % row), dtype=torch.float32,
                        device=device)
    offsets, off = {}, 0
    for g in leaves:
        size = math.prod(g.shape[nd:])
        plane[..., off:off + size].copy_(g.reshape(*mesh.shape, size))
        offsets[id(g)] = off
        off += size
    del leaves
    plane = hier_all_reduce_shard(plane.view(*mesh.shape, -1, 128), mesh,
                                  slow_axis=slow_axis, fast_axis=fast_axis,
                                  plain=plain).view(*mesh.shape, -1)

    def cut(g):
        o, size = offsets[id(g)], math.prod(g.shape[nd:])
        return plane[..., o:o + size].reshape(g.shape).to(g.dtype)

    return tree_map(cut, grads)


def _compact_bundles(bundle, inner_splits, tokens):
    """Pack each bundle's valid rows into a contiguous prefix: bundle [G,
    S, H] with S = L tokens (L inner segments, lane-major), inner_splits
    [G, L] the valid rows of each segment -> (compacted bundle, valid rows
    first in lane-major order, zeros after; bundle_splits [G] int32, the
    valid rows of each bundle).  Row (lane, off) goes to cum_prev[lane] +
    off, the mirror of :func:`_uncompact_bundles`."""
    G, S, _ = bundle.shape
    ar = torch.arange(S, device=bundle.device)
    lane, off = ar // tokens, ar % tokens
    inner = inner_splits.long()
    valid = off[None, :] < inner[:, lane]                       # [G, S]
    cum_prev = torch.cumsum(inner, dim=1) - inner
    pos = cum_prev[:, lane] + off[None, :]
    g = torch.arange(G, device=bundle.device)[:, None].expand(G, S)
    comp = torch.zeros_like(bundle)
    comp[g[valid], pos[valid]] = bundle[valid]
    return comp, valid.sum(dim=1).to(torch.int32)


def _uncompact_bundles(comp, inner_splits, tokens):
    """The inverse at the receiver: the valid prefix scattered back into
    the padded lane-major layout, padding rows ZERO; ``inner_splits`` are
    the received per-segment counts [G, L]."""
    G, S, _ = comp.shape
    L = S // tokens
    cum = torch.cumsum(inner_splits.long(), dim=1)               # [G, L]
    k = torch.arange(S, device=comp.device)
    lane = (k[None, :, None] >= cum[:, None, :]).sum(dim=2)      # [G, S]
    prev = torch.where(lane > 0, torch.gather(
        cum, 1, (lane - 1).clamp(min=0)), torch.zeros_like(lane))
    pos = lane.clamp(max=L - 1) * tokens + (k[None, :] - prev)
    valid = k[None, :] < cum[:, -1:]
    g = torch.arange(G, device=comp.device)[:, None].expand(G, S)
    out = torch.zeros_like(comp)
    out[g[valid], pos[valid]] = comp[valid]
    return out


def _group_a2a(send, splits, plain):
    """The flat all-to-all inside every group of an axis: send [n_groups,
    n, n, S, H] (group g's rank-stacked send), splits [n_groups, n, n] ->
    recv of the same shape, one ``fast_all_to_all_shard`` per group."""
    return torch.stack([fast_all_to_all_shard(s, sp, plain=plain)[0]
                        for s, sp in zip(send, splits)])


def hier_all_to_all_shard(send, splits, mesh: Mesh, *, slow_axis: str,
                          fast_axis: str, plain: bool = False):
    """Two-tier token all-to-all over a mesh of exactly (slow_axis,
    fast_axis), flat rank r = i T + j: send [D, T, W, tokens, H] (rank r's
    row block p goes to flat rank p), splits [D, T, W] int32 -> (recv [D,
    T, W, tokens, H], rank r's block s from flat rank s; recv_splits [D,
    T, W]).  Bundles are compacted before each hop, so the kernel moves
    bytes in proportion to the tokens; padding rows come out ZERO (the
    flat kernel leaves its tail undefined)."""
    if mesh.axis_names != (slow_axis, fast_axis):
        raise ValueError(f"hier_all_to_all_shard: the mesh's axes "
                         f"{mesh.axis_names} must be ({slow_axis!r}, "
                         f"{fast_axis!r})")
    D, T = mesh.shape
    W = D * T
    if send.shape[:3] != (D, T, W) or tuple(splits.shape) != (D, T, W):
        raise ValueError(f"hier_all_to_all_shard: send {tuple(send.shape)} "
                         f"must be [{D}, {T}, {W}, tokens, H], splits "
                         f"{tuple(splits.shape)} [{D}, {T}, {W}]")
    tokens, H = send.shape[3:]
    splits = splits.to(torch.int32)

    # stage 1 (slow): rank (i, j) bundles its rows by destination slice p
    # and ships bundle p to rank (p, j); each group j is one kernel world
    comp1, bs1 = _compact_bundles(send.reshape(W * D, T * tokens, H),
                                  splits.reshape(W * D, T), tokens)
    # [j, i(src), p(dst), ...]
    s1c = _group_a2a(comp1.view(D, T, D, T * tokens, H).transpose(0, 1),
                     bs1.view(D, T, D).transpose(0, 1), plain)
    # side channel: rank (p, j) receives from (i, j) the T inner splits
    # of its slice: sp1[p, j, i, q] = splits[i, j, p * T + q]
    sp1 = splits.view(D, T, D, T).permute(2, 1, 0, 3)
    s1 = _uncompact_bundles(s1c.transpose(0, 1).reshape(W * D, T * tokens, H),
                            sp1.reshape(W * D, T), tokens)
    # s1 at rank (p, j): [i, q, tokens, H], the tokens of rank (i, j) for
    # lane q of slice p; regroup by destination lane q for stage 2
    s1 = s1.view(D, T, D, T, tokens, H)
    stage2 = s1.permute(0, 1, 3, 2, 4, 5).reshape(W * T, D * tokens, H)
    inner2 = sp1.permute(0, 1, 3, 2)                        # [p, j, q, i]
    comp2, bs2 = _compact_bundles(stage2, inner2.reshape(W * T, D), tokens)
    # stage 2 (fast): within slice p, rank (p, j) ships bundle q to (p, q)
    s2c = _group_a2a(comp2.view(D, T, T, D * tokens, H),
                     bs2.view(D, T, T), plain)             # [p, q, j, ...]
    sp2 = inner2.transpose(1, 2)                            # [p, q, j, i]
    s2 = _uncompact_bundles(s2c.reshape(W * T, D * tokens, H),
                            sp2.reshape(W * T, D), tokens)
    # s2 at rank (p, q): [j, i, tokens, H] from rank (i, j): flat i T + j
    recv = s2.view(D, T, T, D, tokens, H).transpose(2, 3)
    recv_splits = sp2.transpose(2, 3).reshape(D, T, W)
    return recv.reshape(D, T, W, tokens, H), recv_splits.contiguous()
