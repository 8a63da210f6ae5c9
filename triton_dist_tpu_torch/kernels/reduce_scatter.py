"""Reduce-scatter over one axis of a mesh: ring and bidirectional ring.

Counterpart of ``triton_dist_tpu/kernels/reduce_scatter.py`` on the port's
virtual world (``runtime/bootstrap.Mesh``): per-rank tensors carry the
mesh shape as leading dimensions, x ``[*mesh.shape, T * rows, ...]`` (every
rank's full-size partial) and the result ``[*mesh.shape, rows, ...]``,
rank c of each group along ``axis`` holding the group's sum of chunk c
(``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``).  One
call serves every group of the axis.

- :func:`reduce_scatter_ref`: the plain version, summed in the method's
  order: ``RING_1D`` and ``RING_BIDIR`` in the reference's ring order
  (chunk c starts at rank c + 1 and ends at rank c, ``acc = local +
  recv``; ``bidir`` takes the first ``rows // 2`` rows rightward and the
  rest leftward, :101-131, :160-206), so an f32 result is bit-equal to the
  interpret-mode Pallas kernels; ``XLA`` in rank order.
- :func:`reduce_scatter_shard`: the reference's dispatch, ``bidir`` at
  rows >= 2 per rank, else ``ring``; an axis of one rank returns its
  input.  On CUDA tensors ``RING_1D`` / ``RING_BIDIR`` launch
  ``csrc/reduce_scatter.cu`` in its modes ``ring`` / ``bidir`` (the port
  of the TPU ``_ring_rs_kernel`` :73 and ``_bidir_ring_rs_kernel`` :134;
  f32 and bf16), counted in ``reduce_scatter_shard.launches`` and by
  mode in ``.mode_launches``, or raises on what the kernel does not take;
  the result is bit for bit the plain version's.  On CPU tensors, with
  ``plain``, or for ``XLA``, the plain version.  A tuple ``axis`` with two
  or more axes of more than one rank (:217-226) is a joint group, its
  bands in flat axes-major order: ``XLA`` sums in joint order (the plain
  version of XLA's joint ``psum_scatter``), every other method takes the
  torus schedule (``kernels/torus.py``); a tuple with one real axis is
  that axis.
- :class:`ReduceScatterContext`, :func:`create_reduce_scatter_context`,
  :func:`resolve_method` and the host :func:`reduce_scatter` with its
  stacked-partials contract (:289-328).

``AUTO`` is :func:`resolve_method`: the bidirectional ring, unless
``plain``.  The reference resolves ``AUTO`` to ``XLA`` off the TPU; the
port treats the card as the reference's chip, so ``AUTO`` picks the
kernel there (and its ring order in the plain version on the CPU).  The
launches carry a host epoch, so none can be captured in a CUDA graph.

The fold order: :func:`ring_fold_order` is the reference's ring order for
one chunk and direction, the plain version folds by it, and the kernel
takes it from the host as a table (:func:`fold_table`).  The kernel is a
pull: each rank reads its band of chunk c from the T partials of its
group and folds them in that order, so nothing is pushed and no landing
buffer exists (the reference's ring passes running sums hop by hop); it
allocates nothing but its output.  Peers read each rank's input in
place: the virtual world's ranks are slices of one allocation, and a
multi-process backend has to put the inputs in symmetric memory and
hold each rank at a barrier on exit (ROADMAP Queue 1's tenth entry).
"""

from __future__ import annotations

import ctypes
import enum
import math
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels import _build, torus
from triton_dist_tpu_torch.kernels.allgather import (
    joint_axes,
    shard_over,
    single_axis,
)
from triton_dist_tpu_torch.runtime.bootstrap import MAX_RANKS, Mesh
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

# pointer tables (x, out, barrier), the fold table, chunk, split, row,
# dtype, world, size, stride, the epoch and the stream
_SIG = {"tdt_reduce_scatter": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 5 + [ctypes.c_uint, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"
    RING_BIDIR = "ring_bidir"


@dataclass
class ReduceScatterContext:
    """Counterpart of the reference's context (:46); ``plain`` is its
    non-interpret CPU path (``XLA``)."""

    mesh: Mesh
    axis: str = "tp"
    method: ReduceScatterMethod = ReduceScatterMethod.AUTO
    plain: bool = False

    @property
    def world(self) -> int:
        return self.mesh.joint_size(self.axis)


def create_reduce_scatter_context(mesh, axis="tp",
                                  method=ReduceScatterMethod.AUTO,
                                  plain=False) -> ReduceScatterContext:
    return ReduceScatterContext(mesh=mesh, axis=axis, method=method,
                                plain=plain)


def resolve_method(plain: bool = False) -> ReduceScatterMethod:
    """``AUTO``: the bidirectional ring, or ``XLA`` when ``plain``."""
    return ReduceScatterMethod.XLA if plain else ReduceScatterMethod.RING_BIDIR


def _check(x, mesh: Mesh, T: int):
    nd = len(mesh.shape)
    if x.dim() <= nd or tuple(x.shape[:nd]) != mesh.shape:
        raise ValueError(f"reduce_scatter: x {tuple(x.shape)} must be "
                         f"[*{mesh.shape}, T * rows, ...]")
    if x.shape[nd] % T:
        raise ValueError(f"reduce_scatter: {x.shape[nd]} rows do not split "
                         f"into {T} chunks")


def ring_fold_order(T: int, c: int, d: int) -> list[int]:
    """The coordinates whose partials of chunk c are folded, in order, by
    the reference's ring in direction d (+1 rightward, -1 leftward;
    :101-131, :160-206): rank c + d starts the sum, and c + 2d, ..., c
    each add their partial, ``acc = local + acc``."""
    return [(c + d * k) % T for k in range(1, T + 1)]


def fold_table(T: int) -> list[int]:
    """The kernel's fold table [MAX_RANKS][2][MAX_RANKS] flat:
    :func:`ring_fold_order` for each coordinate c < T and direction
    (rightward, leftward), zeros elsewhere."""
    if not 2 <= T <= MAX_RANKS:
        raise ValueError(f"reduce_scatter kernel: 2 .. {MAX_RANKS} ranks "
                         f"an axis, got {T}")
    table = [0] * (MAX_RANKS * 2 * MAX_RANKS)
    for c in range(T):
        for di, d in enumerate((1, -1)):
            at = (c * 2 + di) * MAX_RANKS
            table[at:at + T] = ring_fold_order(T, c, d)
    return table


def _ring_sum(xm, c, T, d, nd, r0, r1):
    """Chunk c's rows [r0, r1) summed round the ring in direction d, in
    :func:`ring_fold_order`'s order."""
    def part(src):
        return xm[src].select(nd - 1, c).narrow(nd - 1, r0, r1 - r0)

    first, *rest = ring_fold_order(T, c, d)
    acc = part(first)
    for src in rest:
        acc = part(src) + acc
    return acc


def reduce_scatter_ref(x, mesh: Mesh, axis: str,
                       method=ReduceScatterMethod.RING_BIDIR):
    """The plain version (module docstring): [*mesh.shape, rows, ...]."""
    nd, a, T = len(mesh.shape), mesh.dim(axis), mesh.axis_size(axis)
    _check(x, mesh, T)
    rows = x.shape[nd] // T
    tail = x.shape[nd + 1:]
    # [src, *others, chunk, rows, ...]
    xm = x.movedim(a, 0).reshape(T, *x.shape[:a], *x.shape[a + 1:nd], T,
                                 rows, *tail)
    bands = []
    for c in range(T):
        if method is ReduceScatterMethod.XLA:
            acc = xm[0].select(nd - 1, c)
            for s in range(1, T):
                acc = acc + xm[s].select(nd - 1, c)
        elif method is ReduceScatterMethod.RING_BIDIR and rows >= 2:
            ra = rows // 2
            acc = torch.cat([_ring_sum(xm, c, T, 1, nd, 0, ra),
                             _ring_sum(xm, c, T, -1, nd, ra, rows)],
                            dim=nd - 1)
        else:
            acc = _ring_sum(xm, c, T, 1, nd, 0, rows)
        bands.append(acc)
    return torch.stack(bands, dim=a)


def joint_sum_ref(x, mesh: Mesh, axes):
    """XLA's joint ``psum_scatter`` over the joint group ``axes``, plain:
    each rank's band of the group's partials summed in joint order in
    x's dtype, [*mesh.shape, rows, ...]."""
    nd, G = len(mesh.shape), mesh.joint_size(axes)
    _check(x, mesh, G)
    rows = x.shape[nd] // G
    xs = x.reshape(mesh.size, G, rows, *x.shape[nd + 1:])
    out = torch.empty_like(xs[:, 0])
    for group in mesh.joint_groups(axes):
        for t, r in enumerate(group):
            acc = xs[group[0], t]
            for s in group[1:]:
                acc = acc + xs[s, t]
            out[r] = acc
    return out.reshape(*mesh.shape, rows, *x.shape[nd + 1:])


def reduce_scatter_shard(x, mesh: Mesh, axis="tp",
                         method=ReduceScatterMethod.AUTO, *,
                         plain: bool = False):
    """Reduce every rank's full-size partial over ``axis`` and scatter the
    leading dimension: x [*mesh.shape, T * rows, ...] -> [*mesh.shape,
    rows, ...] (module docstring)."""
    if method is ReduceScatterMethod.AUTO:
        method = resolve_method(plain)
    joint = joint_axes(axis, mesh)
    if joint is not None:
        if method is ReduceScatterMethod.XLA:
            return joint_sum_ref(x, mesh, joint)
        return torus.torus_reduce_scatter_shard(x, mesh, joint, plain=plain)
    axis = single_axis(axis, mesh)
    if axis is None:
        return x
    nd, T = len(mesh.shape), mesh.axis_size(axis)
    _check(x, mesh, T)
    if T == 1:
        return x
    if method is ReduceScatterMethod.XLA or plain or x.device.type == "cpu":
        return reduce_scatter_ref(x, mesh, axis, method)
    if not x.is_cuda:
        raise ValueError(f"reduce_scatter: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"reduce_scatter kernel: f32 or bf16, got "
                        f"{x.dtype}")
    rows = x.shape[nd] // T
    row = math.prod(x.shape[nd + 1:])
    chunk = rows * row
    bidir = method is ReduceScatterMethod.RING_BIDIR and rows >= 2
    split = (rows // 2) * row if bidir else chunk
    W, dtype = mesh.size, _DTYPES[x.dtype]
    xs = x.contiguous().view(W, -1)
    out = torch.empty((*mesh.shape, rows, *x.shape[nd + 1:]),
                      dtype=x.dtype, device=x.device)
    order = (ctypes.c_int * (MAX_RANKS * 2 * MAX_RANKS))(*fold_table(T))
    lib = _build.load("reduce_scatter", _SIG)
    ws = mesh.world.workspace
    bar = ws.flags("barrier", W)
    epoch = ws.next_epoch()
    tables = [(ctypes.c_longlong * W)(*peer_table(t))
              for t in (xs, out.view(W, -1), bar)]
    with torch.cuda.device(x.device):
        err = lib.tdt_reduce_scatter(*tables, order, chunk, split, row,
                                     dtype, W, T, mesh.axis_stride(axis),
                                     epoch,
                                     torch.cuda.current_stream().cuda_stream)
    name = "bidir" if bidir else "ring"
    _build.check(err, f"reduce_scatter ({name})")
    reduce_scatter_shard.launches += 1
    reduce_scatter_shard.mode_launches[name] += 1
    return out


reduce_scatter_shard.launches = 0
reduce_scatter_shard.mode_launches = {"ring": 0, "bidir": 0}


def reduce_scatter(x, ctx: ReduceScatterContext):
    """Host entry (reference :289): x (T, T * rows, ...), the partials
    stacked (rank i of the axis contributes x[i]; the mesh's other axes
    hold the same; a tuple axis: i the joint index, flat axes-major) ->
    (T * rows, ...), rank i's band at rows i * rows ...  A leading
    dimension other than T raises ``ValueError``."""
    T = ctx.world
    if x.shape[0] != T:
        raise ValueError(f"expected stacked partials with leading dim {T}, "
                         f"got {tuple(x.shape)}")
    mesh = ctx.mesh
    parts = shard_over(x.reshape(T * x.shape[1], *x.shape[2:]), mesh,
                       ctx.axis)
    out = reduce_scatter_shard(parts, mesh, ctx.axis, ctx.method,
                               plain=ctx.plain)
    out = out.reshape(mesh.size, *out.shape[len(mesh.shape):])
    bands = out[mesh.joint_groups(ctx.axis)[0]]
    return bands.reshape(T * bands.shape[1], *bands.shape[2:])
