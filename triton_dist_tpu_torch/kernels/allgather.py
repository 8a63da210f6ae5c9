"""All-gather over one axis of a mesh: ring, bidirectional ring, full-mesh
push.

Counterpart of ``triton_dist_tpu/kernels/allgather.py`` on the port's
virtual world (``runtime/bootstrap.Mesh``): per-rank tensors carry the
mesh shape as leading dimensions, x ``[*mesh.shape, rows, ...]`` (rank
r's shard at its coordinates) and the result ``[*mesh.shape, T * rows,
...]``, where every rank holds its group's T shards in coordinate order
along ``axis`` (``lax.all_gather(x, axis, tiled=True)``).  One call serves
every group of the axis.

- :func:`all_gather_ref`: the plain version, a concatenation.
- :func:`all_gather_shard`: the reference's dispatch.  ``AUTO`` picks by
  :func:`choose_allgather_method` (the reference's thresholds); ``bidir``
  on odd rows takes ``ring`` (:216-217); an axis of one rank returns its
  input; ``TORUS_2D`` on one axis is ``bidir`` (:272-273).  A tuple
  ``axis`` with two or more axes of more than one rank (:240-263) is a
  joint group, gathered in flat axes-major order: ``AUTO`` takes the
  torus kernel (``kernels/torus.py``) above 64 KiB a rank and XLA's joint
  gather (the plain version) at or below it, and every other method but
  ``XLA`` is the torus kernel; a tuple with one real axis is that axis.
  On CUDA
  tensors the three methods launch ``csrc/allgather.cu`` in its modes
  ``ring`` / ``bidir`` / ``full_mesh`` (the port of the TPU
  ``_ring_ag_kernel`` :109, ``_bidir_ring_ag_kernel`` :146 and
  ``_full_mesh_push_ag_kernel`` :185), each launch counted in
  ``all_gather_shard.launches`` and by mode in ``.mode_launches``, or
  raises on what the kernel does not take; the result is bit for bit the
  plain version's.  On CPU tensors, with ``plain``, or for the method
  ``XLA``, the plain version.
- :class:`AllGatherContext`, :func:`create_allgather_context`,
  :func:`all_gather` (the host entry: the global array in, the gathered
  array out).

``AUTO`` on the card: the reference's host entry resolves ``AUTO`` to
``XLA`` off the TPU (:289); the port treats the card as the reference's
chip, so ``AUTO`` picks the kernels there.  The launches carry a host
epoch, so none can be
captured in a CUDA graph.  The kernel pushes into the peers' outputs,
which are allocated per call, outside the world's symmetric workspace:
their peer table works only because the virtual world's ranks are slices
of one allocation.  A multi-process backend has to take them from
symmetric memory (ROADMAP Queue 1's tenth entry).
"""

from __future__ import annotations

import ctypes
import enum
import math
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels import _build, torus
from triton_dist_tpu_torch.runtime.bootstrap import Mesh, as_axes
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

_SIG = {"tdt_allgather": [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_void_p],
        "tdt_allgather_flags": [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int]}


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"
    RING_BIDIR = "ring_bidir"
    FULL_MESH_PUSH = "full_mesh_push"
    TORUS_2D = "torus_2d"


# the kernel's mode of each method (csrc/allgather.cu `Mode`)
MODES = {AllGatherMethod.RING_1D: (0, "ring"),
         AllGatherMethod.RING_BIDIR: (1, "bidir"),
         AllGatherMethod.FULL_MESH_PUSH: (2, "full_mesh")}


def choose_allgather_method(nbytes_per_rank: int, n_ranks: int,
                            axis_sizes: tuple[int, ...] | None = None
                            ) -> AllGatherMethod:
    """The reference's selection (:54-83): a bandwidth-bound gather over
    two or more real axes takes the torus schedule, a latency-bound one
    (<= 64 KiB) XLA's joint gather; on one axis, two ranks or small
    messages (<= 256 KiB) the full-mesh push, else the bidirectional
    ring."""
    if axis_sizes is not None:
        real = [s for s in axis_sizes if s > 1]
        if len(real) >= 2:
            if nbytes_per_rank > 64 * 1024:
                return AllGatherMethod.TORUS_2D
            return AllGatherMethod.XLA
    if n_ranks <= 2:
        return AllGatherMethod.FULL_MESH_PUSH
    if nbytes_per_rank <= 256 * 1024:
        return AllGatherMethod.FULL_MESH_PUSH
    return AllGatherMethod.RING_BIDIR


@dataclass
class AllGatherContext:
    """Counterpart of the reference's context (:86): the mesh, the axis
    and the method; ``plain`` takes the plain version on any device (the
    reference's non-interpret CPU path)."""

    mesh: Mesh
    axis: str = "tp"
    method: AllGatherMethod = AllGatherMethod.AUTO
    plain: bool = False

    @property
    def world(self) -> int:
        return self.mesh.joint_size(self.axis)


def create_allgather_context(mesh, axis="tp", method=AllGatherMethod.AUTO,
                             plain=False) -> AllGatherContext:
    return AllGatherContext(mesh=mesh, axis=axis, method=method, plain=plain)


def _check(x, mesh: Mesh):
    nd = len(mesh.shape)
    if x.dim() <= nd or tuple(x.shape[:nd]) != mesh.shape:
        raise ValueError(f"all_gather: x {tuple(x.shape)} must be "
                         f"[*{mesh.shape}, rows, ...]")


def single_axis(axis, mesh: Mesh):
    """The one real axis of ``axis`` (a name, or a tuple whose other axes
    have one rank), None when no axis has more than one rank; the caller
    routes two or more real axes to the torus schedule first."""
    if not isinstance(axis, (tuple, list)):
        return axis
    real = [a for a in axis if mesh.axis_size(a) > 1]
    assert len(real) <= 1, (axis, mesh.shape)
    return real[0] if real else None


def joint_axes(axis, mesh: Mesh):
    """The real axes of a tuple ``axis`` when two or more have more than
    one rank (the torus schedule's group), else None; more than three
    axes raise ``ValueError``."""
    if not isinstance(axis, (tuple, list)):
        return None
    real = torus.real_axes(mesh, axis, "a joint group")
    return real if len(real) >= 2 else None


def all_gather_ref(x, mesh: Mesh, axis: str):
    """The plain version: every rank's group's shards concatenated in
    coordinate order along ``axis``, [*mesh.shape, T * rows, ...]."""
    _check(x, mesh)
    nd, a, T = len(mesh.shape), mesh.dim(axis), mesh.axis_size(axis)
    g = x.movedim(a, nd - 1)               # [..others, T, rows, ...]
    g = g.reshape(*g.shape[:nd - 1], T * x.shape[nd], *x.shape[nd + 1:])
    return g.unsqueeze(a).expand(*mesh.shape, *g.shape[nd - 1:]).contiguous()


def all_gather_shard(x, mesh: Mesh, axis="tp",
                     method=AllGatherMethod.AUTO, *, plain: bool = False):
    """Gather the leading dimension of every rank's shard over ``axis``:
    x [*mesh.shape, rows, ...] -> [*mesh.shape, T * rows, ...] (module
    docstring)."""
    _check(x, mesh)
    joint = joint_axes(axis, mesh)
    if joint is not None:
        if method is AllGatherMethod.AUTO:
            nd = len(mesh.shape)
            nbytes = math.prod(x.shape[nd:]) * x.element_size()
            method = choose_allgather_method(
                nbytes, mesh.joint_size(joint),
                axis_sizes=tuple(mesh.axis_size(a) for a in as_axes(axis)))
        if method is AllGatherMethod.XLA:
            return torus.torus_all_gather_ref(x, mesh, joint)
        return torus.torus_all_gather_shard(x, mesh, joint, plain=plain)
    axis = single_axis(axis, mesh)
    if axis is None:
        return x
    nd, T = len(mesh.shape), mesh.axis_size(axis)
    if T == 1:
        return x
    rows = x.shape[nd]
    seg = math.prod(x.shape[nd:]) * x.element_size()
    if method is AllGatherMethod.AUTO:
        method = choose_allgather_method(seg, T)
    if method is AllGatherMethod.TORUS_2D:
        method = AllGatherMethod.RING_BIDIR   # one axis: torus degenerates
    if method is AllGatherMethod.XLA or plain or x.device.type == "cpu":
        return all_gather_ref(x, mesh, axis)
    if not x.is_cuda:
        raise ValueError(f"all_gather: unsupported device {x.device}")
    if method is AllGatherMethod.RING_BIDIR and rows % 2:
        method = AllGatherMethod.RING_1D
    mode, name = MODES[method]
    W = mesh.size
    xs = x.contiguous().view(W, -1)
    out = torch.empty((*mesh.shape, T * rows, *x.shape[nd + 1:]),
                      dtype=x.dtype, device=x.device)
    lib = _build.load("allgather", _SIG)
    ws = mesh.world.workspace
    flags = ws.flags("allgather", lib.tdt_allgather_flags(seg, T, mode))
    bar = ws.flags("barrier", W)
    epoch = ws.next_epoch()
    tables = [(ctypes.c_longlong * W)(*peer_table(t))
              for t in (xs, out.view(W, -1), flags, bar)]
    with torch.cuda.device(x.device):
        err = lib.tdt_allgather(*tables, seg, W, T, mesh.axis_stride(axis),
                                mode, epoch,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"allgather ({name})")
    all_gather_shard.launches += 1
    all_gather_shard.mode_launches[name] += 1
    return out


all_gather_shard.launches = 0
all_gather_shard.mode_launches = {"ring": 0, "bidir": 0, "full_mesh": 0}


def shard_over(x, mesh: Mesh, axes):
    """The per-rank tensor [*mesh.shape, rows, ...] of a global array x
    [n * rows, ...] sharded over ``axes`` (one name or a tuple, slow-major)
    and replicated over the mesh's other axes (an expanded view)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)
    sizes = [mesh.axis_size(a) for a in axes]
    n = math.prod(sizes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not shard over {axes} "
                         f"({n} ranks)")
    shards = x.reshape(*sizes, x.shape[0] // n, *x.shape[1:])
    # the sharded axes in mesh order, each at its mesh dimension
    order = sorted(range(len(axes)), key=lambda i: mesh.dim(axes[i]))
    shards = shards.permute(*order, *range(len(axes), shards.dim()))
    view = [1] * len(mesh.shape)
    for a in axes:
        view[mesh.dim(a)] = mesh.axis_size(a)
    shards = shards.reshape(*view, *shards.shape[len(axes):])
    return shards.expand(*mesh.shape, *shards.shape[len(mesh.shape):])


def all_gather(x, ctx: AllGatherContext):
    """Host entry (reference :282): x [T * rows, ...], sharded over
    ``ctx.axis`` (a tuple: flat axes-major over the joint group) -> the
    gathered [T * rows, ...] every rank holds (rank 0's copy)."""
    out = all_gather_shard(shard_over(x, ctx.mesh, ctx.axis), ctx.mesh,
                           ctx.axis, ctx.method, plain=ctx.plain)
    return out[(0,) * len(ctx.mesh.shape)]
