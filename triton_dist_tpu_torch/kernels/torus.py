"""All-gather and reduce-scatter over a joint group of two or three mesh
axes: the multi-axis (torus) collectives.

Counterpart of ``triton_dist_tpu/kernels/torus.py`` on the port's virtual
world (``runtime/bootstrap.Mesh``).  Per-rank tensors carry the mesh shape
as leading dimensions.  A tuple ``axes`` names a joint group: the ranks
that agree on the mesh's other axes, in flat axes-major order (``axes[0]``
slowest, whatever the mesh's own axis order), the order of
``lax.all_gather`` / ``lax.psum_scatter`` over the joint axes.  One call
serves every group.

- :func:`torus_all_gather_shard`: x ``[*mesh.shape, rows, ...]`` ->
  ``[*mesh.shape, G * rows, ...]``, every rank holding its group's G
  shards in joint order; exact.
- :func:`torus_reduce_scatter_shard`: x ``[*mesh.shape, G * rows, ...]``
  (every rank's full partial, flat axes-major) -> ``[*mesh.shape, rows,
  ...]``, each rank's band summed over its group in the reference's torus
  order and rounding: row part q of ``_split_parts(rows, 2n)`` takes path
  flavor q (``_paths_for``), whose phase l ring-reduces along axis
  ``order[l]`` in direction d, group c's sum starting at the rank c + d
  and each hop adding ``acc = local + acc`` in the tensor's dtype
  (``_fold_tiles`` :294).  So f32 and bf16 results are bit for bit the
  interpret-mode Pallas kernel's.
- :func:`torus_fold`: that order, over any values (the torus GEMM-RS of
  ``gemm_reduce_scatter.py`` folds its partials by it too).

The reference's rules: size-1 axes are dropped; one real axis takes the
1-axis dispatch (``allgather.all_gather_shard`` / ``reduce_scatter.
reduce_scatter_shard`` with ``AUTO``); more than three axes raise
``ValueError``.  On CUDA tensors two or more real axes launch
``csrc/torus.cu`` (``tdt_torus_ag``, the port of ``_torus_ag_kernel``
:104; ``tdt_torus_rs``, of ``_torus_rs_kernel`` :311, f32 and bf16), each
launch counted in the function's ``.launches``, or raise on what the
kernel does not take; on CPU tensors, or with ``plain``, the plain
versions (:func:`torus_all_gather_ref`, :func:`torus_reduce_scatter_ref`).
The kernels pull from the peers' buffers over the joint group (the card
has no torus: every rank reaches every other at one hop); they need no
landing slots.  The launches carry a host epoch, so none can be captured
in a CUDA graph.  The reference's composition of per-axis ring RS kernels
above Mosaic's scoped-VMEM ceiling (:521-537) is a TPU compile limit: the
port takes every shape in the fused order.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.bootstrap import Mesh, as_axes
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

__all__ = ["torus_all_gather_shard", "torus_reduce_scatter_shard"]

_LBL = ("x", "y", "z")  # internal storage-order labels for up to 3 axes
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIG = {"tdt_torus_ag": [_P] * 4 + [ctypes.c_longlong, _I, _U, _P],
        "tdt_torus_rs": [_P] * 5 + [_I] * 4 + [_U, _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _split_parts(rows: int, k: int):
    """Split ``rows`` into ``k`` contiguous (offset, length) parts; lengths
    may be 0 for tiny shards (those path flavors simply do not run)."""
    base, rem = divmod(rows, k)
    lens = [base + (1 if q < rem else 0) for q in range(k)]
    offs, o = [], 0
    for ln in lens:
        offs.append(o)
        o += ln
    return list(zip(offs, lens))


def _path_flavors(n: int):
    """``2n`` (cyclic axis order, direction) flavors: every (axis, dir)
    link of the torus is the phase-p ring of exactly one path, for every
    phase p."""
    orders = [tuple(_LBL[(s + t) % n] for t in range(n)) for s in range(n)]
    return tuple((order, d) for order in orders for d in (1, -1))


def free_slot_count(order, sizes_by_lbl, l):
    """Free-slot count after phase ``l`` of a cyclic-order path: the
    product of the pending axes' sizes."""
    g = 1
    for a in order[l + 1:]:
        g *= sizes_by_lbl[a]
    return g


def _paths_for(rows: int, n: int):
    return tuple((off, ln, order, d)
                 for (off, ln), (order, d) in zip(_split_parts(rows, 2 * n),
                                                  _path_flavors(n)))


def real_axes(mesh: Mesh, axes, what: str) -> tuple:
    """``axes`` without its size-1 axes; more than three raise
    ``ValueError``."""
    axes = as_axes(axes)
    if len(axes) > 3:
        raise ValueError(f"{what} supports 1-3 axes, got {axes}")
    return tuple(a for a in axes if mesh.axis_size(a) > 1)


def part_ends(n_units: int, n_axes: int) -> list[int]:
    """The ends of the 2n parts of ``_split_parts(n_units, 2n)`` (the
    kernels' ``part_end``)."""
    return [off + ln for off, ln in _split_parts(n_units, 2 * n_axes)]


def torus_fold(value, sizes, t: int, order, d: int):
    """Joint index t's sum over its group (``sizes``: the real axes' sizes
    in tuple order) in the reference's torus order for the path flavor
    (``order``: the phases' axis labels, ``d``): a nested ring sum, the
    phase-0 axis innermost; ``value(j)`` is source joint index j's value
    (a tensor), every add in its dtype."""
    n = len(sizes)
    jst = [math.prod(sizes[i + 1:]) for i in range(n)]
    coords = [(t // jst[i]) % sizes[i] for i in range(n)]
    axes = [_LBL.index(lbl) for lbl in order]

    def level(l, src):
        ax = axes[l]
        w = sizes[ax]
        acc = None
        for k in range(1, w + 1):
            u = (coords[ax] + k * d) % w
            s = src + u * jst[ax]
            v = value(s) if l == 0 else level(l - 1, s)
            acc = v if acc is None else v + acc
        return acc

    return level(n - 1, 0)


def _check(x, mesh: Mesh, what: str):
    nd = len(mesh.shape)
    if x.dim() <= nd or tuple(x.shape[:nd]) != mesh.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"[*{mesh.shape}, rows, ...]")


def _group_index(mesh: Mesh, axes):
    """[W, G]: row r lists rank r's group in joint order."""
    idx = [None] * mesh.size
    for group in mesh.joint_groups(axes):
        for r in group:
            idx[r] = group
    return torch.tensor(idx)


def torus_all_gather_ref(x, mesh: Mesh, axes):
    """The plain version: every rank's group's shards concatenated in
    joint order, [*mesh.shape, G * rows, ...]."""
    _check(x, mesh, "torus_all_gather")
    nd, G = len(mesh.shape), mesh.joint_size(axes)
    tail = x.shape[nd:]
    xs = x.reshape(mesh.size, *tail)
    g = xs[_group_index(mesh, axes).to(x.device)]      # [W, G, rows, ...]
    return g.reshape(*mesh.shape, G * tail[0], *tail[1:])


def torus_reduce_scatter_ref(x, mesh: Mesh, axes):
    """The plain version: each rank's band summed over its group in the
    reference's torus order (module docstring), [*mesh.shape, rows,
    ...]."""
    axes = as_axes(axes)
    nd, G = len(mesh.shape), mesh.joint_size(axes)
    _check(x, mesh, "torus_reduce_scatter")
    if x.shape[nd] % G:
        raise ValueError(f"torus_reduce_scatter: {x.shape[nd]} rows do not "
                         f"split into {G} chunks")
    rows = x.shape[nd] // G
    tail = x.shape[nd + 1:]
    xs = x.reshape(mesh.size, G, rows, *tail)
    sizes = [mesh.axis_size(a) for a in axes]
    paths = _paths_for(rows, len(axes))
    out = torch.empty((mesh.size, rows, *tail), dtype=x.dtype,
                      device=x.device)
    for group in mesh.joint_groups(axes):
        for t, r in enumerate(group):
            for off, ln, order, d in paths:
                if ln:
                    out[r, off:off + ln] = torus_fold(
                        lambda j: xs[group[j], t, off:off + ln], sizes, t,
                        order, d)
    return out.reshape(*mesh.shape, rows, *tail)


def torus_all_gather_shard(x, mesh: Mesh, axes, *, plain: bool = False):
    """Gather every rank's shard over the joint group ``axes`` (module
    docstring): x [*mesh.shape, rows, ...] -> [*mesh.shape, G * rows,
    ...]."""
    from triton_dist_tpu_torch.kernels.allgather import (
        AllGatherMethod,
        all_gather_shard,
    )

    _check(x, mesh, "torus_all_gather")
    real = real_axes(mesh, axes, "torus_all_gather_shard")
    if not real:
        return x
    if len(real) == 1:
        return all_gather_shard(x, mesh, real[0], AllGatherMethod.AUTO,
                                plain=plain)
    if plain or x.device.type == "cpu":
        return torus_all_gather_ref(x, mesh, real)
    if not x.is_cuda:
        raise ValueError(f"torus_all_gather: unsupported device {x.device}")
    nd, W, G = len(mesh.shape), mesh.size, mesh.joint_size(real)
    seg = math.prod(x.shape[nd:]) * x.element_size()
    xs = x.contiguous().view(W, -1)
    out = torch.empty((*mesh.shape, G * x.shape[nd], *x.shape[nd + 1:]),
                      dtype=x.dtype, device=x.device)
    lib = _build.load("torus", _SIG)
    ws = mesh.world.workspace
    bar = ws.flags("barrier", W)
    epoch = ws.next_epoch()
    tables = [(ctypes.c_longlong * W)(*peer_table(t))
              for t in (xs, out.view(W, -1), bar)]
    group = (ctypes.c_int * 7)(*mesh.group_args(real))
    with torch.cuda.device(x.device):
        err = lib.tdt_torus_ag(*tables, group, seg, W, epoch,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "torus_ag")
    torus_all_gather_shard.launches += 1
    return out


def torus_reduce_scatter_shard(x, mesh: Mesh, axes, *, plain: bool = False):
    """Reduce every rank's full partial over the joint group ``axes`` and
    scatter its rows (module docstring): x [*mesh.shape, G * rows, ...] ->
    [*mesh.shape, rows, ...]."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        ReduceScatterMethod,
        reduce_scatter_shard,
    )

    _check(x, mesh, "torus_reduce_scatter")
    real = real_axes(mesh, axes, "torus_reduce_scatter_shard")
    if not real:
        return x
    if len(real) == 1:
        return reduce_scatter_shard(x, mesh, real[0],
                                    ReduceScatterMethod.AUTO, plain=plain)
    nd, W, G = len(mesh.shape), mesh.size, mesh.joint_size(real)
    if plain or x.device.type == "cpu":
        return torus_reduce_scatter_ref(x, mesh, real)
    if not x.is_cuda:
        raise ValueError(f"torus_reduce_scatter: unsupported device "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"torus_reduce_scatter kernel: f32 or bf16, got "
                        f"{x.dtype}")
    if x.shape[nd] % G:
        raise ValueError(f"torus_reduce_scatter: {x.shape[nd]} rows do not "
                         f"split into {G} chunks")
    rows = x.shape[nd] // G
    row = math.prod(x.shape[nd + 1:])
    xs = x.contiguous().view(W, -1)
    out = torch.empty((*mesh.shape, rows, *x.shape[nd + 1:]),
                      dtype=x.dtype, device=x.device)
    lib = _build.load("torus", _SIG)
    ws = mesh.world.workspace
    bar = ws.flags("barrier", W)
    epoch = ws.next_epoch()
    tables = [(ctypes.c_longlong * W)(*peer_table(t))
              for t in (xs, out.view(W, -1), bar)]
    group = (ctypes.c_int * 7)(*mesh.group_args(real))
    ends = (ctypes.c_int * 6)(*part_ends(rows, len(real)))
    with torch.cuda.device(x.device):
        err = lib.tdt_torus_rs(*tables, group, ends, rows, row,
                               _DTYPES[x.dtype], W, epoch,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "torus_rs")
    torus_reduce_scatter_shard.launches += 1
    return out


torus_all_gather_shard.launches = 0
torus_reduce_scatter_shard.launches = 0
