"""Bootstrap: the world of ranks the tensor-parallel kernels run over.

Counterpart of ``triton_dist_tpu/runtime/bootstrap.py``
(``initialize_distributed`` :46, ``default_mesh`` :125, ``rank`` :131,
``num_ranks`` :140).  The reference builds a device mesh and runs one
program per device under ``shard_map``; the port holds a **virtual world**
of ``size`` ranks on ONE device, the counterpart of the reference's
virtual CPU mesh in its tests:

- every per-rank tensor carries a leading rank dimension (rank r's shard
  is ``t[r]``), and one kernel launch runs every rank's work;
- each rank's symmetric buffers are slices of one device allocation
  (``runtime/symm_mem.py``), which the kernels reach through a
  rank-indexed pointer table.

A multi-process backend (one process per card, NCCL plus torch symmetric
memory) changes only who fills that table.  It is not ported yet; asking
for it raises, naming the ROADMAP item.

:class:`Mesh` names axes over one world: the counterpart of the
``jax.sharding.Mesh`` the reference's shard-level code runs under, with
:func:`create_hybrid_mesh` for the shape contract of the reference's
``runtime/topology.create_hybrid_mesh`` (:130: the slow ``dcn`` axis
leading).  Rank r is the row-major index of its coordinates, per-rank
tensors carry the mesh shape as leading dimensions (``[2, 2, 2, rows,
128]`` on a (2, 2, 2) mesh), and a collective over one axis runs over
every group of ranks that agree on the other axes: rank r's peer at
coordinate c' of an axis is ``r + (c' - c) * stride`` (c its own), so one
kernel launch serves every group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from triton_dist_tpu_torch.runtime.utils import resolve_device

MAX_RANKS = 8     # csrc/dist_verbs.cuh MAX_RANKS

_WORLDS: dict = {}


@dataclass(eq=False)
class World:
    """``size`` ranks, all held by this process on ``device``."""

    size: int
    device: torch.device
    workspace: object = field(default=None, repr=False)

    def __post_init__(self):
        if not 1 <= self.size <= MAX_RANKS:
            raise ValueError(f"world size {self.size}: the kernels take 1.."
                             f"{MAX_RANKS} ranks")
        self.device = torch.device(self.device)
        if self.workspace is None:
            from triton_dist_tpu_torch.runtime.symm_mem import (
                SymmetricWorkspace,
            )
            self.workspace = SymmetricWorkspace(self)


def initialize_distributed(world_size: int = 1, *, device=None,
                           backend: str = "virtual") -> World:
    """The process's world of ``world_size`` ranks on ``device`` (the card
    unless ``device="cpu"``); one per (size, device), made on first use.
    ``backend="virtual"`` is the only one ported."""
    if backend != "virtual":
        raise NotImplementedError(
            f"backend {backend!r}: one process per card (NCCL plus torch "
            f"symmetric memory) is not ported yet (ROADMAP Queue 1 item 11); "
            f"the port runs the virtual world of one device")
    dev = canonical_device(device)
    key = (int(world_size), str(dev))
    if key not in _WORLDS:
        _WORLDS[key] = World(int(world_size), dev)
    return _WORLDS[key]


def canonical_device(device) -> torch.device:
    """``device`` resolved (the card unless ``"cpu"`` is asked for), a
    CUDA device with its index: the key a world is kept under."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def get_world(size: int, device) -> World:
    """The world of ``size`` ranks on ``device`` (made on first use; a
    device already in its kept form, such as a tensor's, is looked up
    directly)."""
    world = _WORLDS.get((int(size), str(device)))
    return world or initialize_distributed(size, device=device)


def finalize_distributed() -> None:
    """Drop every world and its workspace buffers."""
    _WORLDS.clear()


@dataclass(eq=False)
class Mesh:
    """Named axes of ``shape`` over the world of ``prod(shape)`` ranks on
    ``device`` (at most ``MAX_RANKS``): the axes' sizes, strides and
    groups are the reference's ``jax.lax.axis_size`` / ``axis_index``."""

    shape: tuple
    axis_names: tuple
    device: torch.device = None
    world: World = field(default=None, repr=False)

    def __post_init__(self):
        self.shape = tuple(int(s) for s in self.shape)
        self.axis_names = tuple(self.axis_names)
        if len(self.shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} must pair up, names unique")
        if self.world is None:
            self.world = get_world(math.prod(self.shape),
                                   canonical_device(self.device))
        self.device = self.world.device
        if self.world.size != math.prod(self.shape):
            raise ValueError(f"mesh {self.shape} over a world of "
                             f"{self.world.size} ranks")

    @property
    def size(self) -> int:
        """The number of ranks."""
        return self.world.size

    def dim(self, axis: str) -> int:
        """The leading dimension of a per-rank tensor that runs over
        ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} is not one of {self.axis_names}")
        return self.axis_names.index(axis)

    def axis_size(self, axis: str) -> int:
        """The reference's ``jax.lax.axis_size(axis)``."""
        return self.shape[self.dim(axis)]

    def axis_stride(self, axis: str) -> int:
        """How far apart, in ranks, two neighbours along ``axis`` are."""
        return math.prod(self.shape[self.dim(axis) + 1:])

    def axis_index(self, axis: str) -> torch.Tensor:
        """Every rank's coordinate on ``axis`` (the reference's
        ``jax.lax.axis_index``), as an int64 tensor of the mesh's shape on
        the CPU."""
        idx = torch.arange(self.shape[self.dim(axis)])
        view = [1] * len(self.shape)
        view[self.dim(axis)] = -1
        return idx.reshape(view).expand(self.shape)

    def axis_groups(self, axis: str) -> list[list[int]]:
        """The ranks of each group along ``axis``, in coordinate order:
        for ``tp`` of a (2, 2, 2) mesh, four groups of two."""
        n, stride = self.axis_size(axis), self.axis_stride(axis)
        firsts = [r for r in range(self.size) if (r // stride) % n == 0]
        return [[r + c * stride for c in range(n)] for r in firsts]

    def joint_size(self, axes) -> int:
        """The ranks of a joint group over ``axes`` (one name or a tuple):
        the product of their sizes."""
        return math.prod(self.axis_size(a) for a in as_axes(axes))

    def joint_groups(self, axes) -> list[list[int]]:
        """The ranks of each joint group over ``axes`` (the ranks that
        agree on the other axes), each in joint order: flat axes-major,
        ``axes[0]`` slowest, whatever the mesh's own axis order (the
        order of ``lax.all_gather`` over the joint axes)."""
        axes = as_axes(axes)
        sizes = [self.axis_size(a) for a in axes]
        strides = [self.axis_stride(a) for a in axes]
        firsts = [r for r in range(self.size)
                  if all((r // s) % n == 0 for s, n in zip(strides, sizes))]
        groups = []
        for r in firsts:
            group = [r]
            for s, n in zip(strides, sizes):
                group = [g + c * s for g in group for c in range(n)]
            groups.append(group)
        return groups

    def joint_index(self, axes) -> list[int]:
        """Every rank's index in its joint group over ``axes``."""
        index = [0] * self.size
        for group in self.joint_groups(axes):
            for j, r in enumerate(group):
                index[r] = j
        return index

    def group_args(self, axes) -> list[int]:
        """The joint group over ``axes`` (1-3 names) as the kernels take it
        (csrc/dist_verbs.cuh ``group_from``): [n, size0..2, stride0..2]."""
        axes = as_axes(axes)
        if not 1 <= len(axes) <= 3:
            raise ValueError(f"a joint group takes 1-3 axes, got {axes}")
        pad = [1] * (3 - len(axes))
        return [len(axes), *(self.axis_size(a) for a in axes), *pad,
                *(self.axis_stride(a) for a in axes), *pad]


def as_axes(axis) -> tuple:
    """``axis`` as a tuple of names (a name is a tuple of one)."""
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def create_hybrid_mesh(ici_axes: dict, dcn_axis: str = "dcn",
                       n_slow: int = 1, device=None) -> Mesh:
    """The reference's hybrid mesh shape: ``(n_slow, *ici_axes sizes)``
    named ``(dcn_axis, *ici_axes)``, the slow axis leading."""
    return Mesh((int(n_slow), *ici_axes.values()),
                (dcn_axis, *ici_axes), device)


def rank(world: World) -> range:
    """The ranks this process holds: in the virtual world, all of them
    (a per-rank tensor's leading dimension runs over them)."""
    return range(world.size)


def num_ranks(world: World) -> int:
    """The world size (the reference's ``num_ranks(axis)``)."""
    return world.size
