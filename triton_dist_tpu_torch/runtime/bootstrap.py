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
"""

from __future__ import annotations

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


def rank(world: World) -> range:
    """The ranks this process holds: in the virtual world, all of them
    (a per-rank tensor's leading dimension runs over them)."""
    return range(world.size)


def num_ranks(world: World) -> int:
    """The world size (the reference's ``num_ranks(axis)``)."""
    return world.size
