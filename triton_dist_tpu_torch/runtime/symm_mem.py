"""Symmetric memory of the virtual world: rank-stacked buffers, the
pointer table the kernels reach them by, and the call epoch.

Counterpart of ``triton_dist_tpu/runtime/symm_mem.py``
(``create_symm_tensor`` :31, ``SymmetricWorkspace`` :55).  A symmetric
tensor is one device allocation ``[size, *per_rank_shape]``: rank r's
buffer is row r, and :func:`peer_table` lists the W row addresses, the
rank-indexed pointer table of ``csrc/dist_verbs.cuh`` (passed by value in
a kernel's parameters).  A multi-card backend would fill the same table
with the peers' mapped addresses.

:class:`SymmetricWorkspace` keeps the buffers a kernel needs across calls
(flags, barrier slots, staging), cached by (name, shape, dtype), so a call
allocates nothing, and hands each call a new **epoch**: kernels set flags
to their call's epoch and wait until a flag has reached it, so a flag left
by an earlier call can never satisfy a wait and no flag is ever cleared.
The epoch is a host counter passed as a kernel argument, so a launch that
carries it cannot be replayed from a CUDA graph (the wrappers refuse a
capture).
"""

from __future__ import annotations

from typing import Sequence

import torch

_EPOCH_LIMIT = 1 << 30   # flags compare wrap-safe within 2**31


def create_symm_tensor(world, per_rank_shape: Sequence[int],
                       dtype=torch.bfloat16):
    """``[world.size, *per_rank_shape]`` zeros on the world's device: every
    rank's buffer in one allocation."""
    return torch.zeros((world.size, *per_rank_shape), dtype=dtype,
                       device=world.device)


def peer_table(t: torch.Tensor) -> list[int]:
    """The device address of each rank's buffer ``t[r]`` (the leading
    dimension runs over the ranks)."""
    step = t.stride(0) * t.element_size()
    return [t.data_ptr() + r * step for r in range(t.shape[0])]


class SymmetricWorkspace:
    """Persistent per-world scratch of the distributed kernels, and their
    call epoch.  Buffers are keyed by (name, per-rank shape, dtype)."""

    def __init__(self, world):
        self.world = world
        self.buffers: dict = {}
        # what a kernel derives once per shape from these buffers (pointer
        # tables, chunking), kept by the kernel under its own key
        self.plans: dict = {}
        self.epoch = 0

    def get(self, name: str, per_rank_shape: Sequence[int],
            dtype=torch.bfloat16) -> torch.Tensor:
        """The workspace buffer ``[size, *per_rank_shape]``, made (zeroed)
        on first use and returned as it is afterwards."""
        key = (name, tuple(int(s) for s in per_rank_shape), dtype)
        if key not in self.buffers:
            self.buffers[key] = create_symm_tensor(self.world, key[1], dtype)
        return self.buffers[key]

    def flags(self, name: str, per_rank: int) -> torch.Tensor:
        """An int32 flag array of ``per_rank`` entries for every rank."""
        return self.get(name, (per_rank,), torch.int32)

    def next_epoch(self) -> int:
        """This call's epoch (1, 2, ...).  Near the wrap limit every flag
        is cleared and the count restarts, so the kernels' wrap-safe
        comparisons stay within range."""
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the distributed kernels cannot be captured in a CUDA graph:"
                " each call takes a new epoch from a host counter")
        self.epoch += 1
        if self.epoch >= _EPOCH_LIMIT:
            for (_, _, dtype), buf in self.buffers.items():
                if dtype == torch.int32:
                    buf.zero_()
            self.epoch = 1
        return self.epoch
