"""Device-side synchronisation: the barrier across the ranks of a mesh axis.

Counterpart of ``triton_dist_tpu/kernels/common_ops.py``
(``_barrier_kernel`` :34, ``barrier_all_on_mesh`` :52) on the port's
virtual world (``runtime/bootstrap.Mesh``): one int32 per rank, carried
with the mesh shape as leading dimensions.

- :func:`barrier_shard`: on CUDA tensors one cooperative launch of
  ``csrc/barrier.cu`` (every rank signals its axis peers' barrier slots
  with the call's epoch, waits for all of them, then copies its word),
  counted in ``barrier_shard.launches``; on CPU tensors, or with
  ``plain``, the plain version, the identity (a barrier among ranks that
  one process holds is a no-op).  An axis of one rank returns its input.
- :func:`barrier_all_on_mesh`: the host barrier, returning the [T] int32
  zeros the reference's returns (T the axis size).

The reference's ``AUTO`` has no place here (one kernel, no method); the
launch carries a host epoch, so it cannot be captured in a CUDA graph.
No model path calls the barrier.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.bootstrap import Mesh
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

_SIG = {"tdt_barrier": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_uint, ctypes.c_void_p]}


def barrier_ref(x):
    """The plain version: every rank's word as it came in (a new tensor)."""
    return x.clone()


def barrier_shard(x, mesh: Mesh, axis: str = "tp", *, plain: bool = False):
    """x [*mesh.shape] int32 (one word per rank) -> the same words, written
    after every rank of each group along ``axis`` reached the barrier."""
    if tuple(x.shape) != mesh.shape or x.dtype != torch.int32:
        raise ValueError(f"barrier: x must be int32 {mesh.shape}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    size = mesh.axis_size(axis)
    if plain or x.device.type == "cpu" or size == 1:
        return barrier_ref(x)
    if not x.is_cuda:
        raise ValueError(f"barrier: unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    ws = mesh.world.workspace
    bar = ws.flags("barrier", mesh.size)
    table = (ctypes.c_longlong * mesh.size)(*peer_table(bar))
    epoch = ws.next_epoch()
    lib = _build.load("barrier", _SIG)
    with torch.cuda.device(x.device):
        err = lib.tdt_barrier(x.data_ptr(), out.data_ptr(), table, mesh.size,
                              size, mesh.axis_stride(axis), epoch,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(err, "barrier")
    barrier_shard.launches += 1
    return out


barrier_shard.launches = 0


def barrier_all_on_mesh(mesh: Mesh, axis: str = "tp", *,
                        plain: bool = False):
    """Host-level barrier over ``axis`` (reference :52): [T] int32 zeros
    (the reference's array sharded over the axis); once it is ready, every
    rank has reached the barrier kernel."""
    x = torch.zeros(mesh.shape, dtype=torch.int32, device=mesh.device)
    out = barrier_shard(x, mesh, axis, plain=plain)
    return out.movedim(mesh.dim(axis), 0).reshape(mesh.axis_size(axis),
                                                  -1)[:, 0]
