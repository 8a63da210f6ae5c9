"""Expert-parallel all-to-all: the token shuffle of MoE dispatch and combine.

Counterpart of ``triton_dist_tpu/kernels/all_to_all.py``.  The port runs a
world of W ranks on one device (``runtime/bootstrap.py``), so every
per-rank operand carries a leading rank dimension and one call serves
every rank.  Layout, the same at every world size (world 1 is W = 1):

- send [W, W, max_tokens, H]: rank r's row block p goes to peer p;
- splits [W, W] int32: rank r's valid rows of each block;
- recv [W, W, max_tokens, H]: rank p's row block r came from rank r, so
  ``recv[p][r] = send[r][p]`` on the rows below the split;
- recv_splits [W, W] int32: ``recv_splits[p][r] = splits[r][p]``.

- :func:`all_to_all_ref`: the plain version, the full-segment shuffle the
  reference's ``impl="xla"`` computes (padding rows move too).
- :func:`fast_all_to_all_shard`: on CUDA tensors it launches
  ``csrc/all_to_all.cu`` (the port of the TPU ``_a2a_kernel``: the own
  segment copied whole, each peer segment in proportion to its split, the
  split counts beside) and counts the launch, or raises on what the
  kernel does not take; on CPU tensors, or with ``plain``, the plain
  version.  Over more than one rank the kernel leaves a peer segment's
  rows past ``min(split, max_tokens)`` undefined: consumers mask by
  ``recv_splits``.  ``debug_poison`` fills exactly those rows with NaN
  (integer payloads: the type's maximum), in the kernel and in the plain
  version alike, so a test shows that each consumer masks.
- :class:`AllToAllFn` / :func:`fast_all_to_all_shard_diff`: the
  counterpart of the reference's custom VJP: the shuffle's transpose is
  the same shuffle of the cotangent by ``recv_splits``, with the rows past
  the returned split counts zeroed.
- :class:`AllToAllContext`, :func:`create_all_to_all_context`,
  :func:`fast_all_to_all` (the host entry, the reference's global
  ``[W * W, max_tokens, H]`` layout) and :func:`all_to_all_post_process`.

The reference's ``wire_block``, ``collective_id`` and ``TDT_A2A_POISON``
have no counterpart: the kernel ships exactly the split's rows, a launch
needs no collective id, and poison is the keyword alone.  A (slow, fast)
2-tuple axis is the reference's hierarchical two-stage path: a context
over a ``Mesh`` of those two axes routes :func:`fast_all_to_all` through
``kernels/hierarchical.hier_all_to_all_shard``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.runtime.bootstrap import (
    MAX_RANKS,
    Mesh,
    World,
    get_world,
)
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

_SIG = {"tdt_a2a_local": [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
        "tdt_a2a": [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
        + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                ctypes.c_ulonglong, ctypes.c_void_p]}
CHUNK_BYTES = 1 << 16    # rows a block copies before it signals: ~64 KB


def check_axis(axis) -> bool:
    """Whether ``axis`` is a (slow, fast) 2-tuple, the reference's
    hierarchical two-stage all-to-all (``kernels/hierarchical.py``); a
    tuple of another length raises."""
    if not isinstance(axis, (tuple, list)):
        return False
    if len(axis) != 2:
        raise ValueError(f"axis {tuple(axis)}: one axis, or a (slow, fast) "
                         f"pair for the two-stage all-to-all")
    return True


def _check(send, splits):
    if (send.dim() != 4 or send.shape[0] != send.shape[1]
            or tuple(splits.shape) != tuple(send.shape[:2])):
        raise ValueError(f"all_to_all: send {tuple(send.shape)} must be "
                         f"[W, W, max_tokens, H] and splits "
                         f"{tuple(splits.shape)} [W, W]")
    if splits.dtype != torch.int32:
        raise TypeError(f"all_to_all: splits must be int32, got "
                        f"{splits.dtype}")


def poison_pattern(dtype) -> bytes:
    """One element of the poison sentinel in ``dtype``, as its bytes: NaN
    for floating types (fp8 included), the maximum for integers."""
    if dtype.is_floating_point:
        v = torch.full((1,), float("nan"), dtype=dtype)
    else:
        v = torch.full((1,), torch.iinfo(dtype).max, dtype=dtype)
    return bytes(v.view(torch.uint8).tolist())


def _poison_(recv, recv_splits):
    """Fill every peer segment's rows past min(recv_split, max_tokens)
    with the poison pattern, in place (the own segment is whole)."""
    world, _, max_tokens, hidden = recv.shape
    row = torch.arange(max_tokens, device=recv.device)
    shipped = torch.clamp(recv_splits.long(), 0, max_tokens)
    peer = ~torch.eye(world, dtype=torch.bool, device=recv.device)
    undefined = (row >= shipped[..., None]) & peer[..., None]
    pat = torch.tensor(list(poison_pattern(recv.dtype)), dtype=torch.uint8,
                       device=recv.device).repeat(hidden)
    raw = recv.view(torch.uint8).view(world, world, max_tokens, -1)
    raw[undefined] = pat


def all_to_all_ref(send, splits, *, debug_poison: bool = False):
    """(recv, recv_splits): the full-segment shuffle ``recv[p][r] =
    send[r][p]``, ``recv_splits[p][r] = splits[r][p]`` (new tensors);
    ``debug_poison`` fills the rows the kernel leaves undefined."""
    _check(send, splits)
    copy = torch.contiguous_format
    recv = send.transpose(0, 1).clone(memory_format=copy)
    recv_splits = splits.t().clone(memory_format=copy)
    if debug_poison and send.shape[0] > 1:
        _poison_(recv, recv_splits)
    return recv, recv_splits


def fast_all_to_all_shard(send, splits, *, plain: bool = False,
                          debug_poison: bool = False):
    """(recv [W, W, max_tokens, H], recv_splits [W, W] int32) of the
    shuffle of rank-stacked ``send`` and ``splits`` (module docstring)."""
    _check(send, splits)
    if plain or send.device.type == "cpu":
        return all_to_all_ref(send, splits, debug_poison=debug_poison)
    if not send.is_cuda:
        raise ValueError(f"all_to_all: unsupported device {send.device}")
    if splits.device != send.device:
        raise ValueError(f"all_to_all: splits on {splits.device}, send on "
                         f"{send.device}")
    world, _, max_tokens, _ = send.shape
    if world > MAX_RANKS:
        raise ValueError(f"all_to_all kernel: at most {MAX_RANKS} ranks, "
                         f"got {world}")
    send, splits = send.contiguous(), splits.contiguous()
    recv = torch.empty_like(send)
    recv_splits = torch.empty_like(splits)
    lib = _build.load("all_to_all", _SIG)
    row_bytes = send.shape[3] * send.element_size()
    if world == 1:
        with torch.cuda.device(send.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tdt_a2a_local(send.data_ptr(), splits.data_ptr(),
                                    recv.data_ptr(), recv_splits.data_ptr(),
                                    max_tokens * row_bytes, 0, stream)
    else:
        ws = get_world(world, send.device).workspace
        chunk_rows = max(1, CHUNK_BYTES // max(row_bytes, 1))
        n_chunk = max(1, -(-max_tokens // chunk_rows))
        flags = ws.flags("all_to_all", world * n_chunk)
        staged = ws.get("all_to_all_splits", (world,), torch.int32)
        bar = ws.flags("barrier", world)
        pattern = poison_pattern(send.dtype)
        epoch = ws.next_epoch()
        tables = [(ctypes.c_longlong * world)(*peer_table(t))
                  for t in (send, recv, splits, recv_splits, staged, flags,
                            bar)]
        with torch.cuda.device(send.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.tdt_a2a(*tables, row_bytes, world, max_tokens,
                              chunk_rows, n_chunk, epoch, int(debug_poison),
                              len(pattern), int.from_bytes(pattern, "little"),
                              stream)
    _build.check(err, "all_to_all")
    fast_all_to_all_shard.launches += 1
    return recv, recv_splits


fast_all_to_all_shard.launches = 0


class AllToAllFn(torch.autograd.Function):
    """The shuffle under autograd: the backward shuffles the cotangent
    back by the received split counts and zeroes the rows past them (a
    send row that never shipped has a zero cotangent, and the kernel
    leaves it undefined)."""

    @staticmethod
    def forward(ctx, send, splits, plain, debug_poison):
        recv, recv_splits = fast_all_to_all_shard(
            send, splits, plain=plain, debug_poison=debug_poison)
        ctx.save_for_backward(recv_splits)
        ctx.plain = plain
        ctx.mark_non_differentiable(recv_splits)
        return recv, recv_splits

    @staticmethod
    def backward(ctx, d_recv, _d_splits):
        (recv_splits,) = ctx.saved_tensors
        d_send, d_splits = fast_all_to_all_shard(d_recv.contiguous(),
                                                 recv_splits,
                                                 plain=ctx.plain)
        row = torch.arange(d_send.shape[2], device=d_send.device)
        keep = (row < d_splits[..., None])[..., None]
        return (torch.where(keep, d_send, torch.zeros_like(d_send)), None,
                None, None)


def fast_all_to_all_shard_diff(send, splits, *, plain: bool = False,
                               debug_poison: bool = False):
    """:func:`fast_all_to_all_shard`, differentiable through
    :class:`AllToAllFn` when grad is enabled and send requires grad."""
    if torch.is_grad_enabled() and send.requires_grad:
        return AllToAllFn.apply(send, splits, plain, debug_poison)
    return fast_all_to_all_shard(send, splits, plain=plain,
                                 debug_poison=debug_poison)


@dataclass
class AllToAllContext:
    """Counterpart of the reference's ``AllToAllContext`` (:66): the
    world the shuffle runs over and the sizing of its buffers.
    ``max_tokens`` None means "size for the lossless worst case at
    dispatch time" (EP dispatch only); the raw :func:`fast_all_to_all`
    needs a number.  ``plain`` takes the plain version on any device (the
    reference's ``impl="xla"``)."""

    world: World
    max_tokens: int | None
    hidden: int
    axis: str = "ep"
    plain: bool = False
    mesh: Mesh | None = None

    def __post_init__(self):
        if check_axis(self.axis) and (
                self.mesh is None
                or self.mesh.axis_names != tuple(self.axis)):
            raise ValueError(f"axis {tuple(self.axis)}: the two-stage "
                             f"all-to-all needs a Mesh of those two axes")

    @property
    def size(self) -> int:
        """The number of ranks (the reference's ``ctx.world``)."""
        return self.world.size


def create_all_to_all_context(world, max_tokens, hidden, axis="ep", *,
                              device=None,
                              plain: bool = False) -> AllToAllContext:
    """The context over ``world``: a :class:`World`, a rank count (the
    world of that size on ``device``, made on first use), or a
    :class:`Mesh` (the two-stage path over its two axes)."""
    mesh = world if isinstance(world, Mesh) else None
    if mesh is not None:
        world = mesh.world
    elif not isinstance(world, World):
        world = get_world(int(world), device)
    return AllToAllContext(world=world, max_tokens=max_tokens, hidden=hidden,
                           axis=axis, plain=plain, mesh=mesh)


def fast_all_to_all(send, splits, ctx: AllToAllContext):
    """Host entry (reference :371): send [W * W, max_tokens, H], rank r's
    outgoing blocks at rows r W .. r W + W - 1 (the reference's array
    sharded over the axis); splits [W * W] likewise.  Returns (recv
    [W * W, max_tokens, H], recv_splits [W * W]) in the same layout."""
    w = ctx.size
    if ctx.max_tokens is None:
        raise ValueError(
            "fast_all_to_all needs an explicit ctx.max_tokens (it sizes the "
            "symmetric buffers); max_tokens=None is only meaningful for the "
            "EP dispatch path, which derives the worst case itself")
    expected = (w * w, ctx.max_tokens, ctx.hidden)
    if tuple(send.shape) != expected:
        raise ValueError(
            f"send shape {tuple(send.shape)} != ctx sizing {expected} "
            f"(world={w}, max_tokens={ctx.max_tokens}, hidden={ctx.hidden})")
    if check_axis(ctx.axis):
        from triton_dist_tpu_torch.kernels.hierarchical import (
            hier_all_to_all_shard,
        )

        d, t = ctx.mesh.shape
        recv, recv_splits = hier_all_to_all_shard(
            send.reshape(d, t, w, ctx.max_tokens, ctx.hidden),
            splits.reshape(d, t, w), ctx.mesh, slow_axis=ctx.axis[0],
            fast_axis=ctx.axis[1], plain=ctx.plain)
    else:
        recv, recv_splits = fast_all_to_all_shard(
            send.reshape(w, w, ctx.max_tokens, ctx.hidden),
            splits.reshape(w, w), plain=ctx.plain)
    return recv.reshape(expected), recv_splits.reshape(w * w)


def all_to_all_post_process(recv, recv_splits):
    """One rank's receive buffer flattened, with its validity mask
    (reference :406, which keeps static shapes where the original
    compacts): recv [W, max_tokens, H] and recv_splits [W] -> (tokens
    [W * max_tokens, H] with the padding rows in place, mask
    [W * max_tokens] bool).  Leading (rank) dimensions are kept."""
    lead = recv.shape[:-3]
    world, max_tokens, hidden = recv.shape[-3:]
    row = torch.arange(max_tokens, device=recv.device)
    mask = row < recv_splits[..., None]
    return (recv.reshape(*lead, world * max_tokens, hidden),
            mask.reshape(*lead, world * max_tokens))
