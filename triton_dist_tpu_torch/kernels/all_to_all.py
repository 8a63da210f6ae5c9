"""Expert-parallel all-to-all: the token shuffle of MoE dispatch and combine.

Counterpart of ``triton_dist_tpu/kernels/all_to_all.py``'s shard-level
entries.  Layout, for one rank: send [world, max_tokens, H], row block p
going to peer p; splits [world] int32, the valid rows of each block; recv
[world, max_tokens, H], row block p having come from peer p; recv_splits
[world] int32.

- :func:`all_to_all_ref`: the plain version at world 1: recv is a copy of
  send, padding rows included, and recv_splits a copy of splits (what the
  reference kernel's local copy leaves).
- :func:`fast_all_to_all_shard`: on CUDA tensors it launches
  ``csrc/all_to_all.cu`` (the port of the TPU ``_a2a_kernel``: the rank's
  own segment and its split count) and counts the launch; on CPU tensors,
  or with ``plain``, the plain version.
- :func:`fast_all_to_all_shard_diff`: differentiable, the counterpart of
  the reference's custom VJP: the shuffle's transpose is the same shuffle
  applied to the cotangent, whose rows past the returned split counts are
  zeroed.

The reference's ``wire_block`` has no counterpart: at world 1 the whole
segment is one copy.  More than one rank needs the peer segments (the
kernel's remote half and a runtime that maps the peers' buffers), so a
send buffer of more than one block raises.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

_SIG = {"tdt_a2a_local": [ctypes.c_void_p] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}


def _check(send, splits):
    if send.dim() != 3 or tuple(splits.shape) != (send.shape[0],):
        raise ValueError(f"all_to_all: send {tuple(send.shape)} must be "
                         f"[world, max_tokens, H] and splits "
                         f"{tuple(splits.shape)} [world]")
    if send.shape[0] != 1:
        raise NotImplementedError(
            f"all_to_all over {send.shape[0]} ranks needs the peer "
            f"segments of the kernel and the distributed runtime, not "
            f"ported yet: ROADMAP Queue 1 item 11 and Queue 2 item 16")
    if splits.dtype != torch.int32:
        raise TypeError(f"all_to_all: splits must be int32, got "
                        f"{splits.dtype}")


def all_to_all_ref(send, splits):
    """(recv, recv_splits) at world 1: copies of send and splits."""
    _check(send, splits)
    return send.clone(), splits.clone()


def fast_all_to_all_shard(send, splits, *, plain: bool = False):
    """(recv [world, max_tokens, H], recv_splits [world] int32) of the
    shuffle; world (``send.shape[0]``) must be 1."""
    _check(send, splits)
    if plain or send.device.type == "cpu":
        return all_to_all_ref(send, splits)
    if not send.is_cuda:
        raise ValueError(f"all_to_all: unsupported device {send.device}")
    if splits.device != send.device:
        raise ValueError(f"all_to_all: splits on {splits.device}, send on "
                         f"{send.device}")
    send, splits = send.contiguous(), splits.contiguous()
    recv = torch.empty_like(send)
    recv_splits = torch.empty_like(splits)
    lib = _build.load("all_to_all", _SIG)
    with torch.cuda.device(send.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdt_a2a_local(send.data_ptr(), splits.data_ptr(),
                                recv.data_ptr(), recv_splits.data_ptr(),
                                send[0].numel() * send.element_size(), 0,
                                stream)
    _build.check(err, "all_to_all")
    fast_all_to_all_shard.launches += 1
    return recv, recv_splits


fast_all_to_all_shard.launches = 0


class AllToAllFn(torch.autograd.Function):
    """The shuffle under autograd: the backward shuffles the cotangent
    back by the received split counts and zeroes the rows past them (a
    send row that never shipped has a zero cotangent)."""

    @staticmethod
    def forward(ctx, send, splits, plain):
        recv, recv_splits = fast_all_to_all_shard(send, splits, plain=plain)
        ctx.save_for_backward(recv_splits)
        ctx.plain = plain
        ctx.mark_non_differentiable(recv_splits)
        return recv, recv_splits

    @staticmethod
    def backward(ctx, d_recv, _d_splits):
        (recv_splits,) = ctx.saved_tensors
        d_send, d_splits = fast_all_to_all_shard(d_recv, recv_splits,
                                                 plain=ctx.plain)
        row = torch.arange(d_send.shape[1], device=d_send.device)
        keep = (row[None, :] < d_splits[:, None])[..., None]
        return (torch.where(keep, d_send, torch.zeros_like(d_send)), None,
                None)


def fast_all_to_all_shard_diff(send, splits, *, plain: bool = False):
    """:func:`fast_all_to_all_shard`, differentiable through
    :class:`AllToAllFn` when grad is enabled and send requires grad."""
    if torch.is_grad_enabled() and send.requires_grad:
        return AllToAllFn.apply(send, splits, plain)
    return fast_all_to_all_shard(send, splits, plain=plain)
