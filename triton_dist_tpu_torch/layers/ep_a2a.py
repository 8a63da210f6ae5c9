"""Expert-parallel dispatch and combine over a world of W ranks.

Counterpart of ``triton_dist_tpu/layers/ep_a2a.py``.  The port holds the W
ranks of its virtual world on one device (``runtime/bootstrap.py``), so
every per-rank tensor carries a leading rank dimension: rank r's tokens
are ``x[r]``.  Expert ``e`` lives on rank ``e // (n_experts // W)`` (the
reference's contiguous layout).

- :func:`ep_dispatch_shard` packs every (token, k) assignment into
  per-destination-rank slots (``stable_rank_in_group``; capacity
  ``max_tokens``, by default the lossless ``t_loc * topk``) and ships them
  through ``kernels/all_to_all.fast_all_to_all_shard_diff``; the expert
  ids ride beside them as a transpose of the rank dimensions (an XLA
  all-to-all in the reference, no kernel); ``n_dropped`` counts the
  truncated assignments of every rank (the reference's ``psum``).
- :func:`ep_combine_shard` ships the expert outputs back by the same slots
  and takes the topk-weighted sum in f32, zeroing invalid slots before it.
- :class:`EPAll2AllLayer` over an ``AllToAllContext``: the host-level
  entries, in the reference's global layout.

``plain`` takes the shuffle's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.all_to_all import (
    AllToAllContext,
    fast_all_to_all_shard_diff,
)
from triton_dist_tpu_torch.kernels.moe_utils import stable_rank_in_group


def ep_dispatch_shard(x_loc, experts_loc, *, n_experts, max_tokens=None,
                      plain: bool = False, zero_undefined: bool = False,
                      debug_poison: bool = False):
    """Pack per-destination-rank slots and shuffle them to the experts'
    owners.  x_loc [W, t_loc, H], experts_loc [W, t_loc, topk] int (rank
    r's rows at [r]).  Returns (recv [W, W, max_tokens, H], recv_expert
    [W, W, max_tokens] int32, recv_splits [W, W] int32, plan, n_dropped
    int32 scalar, summed over the ranks).

    Over more than one rank the all-to-all leaves recv rows past each
    split undefined (the kernel writes into ``torch.empty``;
    ``debug_poison`` fills them with NaN).  ``zero_undefined`` masks them
    to zero: required when recv feeds a differentiated product, whose
    weight gradient contracts over every row (a zero cotangent times NaN
    is NaN).  Paths that mask at combine may skip it."""
    world, t_loc, topk = experts_loc.shape
    hidden = x_loc.shape[-1]
    epr = n_experts // world
    n = t_loc * topk
    if max_tokens is None:
        max_tokens = n
    dev = x_loc.device

    flat_e = experts_loc.reshape(world, n).long()
    dest = flat_e // epr                                  # [W, n]
    rank = torch.arange(world, device=dev)[:, None].expand(world, n)
    # one group per (sending rank, destination): a rank's assignments are
    # contiguous, so the stable rank in a group is the per-rank slot
    slot, counts = stable_rank_in_group((rank * world + dest).reshape(-1),
                                        world * world)
    slot = slot.long().reshape(world, n)
    counts = counts.reshape(world, world)
    valid = slot < max_tokens
    # a dropped assignment lands in a scratch destination that is cut off
    dest_safe = torch.where(valid, dest, torch.full_like(dest, world))
    slot_safe = torch.clamp(slot, max=max_tokens - 1)
    token_of = torch.arange(n, device=dev) // topk
    send = torch.zeros((world, world + 1, max_tokens, hidden),
                       dtype=x_loc.dtype, device=dev).index_put(
        (rank, dest_safe, slot_safe), x_loc[:, token_of])[:, :world]
    meta = torch.zeros((world, world + 1, max_tokens), dtype=torch.int32,
                       device=dev).index_put(
        (rank, dest_safe, slot_safe), flat_e.to(torch.int32))[:, :world]
    splits = torch.clamp(counts, max=max_tokens).to(torch.int32)
    n_dropped = torch.clamp(counts - max_tokens, min=0).sum().to(torch.int32)
    recv, recv_splits = fast_all_to_all_shard_diff(
        send.contiguous(), splits, plain=plain, debug_poison=debug_poison)
    recv_meta = meta.transpose(0, 1).contiguous()
    if zero_undefined:
        row = torch.arange(max_tokens, device=dev)
        keep = (row < recv_splits[..., None])[..., None]
        recv = torch.where(keep, recv, torch.zeros_like(recv))
    return recv, recv_meta, recv_splits, (dest, slot, valid, recv_splits), \
        n_dropped


def ep_combine_shard(y, weights_loc, plan, *, plain: bool = False,
                     debug_poison: bool = False):
    """Inverse shuffle and topk-weighted reduce back to token order.
    y [W, W, max_tokens, H]: expert outputs in the received layout (block
    p returns to rank p, same slots).  Returns out [W, t_loc, H] in y's
    dtype.  ``debug_poison`` as in :func:`ep_dispatch_shard`."""
    world, _, max_tokens, hidden = y.shape
    _, t_loc, topk = weights_loc.shape
    dest, slot, valid, recv_splits = plan
    # ship back exactly the rows received: every valid slot lies below its
    # split
    back, _ = fast_all_to_all_shard_diff(y.contiguous(), recv_splits,
                                         plain=plain,
                                         debug_poison=debug_poison)
    rank = torch.arange(world, device=y.device)[:, None]
    vals = back[rank, torch.clamp(dest, max=world - 1),
                torch.clamp(slot, max=max_tokens - 1)]     # [W, n, H]
    # zero invalid slots BEFORE the weighted sum (0 * garbage may be NaN)
    vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
    w = (weights_loc.reshape(world, -1, 1) * valid[..., None]).float()
    out = (w * vals.float()).reshape(world, t_loc, topk, hidden).sum(dim=2)
    return out.to(y.dtype)


@dataclass
class EPAll2AllLayer:
    """Counterpart of the reference's ``EPAll2AllLayer`` (:139): dispatch
    returns a plan that combine takes back.  Host-level tensors are in the
    reference's global layout: tokens [T, H] (rank r's rows r T/W ...),
    received buffers [W * W, max_tokens, H], plan leaves concatenated over
    the ranks."""

    ctx: AllToAllContext
    n_experts: int
    topk: int

    def __post_init__(self):
        if self.n_experts % self.ctx.size:
            raise ValueError(f"{self.n_experts} experts do not split over "
                             f"{self.ctx.size} ranks")

    @property
    def experts_per_rank(self) -> int:
        return self.n_experts // self.ctx.size

    def dispatch(self, x, experts):
        """x [T, H], experts [T, topk].  Returns (recv [W * W, max_tokens,
        H], recv_expert [W * W, max_tokens], recv_splits [W * W], plan,
        n_dropped): rank p's receive block is rows p W .. p W + W - 1,
        ``recv_expert`` the global expert id of every valid row."""
        w = self.ctx.size
        recv, meta, splits, plan, n_dropped = ep_dispatch_shard(
            x.reshape(w, -1, x.shape[-1]),
            experts.reshape(w, -1, experts.shape[-1]),
            n_experts=self.n_experts, max_tokens=self.ctx.max_tokens,
            plain=self.ctx.plain)
        flat = tuple(t.reshape(-1, *t.shape[2:]) for t in plan)
        return (recv.reshape(w * w, *recv.shape[2:]),
                meta.reshape(w * w, -1), splits.reshape(-1), flat, n_dropped)

    def combine(self, y, weights, plan):
        """y [W * W, max_tokens, H]: expert outputs in the received layout;
        weights [T, topk].  Returns [T, H]."""
        w = self.ctx.size
        plan = tuple(t.reshape(w, -1, *t.shape[1:]) for t in plan)
        out = ep_combine_shard(y.reshape(w, w, *y.shape[1:]),
                               weights.reshape(w, -1, weights.shape[-1]),
                               plan, plain=self.ctx.plain)
        return out.reshape(-1, out.shape[-1])
