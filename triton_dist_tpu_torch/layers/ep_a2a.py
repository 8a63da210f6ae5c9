"""Expert-parallel dispatch and combine at world 1.

Counterpart of ``triton_dist_tpu/layers/ep_a2a.py``'s shard-level
functions.  :func:`ep_dispatch_shard` packs every (token, k) assignment
into per-destination-rank slots (``stable_rank_in_group``; capacity
``max_tokens``, by default the lossless ``t_loc * topk``, with the exact
count of dropped assignments returned); :func:`ep_combine_shard` brings
the expert outputs back by the same slots and takes the topk-weighted sum
in f32, zeroing invalid slots before it.

Both shuffle through ``kernels/all_to_all.fast_all_to_all_shard_diff``,
as the reference's do: at world 1 its kernel (``csrc/all_to_all.cu`` on
the card) copies the send buffer, padding rows included, into the receive
buffer and the send splits into the receive splits, and its backward
shuffles the cotangent back.  More than one rank needs the all-to-all's
peer segments, which are not ported yet.  ``EPAll2AllLayer`` and
``AllToAllContext`` need a mesh and are left out with them.  ``plain``
takes the shuffle's plain version.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.all_to_all import (
    fast_all_to_all_shard_diff,
)
from triton_dist_tpu_torch.kernels.moe_utils import stable_rank_in_group


def ep_dispatch_shard(x_loc, experts_loc, *, n_experts, max_tokens=None,
                      world: int = 1, plain: bool = False):
    """Pack per-destination-rank slots.  x_loc [t_loc, H], experts_loc
    [t_loc, topk] int.  Returns (recv [world, max_tokens, H], recv_expert
    [world, max_tokens] int32, recv_splits [world] int32, plan, n_dropped
    int32) — ``n_dropped`` counts the (token, k) assignments truncated by
    capacity, always 0 at the default sizing.  Rows past a rank's split
    are zeros: the reference's ``zero_undefined`` masking, needed there
    because its all-to-all leaves them unwritten, has nothing to do at
    world 1, where the whole segment is copied."""
    if world != 1:
        raise NotImplementedError(
            f"expert parallelism over {world} ranks needs the all-to-all "
            f"kernel and the distributed runtime, not ported yet: ROADMAP "
            f"Queue 1 item 11 and Queue 2 item 16")
    t_loc, topk = experts_loc.shape
    hidden = x_loc.shape[1]
    epr = n_experts // world
    n = t_loc * topk
    if max_tokens is None:
        max_tokens = n
    dev = x_loc.device

    flat_e = experts_loc.reshape(-1).long()
    dest = flat_e // epr
    slot, counts = stable_rank_in_group(dest, world)
    slot = slot.long()
    valid = slot < max_tokens
    # a dropped assignment lands in a scratch rank row that is cut off
    dest_safe = torch.where(valid, dest, torch.full_like(dest, world))
    slot_safe = torch.clamp(slot, max=max_tokens - 1)
    token_of = torch.arange(n, device=dev) // topk
    send = torch.zeros((world + 1, max_tokens, hidden), dtype=x_loc.dtype,
                       device=dev).index_put((dest_safe, slot_safe),
                                             x_loc[token_of])[:world]
    meta = torch.zeros((world + 1, max_tokens), dtype=torch.int32,
                       device=dev).index_put((dest_safe, slot_safe),
                                             flat_e.to(torch.int32))[:world]
    splits = torch.clamp(counts, max=max_tokens).to(torch.int32)
    n_dropped = torch.clamp(counts - max_tokens, min=0).sum().to(torch.int32)
    recv, recv_splits = fast_all_to_all_shard_diff(send, splits, plain=plain)
    # the expert ids ride an XLA all-to-all in the reference (no kernel):
    # at world 1 they stay where they are
    return recv, meta, recv_splits, (dest, slot, valid, recv_splits), \
        n_dropped


def ep_combine_shard(y, weights_loc, plan, *, plain: bool = False):
    """Inverse shuffle and topk-weighted reduce back to token order.
    y [world, max_tokens, H]: expert outputs in the received layout.
    Returns out [t_loc, H] in y's dtype."""
    world, max_tokens, hidden = y.shape
    t_loc, topk = weights_loc.shape
    dest, slot, valid, recv_splits = plan
    back, _ = fast_all_to_all_shard_diff(y, recv_splits, plain=plain)
    vals = back[torch.clamp(dest, max=world - 1),
             torch.clamp(slot, max=max_tokens - 1)]
    # zero invalid slots BEFORE the weighted sum (0 * garbage may be NaN)
    vals = torch.where(valid[:, None], vals, torch.zeros_like(vals))
    w = (weights_loc.reshape(-1, 1) * valid[:, None]).float()
    out = (w * vals.float()).reshape(t_loc, topk, hidden).sum(dim=1)
    return out.to(y.dtype)
