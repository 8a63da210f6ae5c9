"""Ulysses attention: head-scatter all-to-all sequence parallelism.

Counterpart of ``triton_dist_tpu/kernels/ulysses_attention.py``.  The
activations arrive sequence-sharded over the ranks of a virtual world,
rank-stacked: q [W, S_loc, B, Hq, hd], k/v [W, S_loc, B, Hkv, hd].  One
all-to-all re-shards Q/K/V to head-sharded with the full sequence (the
three ride ONE fused shuffle, each peer's head chunk of q, k and v side by
side), each rank attends over the whole sequence for its heads, and a
second all-to-all restores the sequence sharding: exactly two all-to-alls
per attention call.

Both shuffles ride :func:`all_to_all.fast_all_to_all_shard_diff` (the
all-to-all kernel ``csrc/all_to_all.cu`` on CUDA tensors, with its VJP
over peers) in the rank-stacked layout send [W, W, S_loc, cols] with full
splits; at Llama-3-8B CP 4, cols = B (8 + 2 + 2) 128 = 1,536.  The local
full-sequence attention is ONE ``flash_gqa_attention`` call over every
rank's heads laid side by side (its rank-stacked form, which
``models/llama._attention`` uses too).  ``plain=True`` is the
reference's ``impl="xla"``: the all-to-all's plain version and the plain
attention.  GQA needs ``Hq % W == Hkv % W == 0``, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.all_to_all import (
    fast_all_to_all_shard_diff,
)
from triton_dist_tpu_torch.kernels.flash_attention import flash_gqa_attention
from triton_dist_tpu_torch.runtime.bootstrap import World, get_world


@dataclass
class UlyssesContext:
    """Counterpart of the reference's context: the world and the
    attention's options (``plain`` for the reference's ``impl="xla"``)."""

    world: World
    axis: str = "sp"
    causal: bool = True
    plain: bool = False
    window: int = 0
    soft_cap: float = 0.0

    @property
    def size(self) -> int:
        """The number of ranks (the reference's ``ctx.world``)."""
        return self.world.size


def create_ulysses_context(world, axis="sp", causal=True, window=0,
                           soft_cap=0.0, *, device=None,
                           plain=False) -> UlyssesContext:
    """The context over ``world``: a :class:`World`, or a rank count (the
    world of that size on ``device``, made on first use)."""
    if not isinstance(world, World):
        world = get_world(int(world), device)
    return UlyssesContext(world=world, axis=axis, causal=causal, plain=plain,
                          window=window, soft_cap=soft_cap)


def _a2a_blocks(send, *, plain=False):
    """Peer-block all-to-all of every rank: send [W, W, rows, cols], rank
    r's block p goes to peer p; returns recv [W, W, rows, cols] with
    ``recv[p][r] = send[r][p]`` (full splits, differentiable)."""
    world, _, rows = send.shape[:3]
    splits = torch.full((world, world), rows, dtype=torch.int32,
                        device=send.device)
    recv, _ = fast_all_to_all_shard_diff(send.contiguous(), splits,
                                         plain=plain)
    return recv


def _a2a_heads_to_seq(x, *, plain=False):
    """[W, S, B, H_loc, hd] head-sharded -> [W, S_loc, B, W H_loc, hd]
    sequence-sharded."""
    world, s, b, h_loc, hd = x.shape
    s_loc = s // world
    send = x.reshape(world, world, s_loc, b * h_loc * hd)
    recv = _a2a_blocks(send, plain=plain)
    return (recv.reshape(world, world, s_loc, b, h_loc, hd)
            .permute(0, 2, 3, 1, 4, 5)
            .reshape(world, s_loc, b, world * h_loc, hd))


def ulysses_attention_shard(q, k, v, *, causal=True, scale=None, window=0,
                            soft_cap=0.0, plain=False):
    """Every rank's Ulysses attention: q [W, S_loc, B, Hq, hd], k/v [W,
    S_loc, B, Hkv, hd] -> [W, S_loc, B, Hq, hd].  Differentiable (the
    all-to-all's VJP, the flash kernels' backward).  ``window`` and
    ``soft_cap`` pass straight to the local full-sequence attention."""
    world, s_loc, b, hq, hd = q.shape
    hkv = k.shape[3]
    if hq % world or hkv % world:
        raise ValueError(f"Ulysses needs heads divisible by world: Hq={hq} "
                         f"Hkv={hkv} world={world}; use ring attention "
                         f"otherwise")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    hq_loc, hkv_loc = hq // world, hkv // world
    tot = hq_loc + 2 * hkv_loc

    # fused scatter: peer p's chunk = my sequence block of [q|k|v]'s p-th
    # heads, [W (me), W (peer), S_loc, B * tot * hd]
    per_peer = torch.cat([
        q.reshape(world, s_loc, b, world, hq_loc, hd),
        k.reshape(world, s_loc, b, world, hkv_loc, hd),
        v.reshape(world, s_loc, b, world, hkv_loc, hd)], dim=4)
    send = per_peer.permute(0, 3, 1, 2, 4, 5).reshape(
        world, world, s_loc, b * tot * hd)
    recv = _a2a_blocks(send, plain=plain)
    full = recv.reshape(world, world * s_loc, b, tot, hd)
    qh, kh, vh = torch.split(full, [hq_loc, hkv_loc, hkv_loc], dim=3)
    oh = flash_gqa_attention(qh, kh, vh, causal=causal, scale=float(scale),
                             window=window, soft_cap=soft_cap, plain=plain)
    return _a2a_heads_to_seq(oh, plain=plain)


def ulysses_attention(q, k, v, ctx: UlyssesContext):
    """Host entry: q/k/v [S, B, H, hd], the global sequence sharded evenly
    over ``ctx``'s ranks.  Returns [S, B, Hq, hd]."""
    w = ctx.size
    S = q.shape[0]
    if S % w:
        raise ValueError(f"{S} positions do not split over {w} ranks")

    def shard(x):
        return x.reshape(w, S // w, *x.shape[1:])

    out = ulysses_attention_shard(
        shard(q), shard(k), shard(v), causal=ctx.causal, window=ctx.window,
        soft_cap=ctx.soft_cap, plain=ctx.plain)
    return out.reshape(S, *out.shape[2:])
