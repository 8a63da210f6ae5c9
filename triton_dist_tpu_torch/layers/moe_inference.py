"""Serving-side MoE layer over a world of W ranks: dispatch, grouped FFN,
combine.

Counterpart of ``triton_dist_tpu/layers/moe_inference.py``.  The W ranks
of the port's virtual world live on one device, so per-rank tensors carry
a leading rank dimension (rank r's tokens ``x[r]``):

- :func:`moe_infer_shard`: dispatch (``layers/ep_a2a.py``: the all-to-all
  kernel), sort by expert, the grouped SwiGLU
  (``kernels/group_gemm.moe_ffn_sorted``: the bf16 mode of
  ``csrc/group_gemm.cu`` on the card), combine;
- :func:`moe_ffn_sorted_w8a8` / :func:`moe_infer_shard_w8a8`: the W8A8
  twin — dynamic per-row activation quant around exact int8 grouped GEMMs
  (the int8 mode of the same kernel), per-expert-channel weight scales,
  dequantized in the reference's order ``acc * x_s[:, None] *
  w_s[row_e]``;
- :func:`expert_ffn`: the expert compute over the received buffers of
  every rank, shared with the training path (``models/moe.py``);
- :class:`DistributedMoELayer`: ``init_weights(seed)``,
  ``quantize_weights()``, ``weight_specs()``, ``route`` and ``forward``.
  Its constructor takes ``world=`` (ranks of the virtual world) and
  ``device=`` where the reference's takes a mesh.

Expert ``e`` lives on rank ``e // (E / W)``.  The expert stacks stay
``[E, K, N]``: stacked rank-major, they are exactly the world-1 layout, so
rank r's slab is the view ``w[r E/W : (r + 1) E/W]`` and sharding them
copies nothing.  Each rank sorts its received rows by its local experts
(padding rows, undefined under the all-to-all, steered to its local expert
0 as the reference does; combine never reads them); the ranks' sorted rows
are laid end to end, each tile tagged with its global expert, and go
through ONE grouped GEMM per projection.  ``plain=True`` runs the plain
versions of the all-to-all and the grouped GEMM (a reference computation
on the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

import torch

from triton_dist_tpu_torch.kernels.all_to_all import check_axis
from triton_dist_tpu_torch.kernels.group_gemm import (
    group_gemm_i8,
    load_aware_block_m,
    moe_ffn_sorted,
)
from triton_dist_tpu_torch.kernels.moe_utils import (
    gather_sorted,
    sort_align,
    topk_routing,
)
from triton_dist_tpu_torch.kernels.quant import (
    quantize_channelwise,
    quantize_rowwise,
)
from triton_dist_tpu_torch.layers.ep_a2a import (
    ep_combine_shard,
    ep_dispatch_shard,
)
from triton_dist_tpu_torch.runtime.utils import resolve_device


def expert_ffn(recv, recv_expert, *, n_experts, block_m, ffn):
    """The experts' compute over every rank's received rows: recv [W, W,
    max_tokens, H], recv_expert [W, W, max_tokens] global ids -> y in the
    same layout, ``ffn(x_sorted, tile_expert)`` run once over all ranks'
    sorted rows (tiles tagged with global experts; each expert's tiles
    come from its owner alone)."""
    world, _, max_tokens, hidden = recv.shape
    epr = n_experts // world
    base = torch.arange(world, device=recv.device)[:, None, None] * epr
    # rank r's local expert clip(e - r E/W, 0, E/W - 1), as a global id
    global_e = torch.clamp(recv_expert - base, 0, epr - 1) + base
    rows = world * world * max_tokens
    splan = sort_align(global_e.reshape(rows, 1), n_experts, block_m)
    x_sorted = gather_sorted(recv.reshape(rows, hidden), splan["dest"],
                             splan["m_pad"])
    y_sorted = ffn(x_sorted, splan["tile_expert"])
    return y_sorted[splan["dest"]].reshape(world, world, max_tokens, hidden)


def _sorted_ffn(x_loc, experts_loc, weights_loc, *, n_experts, max_tokens,
                block_m, ffn, plain):
    """dispatch -> :func:`expert_ffn` -> combine: x_loc [W, t_loc, H] ->
    [W, t_loc, H]."""
    recv, recv_expert, _splits, plan, _dropped = ep_dispatch_shard(
        x_loc, experts_loc, n_experts=n_experts, max_tokens=max_tokens,
        plain=plain)
    y = expert_ffn(recv, recv_expert, n_experts=n_experts, block_m=block_m,
                   ffn=ffn)
    return ep_combine_shard(y, weights_loc, plan, plain=plain)


def moe_infer_shard(x_loc, weights_loc, experts_loc, w_gate, w_up, w_down, *,
                    n_experts, max_tokens, block_m, plain=False):
    """The serving MoE FFN of every rank: x_loc [W, t_loc, H] -> [W, t_loc,
    H].  weights_loc [W, t_loc, topk] f32 routing weights, experts_loc
    [W, t_loc, topk] global expert ids; w_* the expert stacks [E, H, F] /
    [E, F, H] (rank-major: rank r owns slabs r E/W ...)."""
    def ffn(x_sorted, tile_expert):
        return moe_ffn_sorted(x_sorted, w_gate, w_up, w_down, tile_expert,
                              block_m=block_m, plain=plain)

    return _sorted_ffn(x_loc, experts_loc, weights_loc, n_experts=n_experts,
                       max_tokens=max_tokens, block_m=block_m, ffn=ffn,
                       plain=plain)


def moe_ffn_sorted_w8a8(x_sorted, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s,
                        tile_expert, *, block_m, plain=False):
    """W8A8 grouped SwiGLU: x_sorted [M_pad, H] float; w*_q int8 stacks
    [E, H, F] / [E, F, H] with scales [E, F] / [E, H]."""
    row_e = torch.repeat_interleave(tile_expert.long(), block_m)

    def gg(q, w_q):
        return group_gemm_i8(q, w_q, tile_expert, block_m=block_m,
                             plain=plain).float()

    x_q, x_s = quantize_rowwise(x_sorted)
    gate = gg(x_q, wg_q) * x_s[:, None] * wg_s[row_e]
    up = gg(x_q, wu_q) * x_s[:, None] * wu_s[row_e]
    hidden = torch.nn.functional.silu(gate) * up
    h_q, h_s = quantize_rowwise(hidden)
    down = gg(h_q, wd_q) * h_s[:, None] * wd_s[row_e]
    return down.to(x_sorted.dtype)


def moe_infer_shard_w8a8(x_loc, weights_loc, experts_loc, wg_q, wg_s, wu_q,
                         wu_s, wd_q, wd_s, *, n_experts, max_tokens, block_m,
                         plain=False):
    """W8A8 twin of :func:`moe_infer_shard` (same dispatch and combine;
    the expert compute runs the int8 grouped GEMMs)."""
    def ffn(x_sorted, tile_expert):
        return moe_ffn_sorted_w8a8(x_sorted, wg_q, wg_s, wu_q, wu_s, wd_q,
                                   wd_s, tile_expert, block_m=block_m,
                                   plain=plain)

    return _sorted_ffn(x_loc, experts_loc, weights_loc, n_experts=n_experts,
                       max_tokens=max_tokens, block_m=block_m, ffn=ffn,
                       plain=plain)


@dataclass
class DistributedMoELayer:
    """Counterpart of the reference's ``DistributedMoELayer`` (:137) over
    ``world`` ranks of the virtual world on ``device``.

    Tokens [T, H] split over the ranks (rank r's rows r T/W ...), expert
    ``e`` on rank ``e // (E / W)``.  ``max_tokens`` is the per-(src, dst)
    dispatch capacity (None: the lossless ``t_loc * topk``); ``block_m``
    None picks :func:`load_aware_block_m` of the batch.  ``weights`` is a
    dict of tensors on ``device`` (``init_weights``, or assigned
    directly), the expert stacks [E, ...] whatever the world (module
    docstring).  A (slow, fast) tuple ``axis`` (the reference's two-tier
    all-to-all) raises: the layer holds a flat world (the two-stage
    all-to-all itself is ``kernels/hierarchical.hier_all_to_all_shard``
    over a ``Mesh``)."""

    n_experts: int
    topk: int
    hidden: int
    intermediate: int
    max_tokens: int | None = None
    block_m: int | None = None
    dtype: Any = torch.bfloat16
    world: int = 1
    axis: Any = "ep"
    device: Any = "cuda"
    weights: dict = field(default=None)

    def __post_init__(self):
        if check_axis(self.axis):
            raise NotImplementedError(
                f"axis {tuple(self.axis)}: the layer over a (slow, fast) "
                f"mesh is not ported yet (ROADMAP Queue 1's ninth entry)")
        if self.world < 1 or self.n_experts % self.world:
            raise ValueError(f"{self.n_experts} experts do not split over "
                             f"{self.world} ranks")
        self.device = resolve_device(self.device)

    @property
    def experts_per_rank(self) -> int:
        return self.n_experts // self.world

    # -- weights -----------------------------------------------------------
    def init_weights(self, seed: int = 0) -> dict:
        """Random weights from a seeded ``torch.Generator`` (the
        reference's normal / sqrt(fan_in) init; the router in f32)."""
        E, H, F_ = self.n_experts, self.hidden, self.intermediate
        gen = torch.Generator(device=self.device).manual_seed(int(seed))

        def draw(shape, fan_in, dtype):
            out = torch.empty(shape, dtype=dtype, device=self.device)
            for e in range(shape[0]):
                out[e] = (torch.randn(shape[1:], generator=gen,
                                      device=self.device)
                          / math.sqrt(fan_in)).to(dtype)
            return out

        self.weights = {
            "router": draw((H, E), H, torch.float32),
            "w_gate": draw((E, H, F_), H, self.dtype),
            "w_up": draw((E, H, F_), H, self.dtype),
            "w_down": draw((E, F_, H), F_, self.dtype),
        }
        return self.weights

    def quantize_weights(self) -> dict:
        """Convert the expert stacks to W8A8 (int8 and per-expert-channel
        scales); later ``forward`` calls run the int8 grouped GEMMs.  The
        router stays f32."""
        def per_expert(w):   # [E, K, N] -> ([E, K, N] int8, [E, N] f32)
            qs = [quantize_channelwise(w[e]) for e in range(w.shape[0])]
            return (torch.stack([q for q, _ in qs]),
                    torch.stack([s for _, s in qs]))

        w = self.weights
        qw = {"router": w["router"]}
        for name in ("w_gate", "w_up", "w_down"):
            qw[name + "_q"], qw[name + "_s"] = per_expert(w[name])
        self.weights = qw
        return qw

    def weight_specs(self) -> dict:
        """The reference's PartitionSpecs, as the dimension of each weight
        split over the ranks (None: held once): the router is replicated,
        the expert stacks split on their expert dimension."""
        return {"router": None, "w_gate": 0, "w_up": 0, "w_down": 0}

    @property
    def is_quantized(self) -> bool:
        return self.weights is not None and "w_gate_q" in self.weights

    # -- forward -----------------------------------------------------------
    def route(self, x):
        """Router probabilities -> (weights [T, topk] f32, experts int32)."""
        return topk_routing(x.float() @ self.weights["router"], self.topk)

    def forward(self, x, experts=None, routing_weights=None, *,
                plain: bool = False):
        """x [T, H], T a multiple of ``world``.  ``experts`` /
        ``routing_weights`` may be given (the reference's simulated
        indices) or come from the router.  Returns [T, H] in ``dtype``."""
        if experts is None:
            routing_weights, experts = self.route(x)
        if routing_weights is None:
            routing_weights = torch.full(experts.shape, 1.0 / self.topk,
                                         dtype=torch.float32,
                                         device=experts.device)
        block_m = self.block_m or load_aware_block_m(
            x.shape[0] * self.topk, self.n_experts)
        opts = dict(n_experts=self.n_experts, max_tokens=self.max_tokens,
                    block_m=block_m, plain=plain)
        w = self.weights

        def ranks(t):
            return t.reshape(self.world, -1, t.shape[-1])

        x, routing_weights, experts = (ranks(x.to(self.dtype)),
                                       ranks(routing_weights), ranks(experts))
        if self.is_quantized:
            out = moe_infer_shard_w8a8(
                x, routing_weights, experts, w["w_gate_q"], w["w_gate_s"],
                w["w_up_q"], w["w_up_s"], w["w_down_q"], w["w_down_s"],
                **opts)
        else:
            out = moe_infer_shard(x, routing_weights, experts, w["w_gate"],
                                  w["w_up"], w["w_down"], **opts)
        return out.reshape(-1, self.hidden)

    __call__ = forward
