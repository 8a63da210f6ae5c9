"""MoE transformer (Mixtral / DeepSeek class), at world 1 and expert-parallel
over W ranks.

Counterpart of ``triton_dist_tpu/models/moe.py``: the Llama attention
block (``models/llama.attention_block_shard``, through ``cfg.as_llama()``)
with the dense FFN replaced by a top-k routed expert FFN — the f32
router, the dispatch and combine of ``layers/ep_a2a.py`` (the all-to-all
kernel), the sort/align of ``kernels/moe_utils.py`` and three grouped
GEMMs (``kernels/group_gemm.py``: the hand-written kernel on the card, dx
through its transposed mode in the backward).  The Switch-style
load-balance aux loss is the reference's: each rank's local-batch loss,
divided by the world size.

``world`` chooses the parallelism (the reference's layout, :18-27):

- world 1: every projection ``torch.matmul``, the all-to-all a copy;
- world W > 1, over the port's virtual world of W ranks on one device:
  attention tensor-parallel over heads with a sequence-parallel residual
  stream [W, S/W, B, D] (the dense family's code: the AG-GEMM and GEMM-RS
  kernels), the FFN expert-parallel (expert e on rank e // (E/W); tokens
  travel to their experts through the all-to-all's peer segments and back
  the same way).  :func:`shard_params` makes the tree.

Parameters are a plain dict in the reference's pytree layout:
``{"embed", "lm_head", "final_norm", "layers": [{"attn_norm",
"mlp_norm", "wq", "wk", "wv", "wo", "router" (f32), "w_gate" [E, D, F],
"w_up" [E, D, F], "w_down" [E, F, D]}, ...]}``.  The reference's mesh,
``axis``, ``dp_axis``, ``impl`` and ``interpret`` arguments are dropped;
``plain`` runs the plain version of every hand-written kernel the family
runs (attention, all-to-all, grouped GEMM): a reference computation on any
device.  ``routes`` pins the routing, so that two computations of the
model can be compared token for token (:func:`forward_shard`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.group_gemm import moe_ffn_sorted
from triton_dist_tpu_torch.kernels.moe_utils import topk_routing
from triton_dist_tpu_torch.layers.ep_a2a import (
    ep_combine_shard,
    ep_dispatch_shard,
)
from triton_dist_tpu_torch.layers.moe_inference import expert_ffn
from triton_dist_tpu_torch.models import llama
from triton_dist_tpu_torch.models.llama import (
    LlamaConfig,
    _LogitsF32,
    _rms_norm,
    attention_block_shard,
)
from triton_dist_tpu_torch.runtime.utils import (
    resolve_device,
    tree_leaves,
    value_and_grad,
)


@dataclass(frozen=True)
class MoEConfig:
    vocab: int = 512
    dim: int = 256
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    n_experts: int = 8
    topk: int = 2
    expert_ffn_dim: int = 256
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    aux_loss_coef: float = 0.01
    # grouped-GEMM row-tile size; also the expert padding granularity
    block_m: int = 128
    # per-destination-rank token capacity; None = lossless t_loc * topk
    max_tokens: int | None = None
    dtype: torch.dtype = torch.float32
    attn_window: int = 0
    attn_soft_cap: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def as_llama(self) -> LlamaConfig:
        """Attention-side view (the shared attention takes a LlamaConfig)."""
        return LlamaConfig(
            vocab=self.vocab, dim=self.dim, n_layers=self.n_layers,
            n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            ffn_dim=self.expert_ffn_dim, max_seq=self.max_seq,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            dtype=self.dtype, attn_window=self.attn_window,
            attn_soft_cap=self.attn_soft_cap)

    @staticmethod
    def mixtral_8x7b() -> "MoEConfig":
        """Mixtral-8x7B shapes (the DeepEP / EP-MoE benchmark class)."""
        return MoEConfig(vocab=32000, dim=4096, n_layers=32, n_heads=32,
                         n_kv_heads=8, n_experts=8, topk=2,
                         expert_ffn_dim=14336, dtype=torch.bfloat16)

    @staticmethod
    def deepseek_moe() -> "MoEConfig":
        """The reference's low-latency all-to-all benchmark configuration
        (128 experts, topk 8, hidden 7168: the DeepSeek-V3 serving
        point)."""
        return MoEConfig(vocab=129280, dim=7168, n_layers=61, n_heads=128,
                         n_kv_heads=128, n_experts=128, topk=8,
                         expert_ffn_dim=2048, dtype=torch.bfloat16)

    @staticmethod
    def tiny(dtype=torch.float32) -> "MoEConfig":
        """Test size (head_dim 128; block_m small enough for few tokens)."""
        return MoEConfig(vocab=512, dim=512, n_layers=2, n_heads=4,
                         n_kv_heads=4, n_experts=8, topk=2,
                         expert_ffn_dim=512, max_seq=128, block_m=8,
                         dtype=dtype)


CONFIGS = {"mixtral_8x7b": MoEConfig.mixtral_8x7b,
           "deepseek_moe": MoEConfig.deepseek_moe, "tiny": MoEConfig.tiny}


def _layer_shapes(cfg: MoEConfig) -> dict:
    hd, E, F_ = cfg.head_dim, cfg.n_experts, cfg.expert_ffn_dim
    return {
        "wq": (cfg.dim, cfg.n_heads * hd),
        "wk": (cfg.dim, cfg.n_kv_heads * hd),
        "wv": (cfg.dim, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, cfg.dim),
        "router": (cfg.dim, E),
        "w_gate": (E, cfg.dim, F_),
        "w_up": (E, cfg.dim, F_),
        "w_down": (E, F_, cfg.dim),
    }


def init_params(cfg: MoEConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's ``1/sqrt(fan_in)`` scaling
    (the router in f32), drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the bits differ from JAX's; ``params_from_jax``
    carries those).  Each matrix is drawn in f32 row blocks and cast, so a
    full-width model never holds more than one f32 block beside its
    weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def dense(shape, fan_in, dtype=cfg.dtype):
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1, shape[-1])
        rows = max(1, (1 << 26) // shape[-1])
        for r0 in range(0, flat.shape[0], rows):
            blk = torch.randn((min(rows, flat.shape[0] - r0), shape[-1]),
                              generator=gen, device=dev, dtype=torch.float32)
            flat[r0:r0 + blk.shape[0]] = (blk / math.sqrt(fan_in)).to(dtype)
        return out

    ones = lambda: torch.ones((cfg.dim,), dtype=cfg.dtype, device=dev)
    params = {
        "embed": dense((cfg.vocab, cfg.dim), 1),
        "lm_head": dense((cfg.dim, cfg.vocab), cfg.dim),
        "final_norm": ones(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {"attn_norm": ones(), "mlp_norm": ones()}
        for name, shape in _layer_shapes(cfg).items():
            layer[name] = dense(shape, shape[-2],     # fan_in
                                torch.float32 if name == "router"
                                else cfg.dtype)
        params["layers"].append(layer)
    return params


def params_from_jax(tree, cfg: MoEConfig, device="cuda") -> dict:
    """Carry the reference's parameter pytree across: ``tree`` holds numpy
    arrays (``jax.device_get`` of ``moe.init_params``) in the same nesting
    and orientation; returns the port's dict on ``device`` in
    ``cfg.dtype``, the router in f32."""
    dev = resolve_device(device)

    def conv(x, shape, dtype=cfg.dtype):
        a = np.asarray(x)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"parameter shape {tuple(t.shape)} != "
                             f"{tuple(shape)} for {cfg}")
        return t.to(device=dev, dtype=dtype)

    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, cfg has "
                         f"{cfg.n_layers}")
    out = {
        "embed": conv(tree["embed"], (cfg.vocab, cfg.dim)),
        "lm_head": conv(tree["lm_head"], (cfg.dim, cfg.vocab)),
        "final_norm": conv(tree["final_norm"], (cfg.dim,)),
        "layers": [],
    }
    for lt in tree["layers"]:
        layer = {"attn_norm": conv(lt["attn_norm"], (cfg.dim,)),
                 "mlp_norm": conv(lt["mlp_norm"], (cfg.dim,))}
        for name, shape in _layer_shapes(cfg).items():
            layer[name] = conv(lt[name], shape,
                               torch.float32 if name == "router"
                               else cfg.dtype)
        out["layers"].append(layer)
    return out


# ---------------------------------------------------------------------------
# Expert parallelism over W ranks
# ---------------------------------------------------------------------------


def _check_world(cfg: MoEConfig, world: int) -> None:
    if world < 1 or cfg.n_experts % world:
        raise ValueError(f"EP over {world} ranks needs n_experts "
                         f"({cfg.n_experts}) divisible by it")
    llama._check_world(cfg.as_llama(), world)


def shard_params(params, cfg: MoEConfig, world: int) -> dict:
    """The W-rank tree of a world-1 tree (``init_params`` or
    ``params_from_jax`` output, or a gradient tree shaped like one), as the
    reference's ``param_specs`` (:160) cut it: the attention weights as in
    ``llama.shard_params`` (wq, wk, wv [W, D, out/W]; wo [W, in/W, D]:
    copies); the expert stacks stay [E, ...] (stacked rank-major they are
    the sharded layout: rank r's slab is the view ``w[r E/W ...]``); the
    router, norms, embed and lm_head held once, so autograd sums the
    ranks' contributions into their one gradient (the reference's psum).
    Every leaf but the attention weights is the input's own tensor (the
    expert stacks are the bulk of the model).  At world 1 the tree is
    returned as it is."""
    _check_world(cfg, world)
    if world == 1:
        return params

    def split(t, dim):
        return torch.stack(t.chunk(world, dim=dim))

    cut = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    out = {k: params[k] for k in ("embed", "lm_head", "final_norm")}
    out["layers"] = [{k: split(t, cut[k]) if k in cut else t
                      for k, t in layer.items()}
                     for layer in params["layers"]]
    return out


# ---------------------------------------------------------------------------
# MoE FFN (shard level)
# ---------------------------------------------------------------------------


def moe_ffn_shard(h2, layer, cfg: MoEConfig, *, plain=False, experts=None):
    """Routed expert FFN over every rank's tokens h2 [W, t_loc, D]: f32
    router, top-k, dispatch (zero_undefined: the training path), sort by
    expert, grouped-GEMM SwiGLU, combine.  ``experts`` [W, t_loc, topk],
    where given, replaces the router's top-k choice (the routing weights
    are still the router's renormalised probabilities of those experts).
    Returns (out [W, t_loc, D] in ``cfg.dtype``, aux-loss contribution f32
    scalar, experts [W, t_loc, topk] int32)."""
    E = cfg.n_experts
    world, t_loc, _ = h2.shape
    logits = h2.float() @ layer["router"]                   # [W, t_loc, E]
    if experts is None:
        weights, experts = topk_routing(logits, cfg.topk)
    else:
        picked = torch.softmax(logits, dim=-1).gather(-1, experts.long())
        weights = picked / picked.sum(dim=-1, keepdim=True)

    # Switch-style balance loss E * sum_e f_e * p_e over each rank's local
    # tokens (f: share of assignments to e, not differentiable; p: mean
    # router probability of e), the mean over the ranks (the reference's
    # per-device contribution divided by the world, :205)
    probs = torch.softmax(logits, dim=-1)
    rank = torch.arange(world, device=h2.device)[:, None]
    frac = torch.zeros((world, E), dtype=torch.float32,
                       device=h2.device).index_put(
        (rank.expand(world, t_loc * cfg.topk),
         experts.reshape(world, -1).long()),
        torch.ones((), dtype=torch.float32, device=h2.device),
        accumulate=True) / (t_loc * cfg.topk)
    aux = E * torch.sum(frac * probs.mean(dim=1)) / world

    recv, recv_expert, _splits, plan, _dropped = ep_dispatch_shard(
        h2.to(cfg.dtype), experts, n_experts=E, max_tokens=cfg.max_tokens,
        plain=plain, zero_undefined=True)

    def ffn(x_sorted, tile_expert):
        return moe_ffn_sorted(x_sorted, layer["w_gate"], layer["w_up"],
                              layer["w_down"], tile_expert,
                              block_m=cfg.block_m, plain=plain)

    y = expert_ffn(recv, recv_expert, n_experts=E, block_m=cfg.block_m,
                   ffn=ffn)
    out = ep_combine_shard(y, weights, plan, plain=plain)
    return out.to(cfg.dtype), aux, experts


def moe_block_shard(x, layer, cfg: MoEConfig, *, plain=False, experts=None):
    """MoE FFN sub-block with residual: RMSNorm, routed expert FFN.
    x: [S, B, D] at world 1, [W, S/W, B, D] over W ranks.  Returns (x',
    aux contribution, experts [S*B, topk]: every rank's, in sequence
    order, the layout ``experts`` is given in too)."""
    world = x.shape[0] if x.dim() == 4 else 1
    s_loc, b = x.shape[-3:-1]
    h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    if experts is not None:
        experts = experts.reshape(world, s_loc * b, cfg.topk)
    out, aux, experts = moe_ffn_shard(h.reshape(world, s_loc * b, cfg.dim),
                                      layer, cfg, plain=plain,
                                      experts=experts)
    return (x + out.reshape(x.shape), aux,
            experts.reshape(world * s_loc * b, cfg.topk))


# ---------------------------------------------------------------------------
# Forward / loss
# ---------------------------------------------------------------------------


def forward_shard(params, tokens, cfg: MoEConfig, *, world=1, plain=False,
                  routes=None):
    """tokens [S, B] int (seq-major) -> (logits [S, B, vocab] f32, aux
    loss f32 scalar summed over layers).  Over ``world`` > 1 ranks
    ``params`` is the :func:`shard_params` tree and rank r holds positions
    r S/W .. (r + 1) S/W - 1: attention is tensor-parallel over heads on
    the AG-GEMM and GEMM-RS kernels (``llama.attention_block_shard``), the
    FFN expert-parallel; the logits come back in sequence order.

    ``routes``, a list: when empty, each layer appends the experts it
    picked ([S*B, topk] int32, sequence order at every world, so rank r's
    are rows r S/W B ...); when it holds one entry per layer, each layer
    takes its experts from it instead of its router's top-k.  Two
    computations that differ by rounding (kernels and plain versions, or
    two worlds) then send every token to the same experts, where a
    near-tie of two router probabilities could otherwise move a token's
    whole FFN output."""
    _check_world(cfg, world)
    lcfg = cfg.as_llama()
    s, b = tokens.shape
    if s % world:
        raise ValueError(f"{s} positions do not split over {world} ranks")
    x = params["embed"][tokens.long()]                               # [S,B,D]
    if world > 1:
        x = x.reshape(world, s // world, b, cfg.dim)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    replay = bool(routes)
    for i, layer in enumerate(params["layers"]):
        x = attention_block_shard(x, layer, lcfg, plain=plain)
        x, aux, experts = moe_block_shard(
            x, layer, cfg, plain=plain, experts=routes[i] if replay else None)
        if routes is not None and not replay:
            routes.append(experts)
        aux_total = aux_total + aux
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _LogitsF32.apply(x.reshape(s * b, cfg.dim), params["lm_head"])
    return logits.reshape(s, b, cfg.vocab), aux_total


def loss_shard(params, tokens, targets, cfg: MoEConfig, *, world=1,
               plain=False, routes=None):
    """Mean next-token cross-entropy over every [S, B] position plus
    ``aux_loss_coef`` times the balance loss: the sum of the reference's
    per-device contributions over the ``world`` ranks (``routes`` as in
    :func:`forward_shard`)."""
    logits, aux = forward_shard(params, tokens, cfg, world=world,
                                plain=plain, routes=routes)
    ce = F.cross_entropy(logits.reshape(-1, cfg.vocab),
                         targets.reshape(-1).long())
    return ce + cfg.aux_loss_coef * aux


def make_forward(cfg: MoEConfig, world: int = 1, *, plain=False):
    """``fn(params, tokens [S, B], routes=None) -> (logits [S, B, vocab]
    f32, aux)``; over ``world`` > 1 ranks ``params`` is the
    :func:`shard_params` tree."""
    _check_world(cfg, world)
    return functools.partial(forward_shard, cfg=cfg, world=world,
                             plain=plain)


def dp_loss(params, tokens, targets, cfg: MoEConfig, *, dp: int = 1, **kw):
    """The loss of the reference's data parallelism over ``dp`` ranks
    (``dp_axis``): the mean over the ranks of :func:`loss_shard`, rank d on
    its B / dp columns of tokens / targets [S, B].  The balance loss is
    each rank's own (the reference's ``aux / dp``), so the batch is split.
    The ranks share every leaf, so autograd's accumulation over them is the
    reference's psum over dp (XLA's there: no kernel is owed)."""
    b = llama.check_dp(tokens, dp)
    return sum(loss_shard(params, tokens[:, d * b:(d + 1) * b],
                          targets[:, d * b:(d + 1) * b], cfg, **kw)
               for d in range(dp)) / dp


def make_train_step(cfg: MoEConfig, world: int = 1, *, lr=1e-3,
                    dp: int = 1):
    """Plain-SGD step ``step(params, tokens, targets) -> (params, loss)``:
    loss and gradients by autograd (attention through the flash kernels
    and, over ``world`` > 1 ranks, the AG-GEMM / GEMM-RS kernels; dispatch
    and combine through the all-to-all kernel, the expert FFN through the
    grouped GEMM's forward, dx and dW), then ``p - lr * g`` in the
    parameter dtype, IN PLACE as ``llama.make_train_step`` does (a second
    copy of the weights would not fit the card).  A leaf held once (the
    router, norms, embed, lm_head) gets the sum of every rank's gradient,
    the reference's psum; ``dp`` > 1 splits the batch over data-parallel
    ranks (:func:`dp_loss`)."""
    _check_world(cfg, world)

    def step(params, tokens, targets):
        loss, grads = value_and_grad(dp_loss, params, tokens, targets, cfg,
                                     dp=dp, world=world)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.sub_(lr * g.to(p.dtype))
        return params, loss

    return step
