"""Llama-style dense transformer: configuration, parameters, RMSNorm, RoPE,
and the training forward at world 1 and under tensor parallelism.

Counterpart of ``triton_dist_tpu/models/llama.py``.  Parameters are a
plain dict of tensors in the reference's pytree layout and ``[in, out]``
orientation (``x @ W``): ``{"embed", "lm_head", "final_norm", "layers":
[{"attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "wgate", "wup",
"wdown"}, ...]}``.

The training forward keeps the reference's names and layout (seq-major
tokens ``[S, B]``, the fused ``wqkv`` projection, RoPE over the full
sequence), with the mesh, ``axis``, ``impl`` and ``interpret`` arguments
dropped.  ``world`` chooses the parallelism:

- world 1: every projection is ``torch.matmul`` (the reference's
  overlapped projections reduce to a dot there) and gradients are
  ordinary autograd;
- world W > 1: the sequence-parallel tensor parallelism of the reference
  (``param_specs`` :151) over the port's virtual world of W ranks on one
  device.  :func:`shard_params` turns a world-1 tree into the TP tree:
  column-parallel weights (wq, wk, wv, wgate, wup) become [W, in, out/W],
  row-parallel ones (wo, wdown) [W, in/W, out], whole heads per rank; the
  replicated leaves (embed, lm_head, the norms) are held once, so autograd
  sums the ranks' contributions into their one gradient, the reference's
  ``psum`` over tp (:357-362).  The residual stream is [W, S/W, B, D]
  (rank r holds positions r S/W ...), every column-parallel projection is
  the AG-GEMM kernel and every row-parallel one the GEMM-RS kernel
  (``layers/tp_linear.py``), in the forward and the backward.

Attention is the flash kernels' ``FlashAttentionFn`` (hand-written
forward and backward on the card) over every rank's heads at once.  The
serving path's layer math lives in ``models/generate.py``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.flash_attention import flash_gqa_attention
from triton_dist_tpu_torch.layers.tp_linear import (
    column_parallel_linear,
    row_parallel_linear,
)
from triton_dist_tpu_torch.runtime.utils import (
    resolve_device,
    tree_leaves,
    value_and_grad,
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 32000
    dim: int = 512
    n_layers: int = 2
    n_heads: int = 8
    n_kv_heads: int = 4
    ffn_dim: int = 1408
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # Attention variants: sliding window (Mistral) and logit soft-capping
    # (Gemma-2), threaded to the attention kernels.  0 = off.
    attn_window: int = 0
    attn_soft_cap: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig(vocab=128256, dim=4096, n_layers=32, n_heads=32,
                           n_kv_heads=8, ffn_dim=14336, dtype=torch.bfloat16)

    @staticmethod
    def mistral_7b() -> "LlamaConfig":
        """The reference's preset (``models/llama.py:82-90``): Llama-3-8B's
        layer widths at a vocabulary of 32,000, rope_theta 1e6; the
        sliding window stays off, as there."""
        return LlamaConfig(vocab=32000, dim=4096, n_layers=32, n_heads=32,
                           n_kv_heads=8, ffn_dim=14336, rope_theta=1e6,
                           dtype=torch.bfloat16)

    @staticmethod
    def tiny(dtype=torch.float32) -> "LlamaConfig":
        return LlamaConfig(vocab=512, dim=1024, n_layers=2, n_heads=8,
                           n_kv_heads=4, ffn_dim=1024, max_seq=256,
                           dtype=dtype)


CONFIGS = {"llama3_8b": LlamaConfig.llama3_8b,
           "mistral_7b": LlamaConfig.mistral_7b, "tiny": LlamaConfig.tiny}


def _layer_shapes(cfg: LlamaConfig) -> dict:
    hd = cfg.head_dim
    return {
        "wq": (cfg.dim, cfg.n_heads * hd),
        "wk": (cfg.dim, cfg.n_kv_heads * hd),
        "wv": (cfg.dim, cfg.n_kv_heads * hd),
        "wo": (cfg.n_heads * hd, cfg.dim),
        "wgate": (cfg.dim, cfg.ffn_dim),
        "wup": (cfg.dim, cfg.ffn_dim),
        "wdown": (cfg.ffn_dim, cfg.dim),
    }


def init_params(cfg: LlamaConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters with the reference's ``1/sqrt(fan_in)`` scaling,
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the bits differ from JAX's; ``params_from_jax`` carries those).
    Each matrix is drawn in f32 row blocks and cast, so a full-size model
    never holds more than one f32 block beside its bf16 weights."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        rows = max(1, (1 << 26) // shape[1])
        for r0 in range(0, shape[0], rows):
            blk = torch.randn((min(rows, shape[0] - r0), shape[1]),
                              generator=gen, device=dev,
                              dtype=torch.float32)
            out[r0:r0 + blk.shape[0]] = (blk / math.sqrt(fan_in)).to(
                cfg.dtype)
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
            layer[name] = dense(shape, shape[0])
        params["layers"].append(layer)
    return params


def params_from_jax(tree, cfg: LlamaConfig, device="cuda") -> dict:
    """Carry the reference's parameter pytree across: ``tree`` holds numpy
    arrays (``jax.device_get`` of ``llama.init_params``) in the same
    nesting and ``[in, out]`` orientation; returns the port's dict on
    ``device`` in ``cfg.dtype``.  A world-1 W8A8 serving tree (the
    reference's ``llama_w8a8.quantize_serve_params``: ``wgate_q/s``,
    ``wup_q/s``, ``wo_q/s``, ``wdown_q/s`` in place of the float
    weights) converts too, its int8 weights and f32 scales kept as they
    are."""
    dev = resolve_device(device)

    def conv(x, shape, dtype=cfg.dtype):
        a = np.asarray(x)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
        np_dtype = np.int8 if dtype == torch.int8 else np.float32
        t = torch.from_numpy(np.array(a, dtype=np_dtype))
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
            if name + "_q" not in lt:
                layer[name] = conv(lt[name], shape)
                continue
            # W8A8: row weights (wo, wdown) stack one scale row per rank
            s_shape = ((1, shape[1]) if name in ("wo", "wdown")
                       else (shape[1],))
            layer[name + "_q"] = conv(lt[name + "_q"], shape, torch.int8)
            layer[name + "_s"] = conv(lt[name + "_s"], s_shape,
                                      torch.float32)
        out["layers"].append(layer)
    return out


def _rms_norm(x, w, eps):
    """RMSNorm in f32, cast back to ``x.dtype``, then scaled by ``w``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


@functools.lru_cache(maxsize=None)
def _rope_freqs(hd, theta, device):
    """RoPE inverse frequencies [hd/2] f32 on ``device`` (cached: one
    host-to-device copy per process, not one per layer call)."""
    return torch.from_numpy(
        1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    ).to(device)


def _rope_table(positions, hd, theta):
    """(cos, sin) [N, hd/2] f32 for ``positions`` [N] — computed once per
    forward and shared by every layer's q and k."""
    angles = positions[:, None].float() * _rope_freqs(
        hd, float(theta), positions.device)[None, :]
    return torch.cos(angles), torch.sin(angles)


def _rotate(x, cos, sin):
    """Half-split rotation (Llama convention, not interleaved)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x, positions, theta, table=None):
    """x: [S, B, H, hd]; positions [S] int (``table``: their
    precomputed ``_rope_table``)."""
    cos, sin = table or _rope_table(positions, x.shape[-1], theta)
    return _rotate(x, cos[:, None, None, :], sin[:, None, None, :])


def _silu_mul(gate, up):
    """SwiGLU activation in f32, cast back: silu(gate) * up."""
    return torch.nn.functional.silu(gate.float()).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# Tensor-parallel parameters
# ---------------------------------------------------------------------------

_COLUMN = ("wq", "wk", "wv", "wgate", "wup", "wqkv")   # P(None, tp)
_ROW = ("wo", "wdown")                                  # P(tp, None)


def _check_world(cfg: LlamaConfig, world: int) -> None:
    if world < 1 or cfg.n_heads % world or cfg.n_kv_heads % world:
        raise ValueError(f"TP over {world} ranks needs n_heads "
                         f"({cfg.n_heads}) and n_kv_heads ({cfg.n_kv_heads}) "
                         f"divisible by it")


def _rank_stack(params, world: int) -> dict:
    """Every leaf laid out rank by rank (rank r's shard at [r]) as the
    reference's ``param_specs`` / ``w8a8_param_specs`` cut it: column
    weights (and a W8A8 tree's int8 ``<name>_q`` of them) [W, in, out/W]
    with their channel scales ``<name>_s`` [W, out/W]; row weights [W,
    in/W, out] with rank r's own scale row ``[W, 1, out]`` (from the
    ``[world, out]`` scales of a tree quantized for ``world``); every other
    leaf copied once.  No leaf aliases the input."""

    def split(t, dim):
        return torch.stack(t.chunk(world, dim=dim))

    def leaf(key, t):
        name, suffix = key.rsplit("_", 1) if key.endswith(
            ("_q", "_s")) else (key, "")
        if name in _COLUMN:
            return split(t, 0 if suffix == "s" else 1)
        if name not in _ROW:
            return t.clone()
        if suffix != "s":
            return split(t, 0)
        if t.shape[0] != world:
            raise ValueError(
                f"{key}: scales quantized for a world of {t.shape[0]}, "
                f"placed over {world} ranks (quantize the row weights "
                f"with world={world})")
        return t.clone().unsqueeze(1)

    out = {k: params[k].clone() for k in ("embed", "lm_head", "final_norm")}
    out["layers"] = [{k: leaf(k, t) for k, t in layer.items()}
                     for layer in params["layers"]]
    return out


def shard_params(params, cfg: LlamaConfig, world: int) -> dict:
    """The tensor-parallel tree of a world-1 tree (``init_params`` or
    ``params_from_jax`` output, a gradient tree shaped like one, or a W8A8
    tree of ``llama_w8a8`` quantized for ``world``): column-parallel
    weights [W, in, out/W], row-parallel ones [W, in/W, out], rank r's
    shard at [r] as the reference's ``param_specs`` cut them (the W8A8
    scales beside their weights: :func:`_rank_stack`); replicated leaves
    copied once.  No leaf aliases the input.  At world 1 the tree is
    returned as it is."""
    _check_world(cfg, world)
    if world == 1:
        return params
    return _rank_stack(params, world)


# ---------------------------------------------------------------------------
# Training forward (the reference's shard-level functions)
# ---------------------------------------------------------------------------


def _attention(q, k, v, cfg: LlamaConfig, *, plain=False):
    """Causal GQA attention over the full sequence: q [S, B, Hq, hd], k/v
    [S, B, Hkv, hd] through the flash kernels (differentiable); ``plain``
    takes the plain PyTorch version under autograd instead.  With a
    leading rank dimension (q [W, S, B, Hq/W, hd]) every rank's heads go
    through one call (``flash_gqa_attention``)."""
    return flash_gqa_attention(
        q, k, v, causal=True, scale=1.0 / math.sqrt(cfg.head_dim),
        window=cfg.attn_window, soft_cap=cfg.attn_soft_cap, plain=plain)


def attention_block_shard(x, layer, cfg: LlamaConfig, *, plain=False):
    """RMSNorm → fused-QKV column-parallel projection → RoPE → causal GQA
    on the local heads → row-parallel out projection, residual added.
    x: [S, B, D] at world 1, [W, S/W, B, D] over W ranks (``layer``'s
    weights sharded by :func:`shard_params`)."""
    lead = x.shape[:-3]
    world = lead[0] if lead else 1
    s_loc, b, _ = x.shape[-3:]
    s = world * s_loc
    hd = cfg.head_dim
    hq, hkv = cfg.n_heads // world, cfg.n_kv_heads // world
    positions = torch.arange(s, device=x.device)
    table = _rope_table(positions, hd, cfg.rope_theta)
    h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
    wqkv = torch.cat([layer["wq"], layer["wk"], layer["wv"]], dim=-1)
    qkv = column_parallel_linear(h.reshape(*lead, s_loc * b, cfg.dim),
                                 wqkv, plain=plain)
    qkv = qkv.reshape(*lead, s, b, (hq + 2 * hkv) * hd)
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = _rope(q.reshape(*lead, s, b, hq, hd), positions, cfg.rope_theta,
              table)
    k = _rope(k.reshape(*lead, s, b, hkv, hd), positions, cfg.rope_theta,
              table)
    v = v.reshape(*lead, s, b, hkv, hd)
    o = _attention(q, k, v, cfg, plain=plain).reshape(*lead, s * b, hq * hd)
    return x + row_parallel_linear(o, layer["wo"], plain=plain).reshape(
        x.shape)


def mlp_block_shard(x, layer, cfg: LlamaConfig, *, plain=False):
    """SwiGLU MLP sub-block: RMSNorm → column-parallel gate/up → silu·mul →
    row-parallel down, residual added.  x: [S, B, D] at world 1,
    [W, S/W, B, D] over W ranks."""
    lead = x.shape[:-3]
    h2 = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(
        *lead, -1, cfg.dim)
    gate = column_parallel_linear(h2, layer["wgate"], plain=plain)
    up = column_parallel_linear(h2, layer["wup"], plain=plain)
    act = _silu_mul(gate, up)
    return x + row_parallel_linear(act, layer["wdown"], plain=plain).reshape(
        x.shape)


def _mm_f32(x2, w):
    """x2 [N, D] @ w [D, V] with f32 accumulation into an f32 result."""
    if x2.dtype == torch.float32:
        return x2 @ w
    if x2.is_cuda:
        return torch.mm(x2, w, out_dtype=torch.float32)
    return x2.float() @ w.float()


class _LogitsF32(torch.autograd.Function):
    """``x @ lm_head`` with f32 logits, the reference's
    ``preferred_element_type=jnp.float32``: bf16 operands multiply with
    f32 accumulation into an f32 result.  The backward rounds the f32
    cotangent to the operands' dtype and takes the two products there
    (f32 models: exactly the reference's VJP).  With a leading rank
    dimension (x [R, N, D], w [R, D, V]: each rank's own lm_head, as the
    pipelined step holds it) every rank's product is its own."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        if x2.dim() == 3:
            return torch.stack([_mm_f32(a, b) for a, b in zip(x2, w)])
        return _mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ w.transpose(-1, -2), x2.transpose(-1, -2) @ g


def forward_shard(params, tokens, cfg: LlamaConfig, *, world=1,
                  plain=False):
    """tokens [S, B] int (seq-major) → logits [S, B, vocab] f32.  Over
    ``world`` > 1 ranks ``params`` is the :func:`shard_params` tree and
    rank r holds positions r S/W .. (r + 1) S/W - 1; the logits come back
    in sequence order (the reference's ``out_specs=P("tp")``).  ``plain``
    runs every kernel's plain version (attention, and over W ranks the
    AG-GEMM and the GEMM-RS)."""
    _check_world(cfg, world)
    s, b = tokens.shape
    if s % world:
        raise ValueError(f"{s} positions do not split over {world} ranks")
    x = params["embed"][tokens.long()]                               # [S,B,D]
    if world > 1:
        x = x.reshape(world, s // world, b, cfg.dim)
    for layer in params["layers"]:
        x = attention_block_shard(x, layer, cfg, plain=plain)
        x = mlp_block_shard(x, layer, cfg, plain=plain)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _LogitsF32.apply(x.reshape(s * b, cfg.dim),
                            params["lm_head"]).reshape(s, b, cfg.vocab)


def loss_shard(params, tokens, targets, cfg: LlamaConfig, *, world=1,
               plain=False):
    """Mean next-token cross-entropy over every [S, B] position: at world
    1 the reference's per-device contribution is the whole loss; over W
    ranks each rank contributes its positions' sum over ``ll.size·W``
    (:306-309), and the W contributions add up to this mean."""
    logits = forward_shard(params, tokens, cfg, world=world, plain=plain)
    return F.cross_entropy(logits.reshape(-1, cfg.vocab),
                           targets.reshape(-1).long())


def make_forward(cfg: LlamaConfig, world: int = 1, *, plain=False):
    """``fn(params, tokens [S, B]) -> logits [S, B, vocab]`` f32; over
    ``world`` > 1 ranks ``params`` is the :func:`shard_params` tree."""
    _check_world(cfg, world)
    return functools.partial(forward_shard, cfg=cfg, world=world,
                             plain=plain)


def check_dp(tokens, dp: int) -> int:
    """The columns of tokens [S, B] each of ``dp`` data-parallel ranks
    takes (a batch that does not split raises ``ValueError``)."""
    B = tokens.shape[1]
    if B % dp:
        raise ValueError(f"batch {B} does not split over {dp} dp ranks")
    return B // dp


def dp_loss(params, tokens, targets, cfg, *, dp: int = 1, **kw):
    """The loss of the reference's data parallelism over ``dp`` ranks
    (``dp_axis``): the mean over the ranks of each one's loss on its B / dp
    columns of tokens / targets [S, B].  The dense loss is a mean over
    tokens and no term is a rank's own, so that mean is the whole batch's
    loss, taken here in one pass; the ranks share every leaf, so their
    gradients' psum over dp (XLA's in the reference: no kernel is owed) is
    the whole batch's gradient."""
    check_dp(tokens, dp)
    return loss_shard(params, tokens, targets, cfg, **kw)


def make_train_step(cfg: LlamaConfig, world: int = 1, *, lr=1e-3,
                    dp: int = 1):
    """Plain-SGD training step ``step(params, tokens, targets) ->
    (params, loss)``: loss and gradients by autograd (attention through
    the flash kernels' forward and backward; over ``world`` > 1 ranks
    every projection through the AG-GEMM / GEMM-RS kernels and their
    duals), then ``p - lr * g`` with the product taken in the parameter
    dtype, as the reference rounds.  A replicated leaf's gradient is the
    sum of every rank's contribution, the reference's ``psum``; ``dp`` is
    the reference's data-parallel degree (:func:`dp_loss`).

    Unlike the reference, which returns new arrays, the update is IN
    PLACE and the returned ``params`` is the same dict: a second copy of
    Llama-3-8B's parameters would cost another 16 GB of the card.  The
    reference's ``specs`` are the layout :func:`shard_params` makes and
    are not returned."""
    _check_world(cfg, world)

    def step(params, tokens, targets):
        loss, grads = value_and_grad(dp_loss, params, tokens, targets, cfg,
                                     dp=dp, world=world)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.sub_(lr * g.to(p.dtype))
        return params, loss

    return step
