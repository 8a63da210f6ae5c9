"""Context-parallel (long-context) training of the Llama family.

Counterpart of ``triton_dist_tpu/models/cp.py``.  The training sequence is
sharded over the ranks of a virtual world end to end: the residual stream
is rank-stacked ``[W, S_loc, B, D]`` through every block, the weights are
replicated, and attention crosses the shards through either scheme:

- ``attn="ring"``: KV blocks rotate round the ring
  (``kernels/ring_attention.py``: the flash ring under ``impl="auto"`` at
  flash-legal shapes, else the fused ``ring_attn`` kernel; ``"flash"`` and
  ``"fused"`` ask for one).  It defaults to the ZIGZAG layout (rank r
  holds chunks r and 2W-1-r) where that pays (:func:`_pick_zigzag`);
  tokens and targets are permuted into zigzag order at the entry and the
  logits permuted back, so the public contract stays natural-order;
- ``attn="ulysses"``: the head-scatter all-to-all
  (``kernels/ulysses_attention.py``), heads divisible by W.

``plain=True`` is the reference's ``impl="xla"``: every kernel's plain
version (the dense ring, the all-to-all's plain shuffle and the plain
attention), differentiated op by op.  The weights are the world-1 tree as
it is, held once: every rank's rows go through one product per
projection, and autograd's accumulation over the ranks that share a leaf
is the reference's ``psum`` over the cp axis (:182-183).  RoPE uses each
row's global position (the zigzag shard offsets each of its two chunks),
so the sharded model is the same function as the world-1 one.  The
reference's ``dp_axis`` (cp x dp) is not ported: it raises, naming
ROADMAP Queue 1's ninth entry.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from triton_dist_tpu_torch.kernels.ring_attention import (
    _seg_positions,
    _shard_starts,
    from_zigzag,
    ring_attention_shard,
    to_zigzag,
)
from triton_dist_tpu_torch.kernels.ulysses_attention import (
    ulysses_attention_shard,
)
from triton_dist_tpu_torch.models.llama import (
    LlamaConfig,
    _LogitsF32,
    _rms_norm,
    _rope_table,
    _rotate,
    _silu_mul,
)
from triton_dist_tpu_torch.runtime.utils import tree_leaves, value_and_grad

ATTNS = ("ring", "ulysses")


def _check(cfg: LlamaConfig, world: int, attn: str, dp_axis=None) -> None:
    if dp_axis is not None:
        raise NotImplementedError(
            f"dp_axis={dp_axis!r}: context x data parallelism is not ported "
            f"yet (ROADMAP Queue 1's ninth entry)")
    if attn not in ATTNS:
        raise ValueError(f"attn {attn!r} is not one of {ATTNS}")
    if world < 1:
        raise ValueError(f"world {world} < 1")


def _cp_attention_block(x, layer, cfg: LlamaConfig, *, attn, impl, plain,
                        table, zigzag=False):
    """Attention with sequence-sharded activations x [W, S_loc, B, D] and
    replicated weights; ``table`` is the RoPE (cos, sin) of every row,
    [W, S_loc, 1, 1, hd/2] each."""
    world, s_loc, b, _ = x.shape
    hd = cfg.head_dim
    h2 = _rms_norm(x, layer["attn_norm"], cfg.norm_eps).reshape(-1, cfg.dim)
    q = (h2 @ layer["wq"]).reshape(world, s_loc, b, cfg.n_heads, hd)
    k = (h2 @ layer["wk"]).reshape(world, s_loc, b, cfg.n_kv_heads, hd)
    v = (h2 @ layer["wv"]).reshape(world, s_loc, b, cfg.n_kv_heads, hd)
    q = _rotate(q, *table)
    k = _rotate(k, *table)
    kw = dict(causal=True, window=cfg.attn_window,
              soft_cap=cfg.attn_soft_cap, plain=plain)
    if attn == "ring":
        o = ring_attention_shard(q, k, v, impl=impl, zigzag=zigzag, **kw)
    else:
        if zigzag:
            raise ValueError("zigzag layout applies to attn='ring' only")
        o = ulysses_attention_shard(q, k, v, **kw)
    o2 = o.reshape(-1, cfg.n_heads * hd)
    return x + (o2 @ layer["wo"]).reshape(x.shape)


def _cp_layer(x, layer, cfg: LlamaConfig, *, attn, impl, plain, table,
              zigzag=False):
    """One decoder layer (sharded attention + local MLP) on x [W, S_loc,
    B, D]."""
    x = _cp_attention_block(x, layer, cfg, attn=attn, impl=impl,
                            plain=plain, table=table, zigzag=zigzag)
    h2 = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(-1, cfg.dim)
    act = _silu_mul(h2 @ layer["wgate"], h2 @ layer["wup"])
    return x + (act @ layer["wdown"]).reshape(x.shape)


def cp_forward_shard(params, tokens_shard, cfg: LlamaConfig, *,
                     attn="ring", impl="auto", plain=False, remat=False,
                     zigzag=False):
    """tokens_shard [W, S_loc, B] (rank r's rows at [r]; zigzag chunk
    order when ``zigzag``) -> logits [W, S_loc, B, vocab] f32.

    ``remat=True`` checkpoints each layer
    (``torch.utils.checkpoint``, non-reentrant): the backward recomputes
    the layer, its ring or all-to-all included, instead of keeping its
    activations, the reference's ``jax.checkpoint``."""
    world, s_loc, b = tokens_shard.shape
    # every rank's rows at their global positions (the layout's runs,
    # reference :62-70): [W, S_loc]
    dev = tokens_shard.device
    pos = _seg_positions(
        _shard_starts(torch.arange(world, device=dev)[:, None], s_loc, world,
                      zigzag), torch.arange(s_loc, device=dev)[None, :], s_loc)
    cos, sin = _rope_table(pos.reshape(-1), cfg.head_dim, cfg.rope_theta)
    shape = (world, s_loc, 1, 1, cfg.head_dim // 2)
    table = (cos.reshape(shape), sin.reshape(shape))
    layer_fn = functools.partial(_cp_layer, cfg=cfg, attn=attn, impl=impl,
                                 plain=plain, table=table, zigzag=zigzag)
    x = params["embed"][tokens_shard.long()]
    for layer in params["layers"]:
        if remat:
            x = checkpoint(layer_fn, x, layer, use_reentrant=False)
        else:
            x = layer_fn(x, layer)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _LogitsF32.apply(x.reshape(-1, cfg.dim), params["lm_head"]
                            ).reshape(world, s_loc, b, cfg.vocab)


def _pick_zigzag(zigzag, attn, S, world, impl, head_dim, plain=False):
    """The auto rule (``zigzag=None``, reference :127-147): zigzag only
    where it pays, the flash ring's per-tile skip pruning the dead chunk
    pairs; a zigzag run must tile by 128 for the flash kernels (S_loc %
    256).  Plain (the reference's ``xla``) and fused rings and world 1
    keep the contiguous layout.  An explicit ``zigzag=True`` is checked
    here and overrides the rule."""
    if zigzag is None:
        return (attn == "ring" and world > 1 and S % (2 * world) == 0
                and impl in ("auto", "flash") and not plain
                and (S // world) % 256 == 0 and head_dim % 128 == 0)
    if zigzag:
        if attn != "ring":
            raise ValueError("zigzag layout applies to attn='ring' only "
                             f"(got attn={attn!r})")
        if S % (2 * world):
            raise ValueError(f"zigzag needs S % (2*world) == 0, got "
                             f"S={S}, world={world}")
    return bool(zigzag)


def _shard_tokens(tokens, world):
    S = tokens.shape[0]
    if S % world:
        raise ValueError(f"{S} positions do not split over {world} ranks")
    return tokens.reshape(world, S // world, *tokens.shape[1:])


def make_cp_forward(cfg: LlamaConfig, world: int = 1, *, attn="ring",
                    impl="auto", plain=False, zigzag=None):
    """``fn(params, tokens [S, B]) -> logits [S, B, vocab]`` f32 in
    NATURAL order over ``world`` ranks (any zigzag permutation is applied
    to the tokens and inverted on the logits); ``params`` is the world-1
    tree (:func:`place_cp_params`)."""
    _check(cfg, world, attn)

    def fwd(params, tokens):
        S, b = tokens.shape
        zz = _pick_zigzag(zigzag, attn, S, world, impl, cfg.head_dim, plain)
        tok = to_zigzag(tokens, world) if zz else tokens
        logits = cp_forward_shard(params, _shard_tokens(tok, world), cfg,
                                  attn=attn, impl=impl, plain=plain,
                                  zigzag=zz).reshape(S, b, cfg.vocab)
        return from_zigzag(logits, world) if zz else logits

    return fwd


def cp_loss(params, tokens, targets, cfg: LlamaConfig, *, world: int = 1,
            attn="ring", impl="auto", plain=False, remat=False, zigzag=None):
    """Mean next-token cross-entropy of tokens / targets [S, B] (natural
    order) over ``world`` ranks: the reference's per-rank sums over
    ``ll.size * W`` added up.  ``zigzag`` (default auto,
    :func:`_pick_zigzag`) permutes both at the entry; cross-entropy does
    not see the order."""
    zz = _pick_zigzag(zigzag, attn, tokens.shape[0], world, impl,
                      cfg.head_dim, plain)
    if zz:
        tokens = to_zigzag(tokens, world)
        targets = to_zigzag(targets, world)
    logits = cp_forward_shard(params, _shard_tokens(tokens, world), cfg,
                              attn=attn, impl=impl, plain=plain, remat=remat,
                              zigzag=zz)
    return F.cross_entropy(logits.reshape(-1, cfg.vocab),
                           targets.reshape(-1).long())


def make_cp_train_step(cfg: LlamaConfig, world: int = 1, *, dp_axis=None,
                       attn="ring", impl="auto", plain=False, lr=1e-3,
                       remat=False, zigzag=None):
    """Plain-SGD step ``step(params, tokens, targets) -> (params, loss)``
    of the CP mode over ``world`` ranks: :func:`cp_loss` and its
    gradient by autograd, every leaf's gradient summed over the ranks that
    share it; then ``p - lr * g`` in the parameter dtype, IN PLACE, as
    ``models/llama.make_train_step`` does (the reference returns new
    arrays and its ``specs``; here every leaf is the world-1 tree's)."""
    _check(cfg, world, attn, dp_axis)
    kw = dict(world=world, attn=attn, impl=impl, plain=plain, remat=remat,
              zigzag=zigzag)

    def step(params, tokens, targets):
        loss, grads = value_and_grad(cp_loss, params, tokens, targets, cfg,
                                     **kw)
        with torch.no_grad():
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                p.sub_(lr * g.to(p.dtype))
        return params, loss

    return step


def place_cp_params(params, cfg: LlamaConfig, world: int = 1) -> dict:
    """The CP placement of a world-1 tree: every weight replicated, which
    on the virtual world is the tree as it is (no copy per rank).
    Checks the tree's layer count against ``cfg``."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['layers'])} layers, cfg has "
                         f"{cfg.n_layers}")
    _check(cfg, world, "ring")
    return params
