"""W8A8 quantized serving for the dense Llama family: the tensor-parallel
forward and the serving engine's weight plane.

Counterpart of ``triton_dist_tpu/models/llama_w8a8.py``.  Norms, RoPE,
attention, embedding and lm_head stay in the float dtype (the standard
W8A8 recipe quantizes the GEMMs, not the pointwise math).

The forward (``quantize_params_w8a8`` :73, ``w8a8_forward_shard`` /
``make_w8a8_forward`` :207-267): every projection runs through the W8A8
tensor-parallel linears of ``layers/tp_linear.py`` over the port's virtual
world of W ranks — column-parallel (fused QKV, gate, up) through the
AG-GEMM's int8 mode (activations quantize per row before the gather, the
ring moves int8, the int32 product is exact), row-parallel (out, down) an
exact local int8 GEMM per rank and a dequantized f32 sum over the ranks.
:func:`place_w8a8_params` stands for the reference's ``w8a8_param_specs``
/ ``place_w8a8_params`` (:102-127): it stacks every leaf rank by rank as
those specs cut it (``llama.shard_params``).

The serving weight plane (ServeEngine's ``w8a8=True``): the query/key/
value projections stay float, while the two hook seams every serving
forward exposes — ``out_proj`` and ``ffn`` — run W8A8 GEMMs
(``kernels/quant.w8a8_linear``).

- :func:`quantize_serve_params` turns a float serving tree into the W8A8
  one once: ``wgate``/``wup`` per output channel (column weights),
  ``wo``/``wdown`` per k-chunk of each rank with ``[world, N]`` stacked
  scales (row weights; world 1 stacks one row);
- :func:`w8a8_serve_out_proj` and :func:`w8a8_serve_ffn` are the hooks.
  With ``axis=0`` (the head-sharded engine, ``kv_shard="heads"``) the
  activations and weights are rank-stacked along dim 0 and the hooks'
  row-parallel halves sum the ranks' dequantized partials in rank order,
  the reference's ``psum`` over its mesh axis.
"""

from __future__ import annotations

import functools

import torch

from triton_dist_tpu_torch.kernels.quant import (
    quantize_channelwise,
    w8a8_linear,
)
from triton_dist_tpu_torch.layers.tp_linear import (
    column_parallel_linear_w8a8,
    rank_sum,
    row_parallel_linear_w8a8,
)
from triton_dist_tpu_torch.models.llama import (
    LlamaConfig,
    _attention,
    _check_world,
    _LogitsF32,
    _rank_stack,
    _rms_norm,
    _rope,
    _rope_table,
    _silu_mul,
)

#: the weights the serving hooks quantize, and whether each is a row weight
QUANT_WEIGHTS = {"wgate": False, "wup": False, "wo": True, "wdown": True}


def _quant_col(w):
    """Column weight [k, n]: one per-output-channel quant → (q int8,
    scale f32 [n])."""
    return quantize_channelwise(w)


def _quant_row(w, world: int = 1):
    """Row weight [k, n]: each rank's k-chunk quantized on its own → (q
    int8 [k, n], scales f32 [world, n])."""
    k = w.shape[0]
    if k % world:
        raise ValueError(f"k={k} does not split over world={world}")
    k_loc = k // world
    qs = [quantize_channelwise(w[i * k_loc:(i + 1) * k_loc])
          for i in range(world)]
    return (torch.cat([q for q, _ in qs], dim=0),
            torch.stack([s for _, s in qs], dim=0))


def _fuse_qkv_by_rank(wq, wk, wv, world: int):
    """Q/K/V fused so that rank r's column shard is its own
    ``[wq_r | wk_r | wv_r]`` block (the per-rank concatenation the float
    forward makes, done once): a plain concatenation would hand rank 0
    nothing but Q columns."""
    hq, hk = wq.shape[1] // world, wk.shape[1] // world
    cols = []
    for r in range(world):
        cols += [wq[:, r * hq:(r + 1) * hq], wk[:, r * hk:(r + 1) * hk],
                 wv[:, r * hk:(r + 1) * hk]]
    return torch.cat(cols, dim=1)


def quantize_params_w8a8(params, cfg: LlamaConfig, world: int) -> dict:
    """Float tree → the W8A8 forward's tree (once, on the weights'
    device).  Layer keys: ``wqkv_q/s`` (the fused column weight in
    per-rank block order), ``wgate_q/s``, ``wup_q/s`` (scales [n]),
    ``wo_q/s``, ``wdown_q/s`` (row weights, scales [world, N]), the float
    norms; the top level keeps ``embed``, ``lm_head`` and
    ``final_norm``.  The float tensors are shared, not copied."""
    _check_world(cfg, world)
    out = {"embed": params["embed"], "lm_head": params["lm_head"],
           "final_norm": params["final_norm"], "layers": []}
    for layer in params["layers"]:
        q = {"attn_norm": layer["attn_norm"], "mlp_norm": layer["mlp_norm"]}
        q["wqkv_q"], q["wqkv_s"] = _quant_col(_fuse_qkv_by_rank(
            layer["wq"], layer["wk"], layer["wv"], world))
        for name in ("wgate", "wup"):
            q[name + "_q"], q[name + "_s"] = _quant_col(layer[name])
        for name in ("wo", "wdown"):
            q[name + "_q"], q[name + "_s"] = _quant_row(layer[name], world)
        out["layers"].append(q)
    return out


def place_w8a8_params(qparams, cfg: LlamaConfig, world: int) -> dict:
    """A W8A8 tree (the forward's or the serving one) laid out over
    ``world`` ranks as the reference's specs cut it: column weights
    ``[W, k, n/W]`` with scales ``[W, n/W]``, row weights ``[W, k/W, N]``
    with rank r's own scale row ``[W, 1, N]``, replicated leaves copied
    once.  The row scales must have been quantized for ``world``."""
    _check_world(cfg, world)
    return _rank_stack(qparams, world)


def w8a8_forward_shard(qparams, tokens, cfg: LlamaConfig, *, world: int,
                       plain: bool = False):
    """The quantized forward over ``world`` ranks (the W8A8 twin of
    ``llama.forward_shard``): tokens [S, B] → logits [S, B, vocab] f32,
    rank r holding positions r S/W .. (r + 1) S/W - 1.  ``qparams`` is
    :func:`place_w8a8_params` of :func:`quantize_params_w8a8`.  ``plain``
    runs every kernel's plain version (attention, the int8 AG-GEMM, the
    int8 GEMM)."""
    _check_world(cfg, world)
    s, b = tokens.shape
    if s % world:
        raise ValueError(f"{s} positions do not split over {world} ranks")
    s_loc, hd = s // world, cfg.head_dim
    hq, hkv = cfg.n_heads // world, cfg.n_kv_heads // world
    col = functools.partial(column_parallel_linear_w8a8, plain=plain)
    row = functools.partial(row_parallel_linear_w8a8, plain=plain)
    x = qparams["embed"][tokens.long()].reshape(world, s_loc, b, cfg.dim)
    positions = torch.arange(s, device=x.device)
    table = _rope_table(positions, hd, cfg.rope_theta)
    for layer in qparams["layers"]:
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        qkv = col(h.reshape(world, s_loc * b, cfg.dim), layer["wqkv_q"],
                  layer["wqkv_s"]).reshape(world, s, b, (hq + 2 * hkv) * hd)
        q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
        q = _rope(q.reshape(world, s, b, hq, hd), positions, cfg.rope_theta,
                  table)
        k = _rope(k.reshape(world, s, b, hkv, hd), positions,
                  cfg.rope_theta, table)
        v = v.reshape(world, s, b, hkv, hd)
        o = _attention(q, k, v, cfg, plain=plain).reshape(world, s * b,
                                                         hq * hd)
        x = x + row(o, layer["wo_q"], layer["wo_s"][:, 0]).reshape(x.shape)
        h2 = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(
            world, s_loc * b, cfg.dim)
        act = _silu_mul(col(h2, layer["wgate_q"], layer["wgate_s"]),
                        col(h2, layer["wup_q"], layer["wup_s"]))
        x = x + row(act, layer["wdown_q"], layer["wdown_s"][:, 0]).reshape(
            x.shape)
    x = _rms_norm(x, qparams["final_norm"], cfg.norm_eps)
    return _LogitsF32.apply(x.reshape(s * b, cfg.dim),
                            qparams["lm_head"]).reshape(s, b, cfg.vocab)


def make_w8a8_forward(cfg: LlamaConfig, world: int, *, plain: bool = False):
    """``fn(qparams, tokens [S, B]) -> logits [S, B, vocab]`` f32 over
    ``world`` ranks (the reference's jitted shard_map over its mesh)."""
    _check_world(cfg, world)
    return functools.partial(w8a8_forward_shard, cfg=cfg, world=world,
                             plain=plain)


# ---------------------------------------------------------------------------
# the serving weight plane
# ---------------------------------------------------------------------------


def quantize_serve_params(params, cfg: LlamaConfig, world: int = 1) -> dict:
    """Float serving tree → the W8A8 serving tree (once, on the weights'
    device).  Layer keys: float ``attn_norm``, ``mlp_norm``, ``wq``,
    ``wk``, ``wv``; ``wgate_q/s``, ``wup_q/s`` (scales [n]); ``wo_q/s``,
    ``wdown_q/s`` (scales [world, N]: each rank's k-chunk quantized on its
    own, as the head-sharded engine's ranks contract it); the top level
    keeps ``embed``, ``lm_head`` and ``final_norm``.  The float tensors
    are shared, not copied."""
    del cfg
    out = {"embed": params["embed"], "lm_head": params["lm_head"],
           "final_norm": params["final_norm"], "layers": []}
    for layer in params["layers"]:
        q = {k: layer[k] for k in ("attn_norm", "mlp_norm", "wq", "wk",
                                   "wv")}
        for name, is_row in QUANT_WEIGHTS.items():
            w_q, w_s = (_quant_row(layer[name], world) if is_row
                        else _quant_col(layer[name]))
            q[name + "_q"], q[name + "_s"] = w_q, w_s
        out["layers"].append(q)
    return out


def _check_axis(axis):
    if axis not in (None, 0):
        raise ValueError(f"axis={axis!r}: the rank-stacked operands carry "
                         f"their ranks along dim 0 (axis=0), or None at "
                         f"world 1")


def w8a8_serve_out_proj(o2, layer, *, axis=None, plain=False):
    """``out_proj`` hook: the attention output [rows, Hq*hd] through the
    W8A8 GEMM; ``layer["wo_s"][0]`` is the (one) rank's scale row.  With
    ``axis=0``: o2 [W, rows, Hq/W*hd] against the rank-stacked ``wo_q``
    [W, Hq/W*hd, D] and ``wo_s`` [W, 1, D], each rank's dequantized
    partial summed over the ranks.  ``plain`` runs the GEMM's plain
    version (a reference forward)."""
    _check_axis(axis)
    if axis is None:
        return w8a8_linear(o2, layer["wo_q"], layer["wo_s"][0], plain=plain)
    return rank_sum(torch.stack([
        w8a8_linear(o2[r], layer["wo_q"][r], layer["wo_s"][r][0],
                    plain=plain) for r in range(o2.shape[0])]), o2.dtype)


def w8a8_serve_ffn(h2, layer, *, axis=None, plain=False):
    """``ffn`` hook: the SwiGLU MLP with all three GEMMs W8A8 (the
    activation math of ``generate._dense_prompt_ffn``).  With ``axis=0``
    h2 [rows, D] is replicated, the weights rank-stacked: every rank's
    gate/up columns and down rows, its down partial summed over the
    ranks."""
    _check_axis(axis)

    def ffn(gate_q, gate_s, up_q, up_s, down_q, down_s):
        gate = w8a8_linear(h2, gate_q, gate_s, plain=plain)
        up = w8a8_linear(h2, up_q, up_s, plain=plain)
        return w8a8_linear(_silu_mul(gate, up), down_q, down_s[0],
                           plain=plain)

    keys = ("wgate_q", "wgate_s", "wup_q", "wup_s", "wdown_q", "wdown_s")
    if axis is None:
        return ffn(*(layer[k] for k in keys))
    return rank_sum(torch.stack([
        ffn(*(layer[k][r] for k in keys))
        for r in range(layer["wgate_q"].shape[0])]), h2.dtype)
