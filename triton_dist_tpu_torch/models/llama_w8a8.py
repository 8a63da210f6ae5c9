"""W8A8 serving weights for the dense Llama family (world 1).

Counterpart of the serving half of ``triton_dist_tpu/models/llama_w8a8.py``
(ServeEngine's weight plane): the query/key/value projections, norms,
RoPE, attention, embedding and lm_head stay in the float dtype, while the
two hook seams every serving forward exposes — ``out_proj`` and ``ffn`` —
run W8A8 GEMMs (``kernels/quant.w8a8_linear``: dynamic per-row activation
quant, the exact int8 GEMM, rank-1 f32 dequant).

- :func:`quantize_serve_params` turns a float serving tree into the W8A8
  one once, host-side: ``wgate``/``wup`` per output channel (column
  weights), ``wo``/``wdown`` per k-chunk of each rank with ``[world, N]``
  stacked scales (row weights; world 1 stacks one row);
- :func:`w8a8_serve_out_proj` and :func:`w8a8_serve_ffn` are the hooks.

The tensor-parallel forms (``axis=`` on the hooks; the fused-QKV training
forward ``quantize_params_w8a8`` / ``w8a8_forward_shard`` /
``make_w8a8_forward``) need the W8A8 tensor-parallel linears: ROADMAP
Queue 1 item 9.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.quant import (
    quantize_channelwise,
    w8a8_linear,
)
from triton_dist_tpu_torch.models.llama import LlamaConfig, _silu_mul

#: the weights the hooks quantize, and whether each is a row weight
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


def quantize_serve_params(params, cfg: LlamaConfig, world: int = 1) -> dict:
    """Float serving tree → the W8A8 serving tree (once, on the weights'
    device).  Layer keys: float ``attn_norm``, ``mlp_norm``, ``wq``,
    ``wk``, ``wv``; ``wgate_q/s``, ``wup_q/s`` (scales [n]); ``wo_q/s``,
    ``wdown_q/s`` (scales [world, n]); the top level keeps ``embed``,
    ``lm_head`` and ``final_norm``.  The float tensors are shared, not
    copied."""
    del cfg
    out = {"embed": params["embed"], "lm_head": params["lm_head"],
           "final_norm": params["final_norm"], "layers": []}
    for layer in params["layers"]:
        q = {k: layer[k] for k in ("attn_norm", "mlp_norm", "wq", "wk",
                                   "wv")}
        for name, row in QUANT_WEIGHTS.items():
            w_q, w_s = (_quant_row(layer[name], world) if row
                        else _quant_col(layer[name]))
            q[name + "_q"], q[name + "_s"] = w_q, w_s
        out["layers"].append(q)
    return out


def _no_axis(axis):
    if axis is not None:
        raise NotImplementedError(
            "w8a8 under tensor parallelism (axis=) is not ported yet: "
            "ROADMAP Queue 1 item 9")


def w8a8_serve_out_proj(o2, layer, *, axis=None, plain=False):
    """``out_proj`` hook: the attention output [rows, Hq*hd] through the
    W8A8 GEMM; ``layer["wo_s"][0]`` is the (one) rank's scale row.
    ``plain`` runs the GEMM's plain version (a reference forward)."""
    _no_axis(axis)
    return w8a8_linear(o2, layer["wo_q"], layer["wo_s"][0], plain=plain)


def w8a8_serve_ffn(h2, layer, *, axis=None, plain=False):
    """``ffn`` hook: the SwiGLU MLP with all three GEMMs W8A8 (the
    activation math of ``generate._dense_prompt_ffn``)."""
    _no_axis(axis)
    gate = w8a8_linear(h2, layer["wgate_q"], layer["wgate_s"], plain=plain)
    up = w8a8_linear(h2, layer["wup_q"], layer["wup_s"], plain=plain)
    return w8a8_linear(_silu_mul(gate, up), layer["wdown_q"],
                       layer["wdown_s"][0], plain=plain)
