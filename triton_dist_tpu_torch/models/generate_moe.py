"""Autoregressive generation for the MoE family (world 1).

Counterpart of ``triton_dist_tpu/models/generate_moe.py``: the port's
:class:`~triton_dist_tpu_torch.models.generate.Generator` with its FFN
hooks routed to the experts.  Attention decodes and prefills exactly as
the dense family's does (the flash prefill kernel and the decode kernel).
The FFNs are XLA products in the reference, not Pallas kernels, so here
they are ``torch.matmul``, and no grouped GEMM runs in them:

- :func:`moe_ffn_decode_shard`: one decode step's expert FFN, the
  reference's masked per-expert loop (each expert's SwiGLU weighted by the
  token's routing weight for it, 0 where the expert was not picked) at
  world 1, without the psum;
- :func:`_moe_prompt_ffn`: the prompt phase's FFN, the same masked sum
  over the experts.

An expert no token picked adds exact zeros to the reference's sum, so the
loop skips it (one host read of the picked set per call): a decode step
then streams only the picked experts' slabs.  The reference's
``place_params_serving`` has no counterpart at world 1.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.moe_utils import topk_routing
from triton_dist_tpu_torch.models.generate import (
    Generator,
    _prompt_forward,
)
from triton_dist_tpu_torch.models.moe import MoEConfig


def _dot_f32(a, b):
    """``a @ b`` with an f32 result (the reference's
    ``preferred_element_type=f32``): bf16 operands multiply with f32
    accumulation."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def moe_ffn_decode_shard(h, router, w_gate, w_up, w_down, *, topk):
    """Routed SwiGLU FFN of the rows h [B, D]: router [D, E] f32, expert
    stacks [E, D, F] / [E, F, D].  Each picked expert's SwiGLU of every
    row, weighted by the row's routing weight for it, summed in f32.
    Returns [B, D] in h's dtype."""
    logits = h.float() @ router
    weights, experts = topk_routing(logits, topk)              # [B, topk]
    y = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in sorted(set(experts.reshape(-1).tolist())):
        w_tok = torch.where(experts == e, weights,
                            torch.zeros_like(weights)).sum(dim=-1)   # [B]
        g = _dot_f32(h, w_gate[e])
        u = _dot_f32(h, w_up[e])
        act = (torch.nn.functional.silu(g) * u).to(h.dtype)
        y = y + w_tok[:, None] * _dot_f32(act, w_down[e])
    return y.to(h.dtype)


def _moe_prompt_ffn(h2, layer, cfg: MoEConfig):
    """Prompt-phase routed FFN over flattened tokens h2 [T, D]: the masked
    sum over the experts (correctness first; the dispatch path of
    ``models/moe.moe_ffn_shard`` is the throughput alternative)."""
    return moe_ffn_decode_shard(h2, layer["router"], layer["w_gate"],
                                layer["w_up"], layer["w_down"],
                                topk=cfg.topk)


def _moe_prompt_forward(params, tokens, *, cfg: MoEConfig, plain=False):
    """Full-prompt forward returning per-layer (K, V) and f32 logits:
    ``generate._prompt_forward`` with the MoE FFN in its ``ffn`` hook
    (``plain``: the plain attention, the one kernel this forward runs)."""
    return _prompt_forward(params, tokens, cfg=cfg, plain=plain,
                           ffn=lambda h2, layer: _moe_prompt_ffn(h2, layer,
                                                                 cfg))


class MoEGenerator(Generator):
    """Greedy / sampled decoder for the MoE family: the same API as
    :class:`Generator` (``prefill``, ``prefill_chunked``, ``step``,
    ``generate``) over parameters from ``models.moe.init_params``."""

    def _ffn_prompt(self, h2, layer):
        return _moe_prompt_ffn(h2, layer, self.cfg)

    def _ffn_decode(self, h, layer):
        return _moe_prompt_ffn(h, layer, self.cfg)
