"""Pipeline parallelism: the GPipe schedule over a stage axis.

Counterpart of ``triton_dist_tpu/parallel/pipeline.py``.  Layer
parameters are stacked along a leading layer axis (``stack_layer_params``)
and cut into n_stages contiguous blocks, one per stage.  The schedule runs
``n_micro + n_stages - 1`` ticks (:39-102): at tick t stage s applies its
layers to microbatch t - s, taking stage s - 1's output of the previous
tick (the reference's ``ppermute`` of carries, here a roll of the list of
carries over the stage dimension: no kernel is owed, the reference's is
XLA's).

The reference runs every stage at every tick and masks the bubble ticks'
garbage (:62, :85-93), which touches neither the loss nor any gradient.
On one card the stages run one after another anyway, so only the live
(stage, microbatch) pairs run: n_micro x n_stages stage applications, the
same values.  The backward needs no code: autograd through the schedule
is the reverse pipeline.  The carry is a pytree (tuples / dicts of
tensors), so a model threads auxiliary state (the MoE balance loss)
through the pipe.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from triton_dist_tpu_torch.runtime.utils import tree_leaves, tree_map


def stack_layer_params(layers: list[dict]) -> dict:
    """[{leaf: t}, ...] per-layer dicts -> {leaf: t[L, ...]} stacked (the
    leading axis is cut over the stages)."""
    return {k: torch.stack([layer[k] for layer in layers])
            for k in layers[0]}


def pipeline_spmd(block_fn: Callable[[Any, Any], Any], stage_params: Any,
                  xs: Any, *, n_micro: int):
    """Run the GPipe schedule.

    block_fn(layer_params, carry) -> carry: one layer on one microbatch
    carry.  stage_params: every stage's layer block, a pytree of leaves
    [n_stages, L_loc, ...] (stage s's layers at [s]), or a list over the
    stages of lists over their layers of layer pytrees.  xs: the input
    carries, a pytree with leading [n_micro] on every leaf, consumed by
    stage 0.  Returns the last stage's output carries, leading
    [n_micro]."""
    if isinstance(stage_params, list):
        n_stages = len(stage_params)

        def layers(s):
            return stage_params[s]
    else:
        n_stages, n_layers = tree_leaves(stage_params)[0].shape[:2]

        def layers(s):
            return [tree_map(lambda t: t[s, i], stage_params)
                    for i in range(n_layers)]

    def apply_stage(s, carry):
        for layer in layers(s):
            carry = block_fn(layer, carry)
        return carry

    carries = [None] * n_stages        # each stage's output, last tick
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # the ppermute: stage s takes stage s - 1's carry of tick t - 1
        inputs = [tree_map(lambda l: l[t], xs) if t < n_micro else None,
                  *carries[:-1]]
        carries = [apply_stage(s, inputs[s]) if 0 <= t - s < n_micro
                   else None for s in range(n_stages)]
        if t >= n_stages - 1:
            outs[t - n_stages + 1] = carries[-1]
    return _stack(outs)


def _stack(carries):
    """A list of equally shaped carries -> one carry, leaves stacked."""
    first = carries[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in carries]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([c[i] for c in carries])
                           for i in range(len(first)))
    return torch.stack(carries)
