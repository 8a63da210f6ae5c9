"""Pipelined (dp x pp x tp) training steps for the model families.

Counterpart of ``triton_dist_tpu/models/pp.py``: the GPipe schedule
(``parallel/pipeline.py``) over the tensor-parallel blocks of the family
(``models/llama.attention_block_shard`` / ``mlp_block_shard``, the MoE
family's ``moe_block_shard`` with its aux loss carried through the pipe),
on a ``runtime/bootstrap.Mesh`` of the virtual world.  One step runs

- dp (``dp_axis``, the slow tier): each dp rank takes its columns of every
  microbatch; the ranks run one after another through the same weights;
- pp (``pp_axis``): the layers stacked [L, ...] and cut into contiguous
  stage blocks, only the live (stage, microbatch) pairs run;
- tp (``tp_axis``): sequence-parallel activations [T, S / T, mb, D] through
  the AG-GEMM and GEMM-RS kernels (attention), and for MoE the
  expert-parallel FFN over the all-to-all kernel.

Leaves and their gradients (the reference's gradient sync rule, :113-190):

- leaves sharded over tp (the projections; MoE's expert stacks) are held
  once; autograd's accumulation over the dp ranks that share them is the
  reference's plain ``psum`` over dp (:188-189);
- the tp-replicated leaves (embed, lm_head, final_norm, and the layer
  norms and MoE router, which mention pp but not tp: :170-177) are taken
  per (dp, tp) rank inside the step (each rank's alias of the one stored
  tensor, an autograd input of its own), so the backward leaves each rank
  its partial.  ``hier_dp_fast_axis=tp`` buckets those partials into
  ``kernels/hierarchical.hier_grad_allreduce`` (the reduce-scatter kernel
  over tp, a torch sum over dp, the all-gather kernel over tp: one launch
  of each per step); without it they are summed over the ranks in f32
  (the reference's ``psum``, a torch sum).  ``_pre``'s psum over pp
  (:173-177) is a torch sum: a stage that does not run embed (or lm_head,
  final_norm) holds a zero partial of it, so every stage gets the one
  stage's partial.

``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
non-reentrant), the reference's ``jax.checkpoint``.  The SGD update is IN
PLACE (the reference returns new arrays); ``make_pp_train_step`` returns
``(step, specs)`` as the reference does, ``specs`` the layout of
:func:`pp_param_specs`.  ``plain`` runs every kernel's plain version.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from triton_dist_tpu_torch.kernels.hierarchical import hier_grad_allreduce
from triton_dist_tpu_torch.models import llama, moe
from triton_dist_tpu_torch.models.llama import (
    _LogitsF32,
    _rms_norm,
    attention_block_shard,
    mlp_block_shard,
)
from triton_dist_tpu_torch.parallel.pipeline import (
    pipeline_spmd,
    stack_layer_params,
)
from triton_dist_tpu_torch.runtime.bootstrap import Mesh

_COLUMN = ("wq", "wk", "wv", "wgate", "wup")
_ROW = ("wo", "wdown")
_EXPERT = ("w_gate", "w_up", "w_down")
# tp-replicated layer leaves (bucketed by the hierarchical reduction)
_REPLICATED = ("attn_norm", "mlp_norm", "router")


def _is_moe(cfg) -> bool:
    return isinstance(cfg, moe.MoEConfig)


def _family(cfg):
    return moe if _is_moe(cfg) else llama


def init_pp_params(cfg, seed: int = 0, device="cuda") -> dict:
    """The family's ``init_params`` with the layers stacked [L, ...] (each
    leaf's per-layer tensors dropped as its stack is made, so a full-size
    model holds one extra leaf at most)."""
    base = _family(cfg).init_params(cfg, seed=seed, device=device)
    layers = base["layers"]
    base["layers"] = {k: torch.stack([layer.pop(k) for layer in layers])
                      for k in list(layers[0])}
    return base


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's ``init_pp_params`` tree (numpy, layers stacked) as
    the port's stacked tree on ``device``."""
    n = cfg.n_layers
    per_layer = dict(tree, layers=[{k: v[i] for k, v in
                                    tree["layers"].items()}
                                   for i in range(n)])
    out = _family(cfg).params_from_jax(per_layer, cfg, device=device)
    out["layers"] = stack_layer_params(out["layers"])
    return out


def pp_param_specs(cfg, *, tp_axis="tp", pp_axis="pp") -> dict:
    """Each leaf's layout, the reference's PartitionSpecs as tuples (one
    entry per dimension, None: not sharded; () replicated): the stacked
    layer axis over ``pp_axis``, the projections over ``tp_axis``."""
    layer = {"attn_norm": (None,), "mlp_norm": (None,),
             "wq": (None, tp_axis), "wk": (None, tp_axis),
             "wv": (None, tp_axis), "wo": (tp_axis, None)}
    if _is_moe(cfg):
        layer.update(router=(None, None),
                     **{k: (tp_axis, None, None) for k in _EXPERT})
    else:
        layer.update(wgate=(None, tp_axis), wup=(None, tp_axis),
                     wdown=(tp_axis, None))
    return {"embed": (), "lm_head": (), "final_norm": (),
            "layers": {k: (pp_axis, *spec) for k, spec in layer.items()}}


def _axes(cfg, mesh: Mesh, tp_axis, pp_axis, dp_axis):
    names = [a for a in (dp_axis, pp_axis, tp_axis) if a]
    if sorted(names) != sorted(mesh.axis_names):
        raise ValueError(f"mesh axes {mesh.axis_names} must be "
                         f"{tuple(names)}")
    tp, pp = mesh.axis_size(tp_axis), mesh.axis_size(pp_axis)
    if cfg.n_layers % pp:
        raise ValueError(f"{cfg.n_layers} layers do not split over {pp} "
                         f"stages")
    (moe._check_world if _is_moe(cfg) else llama._check_world)(cfg, tp)
    return (mesh.axis_size(dp_axis) if dp_axis else 1), pp, tp


def place_pp_params(params, cfg, mesh: Mesh, *, tp_axis="tp",
                    pp_axis="pp") -> dict:
    """The layout the step holds a stacked tree in (:func:`pp_param_specs`
    on the virtual world): column-parallel weights [L, T, in, out / T]
    (copies), row-parallel ones [L, T, in / T, out] (views of the input),
    every other leaf the input's own tensor (the expert stacks [L, E,
    ...] are rank-major, the sharded layout already)."""
    tp = mesh.axis_size(tp_axis)
    if cfg.n_layers % mesh.axis_size(pp_axis):
        raise ValueError(f"{cfg.n_layers} layers do not split over "
                         f"{mesh.axis_size(pp_axis)} stages")

    def leaf(k, t):
        n, a, b = t.shape[0], t.shape[1], t.shape[2] if t.dim() > 2 else 0
        if k in _COLUMN:
            return t.view(n, a, tp, b // tp).permute(0, 2, 1, 3).contiguous()
        if k in _ROW:
            return t.view(n, tp, a // tp, b)
        return t

    out = dict(params)
    out["layers"] = {k: leaf(k, t) for k, t in params["layers"].items()}
    return out


def _block(layer, carry, cfg, *, plain):
    """One decoder layer on one microbatch carry (x [T, S / T, mb, D],
    aux)."""
    x, aux = carry
    if _is_moe(cfg):
        x = attention_block_shard(x, layer, cfg.as_llama(), plain=plain)
        x, d_aux, _ = moe.moe_block_shard(x, layer, cfg, plain=plain)
        return x, aux + d_aux
    x = attention_block_shard(x, layer, cfg, plain=plain)
    return mlp_block_shard(x, layer, cfg, plain=plain), aux


def _psum(t, dims):
    """The reference's psum over the rank dimensions ``dims`` of the
    per-rank partials ``t``: summed in f32, cast once."""
    return t.float().sum(dim=dims).to(t.dtype)


def _make_loss_and_grads(cfg, mesh: Mesh, *, tp_axis, pp_axis, dp_axis,
                         n_micro, plain, remat, hier_dp_fast_axis):
    """``fn(params, tokens, targets) -> (loss, held, red)``: the loss, the
    gradients of the leaves held once ({leaf: [per-layer gradient]}) and
    the reduced gradients of the tp-replicated leaves (``_reduce``)."""
    dp, pp, tp = _axes(cfg, mesh, tp_axis, pp_axis, dp_axis)
    if hier_dp_fast_axis is not None and (
            dp_axis is None or hier_dp_fast_axis != tp_axis):
        raise ValueError(f"hier_dp_fast_axis={hier_dp_fast_axis!r} needs "
                         f"dp_axis and names the tp axis ({tp_axis!r})")
    coef = getattr(cfg, "aux_loss_coef", 0.0)
    n_layers = cfg.n_layers
    l_loc = n_layers // pp
    block = functools.partial(_block, cfg=cfg, plain=plain)
    if remat:
        block = functools.partial(checkpoint, block, use_reentrant=False)

    def fn(params, tokens, targets):
        S, B = tokens.shape
        if B % (n_micro * dp) or S % tp:
            raise ValueError(f"tokens [{S}, {B}]: B must split into "
                             f"{n_micro} microbatches over {dp} dp ranks "
                             f"and S over {tp} tp ranks")
        mb, s_loc = B // (n_micro * dp), S // tp
        dev = tokens.device
        lay = params["layers"]
        held = {k: [t[i].detach().requires_grad_() for i in range(n_layers)]
                for k, t in lay.items() if k not in _REPLICATED}

        def alias(t, *shape):
            # rank-wise alias of one stored tensor: its own autograd input
            return t.detach().expand(*shape).requires_grad_()

        D, V = cfg.dim, cfg.vocab
        emb = [alias(params["embed"], tp, V, D) for _ in range(dp)]
        fnorm = [alias(params["final_norm"], tp, D) for _ in range(dp)]
        head = [alias(params["lm_head"], tp, D, V) for _ in range(dp)]
        reps = {k: [[alias(lay[k][i], tp, *lay[k].shape[1:])
                     for i in range(n_layers)] for _ in range(dp)]
                for k in _REPLICATED if k in lay}

        def layer(d, i):
            out = {k: v[i] for k, v in held.items()}
            for k, v in reps.items():
                w = v[d][i]
                out[k] = w.view(tp, 1, 1, D) if w.dim() == 2 else w
            return out

        rank = torch.arange(tp, device=dev)[:, None, None]
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        for d in range(dp):
            # microbatch m's columns m B / n_micro + [d mb, (d + 1) mb)
            cols = (torch.arange(n_micro, device=dev)[:, None]
                    * (B // n_micro) + d * mb
                    + torch.arange(mb, device=dev)[None, :])
            # [n_micro, T, S / T, mb]: microbatch m, rank t's positions
            tok = tokens[:, cols].permute(1, 0, 2).reshape(
                n_micro, tp, s_loc, mb).long()
            tgt = targets[:, cols].permute(1, 0, 2).reshape(
                n_micro, tp, s_loc, mb).long()
            xs = (torch.stack([emb[d][rank, t] for t in tok]),
                  torch.zeros((n_micro,), dtype=torch.float32, device=dev))
            stages = [[layer(d, s * l_loc + i) for i in range(l_loc)]
                      for s in range(pp)]
            outs_x, outs_aux = pipeline_spmd(block, stages, xs,
                                             n_micro=n_micro)
            # head and cross-entropy on the last stage's outputs
            h = _rms_norm(outs_x, fnorm[d].view(1, tp, 1, 1, D),
                          cfg.norm_eps).transpose(0, 1).reshape(tp, -1, D)
            logits = _LogitsF32.apply(h, head[d])
            ce = F.cross_entropy(logits.reshape(-1, V),
                                 tgt.transpose(0, 1).reshape(-1),
                                 reduction="sum")
            loss = loss + ce / (S * B) + coef * outs_aux.sum() / (n_micro
                                                                  * dp)
        inputs = ([t for v in held.values() for t in v] + emb + fnorm + head
                  + [t for v in reps.values() for per_d in v for t in per_d])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(inputs, grads)}
        del grads, inputs

        def parts(ts):
            # the dp ranks' partials of one leaf [dp, T, ...]
            return torch.stack([by_id.pop(id(t)) for t in ts])

        part = {"embed": parts(emb), "final_norm": parts(fnorm),
                "lm_head": parts(head),
                # [dp, L, T, ...] per layer leaf
                "layers": {k: torch.stack([parts(v[d]) for d in range(dp)])
                           for k, v in reps.items()}}
        held = {k: [by_id.pop(id(t)) for t in ts] for k, ts in held.items()}
        with torch.no_grad():
            red = _reduce(part, mesh, dp_axis, pp_axis, tp_axis,
                          hier_dp_fast_axis, plain)
        return loss.detach(), held, red

    return fn


def make_pp_grads(cfg, mesh: Mesh, *, tp_axis="tp", pp_axis="pp",
                  dp_axis=None, n_micro=4, plain=False, remat=False,
                  hier_dp_fast_axis=None):
    """``grads_fn(params, tokens, targets) -> (loss, grads)``: the step's
    loss and its reduced gradients, a tree shaped like the
    :func:`place_pp_params` tree (what :func:`make_pp_train_step`
    subtracts, ``lr`` times)."""
    fn = _make_loss_and_grads(cfg, mesh, tp_axis=tp_axis, pp_axis=pp_axis,
                              dp_axis=dp_axis, n_micro=n_micro, plain=plain,
                              remat=remat,
                              hier_dp_fast_axis=hier_dp_fast_axis)

    def grads_fn(params, tokens, targets):
        loss, held, red = fn(params, tokens, targets)
        layers = {k: torch.stack(v) for k, v in held.items()}
        layers.update(red.pop("layers"))
        return loss, dict(red, layers=layers)

    return grads_fn


def make_pp_train_step(cfg, mesh: Mesh, *, tp_axis="tp", pp_axis="pp",
                       dp_axis=None, n_micro=4, plain=False, lr=1e-3,
                       remat=False, hier_dp_fast_axis=None):
    """SGD step ``step(params, tokens, targets) -> (params, loss)`` over a
    (dp x) pp x tp mesh with GPipe microbatching: tokens / targets [S, B]
    (S over tp, B over dp, B cut host-side into ``n_micro`` microbatches);
    ``params`` the :func:`place_pp_params` tree, updated in place (module
    docstring), ``p - lr * g`` in the parameter dtype.  Returns (step,
    specs)."""
    specs = pp_param_specs(cfg, tp_axis=tp_axis, pp_axis=pp_axis)
    fn = _make_loss_and_grads(cfg, mesh, tp_axis=tp_axis, pp_axis=pp_axis,
                              dp_axis=dp_axis, n_micro=n_micro, plain=plain,
                              remat=remat,
                              hier_dp_fast_axis=hier_dp_fast_axis)

    def step(params, tokens, targets):
        loss, held, red = fn(params, tokens, targets)
        lay = params["layers"]
        with torch.no_grad():
            for k, gs in held.items():
                for i, g in enumerate(gs):
                    lay[k][i].sub_(lr * g.to(lay[k].dtype))
            for k in ("embed", "final_norm", "lm_head"):
                params[k].sub_(lr * red[k].to(params[k].dtype))
            for k, g in red["layers"].items():
                lay[k].sub_(lr * g.to(lay[k].dtype))
        return params, loss

    return step, specs


def _reduce(part, mesh, dp_axis, pp_axis, tp_axis, fast, plain):
    """The reduced gradients of the tp-replicated leaves from their per-rank
    partials (embed, final_norm, lm_head [dp, T, ...]; layer leaves [dp,
    L, T, ...]): through the hierarchical all-reduce when ``fast`` names
    the tp axis, else summed over the ranks.  Returns embed, final_norm,
    lm_head as their leaves' shapes, the layer leaves [L, ...]."""
    if fast is None:
        return {"embed": _psum(part["embed"], (0, 1)),
                "final_norm": _psum(part["final_norm"], (0, 1)),
                "lm_head": _psum(part["lm_head"], (0, 1)),
                "layers": {k: _psum(g, (0, 2))
                           for k, g in part["layers"].items()}}
    # per-rank leaves [*mesh.shape, ...]: built (dp, pp, tp)-major, then
    # permuted into the mesh's axis order
    order = (dp_axis, pp_axis, tp_axis)
    perm = [order.index(a) for a in mesh.axis_names]
    pp = mesh.axis_size(pp_axis)

    def per_rank(t):
        return t.permute(*perm, *range(3, t.dim()))

    def over_pp(t):
        # every stage holds the one stage's partial (the pp psum)
        return per_rank(t.unsqueeze(1).expand(t.shape[0], pp, *t.shape[1:]))

    def stage_rows(g):
        # [dp, L, T, ...] -> [dp, pp, T, L / pp, ...]: stage p's layers
        dp_, n, tp = g.shape[:3]
        g = g.view(dp_, pp, n // pp, tp, *g.shape[3:]).transpose(2, 3)
        return per_rank(g)

    tree = {"embed": over_pp(part["embed"]),
            "final_norm": over_pp(part["final_norm"]),
            "layers": {k: stage_rows(g) for k, g in part["layers"].items()},
            "lm_head": over_pp(part["lm_head"])}
    del part
    red = hier_grad_allreduce(tree, mesh, slow_axis=dp_axis, fast_axis=fast,
                              plain=plain)
    first = (0,) * len(mesh.shape)
    p_dim = mesh.dim(pp_axis)

    def stage(t, p):
        idx = [0] * len(mesh.shape)
        idx[p_dim] = p
        return t[tuple(idx)]

    return {"embed": red["embed"][first],
            "final_norm": red["final_norm"][first],
            "lm_head": red["lm_head"][first],
            "layers": {k: torch.cat([stage(g, p) for p in range(pp)])
                       for k, g in red["layers"].items()}}

