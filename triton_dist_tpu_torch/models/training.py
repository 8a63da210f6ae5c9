"""Optimizer integration: stateful train steps over the port's kernels.

Counterpart of ``triton_dist_tpu/models/training.py``.  The
family modules (``models/llama.py``, ``models/moe.py``) ship a plain-SGD
``make_train_step``; real training wants a stateful optimizer (AdamW
etc.).  This module composes any ``torch.optim.Optimizer`` with a
family's loss:

- :func:`make_grads` — ``(loss, grads)`` of the family's ``loss_shard``
  by autograd (attention through the flash kernels' forward and backward
  on the card), at world 1 or over the ``world`` ranks of the virtual
  world (the family's ``shard_params`` tree: a leaf held once gets the
  sum of every rank's gradient, the reference's per-leaf psum).
- :func:`make_optim_train_step` — the counterpart of
  ``make_optax_train_step``: it takes an optimizer FACTORY (a callable
  from the list of parameter leaves to a ``torch.optim.Optimizer``) where
  the reference takes an optax transform.  :func:`adamw` builds the one
  that matches ``optax.adamw(lr)``.

The reference's ``shard_opt_state_like`` has no counterpart: it places
optax moments in their parameters' shardings on a mesh, and at world 1
every moment already lives on its parameter's device (a torch optimizer
allocates its state with ``zeros_like(param)``).

The optimizer's ``state_dict()`` is a tree of tensors and numbers, so
``runtime/checkpoint.py`` saves {params, opt} together and a resume is
bit-exact.
"""

from __future__ import annotations

from typing import Callable

import torch

from triton_dist_tpu_torch.runtime.utils import tree_leaves, value_and_grad


def _check_family(family) -> None:
    if not family.__name__.endswith(("models.llama", "models.moe")):
        raise NotImplementedError(
            f"{family.__name__}: the ported families are models.llama "
            f"(dense) and models.moe (Mixtral class)")


def make_grads(family, cfg, *, world: int = 1, plain: bool = False,
               dp: int = 1) -> Callable:
    """``grads_fn(params, tokens, targets) -> (loss, grads)``, grads a
    tree shaped like params.  ``family`` is ``models.llama`` or
    ``models.moe``; over ``world`` > 1 ranks ``params`` is the family's
    ``shard_params`` tree; ``plain`` differentiates the plain PyTorch
    versions of every hand-written kernel the family runs (a reference
    gradient on any device); ``dp`` is the reference's data-parallel
    degree (the family's ``dp_loss``)."""
    _check_family(family)

    def grads_fn(params, tokens, targets):
        return value_and_grad(family.dp_loss, params, tokens, targets, cfg,
                              dp=dp, world=world, plain=plain)

    return grads_fn


def adamw(lr: float) -> Callable:
    """Factory of ``torch.optim.AdamW`` with ``optax.adamw(lr)``'s
    defaults: betas (0.9, 0.999), eps 1e-8 and weight decay 1e-4 (torch's
    default is 1e-2).  Both keep the moments in the parameter dtype and
    apply the decay to the pre-update parameter, so the two agree to
    rounding."""

    def make(leaves):
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    return make


def make_optim_train_step(family, cfg, opt_factory: Callable, *,
                          dp: int = 1):
    """(step, init) over a torch optimizer.

    ``init(params) -> opt``: the optimizer over ``params``'s leaves in
    ``jax.tree`` order; ``step(params, opt, tokens, targets) -> (params,
    opt, loss)``.  Gradients are cast to the parameter dtype before the
    update, as the reference casts them; parameters and optimizer state
    update in place.  ``dp`` as in :func:`make_grads`."""
    grads_fn = make_grads(family, cfg, dp=dp)

    def init(params):
        return opt_factory(tree_leaves(params))

    def step(params, opt, tokens, targets):
        loss, grads = grads_fn(params, tokens, targets)
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.grad = g.to(p.dtype)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return params, opt, loss

    return step, init
