"""Training CLI of the PyTorch port: a resumable trainer on one card.

Counterpart of ``examples/train.py``, for the dense Llama family or the
Mixtral-class MoE family (``--model moe``), at world 1 or over ``--tp``
ranks of the virtual world on one device (the reference trainer's mesh of
``tp = n // dp`` devices: Llama tensor-parallel; MoE with tensor-parallel
attention and expert-parallel FFNs, SGD only): plain SGD
(the family's in-place step) or AdamW (``models/training.py``), random
weights and a fixed random token book from ``--seed``, checkpoint/resume
through ``runtime.CheckpointManager`` (kill the process at any step and
re-run the same command to continue bit-exactly), a heartbeat file and a
per-step stall watchdog.

On the card, Llama-3-8B at full width (every attention forward and
backward on the port's hand-written kernels):

    python -m triton_dist_tpu_torch.examples.train --steps 4 --seq 2048 \\
        --batch 1 --lr 0.2

Llama-3-8B tensor-parallel over 4 ranks of the virtual world on the card
(every column-parallel projection on the hand-written AG-GEMM kernel and
every row-parallel one on the GEMM-RS kernel, forward and backward):

    python -m triton_dist_tpu_torch.examples.train --tp 4 --steps 3 \\
        --seq 2048 --batch 1 --lr 0.2

Mixtral-8x7B at full width, cut to 8 layers by default (every expert
FFN on the hand-written grouped-GEMM kernel, dx through its transposed
mode):

    python -m triton_dist_tpu_torch.examples.train --model moe --steps 3 \\
        --seq 2048 --batch 1 --lr 0.2

Mixtral-8x7B at full width over 4 ranks (attention on the AG-GEMM and
GEMM-RS kernels, the tokens' way to their experts and back on the
all-to-all kernel's peer segments, the experts on the grouped GEMM):

    python -m triton_dist_tpu_torch.examples.train --model moe --tp 4 \
        --steps 3 --seq 2048 --batch 1 --lr 0.2

Data parallelism (``--dp N``, the reference trainer's dp x tp mesh, which
the port does not build): the loss of N data-parallel ranks, each on its
B / N columns of the global batch through the same weights, their
gradients summed by autograd (the reference's dp ``psum``, XLA's there: no
kernel is owed).  The dense loss has no per-rank term, so Llama takes it
over the whole batch in one pass; MoE's balance loss is each rank's own,
so MoE splits the batch (``models/*.dp_loss``):

    python -m triton_dist_tpu_torch.examples.train --dp 2 --tp 2 \
        --steps 3 --seq 2048 --batch 2 --lr 0.2

On the CPU, a tiny config (head_dim 128) through the plain versions
(``--tp 4``, ``--dp 2`` too):

    python -m triton_dist_tpu_torch.examples.train --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from dataclasses import replace

import numpy as np
import torch

from triton_dist_tpu_torch.models import llama, moe, training
from triton_dist_tpu_torch.runtime.checkpoint import CheckpointManager
from triton_dist_tpu_torch.runtime.utils import (
    resolve_device,
    tree_leaves,
    use_full_precision_matmul,
)
from triton_dist_tpu_torch.runtime.watchdog import (
    Heartbeat,
    block_until_ready_with_timeout,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("llama", "moe"), default="llama")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel degree: the loss of dp ranks, "
                        "each on its share of the batch")
    p.add_argument("--tp", type=int, default=1,
                   help="ranks of the virtual world on the one device "
                        "(SGD): tensor parallelism (Llama), TP attention "
                        "and expert-parallel FFNs (MoE)")
    p.add_argument("--batch", type=int, default=4, help="global batch")
    p.add_argument("--seq", type=int, default=64, help="sequence length")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--opt", choices=("sgd", "adamw"), default="sgd",
                   help="sgd = the family's in-place step; adamw = "
                        "torch.optim.AdamW with optax's defaults "
                        "(models/training.py), its state checkpointed too")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--keep", type=int, default=3)
    p.add_argument("--step-timeout", type=float, default=600.0,
                   help="per-step stall watchdog (seconds)")
    p.add_argument("--heartbeat", default=None,
                   help="liveness file path (default: <ckpt-dir>/heartbeat.0)")
    p.add_argument("--profile", default=None,
                   help="profile trace directory")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (plain attention, tiny "
                        "config unless --config says otherwise)")
    p.add_argument("--config", default=None,
                   choices=sorted(set(llama.CONFIGS) | set(moe.CONFIGS)),
                   help="model preset (default: llama3_8b or mixtral_8x7b "
                        "on cuda, a tiny test config on cpu)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (widths stay the preset's; "
                        "mixtral_8x7b defaults to 8 layers: 32 do not fit "
                        "one card)")
    return p.parse_args(argv)


def _config(args):
    family = moe if args.model == "moe" else llama
    cpu = torch.device(args.device).type == "cpu"
    if args.config is not None:
        if args.config not in family.CONFIGS:
            raise SystemExit(f"--config {args.config} is not a "
                             f"{args.model} preset")
        cfg = family.CONFIGS[args.config]()
    elif cpu and family is moe:
        # the reference's toy MoE at world 1, widened to head_dim 128;
        # whole heads and experts per rank
        heads = max(2, args.tp)
        cfg = moe.MoEConfig(vocab=256, dim=128 * heads, n_layers=2,
                            n_heads=heads, n_kv_heads=max(1, args.tp),
                            n_experts=max(4, args.tp), topk=2,
                            expert_ffn_dim=64, max_seq=max(args.seq, 64),
                            block_m=8)
    elif cpu:
        # head_dim 128, the width the attention kernels take (the
        # reference's toy config has head_dim 32); whole heads per rank
        heads = max(2, args.tp)
        cfg = llama.LlamaConfig(vocab=256, dim=128 * heads, n_layers=2,
                                n_heads=heads, n_kv_heads=max(1, args.tp),
                                ffn_dim=512, max_seq=max(args.seq, 64))
    elif family is moe:
        cfg = replace(moe.MoEConfig.mixtral_8x7b(), n_layers=8)
    else:
        cfg = llama.LlamaConfig.llama3_8b()
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    return family, cfg


def build(args, device):
    """(cfg, params, opt, step_fn): ``opt`` is None for SGD;
    ``step_fn(tokens, targets) -> loss`` updates params (and opt) in
    place."""
    family, cfg = _config(args)
    params = family.init_params(cfg, seed=args.seed, device=device)
    if args.tp > 1:
        params = family.shard_params(params, cfg, args.tp)
    if args.opt == "adamw":
        opt_step, opt_init = training.make_optim_train_step(
            family, cfg, training.adamw(args.lr), dp=args.dp)
        opt = opt_init(params)

        def step_fn(tokens, targets):
            return opt_step(params, opt, tokens, targets)[2]
    else:
        sgd_step = family.make_train_step(cfg, args.tp, lr=args.lr,
                                          dp=args.dp)
        opt = None

        def step_fn(tokens, targets):
            return sgd_step(params, tokens, targets)[1]
    return cfg, params, opt, step_fn


def main(argv=None):
    args = parse_args(argv)
    if args.batch % args.dp:
        raise SystemExit(f"--batch {args.batch} does not split over --dp "
                         f"{args.dp}")
    if args.profile:
        raise NotImplementedError("--profile: group_profile is not ported "
                                  "yet (ROADMAP Queue 1 item 16)")
    if args.tp > 1 and args.opt == "adamw":
        raise NotImplementedError("--opt adamw --tp > 1: an optimizer over "
                                  "the sharded tree is not ported yet "
                                  "(ROADMAP Queue 1's ninth entry)")
    device = resolve_device(args.device)
    use_full_precision_matmul()
    cfg, params, opt, step_fn = build(args, device)
    print(f"device {device}  model={args.model}  {cfg.n_layers} layers dim "
          f"{cfg.dim}  dp={args.dp}  tp={args.tp}  opt={args.opt}",
          flush=True)

    # Deterministic toy data: next-token prediction on a fixed random book.
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.seq, args.batch)),
        device=device)
    targets = torch.roll(tokens, -1, dims=0)

    def state():
        tree = {"params": params}
        if opt is not None:
            tree["opt"] = opt.state_dict()
        return tree

    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, max_to_keep=args.keep)
        resumed = mgr.restore_latest(like={"params": params})
        if resumed is not None:
            with torch.no_grad():
                for p, saved in zip(tree_leaves(params),
                                    tree_leaves(resumed[1]["params"])):
                    p.copy_(saved)
            if opt is not None:
                opt.load_state_dict(resumed[1]["opt"])
            start = resumed[0] + 1
            print(f"resumed from step {resumed[0]}", flush=True)

    hb_path = args.heartbeat or (
        os.path.join(args.ckpt_dir, "heartbeat.0") if args.ckpt_dir
        else None)

    def loop():
        saved = start - 1
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            loss = step_fn(tokens, targets)
            loss = block_until_ready_with_timeout(
                loss, args.step_timeout, name=f"train step {step}")
            dt = time.perf_counter() - t0
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"{dt * 1e3:7.1f} ms", flush=True)
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step, state())
                saved = step
                print(f"checkpointed step {step}", flush=True)
        if mgr is not None and saved < args.steps - 1:
            mgr.save(args.steps - 1, state())

    with contextlib.ExitStack() as stack:
        if hb_path:
            stack.enter_context(Heartbeat(hb_path, interval_s=10.0))
        loop()
    print("done", flush=True)


if __name__ == "__main__":
    main()
