"""Serving CLI of the PyTorch port: staggered requests through the
continuous-batching engine, or a bare generation run (prefill + decode).

On the card, Llama-3-8B at full width with random weights from a seed:

    python -m triton_dist_tpu_torch.examples.serve --engine \\
        --config llama3_8b --requests 8

On the CPU, a tiny config through the plain PyTorch attention:

    python -m triton_dist_tpu_torch.examples.serve --engine --device cpu

Quantized serving: ``--kv-int8`` (int8 paged KV pools with per-position
scales) and ``--w8a8`` (int8 weights and activations in the out and FFN
projections); the two compose.

Sharded serving: ``--mesh N`` places the engine on a virtual world of N
ranks (on the one device).  ``--kv-shard heads`` (the default, as the
reference's): tensor-parallel weights and pools sharded by KV head, the
out and FFN seams summed over the ranks; ``--w8a8`` and ``--kv-int8``
compose with it.  ``--kv-shard seq``: the paged KV shards by block over
the ranks' sequence spans, and every decode and prompt chunk merges the
ranks' attention partials through the SP combine kernel; long contexts
(Llama-3-8B's 8,192 positions) span every rank:

    python -m triton_dist_tpu_torch.examples.serve --engine --mesh 4 \\
        --kv-shard seq --prompt-len 4096
    python -m triton_dist_tpu_torch.examples.serve --engine --mesh 4 \\
        --kv-shard heads --w8a8

W8A8 prompt scoring (the reference's, without ``--engine``): after the
generation run, ``--w8a8 --mesh N`` scores prompt plus generated tokens
(padded to a multiple of N) through the tensor-parallel W8A8 forward over
N ranks (the AG-GEMM's int8 mode, the int8 GEMM) and prints its cosine
against the float forward:

    python -m triton_dist_tpu_torch.examples.serve --w8a8 --mesh 4

The MoE family (``--model moe``) runs through ``MoEGenerator`` without
``--engine``, as the reference's generation mode does: Mixtral-8x7B at
full width on the card (``--layers`` cuts the depth; 16 layers fit), a
tiny config on the CPU:

    python -m triton_dist_tpu_torch.examples.serve --model moe --layers 16
    python -m triton_dist_tpu_torch.examples.serve --model moe --device cpu

Counterpart of ``examples/serve.py``'s ``run_engine`` and generation mode
(single-step decode; ``--mesh`` with ``--kv-shard seq`` or ``heads``).
On the CPU a layout that shards heads over N ranks widens the tiny
config to 2N query and N KV heads.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from triton_dist_tpu_torch.models import llama, moe
from triton_dist_tpu_torch.models.generate import Generator
from triton_dist_tpu_torch.models.generate_moe import MoEGenerator
from triton_dist_tpu_torch.runtime.bootstrap import get_world
from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul
from triton_dist_tpu_torch.serve import Request, SamplingParams, ServeEngine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("llama", "moe"), default="llama")
    p.add_argument("--engine", action="store_true",
                   help="drive the continuous-batching engine (dense family "
                        "only); without it, prefill a batch of prompts and "
                        "decode them")
    p.add_argument("--batch", type=int, default=2,
                   help="prompts of the generation mode")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' (plain attention, tiny "
                        "config unless --config says otherwise)")
    p.add_argument("--config", default=None,
                   choices=sorted(set(llama.CONFIGS) | set(moe.CONFIGS)),
                   help="model preset (default: llama3_8b or mixtral_8x7b "
                        "on cuda, a tiny test config on cpu)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the depth (widths stay the preset's)")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=None,
                   help="mean prompt length (lengths span 0.5x..1.5x)")
    p.add_argument("--new-tokens", type=int, default=32)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV pool blocks (default: every slot at max_seq)")
    p.add_argument("--stagger", type=int, default=2,
                   help="submit a new request every S engine steps")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 paged KV pools (per-position f32 scales; "
                        "~0.52 of the bf16 bytes per token at head_dim "
                        "128)")
    p.add_argument("--w8a8", action="store_true",
                   help="W8A8 weights: per-channel int8 wo/wgate/wup/wdown, "
                        "per-row int8 activations, exact int8 GEMMs (engine "
                        "mode); with --mesh N and no --engine, the W8A8 "
                        "prompt scoring over N ranks")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="engine mode: serve over a virtual world of N "
                        "ranks on the one device (--kv-shard); with --w8a8 "
                        "and no --engine: score over N ranks")
    p.add_argument("--kv-shard", choices=("heads", "seq", "heads+seq"),
                   default="heads",
                   help="--mesh KV layout: 'heads' (the default) shards "
                        "weights and pools by head (tensor parallelism); "
                        "'seq' shards the paged pools by block, each rank "
                        "owning a contiguous sequence span (SP "
                        "flash-decode); 'heads+seq' is not ported yet")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="after the run, a second wave of the same prompts: "
                        "once every row decodes, time N steps, then run N "
                        "more under torch.profiler; print wall and "
                        "device-busy ms per step, the device's idle share "
                        "and the kernels by device time")
    return p.parse_args(argv)


def _device_us(evt) -> float:
    """Own device time (us) of a profiler event that ran on the card;
    0 for host-side operator events (their kernels are events of their
    own, so counting both would count twice)."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_steps(eng, n_steps: int) -> dict:
    """Time ``n_steps`` engine steps on the host clock, then run as many
    more under ``torch.profiler`` for the device-busy time per step (the
    sum of every kernel's and copy's own device time; the profiler's own
    host cost inflates its window's wall time, so the idle share divides
    by the unprofiled steps' wall time) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    busy = sum(_device_us(e) for e in evts) / 1e3 / n_steps
    top = sorted(evts, key=_device_us, reverse=True)[:10]
    rep = {
        "steps": n_steps,
        "wall_ms_per_step": wall,
        "device_ms_per_step": busy,
        "idle_share": 1.0 - busy / wall,
        "top": [(e.key[:70], e.count, _device_us(e) / 1e3 / n_steps)
                for e in top],
    }
    print(f"[profile] decode steps of {eng.max_batch} rows: wall "
          f"{wall:.3f} ms/step ({n_steps} steps), device busy {busy:.3f} "
          f"ms/step ({n_steps} more steps, profiled), idle share "
          f"{rep['idle_share']:.3f}")
    for name, count, ms in rep["top"]:
        print(f"[profile]   {ms:8.3f} ms/step  x{count:<6d} {name}")
    return rep


def _shards_heads(args) -> bool:
    """Whether the run shards attention heads over ``--mesh`` ranks: the
    heads engine, or the W8A8 scoring of the generation mode."""
    if args.mesh is None:
        return False
    return args.kv_shard == "heads" if args.engine else args.w8a8


def _config(args):
    family = moe if args.model == "moe" else llama
    cpu = torch.device(args.device).type == "cpu"
    if args.config is not None:
        if args.config not in family.CONFIGS:
            raise SystemExit(f"--config {args.config} is not a "
                             f"{args.model} preset")
        cfg = family.CONFIGS[args.config]()
    elif cpu and family is moe:
        # the reference's toy MoE at world 1, widened to head_dim 128
        cfg = moe.MoEConfig(vocab=512, dim=256, n_layers=2, n_heads=2,
                            n_kv_heads=1, n_experts=4, topk=2,
                            expert_ffn_dim=64, max_seq=256, block_m=8)
    elif cpu:
        # a layout that shards heads over N ranks needs N KV heads
        kv = args.mesh if _shards_heads(args) else 1
        cfg = llama.LlamaConfig(vocab=512, dim=256, n_layers=2,
                                n_heads=2 * kv, n_kv_heads=kv, ffn_dim=512,
                                max_seq=256)
    elif family is moe:
        cfg = moe.MoEConfig.mixtral_8x7b()
    else:
        cfg = llama.LlamaConfig.llama3_8b()
    if args.layers is not None:
        from dataclasses import replace
        cfg = replace(cfg, n_layers=args.layers)
    return family, cfg


def run_generate(args):
    """The generation mode: ``--batch`` random prompts of ``--prompt-len``
    tokens (default 8), prefilled at once, then ``--new-tokens`` steps of
    greedy or sampled decode.  Returns the tokens [batch, new] int32."""
    use_full_precision_matmul()
    family, cfg = _config(args)
    prompt_len = args.prompt_len or 8
    max_seq = min(cfg.max_seq, prompt_len + args.new_tokens)
    if prompt_len + args.new_tokens > cfg.max_seq:
        raise SystemExit(f"prompt {prompt_len} + {args.new_tokens} new "
                         f"tokens exceed max_seq {cfg.max_seq}")
    t0 = time.perf_counter()
    params = family.init_params(cfg, seed=args.seed, device=args.device)
    kv = torch.int8 if args.kv_int8 else None
    gen = (MoEGenerator if family is moe else Generator)(
        cfg, max_seq=max_seq, device=args.device, kv_dtype=kv)
    print(f"[serve] {args.model} {cfg.n_layers}-layer dim-{cfg.dim} model on "
          f"{gen.device} ({time.perf_counter() - t0:.1f} s to build)")
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, size=(args.batch, prompt_len))
    sample = generator = None
    if args.temperature > 0:
        from triton_dist_tpu_torch.models.sampling import make_sampler
        sample = make_sampler(temperature=args.temperature, top_k=args.top_k,
                              top_p=args.top_p)
        generator = torch.Generator(device=gen.device).manual_seed(
            args.seed + 1)
    with torch.no_grad():
        t0 = time.perf_counter()
        state = gen.prefill(params, prompt)
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks, state = gen.generate(params, state, args.new_tokens,
                                   sample=sample, generator=generator)
        if gen.device.type == "cuda":
            torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    print(f"[serve] prefill {prompt_len} tokens x{args.batch}: "
          f"{t_pre * 1e3:.1f} ms; decode {args.new_tokens} steps: "
          f"{t_dec * 1e3:.1f} ms ({t_dec / args.new_tokens * 1e3:.1f} "
          f"ms/token)")
    print(f"tokens:\n{toks.cpu().numpy()}")
    if args.w8a8:
        score_w8a8(args, cfg, params, prompt, toks)
    return toks


def score_w8a8(args, cfg, params, prompt, toks) -> float:
    """The reference's W8A8 prompt scoring: prompt plus generated tokens,
    seq-major and padded with token 0 to a multiple of ``--mesh`` N,
    through ``make_w8a8_forward`` over N ranks (the W8A8 tree quantized
    for N and laid out rank by rank); prints and returns the cosine of its
    logits against the float forward's."""
    from triton_dist_tpu_torch.models import llama_w8a8

    n = args.mesh
    seq = torch.cat([torch.as_tensor(prompt, device=toks.device),
                     toks.long()], dim=1).T                      # [S, B]
    seq = torch.nn.functional.pad(seq, (0, 0, 0, -seq.shape[0] % n))
    with torch.no_grad():
        qp = llama_w8a8.place_w8a8_params(
            llama_w8a8.quantize_params_w8a8(params, cfg, n), cfg, n)
        ql = llama_w8a8.make_w8a8_forward(cfg, n)(qp, seq)
        del qp
        fl = llama.make_forward(cfg)(params, seq)
    cos = float((ql * fl).sum() / (ql.norm() * fl.norm()))
    print(f"[serve] w8a8 prompt scoring over {n} ranks, {seq.shape[0]} "
          f"positions x{seq.shape[1]}: cosine vs float {cos:.4f}")
    return cos


def run_engine(args) -> dict:
    use_full_precision_matmul()
    _, cfg = _config(args)
    prompt_len = args.prompt_len or min(512, cfg.max_seq // 4)
    max_seq = cfg.max_seq
    max_seq -= max_seq % args.page_size
    chunk = args.prefill_chunk or min(512, max(args.page_size, prompt_len))
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(max(1, prompt_len // 2), prompt_len * 3 // 2 + 1,
                        size=args.requests)
    if int(lens.max()) + args.new_tokens > max_seq:
        raise SystemExit(f"prompt {int(lens.max())} + {args.new_tokens} new "
                         f"tokens exceed max_seq {max_seq}")
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=args.seed, device=args.device)
    gen = Generator(cfg, max_seq=max_seq, device=args.device,
                    kv_dtype=torch.int8 if args.kv_int8 else None)
    num_blocks = args.num_blocks or 1 + args.max_batch * (max_seq //
                                                         args.page_size)
    mesh = None
    if args.mesh is not None:
        mesh = get_world(args.mesh, gen.device)
        if args.num_blocks is None and args.kv_shard != "heads":
            # equal per-rank partitions, one null each, a full-length
            # span still fitting its partition
            num_blocks = -(-(num_blocks + args.mesh) // args.mesh) * \
                args.mesh
    eng = ServeEngine(gen, params, num_blocks=num_blocks,
                      page_size=args.page_size, max_batch=args.max_batch,
                      prefill_chunk=chunk, w8a8=args.w8a8, mesh=mesh,
                      kv_shard=args.kv_shard)
    kv = eng.metrics.kv_stats()
    print(f"[serve] {cfg.n_layers}-layer dim-{cfg.dim} model on "
          f"{gen.device} ({time.perf_counter() - t0:.1f} s to build); "
          f"{args.requests} requests, prompts {sorted(lens.tolist())}, "
          f"{args.new_tokens} new tokens each; KV pools "
          f"{'int8' if kv['quantized'] else str(cfg.dtype)}, "
          f"{kv['bytes_per_token']:.0f} B/token, weights "
          f"{'w8a8' if args.w8a8 else str(cfg.dtype)}"
          + (f"; mesh {args.mesh} ranks, kv_shard="
             f"{args.kv_shard!r}, "
             f"{num_blocks} blocks" if mesh is not None else ""))
    sp = SamplingParams(max_new_tokens=args.new_tokens,
                        temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p, seed=args.seed)
    reqs = [Request(f"req-{i}", rng.integers(0, cfg.vocab, size=int(n)), sp)
            for i, n in enumerate(lens)]
    outs, sub, steps = {}, 0, 0
    t0 = time.perf_counter()
    with torch.no_grad():
        while eng.has_work() or sub < len(reqs):
            if steps % args.stagger == 0 and sub < len(reqs):
                eng.submit(reqs[sub])
                sub += 1
            for o in eng.step():
                outs[o.request_id] = o
            steps += 1
    if gen.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid in sorted(outs):
        o = outs[rid]
        print(f"{rid}: {o.finish_reason.value}, {len(o.token_ids)} tokens, "
              f"first {o.token_ids[:8]}")
    s = eng.metrics.summary()
    n_tok = sum(len(o.token_ids) for o in outs.values())
    print(f"[serve] {len(outs)} finished in {steps} steps, {wall:.2f} s "
          f"({n_tok / wall:.1f} generated tok/s); prefill tokens "
          f"{s['prefill_tokens']}, decode steps {s['decode_steps']}, "
          f"preemptions {s['preemptions']}, mean ttft "
          f"{s['mean_ttft']:.3f} s, mean itl {s['mean_itl']:.4f} s")
    if args.profile and gen.device.type == "cuda":
        # A second wave of the same prompts, all admitted at once; once
        # every row decodes, N steps run under the profiler (separately
        # from the measured run above, which the profiler would slow).
        with torch.no_grad():
            for r in reqs:
                eng.submit(Request(f"{r.request_id}-p", r.prompt,
                                   SamplingParams(
                                       max_new_tokens=args.new_tokens)))
            while (eng.scheduler.waiting or any(
                    s is not None and s.status.value != "running"
                    for s in eng.slots)):
                eng.step()
            profile_steps(eng, min(args.profile,
                                   (args.new_tokens - 2) // 2))
    return outs


def main(argv=None):
    args = parse_args(argv)
    if args.model == "moe" and (args.engine or args.w8a8):
        raise NotImplementedError(
            "--engine / --w8a8 with --model moe: the reference's engine and "
            "W8A8 forward serve the dense family only; MoE serving goes "
            "through MoEGenerator (drop the flag), and its engine path is "
            "ROADMAP Queue 1 item 13")
    if args.kv_shard != "heads" and args.mesh is None:
        # a non-default layout without a mesh would serve world 1 while
        # the user believes they exercised sequence sharding (the
        # default, heads, serves world 1 off-mesh, as the reference's)
        raise SystemExit("--kv-shard needs --mesh N (and --engine)")
    if not args.engine:
        # --w8a8 and --mesh together: the W8A8 prompt scoring
        if args.profile or args.kv_shard != "heads" or \
                args.w8a8 != (args.mesh is not None):
            raise SystemExit("--profile / --kv-shard are engine-mode flags, "
                             "as are --w8a8 and --mesh alone (together, "
                             "without --engine: the W8A8 prompt scoring): "
                             "add --engine")
        run_generate(args)
        return
    run_engine(args)


if __name__ == "__main__":
    main()
