"""Time the flash kernels of several checkouts of this repository on one
card, interleaved, to compare two versions of ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` on the same card in the same call.

    python -m triton_dist_tpu_torch.examples.flash_times TREE_A TREE_B

Each TREE is the root of a checkout (a ``git archive`` of a commit
unpacked into a git-ignored directory, or the working tree ``.``).  Every
round runs one fresh process per tree, in the order A B .. B A, so a
drift of the card's clock over the call weighs on every tree alike; each
process builds its own tree's kernels (into that tree's ``build/``) and
imports the port from that tree only.  It times, at ``chip_smoke.py``'s
shapes, the kernels of PERF.md rows 1, 5 and 6:

- ``flash_fwd``: the engine's 512-row chunk at q_offset 1536 over 2048
  keys, B 1, Hq 32 / Hkv 8, D 128, bf16;
- ``flash_fwd_i8``: the same chunk over int8 K/V with f32 row scales;
- ``flash_bwd_dq`` / ``flash_bwd_dkv``: B 1, S 2048, causal, bf16
  gradients (the training shape).

Each time is the median over ``--repeats`` CUDA-graph timings (20 calls
captured in one graph, replayed 5 times between CUDA events).  Prints
the card's name and power limit, one JSON line per (tree, round), and a
last JSON line with every tree's median over its rounds.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ("flash_fwd: [1, 32, 512, 128] at q_offset 1536 over [1, 8, 2048, "
          "128]; flash_fwd_i8: the same, int8 K/V; flash_bwd_dq / dkv: [1, "
          "32, 2048, 128], causal, bf16 gradients")


def _graph_ms(fn, iters=20, reps=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def time_tree(tree: str, repeats: int) -> dict:
    """Median ms of each kernel of ``tree``'s port (imported from there)."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("flash_fwd", "flash_bwd"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(torch.bfloat16)

    Hq, Hkv, D = 32, 8, 128
    q, k, v = randn(1, Hq, 512, D), randn(1, Hkv, 2048, D), randn(
        1, Hkv, 2048, D)
    kq, ks = fd.quantize_kv(k.float())
    vq, vs = fd.quantize_kv(v.float())
    S = 2048
    bq, bk, bv, do = (randn(1, Hq, S, D), randn(1, Hkv, S, D),
                      randn(1, Hkv, S, D), randn(1, Hq, S, D))
    out, lse = fa.flash_attention(bq, bk, bv, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).contiguous()
    bkw = dict(causal=True, scale=D ** -0.5, q_offset=0, kv_offset=0,
               soft_cap=0.0, window=0, out_dtype=torch.bfloat16)
    calls = {
        "flash_fwd": lambda: fa.flash_attention(q, k, v, q_offset=1536),
        "flash_fwd_i8": lambda: fa.flash_attention(
            q, kq, vq, q_offset=1536, k_scale=ks, v_scale=vs),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(bq, bk, bv, do, lse, delta,
                                                **bkw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(bq, bk, bv, do, lse,
                                                  delta, **bkw),
    }
    return {name: statistics.median(_graph_ms(fn) for _ in range(repeats))
            for name, fn in calls.items()}


def main(argv=None, *, timer=time_tree, shapes=SHAPES, script=__file__,
         doc=__doc__, rows=()) -> int:
    """Run ``timer(tree, repeats)`` (a dict of kernel name -> ms) in one
    fresh process of ``script`` per (tree, round), interleaved; another
    module times its kernels here by passing its own.  ``rows``, where
    given, are the row names that ``timer`` knows: ``--rows`` picks some
    of them by exact name (all by default), and the timer is called as
    ``timer(tree, repeats, rows)``."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots to compare")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds of A B .. B A (default 2)")
    ap.add_argument("--repeats", type=int, default=9,
                    help="CUDA-graph timings per kernel, median (default 9)")
    if rows:
        ap.add_argument("--rows", nargs="+", choices=rows,
                        default=list(rows),
                        help="rows to time, by exact name (default all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    picked = ["--rows", *args.rows] if rows else []
    if args.child:
        print(json.dumps(timer(args.trees[0], args.repeats,
                               *([args.rows] if rows else []))))
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    print(f"shapes: {shapes}", flush=True)
    trees = [os.path.realpath(t) for t in args.trees]
    order = (trees + trees[::-1]) * args.rounds
    seen: dict[str, list[dict]] = {t: [] for t in trees}
    for i, tree in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.realpath(script), "--child", tree,
             "--repeats", str(args.repeats), *picked], capture_output=True,
            text=True, cwd=tree)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            raise SystemExit(f"timing {tree} failed ({res.returncode})")
        ms = json.loads(res.stdout.strip().splitlines()[-1])
        seen[tree].append(ms)
        print(json.dumps({"tree": tree, "run": i, "ms": ms}), flush=True)
    summary = {t: {k: statistics.median(r[k] for r in runs)
                   for k in runs[0]} for t, runs in seen.items()}
    print(json.dumps({"median_ms": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
