"""Time the decode kernel's four entries over split counts on one card,
in one process, to choose ``kernels/flash_decode.py``'s ``BLOCKS_PER_SM``
(the split count's target: about this many blocks per SM):

    python -m triton_dist_tpu_torch.examples.decode_trials

``split_plan`` reads the module constant at each call, so each trial sets
it and times ``attn_times``' decode rows (``chip_smoke.py``'s shapes,
CUDA-graph replays, L2 warm) with the median of ``--repeats`` timings.
Every trial first holds each entry's result to the one at the shipped
value (1e-3: only the split merge's rounding differs; the card tests hold
the shipped one to the plain version).  The ring's depth is a constant of
``csrc/decode.cu``: compare depths as trees with ``attn_times``.  Prints
the card's name and power limit, one JSON line a trial and a last JSON
line with every trial's times.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", default="2,1,3,4,6",
                    help="BLOCKS_PER_SM values")
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from attn_times import _decode_calls
    from flash_times import _graph_ms
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    _build.build(("decode",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    calls = _decode_calls(torch, fd, randn, dev, 32, 8, 128)
    want = {n: fn() for n, fn in calls.items()}   # the shipped value
    results = []
    for bps in (int(x) for x in args.trials.split(",")):
        fd.BLOCKS_PER_SM = bps
        row = {"blocks_per_sm": bps}
        for name, fn in calls.items():
            out, lse = fn()
            err = (out - want[name][0]).abs().max().item()
            if not err <= 1e-3 or not torch.equal(
                    lse <= -1e29, want[name][1] <= -1e29):
                raise SystemExit(f"{row} {name}: differs from the shipped "
                                 f"value's result by {err}")
            row[name] = statistics.median(_graph_ms(fn)
                                          for _ in range(args.repeats))
        print(json.dumps(row), flush=True)
        results.append(row)
    print(json.dumps({"trials": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
