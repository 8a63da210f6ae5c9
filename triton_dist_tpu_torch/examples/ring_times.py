"""Time the TP ring GEMMs' modes of several checkouts of this repository on
one card, interleaved, to compare two versions of ``csrc/ag_gemm.cu`` /
``csrc/gemm_rs.cu`` (and the tile loop they share) in the same call.

    python -m triton_dist_tpu_torch.examples.ring_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round,
in the order A B .. B A, each building and importing its own tree.  At
Llama-3-8B TP-4 widths on a four-rank virtual world (K 4096, gate/up n
3584 per rank; m_loc 512, the S 2,048 prefill, and 16, a decode step) it
times the AG-GEMM's uni schedule at chunks 1, 2 and 4, its bidir ring and
its int8 wire (PERF.md rows 13, 13c, 13b, 13w), each the median of
``--repeats`` eager timings of 10 calls between CUDA events (a launch
carries its call's epoch: no CUDA graph).
"""

from __future__ import annotations

import os
import statistics
import sys

SHAPES = ("ag_gemm W 4, K 4096, n 3584 per rank, m_loc 512 and 16 (m16); "
          "uni chunks 1 / 2 / 4, bidir, int8 wire")
MODES = {"chunks1": {}, "chunks2": {"chunks": 2}, "chunks4": {"chunks": 4},
         "bidir": {"ring_mode": "bidir"}, "wire": {"wire_dtype": "int8"}}


def _event_ms(fn, iters=10):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_tree(tree: str, repeats: int) -> dict:
    """Median ms of each mode of ``tree``'s AG-GEMM (imported from
    there)."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("ag_gemm",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}
    for tag, m_loc in (("", 512), ("m16 ", 16)):
        a = torch.randn((4, m_loc, 4096), generator=g, device=dev
                        ).to(torch.bfloat16)
        b = (torch.randn((4, 4096, 3584), generator=g, device=dev) / 64
             ).to(torch.bfloat16)
        for mode, kw in MODES.items():
            out[tag + mode] = statistics.median(
                _event_ms(lambda: agm.ag_gemm_shard(a, b, **kw))
                for _ in range(repeats))
    return out


def main(argv=None) -> int:
    # the sibling module, not the package: a timing process imports the
    # port from its tree only
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import flash_times

    return flash_times.main(argv, timer=time_tree, shapes=SHAPES,
                            script=__file__, doc=__doc__)


if __name__ == "__main__":
    sys.exit(main())
