"""Time the TP ring GEMMs' modes of several checkouts of this repository on
one card, interleaved, to compare two versions of ``csrc/ag_gemm.cu`` /
``csrc/gemm_rs.cu`` (and the tile loops they run on) in the same call.

    python -m triton_dist_tpu_torch.examples.ring_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round,
in the order A B .. B A, each building and importing its own tree.  At
Llama-3-8B TP-4 widths on a four-rank virtual world (K 4096, gate/up n
3584 per rank; m_loc 512, the S 2,048 prefill, and 16, a decode step) it
times the AG-GEMM's uni schedule at chunks 1, 2 and 4, its bidir ring and
its int8 wire (PERF.md rows 13, 13c, 13b, 13w), the bidir ring also at
QKV's n 1536 ("bidir qkv"), and at m_loc 512 the uni
kernels at every shape of ``chip_smoke.py``'s rows 13 and 13i (bf16 QKV n
1536, gate/up, wo^T n 1024 and wdown^T n 3584 with B read transposed,
gate/up at m_loc 250; int8 gate/up, QKV and gate/up at m_loc 250), each
the median of ``--repeats`` eager timings of 10 calls between CUDA events
(a launch carries its call's epoch: no CUDA graph), and beside each of
those the host's time per eager call ("host": checks, tensor-map
encodes, launch).
"""

from __future__ import annotations

import os
import statistics
import sys

SHAPES = ("ag_gemm W 4, K 4096, n 3584 per rank, m_loc 512 and 16 (m16); "
          "uni chunks 1 / 2 / 4, bidir (also at n 1536: bidir qkv), int8 "
          "wire; rows 13 / 13i: W 4, "
          "m_loc 512 (r250: 250), K 4096, n 1536 / 3584 / 1024 (B^T) / "
          "3584 (B^T), int8 n 3584 / 1536")
# rows 13 / 13i: (tag, m_loc, n, trans_b, int8)
ROWS = (("13 qkv", 512, 1536, False, False),
        ("13 gate_up", 512, 3584, False, False),
        ("13 wo_bwd", 512, 1024, True, False),
        ("13 wdown_bwd", 512, 3584, True, False),
        ("13 r250", 250, 3584, False, False),
        ("13i gate_up", 512, 3584, False, True),
        ("13i qkv", 512, 1536, False, True),
        ("13i r250", 250, 3584, False, True))
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


def _host_ms(fn, iters=20):
    """Host time of one eager call (the wrapper's checks, its tensor-map
    encodes and the launch), measured on the host clock without waiting
    for the card; each call's device time is far longer, so the queue
    never fills and blocks the host."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


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
        b = (torch.randn((4, 4096, 1536), generator=g, device=dev) / 64
             ).to(torch.bfloat16)
        out[tag + "bidir qkv"] = statistics.median(
            _event_ms(lambda: agm.ag_gemm_shard(a, b, ring_mode="bidir"))
            for _ in range(repeats))
    for tag, m_loc, n, trans, int8 in ROWS:
        if int8:
            a = torch.randint(-127, 128, (4, m_loc, 4096), generator=g,
                              device=dev, dtype=torch.int8)
            b = torch.randint(-127, 128, (4, 4096, n), generator=g,
                              device=dev, dtype=torch.int8)
        else:
            a = torch.randn((4, m_loc, 4096), generator=g, device=dev
                            ).to(torch.bfloat16)
            b = (torch.randn((4, n, 4096) if trans else (4, 4096, n),
                             generator=g, device=dev) / 64
                 ).to(torch.bfloat16)
        out[tag] = statistics.median(
            _event_ms(lambda: agm.ag_gemm_shard(a, b, trans_b=trans))
            for _ in range(repeats))
        out[tag + " host"] = statistics.median(
            _host_ms(lambda: agm.ag_gemm_shard(a, b, trans_b=trans))
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
