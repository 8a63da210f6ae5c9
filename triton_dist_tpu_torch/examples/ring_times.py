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
encodes, launch) and its device time ("dev": the own device time of
every kernel of 20 eager calls, from ``torch.profiler``).  Rows 14 /
14i: the torus AG-GEMM (``torus_ag_gemm``, ``torus_ag_gemm_i8``) on an
eight-rank world as the (2, 4) mesh over both axes at ``chip_smoke.py``
phase 22's shapes (Llama-3-8B TP-8 widths, a 2,048-token prefill: m_loc
256, K 4096, gate/up n 1792, QKV n 768; int8 at gate/up), each held to
its plain version first (the gathered A bit for bit, int8 C exactly),
with the host and device times and (" lib") one library call beside: a
batched ``torch.matmul`` of the gathered view (bf16), one
``torch._int_mm`` of the gathered rows against every rank's B side by
side, B column-major (int8).
"""

from __future__ import annotations

import os
import statistics
import sys

SHAPES = ("ag_gemm W 4, K 4096, n 3584 per rank, m_loc 512 and 16 (m16); "
          "uni chunks 1 / 2 / 4, bidir (also at n 1536: bidir qkv), int8 "
          "wire; rows 13 / 13i: W 4, "
          "m_loc 512 (r250: 250), K 4096, n 1536 / 3584 / 1024 (B^T) / "
          "3584 (B^T), int8 n 3584 / 1536; rows 14 / 14i: the (2, 4) "
          "mesh, m_loc 256, K 4096, n 1792 / 768, int8 n 1792")
# rows 13 / 13i: (tag, m_loc, n, trans_b, int8)
ROWS = (("13 qkv", 512, 1536, False, False),
        ("13 gate_up", 512, 3584, False, False),
        ("13 wo_bwd", 512, 1024, True, False),
        ("13 wdown_bwd", 512, 3584, True, False),
        ("13 r250", 250, 3584, False, False),
        ("13i gate_up", 512, 3584, False, True),
        ("13i qkv", 512, 1536, False, True),
        ("13i r250", 250, 3584, False, True))
# rows 14 / 14i: (tag, n per rank, int8)
TORUS_ROWS = (("14 gate_up", 1792, False), ("14 qkv", 768, False),
              ("14i gate_up", 1792, True))
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


def _device_ms(fn, iters=20):
    """Device time per call of ``fn``: the own device time of every
    kernel that ``iters`` eager calls launch, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us += float(getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0))
    return us / 1e3 / iters


def time_tree(tree: str, repeats: int) -> dict:
    """Median ms of each mode of ``tree``'s AG-GEMM (imported from
    there)."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

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
        out[tag + " dev"] = _device_ms(
            lambda: agm.ag_gemm_shard(a, b, trans_b=trans))
    mesh = Mesh((2, 4), ("x", "y"), dev)
    G, m_loc, k = 8, 256, 4096
    for tag, n, int8 in TORUS_ROWS:
        if int8:
            a = torch.randint(-127, 128, (G, m_loc, k), generator=g,
                              device=dev, dtype=torch.int8)
            b = torch.randint(-127, 128, (G, k, n), generator=g, device=dev,
                              dtype=torch.int8)
            fn, rows = agm.torus_ag_gemm_i8, a.reshape(G * m_loc, k)
            b_cm = b.permute(1, 0, 2).reshape(k, G * n).t().contiguous().t()

            def lib():
                return torch._int_mm(rows, b_cm)
        else:
            a = torch.randn((G, m_loc, k), generator=g, device=dev
                            ).to(torch.bfloat16)
            b = (torch.randn((G, k, n), generator=g, device=dev) / 64
                 ).to(torch.bfloat16)
            fn = agm.torus_ag_gemm
            af = a.reshape(1, G * m_loc, k).expand(G, -1, -1)

            def lib():
                return torch.matmul(af, b)

        def call():
            return fn(a, b, mesh, ("x", "y"))

        got, want = call(), agm.torus_ag_gemm_ref(a, b, mesh, ("x", "y"))
        if not torch.equal(got[0], want[0]) or (
                int8 and not torch.equal(got[1], want[1])):
            raise AssertionError(f"{tag}: differs from the plain version")
        del got, want
        out[tag] = statistics.median(_event_ms(call)
                                     for _ in range(repeats))
        out[tag + " host"] = statistics.median(_host_ms(call)
                                               for _ in range(repeats))
        out[tag + " dev"] = _device_ms(call)
        out[tag + " lib"] = statistics.median(_event_ms(lib)
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
