"""Time the MoE overlap kernels (PERF.md rows 19 and 20, the AG-GroupGEMM
``csrc/ag_group_gemm.cu`` and the GroupGEMM-ReduceScatter
``csrc/moe_rs.cu``) of several checkouts of this repository on one card,
interleaved, to compare two versions of the kernels (and the mainloop they
run on) in the same call.

    python -m triton_dist_tpu_torch.examples.moe_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round, in
the order A B .. B A, each building and importing its own tree.  At
``chip_smoke.py`` phase 21's shapes (Mixtral-8x7B's expert FFN over a
four-rank virtual world: D 4096, F 14336, F_loc 3584, E 8, top-2, bf16,
balanced routing from N(0, 1) logits; weights and tokens from seed 0) it
times ``moe_rs_sorted`` (the down projection, rows "bm512", "bm128",
"t32") and ``ag_group_gemm_sorted`` (the gate projection, rows "ag
bm512", "ag bm128", "ag t32") at T 2,048 with the load-aware block_m
(512) and with block_m 128, and at T 32 with the default block_m, each
the median of ``--repeats`` eager timings of 10 calls between CUDA events
(a launch carries its call's epoch: no CUDA graph).  Beside each: ("
lib") one ``torch._grouped_mm`` of the same padded product (the row tiles
sorted by expert against the whole [E, ., .] stack, as ``chip_smoke.py``
times it), (" host") the host's time per eager call, and (" rel l2") the
relative L2 error against the plain version (``moe_rs_ref``,
``ag_group_gemm_ref``).  Prints the card's name and power limit, one JSON
line per (tree, round), and a last JSON line with every tree's median
over its rounds.
"""

from __future__ import annotations

import os
import sys

SHAPES = ("moe_rs and ag_group_gemm (ag): W 4, D 4096, F 14336 (F_loc "
          "3584), E 8, top-2, balanced; T 2048 at block_m 512 (bm512) and "
          "128 (bm128), T 32 at the default block_m (t32)")
# (tag, tokens, block_m: None takes the load-aware default)
CASES = (("bm512", 2048, None), ("bm128", 2048, 128), ("t32", 32, None))


def _grouped_mm(a, w, te, block_m, n_experts):
    """One ``torch._grouped_mm`` of a's row tiles sorted by expert against
    the whole stack w (the library call beside a row)."""
    import torch

    te = te.reshape(-1).long()
    order = torch.argsort(te, stable=True)
    rows = a.reshape(-1, block_m, a.shape[-1])[order].reshape(-1, a.shape[-1])
    offs = (torch.bincount(te, minlength=n_experts).cumsum(0) * block_m).to(
        torch.int32)
    return lambda: torch._grouped_mm(rows, w, offs=offs)


def _row(out, tag, call, ref, lib, repeats):
    """``tag``'s median ms, host ms, library ms and error against ``ref``
    into ``out``."""
    import statistics

    import ring_times

    import torch

    got, want = call(), ref()
    if isinstance(got, tuple):     # ag_group_gemm: (gathered, y)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{tag}: gathered segments differ")
        got, want = got[1], want[1]
    want = want.float()
    out[tag + " rel l2"] = float((got.float() - want).norm() / want.norm())
    del got, want
    out[tag] = statistics.median(ring_times._event_ms(call)
                                 for _ in range(repeats))
    out[tag + " host"] = statistics.median(ring_times._host_ms(call)
                                           for _ in range(repeats))
    out[tag + " lib"] = statistics.median(ring_times._event_ms(lib)
                                          for _ in range(repeats))


def time_tree(tree: str, repeats: int) -> dict:
    """Median ms of ``tree``'s moe_rs and ag_group_gemm kernels (imported
    from there) at each of CASES, with the library call, host time and
    error beside."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("moe_rs", "ag_group_gemm"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    W, D, F, E, topk = 4, 4096, 14336, 8, 2
    w_down = (torch.randn((E, F, D), generator=g, device=dev) * F ** -0.5
              ).bfloat16()
    wd_r = w_down.view(E, W, F // W, D).permute(1, 0, 2, 3)
    w_gate = (torch.randn((E, D, F), generator=g, device=dev) * D ** -0.5
              ).bfloat16()
    w_r = w_gate.view(E, D, W, F // W).permute(2, 0, 1, 3)
    ctx = agg.create_ag_group_gemm_context(Mesh((W,), ("tp",), dev), E,
                                           topk)
    out = {}
    for tag, T, bm in CASES:
        logits = torch.randn((T, E), generator=g, device=dev)
        _, experts = mu.topk_routing(logits, topk)
        block_m = bm or agg.resolve_block_m(ctx, T)
        dest, te, m_pad = agg._segment_plans(experts.view(W, -1, topk), E,
                                             block_m)
        act = (torch.randn((T, F), generator=g, device=dev)).bfloat16()
        act = act.view(W, T // W, F)
        h = torch.cat([mu.gather_sorted(act[s], dest[s], m_pad)
                       for s in range(W)])
        h_r = h.view(W * m_pad, W, F // W).permute(1, 0, 2)
        _row(out, tag,
             lambda: mrs.moe_rs_sorted(h_r, wd_r, te, block_m=block_m),
             lambda: mrs.moe_rs_ref(h_r, wd_r, te, block_m=block_m),
             _grouped_mm(h, w_down, te, block_m, E), repeats)
        x = (torch.randn((T, D), generator=g, device=dev)).bfloat16()
        x = x.view(W, T // W, D)
        xs = torch.stack([mu.gather_sorted(x[r], dest[r], m_pad)
                          for r in range(W)])
        _row(out, "ag " + tag,
             lambda: agg.ag_group_gemm_sorted(xs, w_r, te, block_m=block_m),
             lambda: agg.ag_group_gemm_ref(xs, w_r, te, block_m=block_m),
             _grouped_mm(xs, w_gate, te, block_m, E), repeats)
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
