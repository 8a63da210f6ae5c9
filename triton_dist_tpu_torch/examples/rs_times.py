"""Time the GEMM-RS kernels and the reduce-scatter (PERF.md rows 15, 15b,
15i, 15bi, 16, 16i, 12r and 12b) of several checkouts of this repository
on one card, interleaved, to
compare two versions of ``csrc/gemm_rs.cu`` / ``csrc/reduce_scatter.cu``
(and the mainloop they run on) in the same call.

    python -m triton_dist_tpu_torch.examples.rs_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round, in
the order A B .. B A, each building and importing its own tree.  It
times, at ``chip_smoke.py``'s shapes:

- row 15 over a four-rank virtual world at Llama-3-8B TP-4 widths (m_loc
  512, N 4096): wo (k 1024), down (k 3584), QKV^T (k 1536) and gate/up^T
  (k 3584) with the weight read transposed, and down at m_loc 250 (r250);
  beside each (" lib") one ``torch.einsum`` that sums each chunk's
  products over the ranks, and (" host") the host's time per eager call;
  the other kernels of ``csrc/gemm_rs.cu`` at down and wo: the bidir
  ring (15b), and the int8 modes, the uni kernel (15i) and the bidir ring
  (15bi), also at m_loc 16 ("m16"), each beside (" lib") one
  ``torch._int_mm`` of the rows against every rank's B stacked in K
  (column-major; at m16 none: cuBLASLt takes no m <= 16), and beside
  each int8 time its device time per call from ``torch.profiler`` ("
  dev": every kernel of 20 calls) and the host's time per eager call ("
  host"); the torus order (16) at ``chip_smoke.py`` phase 22's down and
  wo (TP-8 widths on a (2, 4) mesh: m_loc 256, k 1792 / 512, N 4096),
  each with its relative L2 error, device and host times, one
  ``torch.einsum`` beside (" lib") and the same kernel's index-order fold
  over the same joint group (" group": ``tdt_gemm_rs_group`` torus = 0, the
  yardstick of the torus fold's cost), and the int8 group kernel (16i)
  at down;
- rows 12r / 12b in both modes: the PP path's plane (2,049,056 x 128 f32
  a rank over tp of (2, 2, 2)), T 4 ([4 x 65,536, 128] f32 over (2, 4))
  and T 8 ([8 x 4,096, 128] bf16), beside each (" lib") one ``sum`` over
  the rank dimension of the stacked view.

Each shape is first checked against its plain version (" rel l2": the
GEMM-RS's relative L2 error; " equal": 1.0 when an int8 GEMM-RS's int32 C
or the reduce-scatter is bit-equal).  ``--rows`` picks the rows timed by
exact name (``ROWS``; all by default): a trial of a constant of one
kernel need not time the others.  Each time is the median of
``--repeats`` eager timings of 10 calls between CUDA events (a launch
carries its call's epoch: no CUDA graph).
Prints the card's name and power limit, one JSON line per (tree, round),
and a last JSON line with every tree's median over its rounds.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import sys

SHAPES = ("row 15: W 4, m_loc 512 (r250: 250), N 4096, k 1024 (wo) / 3584 "
          "(down) / 1536 (QKV^T) / 3584 (gate/up^T), 15b / 15i / 15bi at wo "
          "and down (15i / 15bi also at m_loc 16); rows 16 / 16i: (2, 4), "
          "m_loc 256, k 1792 (16 also 512), N 4096; row 12: plane "
          "[2 x 1,024,528, 128] f32 over tp of (2, 2, 2), T4 [4 x 65,536, "
          "128] f32 over (2, 4), T8 [8 x 4,096, 128] bf16 over (8,)")
# the rows --rows picks from
ROWS = ("15", "15b", "15i", "15bi", "16", "16i", "12")
# row 15: (tag, m_loc, k, trans_b)
GEMM_RS = (("wo", 512, 1024, False), ("down", 512, 3584, False),
           ("qkv_bwd", 512, 1536, True), ("gate_up_bwd", 512, 3584, True),
           ("r250", 250, 3584, False))
# row 12: (tag, mesh shape, names, rows per chunk, dtype)
RS = (("plane", (2, 2, 2), ("dcn", "pp", "tp"), 1024528, "float32"),
      ("t4", (2, 4), ("dcn", "tp"), 65536, "float32"),
      ("t8_bf16", (8,), ("tp",), 4096, "bfloat16"))


def time_tree(tree: str, repeats: int, rows=ROWS) -> dict:
    """Median ms of the GEMM-RS and reduce-scatter ``rows`` of ``tree``'s
    port (imported from there), with the library calls, device and host
    times beside."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ring_times

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("gemm_rs", "reduce_scatter"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def med(fn, timer=ring_times._event_ms):
        return statistics.median(timer(fn) for _ in range(repeats))

    def want(row):
        return row in rows

    def randi(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    out = {}
    W, N = 4, 4096
    for tag, m_loc, k, trans in GEMM_RS if want("15") else ():
        a = torch.randn((W, W * m_loc, k), generator=g, device=dev
                        ).to(torch.bfloat16)
        b = (torch.randn((W, N, k) if trans else (W, k, N), generator=g,
                         device=dev) / k ** 0.5).to(torch.bfloat16)
        err = (grs.gemm_rs_shard(a, b, trans_b=trans).float()
               - grs.gemm_rs_ref(a, b, trans_b=trans).float())
        out[f"15 {tag} rel l2"] = (err.norm() / grs.gemm_rs_ref(
            a, b, trans_b=trans).float().norm()).item()
        out[f"15 {tag}"] = med(lambda: grs.gemm_rs_shard(a, b,
                                                         trans_b=trans))
        out[f"15 {tag} host"] = med(
            lambda: grs.gemm_rs_shard(a, b, trans_b=trans),
            ring_times._host_ms)
        a4 = a.view(W, W, m_loc, k)
        eq = "qrmk,qnk->rmn" if trans else "qrmk,qkn->rmn"
        out[f"15 {tag} lib"] = med(lambda: torch.einsum(eq, a4, b))
        del a, b, a4
    for tag, k in (("wo", 1024), ("down", 3584)) if want("15b") else ():
        a = torch.randn((W, W * 512, k), generator=g, device=dev
                        ).to(torch.bfloat16)
        b = (torch.randn((W, k, N), generator=g, device=dev) / k ** 0.5
             ).to(torch.bfloat16)
        out[f"15b {tag}"] = med(lambda: grs.gemm_rs_shard(
            a, b, ring_mode="bidir"))
        del a, b
    for tag, m_loc, k in (("wo", 512, 1024), ("down", 512, 3584),
                          ("m16 wo", 16, 1024), ("m16 down", 16, 3584)):
        a8, b8 = randi(W, W * m_loc, k), randi(W, k, N)
        for row, mode in (("15i", "uni"), ("15bi", "bidir")):
            if not want(row):
                continue
            out[f"{row} {tag} equal"] = float(torch.equal(
                grs.gemm_rs_shard(a8, b8, ring_mode=mode),
                grs.gemm_rs_ref(a8, b8)))
            call = (lambda: grs.gemm_rs_shard(a8, b8, ring_mode=mode))
            out[f"{row} {tag}"] = med(call)
            out[f"{row} {tag} dev"] = ring_times._device_ms(call)
            out[f"{row} {tag} host"] = med(call, ring_times._host_ms)
        if m_loc > 16 and (want("15i") or want("15bi")):
            a2 = a8.view(W, W, m_loc, k).permute(1, 2, 0, 3).reshape(
                W * m_loc, W * k)
            b2 = b8.reshape(W * k, N).t().contiguous().t()
            out[f"15i {tag} lib"] = med(lambda: torch._int_mm(a2, b2))
            del a2, b2
        del a8, b8
    mesh = Mesh((2, 4), ("dcn", "tp"), dev)
    for tag, k in (("down", 1792), ("wo", 512)) if want("16") else ():
        axes = ("dcn", "tp")
        a = torch.randn((8, 8 * 256, k), generator=g, device=dev
                        ).to(torch.bfloat16)
        b = (torch.randn((8, k, N), generator=g, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        want_c = grs.torus_gemm_rs_ref(a, b, mesh, axes).float()
        err = grs.torus_gemm_rs(a, b, mesh, axes).float() - want_c
        out[f"16 {tag} rel l2"] = (err.norm() / want_c.norm()).item()
        del want_c, err
        call = (lambda: grs.torus_gemm_rs(a, b, mesh, axes))
        out[f"16 {tag}"] = med(call)
        out[f"16 {tag} dev"] = ring_times._device_ms(call)
        out[f"16 {tag} host"] = med(call, ring_times._host_ms)
        group = ((ctypes.c_int * 7)(*mesh.group_args(axes)),
                 (ctypes.c_int * 6)(), 0)
        index_order = (lambda: grs._uni(a, b, 256, N, False,
                                        "gemm_rs_group", 8, group=group))
        out[f"16 {tag} group"] = med(index_order)
        out[f"16 {tag} group dev"] = ring_times._device_ms(index_order)
        a4 = a.view(8, 8, 256, k)
        out[f"16 {tag} lib"] = med(lambda: torch.einsum("qrmk,qkn->rmn",
                                                        a4, b))
        del a, b, a4
    if want("16i"):
        a8, b8 = randi(8, 8 * 256, 1792), randi(8, 1792, N)
        axes = ("dcn", "tp")
        out["16i down equal"] = float(torch.equal(
            grs.torus_gemm_rs_i8(a8, b8, mesh, axes),
            grs.torus_gemm_rs_ref(a8, b8, mesh, axes)))
        call = (lambda: grs.torus_gemm_rs_i8(a8, b8, mesh, axes))
        out["16i down"] = med(call)
        out["16i down dev"] = ring_times._device_ms(call)
        out["16i down host"] = med(call, ring_times._host_ms)
        del a8, b8
    for tag, shape, names, rows, dt in RS if want("12") else ():
        mesh = Mesh(shape, names, dev)
        T = mesh.axis_size("tp")
        x = torch.randn((*shape, T * rows, 128), generator=g, device=dev
                        ).to(getattr(torch, dt))
        for meth, mode in ((rs.ReduceScatterMethod.RING_1D, "ring"),
                           (rs.ReduceScatterMethod.RING_BIDIR, "bidir")):
            out[f"12 {tag} {mode} equal"] = float(torch.equal(
                rs.reduce_scatter_shard(x, mesh, "tp", meth),
                rs.reduce_scatter_ref(x, mesh, "tp", meth)))
            torch.cuda.empty_cache()
            out[f"12 {tag} {mode}"] = med(
                lambda: rs.reduce_scatter_shard(x, mesh, "tp", meth))
            torch.cuda.empty_cache()
        a = mesh.dim("tp")
        stacked = x.view(*shape[:a + 1], T, rows, 128)
        out[f"12 {tag} lib"] = med(lambda: stacked.sum(dim=a))
        del x, stacked
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    # the sibling module, not the package: a timing process imports the
    # port from its tree only
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import flash_times

    return flash_times.main(argv, timer=time_tree, shapes=SHAPES,
                            script=__file__, doc=__doc__, rows=ROWS)


if __name__ == "__main__":
    sys.exit(main())
