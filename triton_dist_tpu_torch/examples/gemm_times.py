"""Time the dense GEMM, the int8 GEMM and the grouped GEMM (PERF.md rows 7,
8 and 9) of several checkouts of this repository on one card,
interleaved, to compare two versions of ``csrc/gemm.cu`` /
``csrc/matmul_i8.cu`` / ``csrc/group_gemm.cu`` (and the mainloop they run
on) in the same call.

    python -m triton_dist_tpu_torch.examples.gemm_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round, in
the order A B .. B A, each building and importing its own tree.  It times
(``--rows`` picks rows by exact name, all by default):

- row 7 (bf16 operands, bf16 C) at (M, K, N) = (2048, 4096, 14336)
  ("7": ``chip_smoke.py``'s shape), at m 16 ("7 m16") and at a ragged
  shape that takes the tile loop ("7 ragged": K and N not multiples of
  8), each with one ``torch.matmul`` beside (" lib");

- row 9 at ``chip_smoke.py``'s shapes (Mixtral-8x7B, E 8, K 4096, N
  14336, block_m 128, each row tile's expert from ``sort_align`` of seeded
  top-2 routing): the forward at 2,048 tokens (M_pad 5,120) and at 8
  (M_pad 1,152), dx at 2,048, the down projection (w [E, 14336, 4096])
  and its dx, and the int8 mode at 2,048 (and at block_m 512);
- row 8 over m 8, 16, 32, 64, 128, 256, 512 and 2,048 at Llama-3-8B's
  gate/up (k 4096, n 14336) and down (k 14336, n 4096) widths, and the
  W8A8 TP-4 row side (m 2,048, k 1,024 / 3,584, n 4,096): the kernel the
  wrapper picks and, in a tree whose wrapper has ``matmul_i8_kernel_for``,
  each of its two kernels forced (that rule replaced for the call), which
  measures the crossover.

Each time is the median of ``--repeats`` CUDA-graph timings (20 calls
captured in one graph, replayed 5 times between CUDA events), and beside
it (" host") the host's time per eager call: checks, tensor-map encodes
and the launch.  Prints the card's name and power limit, one JSON line
per (tree, round), and a last JSON line with every tree's median over its
rounds.
"""

from __future__ import annotations

import os
import statistics
import sys

SHAPES = ("row 7: (2048, 4096, 14336), m16 (16, 4096, 14336), ragged "
          "(2048, 4090, 14330); row 9: E 8, K 4096, N 14336, block_m 128, "
          "top-2 plans of 2,048 tokens (M_pad 5,120) and 8 (M_pad 1,152): "
          "fwd, T8, dx, down, down dx, int8 (block_m 128 and 512); row 8: "
          "m 8 .. 2,048 at (k 4096, "
          "n 14336) and (k 14336, n 4096), TP-4 row side m 2,048 at k "
          "1,024 / 3,584, n 4,096")
ROWS = ("7", "8", "9")
# row 7: (tag, M, K, N)
ROW7 = (("7", 2048, 4096, 14336), ("7 m16", 16, 4096, 14336),
        ("7 ragged", 2048, 4090, 14330))
M_SWEEP = (8, 16, 32, 64, 128, 256, 512, 2048)
I8_WIDTHS = {"gate_up": (4096, 14336), "down": (14336, 4096)}
TP_ROW_SIDE = {"tp_wo": (2048, 1024, 4096), "tp_down": (2048, 3584, 4096)}


def time_tree(tree: str, repeats: int, rows=ROWS) -> dict:
    """Median ms (and host ms) of ``rows`` (of 7, 8 and 9) of ``tree``'s
    port (imported from there)."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import gemm
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.kernels import quant

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import flash_times
    import ring_times

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("gemm", "group_gemm", "matmul_i8"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    out = {}

    def timed(tag, fn):
        out[tag] = statistics.median(flash_times._graph_ms(fn)
                                     for _ in range(repeats))
        out[tag + " host"] = statistics.median(ring_times._host_ms(fn)
                                               for _ in range(repeats))

    for tag, m, k, n in ROW7 if "7" in rows else ():
        a = torch.randn((m, k), generator=g, device=dev).bfloat16()
        b = (torch.randn((k, n), generator=g, device=dev) / k ** 0.5
             ).bfloat16()
        timed(tag, lambda: gemm.matmul(a, b))
        timed(tag + " lib", lambda: torch.matmul(a, b))
        del a, b
    if "9" in rows:
        _row9(torch, gg, mu, dev, g, timed)
    if "8" in rows:
        _row8(torch, quant, dev, g, timed)
    return out


def _row9(torch, gg, mu, dev, g, timed):
    """Row 9's entries (the module docstring)."""
    E, K, N, bm = 8, 4096, 14336, 128
    w = (torch.randn((E, K, N), generator=g, device=dev) / K ** 0.5
         ).bfloat16()
    w_down = (torch.randn((E, N, K), generator=g, device=dev) / N ** 0.5
              ).bfloat16()
    for T in (2048, 8):
        _, experts = mu.topk_routing(torch.randn((T, E), generator=g,
                                                 device=dev), 2)
        plan = mu.sort_align(experts, E, bm)
        x = torch.randn((T, K), generator=g, device=dev).bfloat16()
        xs = mu.gather_sorted(x, plan["dest"], plan["m_pad"])
        te, valid = plan["tile_expert"], plan["valid_rows"]
        M = xs.shape[0]
        timed(f"gg fwd T{T}", lambda: gg.group_gemm(xs, w, te, block_m=bm))
        if T != 2048:
            continue
        dy = (torch.randn((M, N), generator=g, device=dev)
              * valid[:, None]).bfloat16()
        timed("gg dx T2048", lambda: gg.group_gemm_dx(dy, w, te,
                                                      block_m=bm))
        timed("gg down T2048", lambda: gg.group_gemm(dy, w_down, te,
                                                     block_m=bm))
        dy2 = (torch.randn((M, K), generator=g, device=dev)
               * valid[:, None]).bfloat16()
        timed("gg down dx T2048", lambda: gg.group_gemm_dx(
            dy2, w_down, te, block_m=bm))
        del dy, dy2
        xq = torch.randint(-127, 128, (M, K), generator=g, device=dev,
                           dtype=torch.int8) * valid[:, None].to(torch.int8)
        wq = torch.randint(-127, 128, (E, K, N), generator=g, device=dev,
                           dtype=torch.int8)
        timed("gg i8 T2048", lambda: gg.group_gemm_i8(xq, wq, te,
                                                      block_m=bm))
        # block_m 512, the W8A8 MoE layer's load-aware tile at T 2,048
        plan = mu.sort_align(experts, E, 512)
        te5 = plan["tile_expert"]
        xq = torch.randint(-127, 128, (plan["m_pad"], K), generator=g,
                           device=dev, dtype=torch.int8) \
            * plan["valid_rows"][:, None].to(torch.int8)
        timed("gg i8 T2048 bm512", lambda: gg.group_gemm_i8(
            xq, wq, te5, block_m=512))
        del xq, wq
    del w, w_down
    torch.cuda.empty_cache()


def _row8(torch, quant, dev, g, timed):
    """Row 8's entries (the module docstring)."""
    rule = getattr(quant, "matmul_i8_kernel_for", None)
    shapes = [(f"i8 m{m} {tag}", m, k, n) for tag, (k, n) in
              I8_WIDTHS.items() for m in M_SWEEP]
    shapes += [(f"i8 {tag}", m, k, n) for tag, (m, k, n) in
               TP_ROW_SIDE.items()]
    for tag, m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        timed(tag, lambda: quant.matmul_i8(a, b))
        if rule is None:
            continue
        for kind in ("wg", "split_k"):
            quant.matmul_i8_kernel_for = lambda m, n, k, kind=kind: kind
            try:
                timed(f"{tag} {kind}", lambda: quant.matmul_i8(a, b))
            finally:
                quant.matmul_i8_kernel_for = rule


def main(argv=None) -> int:
    # the sibling module, not the package: a timing process imports the
    # port from its tree only
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import flash_times

    return flash_times.main(argv, timer=time_tree, shapes=SHAPES,
                            script=__file__, doc=__doc__, rows=ROWS)


if __name__ == "__main__":
    sys.exit(main())
