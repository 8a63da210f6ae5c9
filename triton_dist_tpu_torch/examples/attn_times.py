"""Time the attention forwards, the decode kernel and the SP combine of
several checkouts of this repository on one card, interleaved, to compare
two versions of ``csrc/flash_fwd.cu``, ``csrc/ring_attn.cu`` (and the tile
body they share), ``csrc/decode.cu`` and ``csrc/sp_combine.cu`` in the
same call.

    python -m triton_dist_tpu_torch.examples.attn_times TREE_A TREE_B

The runner is ``flash_times``'s: one fresh process per tree and round, in
the order A B .. B A, each building and importing its own tree.  At
``chip_smoke.py``'s shapes it times PERF.md rows 1, 1z, 21, 2, 3, 4, 4p
and 17:

- ``flash_fwd``: the engine's 512-row chunk at q_offset 1536 over 2048
  keys, B 1, Hq 32 / Hkv 8, D 128, bf16 (CUDA-graph replays);
- ``flash_fwd_seg``: one zigzag ring step of Llama-3-8B CP 4 folded into
  the batch (q [4, 32, 2048, 128], rank r's two chunks against rank
  r - 1's; CUDA-graph replays);
- ``ring_attn`` / ``ring_attn_zigzag``: the fused ring at W 4, S_loc
  2048, B 1, causal (eager, 10 calls between CUDA events: a launch
  carries its call's epoch);
- ``decode`` / ``decode_paged`` / ``decode_i8`` / ``decode_paged_i8``:
  one decode token of B 8 sequences of lens 777..2048 over a cache of S
  2048 (page 16 pools, shuffled tables), Hq 32 / Hkv 8, D 128, bf16 and
  int8 K / V (CUDA-graph replays, L2 warm);
- ``decode_i8_cold`` / ``decode_paged_i8_cold``: the int8 rows with L2
  cold, a 128 MiB write before every call (CUDA-graph replays of write
  and decode, less the replays of the write alone);
- ``sp_combine`` / ``sp_combine_chunk``: the SP-4 combine of out [4, 8,
  32, 128] and [4, 512, 32, 128] f32 (the profiler's device time over 20
  eager calls: the decode shape's eager calls wait on the host).

Each time is the median over ``--repeats`` timings.
"""

from __future__ import annotations

import os
import statistics
import sys

SHAPES = ("flash_fwd: [1, 32, 512, 128] at q_offset 1536 over [1, 8, 2048, "
          "128]; flash_fwd_seg: [4, 32, 2048, 128], zigzag CP-4 step 1; "
          "ring_attn: W 4, S_loc 2048, Hq 32 / Hkv 8, contiguous and "
          "zigzag; decode: q [8, 32, 128] over [8, 8, 2048, 128], lens "
          "777..2048, page 16, bf16 and int8 (cold: 128 MiB written before "
          "each call); sp_combine: [4, 8, 32, 128] and [4, 512, 32, 128] "
          "f32")


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


def _device_ms(fn, key, iters=20):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from triton_dist_tpu_torch.examples.serve import _device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(_device_us(e) for e in prof.key_averages() if key in e.key)
    if us <= 0:
        raise RuntimeError(f"the profiler saw no kernel named {key}")
    return us / 1e3 / iters


def _cold_ms(fn, flush, iters=20, reps=5):
    """Device ms of one ``fn()`` with the L2 cold: CUDA-graph replays of
    ``iters`` x (``flush()``, ``fn()``) less those of ``iters`` x
    ``flush()``."""
    from flash_times import _graph_ms

    def both():
        flush()
        fn()

    return (_graph_ms(both, iters, reps)
            - _graph_ms(flush, iters, reps))


def _decode_calls(torch, fd, randn, dev, Hq, Hkv, D):
    """chip_smoke.py's decode rows: (name -> call) at its shapes."""
    B, S, page = 8, 2048, 16
    g = torch.Generator(device=dev).manual_seed(99)
    k, v = randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    lens = torch.tensor([2048, 1999, 1500, 1024, 1800, 777, 2047, 1300],
                        dtype=torch.int32, device=dev)
    q = randn(B, Hq, D)
    need = [-(-int(n) // page) for n in lens.tolist()]
    n_blocks = 1 + sum(need) + 64
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    table = torch.zeros((B, S // page), dtype=torch.int32, device=dev)
    at = 0
    for b in range(B):
        table[b, :need[b]] = perm[at:at + need[b]].to(torch.int32)
        at += need[b]
    kp, vp = randn(n_blocks, Hkv, page, D), randn(n_blocks, Hkv, page, D)
    (kq, ks), (vq, vs) = (fd.quantize_kv(x.float()) for x in (k, v))
    (kpq, kps), (vpq, vps) = (fd.quantize_kv(x.float()) for x in (kp, vp))
    return {
        "decode": lambda: fd.gqa_decode_shard(q, k, v, lens),
        "decode_paged": lambda: fd.gqa_decode_paged_shard(q, kp, vp, table,
                                                          lens),
        "decode_i8": lambda: fd.gqa_decode_shard(q, kq, vq, lens,
                                                 k_scale=ks, v_scale=vs),
        "decode_paged_i8": lambda: fd.gqa_decode_paged_shard(
            q, kpq, vpq, table, lens, k_scale=kps, v_scale=vps),
    }


def time_tree(tree: str, repeats: int) -> dict:
    """Median ms of each call of ``tree``'s port (imported from there)."""
    sys.path.insert(0, tree)
    import torch

    import triton_dist_tpu_torch
    from flash_times import _graph_ms
    from triton_dist_tpu_torch.kernels import _build
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    here = os.path.realpath(triton_dist_tpu_torch.__file__)
    if not here.startswith(os.path.realpath(tree) + os.sep):
        raise RuntimeError(f"imported the port from {here}, not {tree}")
    _build.build(("flash_fwd", "ring_attn", "sp_combine", "decode"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    W, S, Hq, Hkv, D = 4, 2048, 32, 8, 128
    q, k, v = randn(1, Hq, 512, D), randn(1, Hkv, S, D), randn(1, Hkv, S, D)
    zq, zk, zv = randn(W, Hq, S, D), randn(W, Hkv, S, D), randn(W, Hkv, S, D)
    zkw = dict(causal=True, q_offset=ra._fold_starts(W, 1, S, True, 0),
               kv_offset=ra._fold_starts(W, 1, S, True, 1))
    rq, rk, rv = randn(W, S, 1, Hq, D), randn(W, S, 1, Hkv, D), randn(
        W, S, 1, Hkv, D)
    parts = {}
    for name, B in (("sp_combine", 8), ("sp_combine_chunk", 512)):
        lse = 3 * randn(W, B, Hq, dtype=torch.float32)
        parts[name] = (randn(W, B, Hq, D, dtype=torch.float32), lse)
    graphed = {
        "flash_fwd": lambda: fa.flash_attention(q, k, v, q_offset=1536),
        "flash_fwd_seg": lambda: fa.flash_attention(zq, zk, zv, **zkw),
        **_decode_calls(torch, fd, randn, dev, Hq, Hkv, D),
    }
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    eager = {
        "ring_attn": lambda: ra.ring_attn(rq, rk, rv, zigzag=False),
        "ring_attn_zigzag": lambda: ra.ring_attn(rq, rk, rv, zigzag=True),
    }
    out = {n: statistics.median(_graph_ms(fn) for _ in range(repeats))
           for n, fn in graphed.items()}
    for name in ("decode_i8", "decode_paged_i8"):
        out[name + "_cold"] = statistics.median(
            _cold_ms(graphed[name], scrub.zero_) for _ in range(repeats))
    out.update({n: statistics.median(_event_ms(fn) for _ in range(repeats))
                for n, fn in eager.items()})
    for name, (o, lse) in parts.items():
        out[name] = statistics.median(
            _device_ms(lambda: fd.sp_combine_shard(o, lse), "sp_combine")
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
