"""The PyTorch port stands alone: no JAX, no reference package, no silent CPU.

- A fresh interpreter imports every module of ``triton_dist_tpu_torch``
  and finds neither ``jax`` nor ``triton_dist_tpu`` in ``sys.modules``.
- A source grep of the port and of ``chip_smoke.py`` finds no import of
  either.
- Entry points called without a ``device`` argument raise on a machine
  with no card; the kernel wrappers take their plain versions only for
  CPU tensors.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import triton_dist_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "triton_dist_tpu_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        triton_dist_tpu_torch.__path__, "triton_dist_tpu_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "triton_dist_tpu_torch.serve.engine" in mods
    assert {"triton_dist_tpu_torch.kernels.all_to_all",
            "triton_dist_tpu_torch.kernels.group_gemm",
            "triton_dist_tpu_torch.kernels.moe_utils",
            "triton_dist_tpu_torch.layers.ep_a2a",
            "triton_dist_tpu_torch.layers.moe_inference",
            "triton_dist_tpu_torch.models.moe",
            "triton_dist_tpu_torch.models.generate_moe",
            "triton_dist_tpu_torch.kernels.gemm",
            "triton_dist_tpu_torch.kernels.allgather_gemm",
            "triton_dist_tpu_torch.kernels.gemm_reduce_scatter",
            "triton_dist_tpu_torch.layers.tp_linear",
            "triton_dist_tpu_torch.runtime.bootstrap",
            "triton_dist_tpu_torch.runtime.symm_mem",
            "triton_dist_tpu_torch.serve.mesh",
            "triton_dist_tpu_torch.models.llama_w8a8",
            "triton_dist_tpu_torch.kernels.ring_attention",
            "triton_dist_tpu_torch.kernels.ulysses_attention",
            "triton_dist_tpu_torch.models.cp",
            "triton_dist_tpu_torch.kernels.common_ops",
            "triton_dist_tpu_torch.kernels.allgather",
            "triton_dist_tpu_torch.kernels.reduce_scatter",
            "triton_dist_tpu_torch.kernels.low_latency_allgather",
            "triton_dist_tpu_torch.kernels.hierarchical",
            "triton_dist_tpu_torch.layers.allgather_layer",
            "triton_dist_tpu_torch.parallel.pipeline",
            "triton_dist_tpu_torch.models.pp",
            "triton_dist_tpu_torch.autotuner",
            "triton_dist_tpu_torch.kernels.allgather_group_gemm",
            "triton_dist_tpu_torch.kernels.moe_reduce_rs",
            "triton_dist_tpu_torch.kernels.torus",
            "triton_dist_tpu_torch.runtime.host_ops"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'triton_dist_tpu' or "
            "m.startswith('triton_dist_tpu.'))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+triton_dist_tpu\b(?!_)"
    r"|from\s+triton_dist_tpu\b(?!_))|triton_dist_tpu\.(?!_)",
    re.MULTILINE)


def test_no_jax_or_reference_imports_in_the_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = []
    for f in files:
        for m in _FORBIDDEN.finditer(f.read_text()):
            hits.append(f"{f.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not hits, hits


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot show")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    _no_card()
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.runtime import utils

    cfg = llama.LlamaConfig(vocab=64, dim=256, n_layers=1, n_heads=2,
                            n_kv_heads=1, ffn_dim=64, max_seq=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Generator(cfg)
    cpu = llama.init_params(cfg, device="cpu")
    tree = {k: (v.numpy() if torch.is_tensor(v) else
                [{kk: vv.numpy() for kk, vv in layer.items()}
                 for layer in v]) for k, v in cpu.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.params_from_jax(tree, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.make_tensor(torch.Generator(), (2, 2))
    assert Generator(cfg, device="cpu").device.type == "cpu"


def test_examples_cli_refuses_without_a_card():
    _no_card()
    from triton_dist_tpu_torch.examples import serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--engine", "--requests", "1"])
    from triton_dist_tpu_torch.examples import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    outs = serve.run_engine(serve.parse_args(
        ["--engine", "--device", "cpu", "--requests", "2", "--new-tokens",
         "3", "--prompt-len", "12"]))
    assert sorted(outs) == ["req-0", "req-1"]
    assert all(len(o.token_ids) == 3 for o in outs.values())


def test_kernel_wrappers_use_plain_versions_only_for_cpu_tensors():
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 128)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 8, 128)).astype(
        np.float32))
    n0 = (fa.flash_attention.launches, fd.gqa_decode_shard.launches,
          fd.gqa_decode_paged_shard.launches)
    out = fa.flash_attention(q, k, k)
    assert torch.equal(out, fa.flash_attention_ref(q, k, k)[0])
    lens = torch.tensor([8], dtype=torch.int32)
    o1, _ = fd.gqa_decode_shard(q[:, :, 0], k, k, lens)
    assert torch.equal(o1, fd.decode_ref(q[:, :, 0], k, k, lens)[0])
    table = torch.zeros((1, 1), dtype=torch.int32)
    o2, _ = fd.gqa_decode_paged_shard(q[:, :, 0], k, k, table, lens)
    assert torch.equal(o1, o2)
    # a plain-version call is not a kernel launch
    assert (fa.flash_attention.launches, fd.gqa_decode_shard.launches,
            fd.gqa_decode_paged_shard.launches) == n0
    # the backward: plain on CPU tensors, no kernel launch counted
    nb = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_attention_ref(q, k, k)
    got = fa.flash_attention_bwd(q, k, k, out, lse, q)
    want = fa.flash_attention_bwd_ref(q, k, k, out, lse, q)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == nb
    meta = torch.empty((1, 4, 8, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(meta, meta, meta, meta, meta[..., 0], meta)


def test_int8_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The int8 kernels' wrappers (decode_i8, decode_paged_i8, flash_fwd_i8,
    matmul_i8) take their plain versions for CPU tensors without counting
    a launch, and refuse other devices."""
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.kernels import quant

    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((1, 4, 8, 128)).astype(
        np.float32))
    kq, ks = fd.quantize_kv(torch.from_numpy(
        rng.standard_normal((1, 2, 8, 128)).astype(np.float32)))
    lens = torch.tensor([8], dtype=torch.int32)
    counters = (fd.decode_i8, fd.decode_paged_i8, fa.flash_fwd_i8,
                quant.matmul_i8)
    n0 = [fn.launches for fn in counters]
    o1, _ = fd.gqa_decode_shard(q[:, :, 0], kq, kq, lens, k_scale=ks,
                                v_scale=ks)
    assert torch.equal(o1, fd.decode_ref(q[:, :, 0], kq, kq, lens,
                                         k_scale=ks, v_scale=ks)[0])
    table = torch.zeros((1, 1), dtype=torch.int32)
    o2, _ = fd.gqa_decode_paged_shard(q[:, :, 0], kq, kq, table, lens,
                                      k_scale=ks, v_scale=ks)
    assert torch.equal(o1, o2)
    out = fa.flash_attention(q, kq, kq, k_scale=ks, v_scale=ks)
    assert torch.equal(out, fa.flash_attention_ref(q, kq, kq, k_scale=ks,
                                                   v_scale=ks)[0])
    a = kq[0, 0]
    assert torch.equal(quant.matmul_i8(a, a.t().contiguous()),
                       a.long().matmul(a.long().t()).int())
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((8, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        quant.matmul_i8(meta, meta.t())


def test_moe_entry_points_default_to_cuda_and_raise_without_a_card():
    """moe.init_params / params_from_jax, MoEGenerator and
    DistributedMoELayer run on the card unless asked for the CPU."""
    _no_card()
    from triton_dist_tpu_torch.layers.moe_inference import (
        DistributedMoELayer)
    from triton_dist_tpu_torch.models import moe
    from triton_dist_tpu_torch.models.generate_moe import MoEGenerator

    cfg = moe.MoEConfig(vocab=64, dim=256, n_layers=1, n_heads=2,
                        n_kv_heads=1, n_experts=4, expert_ffn_dim=64,
                        max_seq=64, block_m=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoEGenerator(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedMoELayer(n_experts=4, topk=2, hidden=128,
                            intermediate=128)
    cpu = moe.init_params(cfg, device="cpu")
    tree = {k: (v.numpy() if torch.is_tensor(v) else
                [{kk: vv.numpy() for kk, vv in layer.items()}
                 for layer in v]) for k, v in cpu.items()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moe.params_from_jax(tree, cfg)
    assert MoEGenerator(cfg, device="cpu").device.type == "cpu"
    layer = DistributedMoELayer(n_experts=4, topk=2, hidden=128,
                                intermediate=128, device="cpu")
    assert layer.init_weights(0)["w_gate"].device.type == "cpu"


def test_group_gemm_wrappers_use_plain_versions_only_for_cpu_tensors():
    """group_gemm, group_gemm_dx and group_gemm_i8 take the plain version
    for CPU tensors without counting a launch, and refuse other
    devices."""
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, 24)).astype(np.float32))
    te = torch.tensor([2, 0], dtype=torch.int32)
    counters = (gg.group_gemm, gg.group_gemm_dx, gg.group_gemm_i8)
    n0 = [fn.launches for fn in counters]
    y = gg.group_gemm(x, w, te, block_m=8)
    assert torch.equal(y, gg.group_gemm_ref(x, w, te, block_m=8))
    assert torch.allclose(y[:8], x[:8] @ w[2]) and torch.allclose(
        y[8:], x[8:] @ w[0])
    dx = gg.group_gemm_dx(y, w, te, block_m=8)
    assert torch.allclose(dx[:8], y[:8] @ w[2].t(), atol=1e-5)
    q = torch.from_numpy(rng.integers(-127, 128, (16, 32)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 32, 24)).astype(
        np.int8))
    assert torch.equal(gg.group_gemm_i8(q, wq, te, block_m=8)[8:],
                       (q[8:].long() @ wq[0].long()).int())
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((128, 128), dtype=torch.bfloat16, device="meta")
    wm = torch.empty((2, 128, 128), dtype=torch.bfloat16, device="meta")
    tm = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gg.group_gemm(meta, wm, tm, block_m=128)
    with pytest.raises(ValueError, match="does not tile"):
        gg.group_gemm(x, w, te, block_m=16)


def test_all_to_all_wrapper_uses_plain_version_only_for_cpu_tensors():
    """fast_all_to_all_shard (and its autograd twin) shuffles CPU tensors
    through its plain version without counting a launch, at world 1 and
    over more ranks than the kernel takes, and refuses other devices."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    send = torch.arange(24, dtype=torch.float32).reshape(1, 1, 4, 6)
    splits = torch.tensor([[3]], dtype=torch.int32)
    n0 = a2a.fast_all_to_all_shard.launches
    recv, recv_splits = a2a.fast_all_to_all_shard(send, splits)
    assert torch.equal(recv, send) and torch.equal(recv_splits, splits)
    recv, _ = a2a.fast_all_to_all_shard_diff(send.requires_grad_(), splits)
    (d_send,) = torch.autograd.grad(recv.sum(), (send,))
    assert torch.equal(d_send[0, 0, :3], torch.ones((3, 6)))
    assert torch.all(d_send[0, 0, 3:] == 0)
    nine = torch.arange(9 * 9 * 2, dtype=torch.float32).reshape(9, 9, 2, 1)
    recv, _ = a2a.fast_all_to_all_shard(nine, torch.ones((9, 9),
                                                         dtype=torch.int32))
    assert torch.equal(recv, nine.transpose(0, 1))
    assert a2a.fast_all_to_all_shard.launches == n0
    meta = torch.empty((1, 1, 4, 6), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        a2a.fast_all_to_all_shard(meta, torch.zeros(
            (1, 1), dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError, match="int32"):
        a2a.fast_all_to_all_shard(send, splits.long())
    with pytest.raises(ValueError, match="W, W, max_tokens"):
        a2a.fast_all_to_all_shard(send[0], splits[0])


def test_tp_wrappers_use_plain_versions_only_for_cpu_tensors():
    """matmul, ag_gemm and gemm_rs take their plain versions for CPU
    tensors without counting a launch (and without a world or workspace),
    and refuse other devices; the virtual world defaults to the card and
    the process-group backend is not ported."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.runtime import bootstrap

    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 16, 24)).astype(np.float32))
    counters = (gemm.matmul, agm.ag_gemm_shard, grs.gemm_rs_shard)
    n0 = [fn.launches for fn in counters]
    bootstrap.finalize_distributed()
    assert torch.allclose(gemm.matmul(a[0], b[0]), a[0] @ b[0])
    a_full, c = agm.ag_gemm_shard(a, b)
    assert torch.equal(a_full[1], a.reshape(16, 16))
    assert torch.allclose(c[1], a.reshape(16, 16) @ b[1])
    out = grs.gemm_rs_shard(a, b)
    assert torch.allclose(out[1], a[0, 4:] @ b[0] + a[1, 4:] @ b[1],
                          atol=1e-5)
    assert [fn.launches for fn in counters] == n0
    assert not bootstrap._WORLDS
    meta = torch.empty((2, 128, 128), dtype=torch.bfloat16, device="meta")
    for fn in (agm.ag_gemm_shard, grs.gemm_rs_shard):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gemm.matmul(meta[0], meta[0])
    with pytest.raises(NotImplementedError, match="item 11"):
        bootstrap.initialize_distributed(4, device="cpu", backend="nccl")
    world = bootstrap.initialize_distributed(4, device="cpu")
    assert bootstrap.num_ranks(world) == 4
    assert list(bootstrap.rank(world)) == [0, 1, 2, 3]
    flags = world.workspace.flags("probe", 3)
    assert flags.shape == (4, 3) and flags.dtype == torch.int32
    assert world.workspace.flags("probe", 3) is flags
    assert [world.workspace.next_epoch() for _ in range(2)] == [1, 2]
    bootstrap.finalize_distributed()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bootstrap.initialize_distributed(4)


def test_sp_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The SP combine merges CPU tensors through its plain version without
    counting a launch (over more ranks than the kernel takes too) and
    refuses other devices; the SP entry points default to the card."""
    from triton_dist_tpu_torch.kernels import flash_decode as fd
    from triton_dist_tpu_torch.runtime import bootstrap

    rng = np.random.default_rng(5)
    out = torch.from_numpy(rng.standard_normal((3, 2, 4, 8)).astype(
        np.float32))
    lse = torch.from_numpy(rng.standard_normal((3, 2, 4)).astype(
        np.float32))
    n0 = fd.sp_combine_shard.launches
    got = fd.sp_combine_shard(out, lse, all_ranks=True)
    want = fd.combine_partials(out, lse)
    assert all(torch.equal(got[r], want) for r in range(3))
    assert torch.equal(fd.sp_combine_shard(out, lse), want)
    assert fd.sp_combine_shard.launches == n0
    meta = torch.empty((2, 2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fd.sp_combine_shard(meta, torch.empty((2, 2, 4), device="meta"))
    with pytest.raises(ValueError, match="W, ..., D"):
        fd.sp_combine_shard(out, lse[:, :1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fd.create_sp_decode_context(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bootstrap.get_world(4, None)


def test_w8a8_tp_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The AG-GEMM's int8 mode and the W8A8 tensor-parallel linears run
    their plain versions on CPU tensors without counting a launch (of the
    int8 AG-GEMM or the int8 GEMM), and refuse other devices; ``ag_gemm``
    hands int8 operands to the int8 mode."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import quant
    from triton_dist_tpu_torch.layers import tp_linear as tl

    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.integers(-127, 128, (2, 3, 32), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (2, 32, 16), dtype=np.int8))
    counters = (agm.ag_gemm_shard, agm.ag_gemm_i8, quant.matmul_i8)
    n0 = [fn.launches for fn in counters]
    a_full, c = agm.ag_gemm_shard(a, b)
    assert c.dtype == torch.int32
    assert torch.equal(c[1], quant.matmul_i8_ref(a.reshape(6, 32), b[1]))
    assert torch.equal(agm.ag_gemm_i8(a, b)[1], c)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32)).astype(np.float32))
    scale = torch.ones((2, 16))
    assert tl.column_parallel_linear_w8a8(x, b, scale).shape == (2, 6, 16)
    assert tl.row_parallel_linear_w8a8(
        x.reshape(2, 3, 32).repeat(1, 2, 1), b, scale).shape == (2, 3, 16)
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((2, 64, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        agm.ag_gemm_i8(meta, meta)


def test_cp_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The fused ring kernel's wrapper and the flash ring run their plain
    versions on CPU tensors without counting a launch (of ring_attn, the
    flash kernels or the all-to-all) and refuse other devices; an unknown
    ring algorithm is refused; the CP contexts default to the card."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import ring_attention as ra
    from triton_dist_tpu_torch.kernels import ulysses_attention as ua

    rng = np.random.default_rng(7)
    q, k = (torch.from_numpy(rng.standard_normal((2, 128, 1, h, 128))
                             .astype(np.float32)) for h in (4, 2))
    counters = (ra.ring_attn, fa.flash_attention, fa.flash_bwd_dq,
                a2a.fast_all_to_all_shard)
    n0 = [fn.launches for fn in counters]
    dense = ra.ring_attention_shard(q, k, k, plain=True)
    assert torch.equal(ra.ring_attn(q, k, k), dense)
    flash = ra.ring_attention_shard(q, k, k, impl="flash")
    assert (flash - dense).abs().max() < 1e-5
    ua.ulysses_attention_shard(q, k, k)
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((2, 128, 1, 4, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ra.ring_attn(meta, meta, meta)
    with pytest.raises(ValueError, match="impl"):
        ra.ring_attention_shard(q, k, k, impl="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ra.create_ring_attention_context(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ua.create_ulysses_context(4)


def test_collective_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The barrier, all-gather, reduce-scatter and the hierarchical
    all-reduce run their plain versions on CPU tensors without counting a
    launch and refuse other devices; a mesh, the PP tree and the PP step's
    parameters default to the card."""
    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import common_ops as co
    from triton_dist_tpu_torch.kernels import hierarchical as hi
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs
    from triton_dist_tpu_torch.models import llama, pp
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    mesh = Mesh((2, 2), ("dcn", "tp"), "cpu")
    x = torch.arange(2 * 2 * 4 * 128, dtype=torch.float32).reshape(
        2, 2, 4, 128)
    counters = (co.barrier_shard, ag.all_gather_shard,
                rs.reduce_scatter_shard)
    n0 = [fn.launches for fn in counters]
    co.barrier_shard(torch.zeros((2, 2), dtype=torch.int32), mesh, "tp")
    for m in (ag.AllGatherMethod.RING_1D, ag.AllGatherMethod.RING_BIDIR,
              ag.AllGatherMethod.FULL_MESH_PUSH):
        assert ag.all_gather_shard(x, mesh, "tp", m).shape == (2, 2, 8, 128)
    for m in (rs.ReduceScatterMethod.RING_1D,
              rs.ReduceScatterMethod.RING_BIDIR):
        assert rs.reduce_scatter_shard(x, mesh, "tp", m).shape == \
            (2, 2, 2, 128)
    total = hi.hier_all_reduce_shard(x, mesh, slow_axis="dcn",
                                     fast_axis="tp")
    assert torch.equal(total[1, 0], x.sum(dim=(0, 1)))
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((2, 2, 4, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ag.all_gather_shard(meta, mesh, "tp")
    with pytest.raises(ValueError, match="unsupported device"):
        rs.reduce_scatter_shard(meta, mesh, "tp")
    with pytest.raises(ValueError, match="unsupported device"):
        co.barrier_shard(torch.zeros((2, 2), dtype=torch.int32,
                                     device="meta"), mesh, "tp")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Mesh((2, 2), ("dcn", "tp"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pp.init_pp_params(llama.LlamaConfig.tiny())


def test_moe_tp_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The MoE overlap kernels' wrappers (the AG-GroupGEMM and the
    GroupGEMM-RS) run their plain versions on CPU tensors without counting
    a launch and refuse other devices; their host entries' meshes default
    to the card; the host planner builds the port's own C source into the
    repository's build directory."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.runtime import host_ops
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    rng = np.random.default_rng(8)
    W, t_loc, E, bm = 2, 4, 3, 8
    x = torch.from_numpy(rng.standard_normal((W, t_loc, 16)).astype(
        np.float32))
    experts = torch.from_numpy(rng.integers(0, E, (W, t_loc, 2)).astype(
        np.int32))
    weights = torch.full((W, t_loc, 2), 0.5)
    w = torch.from_numpy(rng.standard_normal((W, E, 16, 24)).astype(
        np.float32))
    counters = (agg.ag_group_gemm_shard, mrs.moe_reduce_rs_shard)
    n0 = [fn.launches for fn in counters]
    out = agg.ag_group_gemm_shard(x, weights, experts, w, n_experts=E,
                                  topk=2, block_m=bm)
    assert out.shape == (W, W * t_loc, 24)
    t = 5      # token 1 of rank 1 against rank 0's F shard
    want = sum(0.5 * x[1, 1] @ w[0, e] for e in experts[1, 1].tolist())
    assert torch.allclose(out[0, t], want, atol=1e-5)
    dest, te, m_pad = agg._segment_plans(experts, E, bm)
    h = torch.from_numpy(rng.standard_normal((W, W * m_pad, 24)).astype(
        np.float32))
    w2 = torch.from_numpy(rng.standard_normal((W, E, 24, 16)).astype(
        np.float32))
    ys = mrs.moe_rs_sorted(h, w2, te, block_m=bm)
    assert ys.shape == (W, m_pad, 16)
    assert mrs.moe_reduce_rs_shard(h, w2, weights, experts, n_experts=E,
                                   topk=2, block_m=bm).shape == (W, t_loc,
                                                                 16)
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((W, m_pad, 128), dtype=torch.bfloat16, device="meta")
    wm = torch.empty((W, E, 128, 128), dtype=torch.bfloat16, device="meta")
    tm = torch.zeros((W, m_pad // bm), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        agg.ag_group_gemm_sorted(meta, wm, tm, block_m=bm)
    with pytest.raises(ValueError, match="unsupported device"):
        mrs.moe_rs_sorted(meta.repeat(1, W, 1), wm, tm, block_m=bm)
    assert host_ops.SRC.is_relative_to(PORT)
    assert host_ops.BUILD_DIR == ROOT / "build" / "host_ops"
    if not torch.cuda.is_available():
        for make in (agg.create_ag_group_gemm_context,
                     mrs.create_moe_rs_context):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(Mesh((W,), ("tp",)), n_experts=E, topk=2)


def test_torus_wrappers_use_plain_versions_only_for_cpu_tensors():
    """The torus kernels' wrappers (all-gather, reduce-scatter, AG-GEMM and
    GEMM-RS and their int8 modes, over the joint group of a (2, 2, 2)
    mesh) run their plain versions on CPU tensors without counting a
    launch, and refuse other devices."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import torus
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    mesh, axes = Mesh((2, 2, 2), ("x", "y", "z"), "cpu"), ("x", "y", "z")
    counters = (torus.torus_all_gather_shard,
                torus.torus_reduce_scatter_shard, agm.torus_ag_gemm,
                agm.torus_ag_gemm_i8, grs.torus_gemm_rs,
                grs.torus_gemm_rs_i8)
    n0 = [fn.launches for fn in counters]
    x = torch.randn(2, 2, 2, 3, 128)
    assert torus.torus_all_gather_shard(x, mesh, axes).shape == \
        (2, 2, 2, 24, 128)
    assert torus.torus_reduce_scatter_shard(
        torch.randn(2, 2, 2, 16, 128), mesh, axes).shape == (2, 2, 2, 2, 128)
    a, b = torch.randn(8, 8, 128), torch.randn(8, 128, 128)
    assert agm.torus_ag_gemm(a, b, mesh, axes)[1].shape == (8, 64, 128)
    ai = torch.randint(-4, 4, (8, 8, 128), dtype=torch.int8)
    bi = torch.randint(-4, 4, (8, 128, 128), dtype=torch.int8)
    assert agm.torus_ag_gemm_i8(ai, bi, mesh, axes)[1].dtype == torch.int32
    a2 = torch.randn(8, 64, 128)
    assert grs.torus_gemm_rs(a2, b, mesh, axes).shape == (8, 8, 128)
    assert grs.torus_gemm_rs_i8(ai.repeat(1, 8, 1), bi, mesh,
                                axes).dtype == torch.int32
    assert [fn.launches for fn in counters] == n0
    meta = torch.empty((2, 2, 2, 8, 128), device="meta")
    for fn in (torus.torus_all_gather_shard,
               torus.torus_reduce_scatter_shard):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, mesh, axes)
    mb = torch.empty((8, 64, 128), dtype=torch.bfloat16, device="meta")
    wb = torch.empty((8, 128, 128), dtype=torch.bfloat16, device="meta")
    for fn in (agm.torus_ag_gemm, grs.torus_gemm_rs):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(mb, wb, mesh, axes)
