"""The port's training path against the JAX reference, on the CPU.

- ``models/llama.make_train_step`` (plain SGD, in place) against the
  reference's ``make_train_step(cfg, mesh1, impl="xla")`` on a 1-device
  mesh, and ``models/training.make_optim_train_step`` with
  ``training.adamw`` against ``make_optax_train_step(..., optax.adamw(lr))``
  — ``LlamaConfig.tiny()`` in f32, the same weights (``params_from_jax``)
  and tokens (numpy, seeded).  Tolerances are those of
  tests/test_llama.py's world-2 vs world-1 comparison: loss within 1e-5,
  updated parameters within 5e-4 (the two packages sum in different
  orders).
- ``runtime/checkpoint.py``: retention, an incomplete save stays
  invisible, and a resume is bit-exact for SGD and AdamW state.
- ``runtime/watchdog.py``: the cases of tests/test_watchdog.py.
- ``examples/train.py`` on ``--device cpu``, run twice over one
  checkpoint directory as tests/test_train_example.py does.
- The MoE family (``models/moe.py``): ``MoEConfig.tiny()`` in f32 against
  the reference's ``make_forward`` / ``make_grads`` / ``make_train_step``
  with ``impl="xla"`` on a 1-device mesh — logits and aux within 2e-5,
  loss within 1e-5, gradients within 1e-5 / 1e-4 and updated parameters
  within 5e-4, as for Llama; ``routes`` recorded and replayed give the
  same forward and gradient to the bit; and ``examples/train.py --model
  moe``.  Over 4 ranks (TP attention, expert-parallel FFN):
  ``shard_params`` of the same weights against the reference's mesh4
  ``make_forward`` / ``make_grads`` / ``make_train_step`` and its
  capacity-truncated forward at the same tolerances; world-1 routes
  replayed at 4 ranks; ``examples/train.py --model moe --tp 4``.
- Context parallelism (``models/cp.py``) over 4 ranks: ``make_cp_forward``
  (ring contiguous, ring zigzag, Ulysses; at S 1024 the zigzag flash ring)
  and ``make_cp_train_step`` against ``triton_dist_tpu.models.cp`` with
  ``impl="xla"`` on a four-device ``cp`` mesh and the same weights
  (``params_from_jax``): logits within 2e-5, the loss within 1e-5 and
  every updated leaf within 5e-4; remat equals no remat, CP equals the
  port's world-1 forward (5e-4, the reference's CP-vs-unsharded bound).
- Pipeline parallelism (``models/pp.py``, ``parallel/pipeline.py``):
  ``pipeline_spmd`` on the reference's toy stack (1e-6); the PP step of
  Llama tiny on (pp 2, tp 2) against the reference's (``impl="xla"``) and
  of MoE tiny on (dcn 2, pp 2, tp 2) with the hierarchical reduction
  against the reference's interpret-mode kernels, two steps each: losses
  within 1e-5, every updated leaf within 5e-4; hierarchical equals psum
  (2e-4), remat equals no remat (1e-6), PP equals the port's TP-2 step
  (1e-5 / 5e-4; ``make_pp_grads`` against its gradients); the families'
  ``dp`` steps against the reference's ``dp_axis`` steps on a (dp 2, tp
  2) mesh (1e-5, 5e-4) and ``examples/train.py --dp 2 --tp 2``.
- The torus (multi-axis) collectives and ring GEMMs over the oracle
  meshes of tests/test_torus.py against the reference's interpret-mode
  Pallas kernels (spied) at its tests' shapes: the all-gather and the
  reduce-scatter bit for bit in f32 and bf16, the host GEMM-RS and
  AG-GEMM within their tests' 2e-3 (the gathered A bit for bit).
"""

import os
import subprocess
import sys
import time

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from triton_dist_tpu.models import cp as jcp
from triton_dist_tpu.models import llama as jllama
from triton_dist_tpu.models import moe as jmoe
from triton_dist_tpu.models import pp as jpp
from triton_dist_tpu.models import training as jtraining
from triton_dist_tpu.parallel import pipeline as jpipe
from triton_dist_tpu_torch.kernels import group_gemm as tgg
from triton_dist_tpu_torch.kernels import ring_attention as tra
from triton_dist_tpu_torch.models import cp as tcp
from triton_dist_tpu_torch.models import llama as tllama
from triton_dist_tpu_torch.models import moe as tmoe
from triton_dist_tpu_torch.models import pp as tpp
from triton_dist_tpu_torch.models import training as ttraining
from triton_dist_tpu_torch.parallel import pipeline as tpipe
from triton_dist_tpu_torch.runtime import checkpoint as ck
from triton_dist_tpu_torch.runtime.bootstrap import Mesh as TMesh
from triton_dist_tpu_torch.runtime.utils import (
    assert_allclose,
    tree_leaves,
    value_and_grad,
)
from triton_dist_tpu_torch.runtime.watchdog import (
    Heartbeat,
    WatchdogTimeout,
    block_until_ready_with_timeout,
    run_with_watchdog,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _tiny_pair(seed=1):
    """(jax cfg, jax params on mesh1, port cfg, port params): the same
    weights in both packages."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(seed))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, jllama.place_params(jparams, jcfg, _mesh1()), tcfg, tparams


def _tokens(vocab, S=64, B=2, seed=3):
    tok = np.random.default_rng(seed).integers(0, vocab, size=(S, B))
    tgt = np.roll(tok, -1, axis=0)
    sh = NamedSharding(_mesh1(), P("tp"))
    return (jax.device_put(jnp.asarray(tok, jnp.int32), sh),
            jax.device_put(jnp.asarray(tgt, jnp.int32), sh),
            torch.as_tensor(tok), torch.as_tensor(tgt))


def _assert_params_close(tparams, jparams):
    got, want = tree_leaves(tparams), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, np.asarray(w), atol=5e-4, rtol=5e-4)


def test_forward_matches_reference():
    """make_forward's f32 logits [S, B, vocab] against the reference's
    make_forward on a 1-device mesh (logits of magnitude ~4; the two sum
    in different orders, ~4e-6 apart)."""
    jcfg, jparams, tcfg, tparams = _tiny_pair(seed=2)
    jtok, _, ttok, _ = _tokens(jcfg.vocab, S=48, seed=6)
    want = jllama.make_forward(jcfg, _mesh1(), impl="xla")(jparams, jtok)
    with torch.no_grad():
        got = tllama.make_forward(tcfg)(tparams, ttok)
    assert got.dtype == torch.float32 and got.shape == (48, 2, jcfg.vocab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_sgd_step_matches_reference():
    jcfg, jparams, tcfg, tparams = _tiny_pair()
    jtok, jtgt, ttok, ttgt = _tokens(jcfg.vocab)
    jstep, _ = jllama.make_train_step(jcfg, _mesh1(), impl="xla", lr=0.5)
    tstep = tllama.make_train_step(tcfg, lr=0.5)
    for _ in range(2):
        jparams, jloss = jstep(jparams, jtok, jtgt)
        same, tloss = tstep(tparams, ttok, ttgt)
        assert same is tparams                 # updated in place
        assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    _assert_params_close(tparams, jparams)
    # the step moved the weights (it is not a no-op that trivially agrees)
    _, fresh, _, _ = _tiny_pair()
    moved = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(jax.tree.leaves(jparams),
                             jax.tree.leaves(fresh))]
    assert max(moved) > 1e-3


def test_adamw_steps_match_optax():
    jcfg, jparams, tcfg, tparams = _tiny_pair()
    jtok, jtgt, ttok, ttgt = _tokens(jcfg.vocab)
    lr = 1e-3
    jstep, jinit = jtraining.make_optax_train_step(
        jllama, jcfg, _mesh1(), optax.adamw(lr), impl="xla")
    jopt = jinit(jparams)
    tstep, tinit = ttraining.make_optim_train_step(tllama, tcfg,
                                                   ttraining.adamw(lr))
    topt = tinit(tparams)
    losses = []
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jtok, jtgt)
        tparams, topt, tloss = tstep(tparams, topt, ttok, ttgt)
        assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
        losses.append(float(tloss))
    assert losses[-1] < losses[0]
    _assert_params_close(tparams, jparams)


def test_make_grads_matches_reference_and_refuses_other_families():
    jcfg, jparams, tcfg, tparams = _tiny_pair(seed=4)
    jtok, jtgt, ttok, ttgt = _tokens(jcfg.vocab, S=32, seed=5)
    jgrads_fn, _ = jtraining.make_grads(jllama, jcfg, _mesh1(), impl="xla")
    jloss, jgrads = jgrads_fn(jparams, jtok, jtgt)
    tloss, tgrads = ttraining.make_grads(tllama, tcfg)(tparams, ttok, ttgt)
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    for g, w in zip(tree_leaves(tgrads), jax.tree.leaves(jgrads)):
        assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4)
    from triton_dist_tpu_torch.models import sampling
    with pytest.raises(NotImplementedError, match="models.moe"):
        ttraining.make_grads(sampling, tcfg)


def _small_cfg():
    return tllama.LlamaConfig(vocab=64, dim=256, n_layers=1, n_heads=2,
                              n_kv_heads=2, ffn_dim=64, max_seq=32)


def _tree():
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.ones(3, dtype=torch.bfloat16), "step": 7}


def test_manager_retention_and_latest(tmp_path):
    mgr = ck.CheckpointManager(tmp_path / "run", max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(like=_tree()) is None
    tree = _tree()
    for s in (0, 1, 5):
        mgr.save(s, tree)
    assert mgr.all_steps() == [1, 5]      # 0 pruned
    assert mgr.latest_step() == 5
    step, out = mgr.restore_latest(like=tree)
    assert step == 5 and torch.equal(out["w"], tree["w"])
    assert out["b"].dtype == torch.bfloat16 and out["step"] == 7
    with pytest.raises(ValueError, match="expected"):
        mgr.restore(5, like={"w": torch.zeros(4, 4)})


def test_incomplete_save_is_invisible(tmp_path):
    """A *.tmp dir from a crashed save is not a resumable step, and the
    next manager to open the directory reclaims it."""
    d = tmp_path / "crash"
    mgr = ck.CheckpointManager(d, max_to_keep=3)
    mgr.save(3, _tree())
    (d / "9.tmp").mkdir()
    assert mgr.all_steps() == [3] and mgr.latest_step() == 3
    ck.CheckpointManager(d)
    assert not (d / "9.tmp").exists()
    # a torn newest step falls back to the newest readable one
    (d / "11").mkdir()
    step, out = ck.CheckpointManager(d).restore_latest(like=_tree())
    assert step == 3 and torch.equal(out["w"], _tree()["w"])


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_resume_bit_exact(tmp_path, opt):
    """save @ step 2 → restore into fresh state → 1 step  ==  3
    uninterrupted steps, bit for bit (AdamW: its moments and step count
    ride the checkpoint too)."""
    cfg = _small_cfg()
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                            (16, 2)))
    tgt = torch.roll(tok, -1, dims=0)

    def make(seed):
        params = tllama.init_params(cfg, seed=seed, device="cpu")
        if opt == "sgd":
            step = tllama.make_train_step(cfg, lr=0.1)
            return params, None, lambda: step(params, tok, tgt)
        step, init = ttraining.make_optim_train_step(
            tllama, cfg, ttraining.adamw(1e-2))
        o = init(params)
        return params, o, lambda: step(params, o, tok, tgt)

    ref, _, ref_step = make(0)
    for _ in range(3):
        ref_step()
    params, o, run = make(0)
    for _ in range(2):
        run()
    mgr = ck.CheckpointManager(tmp_path / "resume", max_to_keep=1)
    mgr.save(1, {"params": params,
                 **({"opt": o.state_dict()} if o is not None else {})})
    params2, o2, run2 = make(1)             # other weights, no opt state
    restored = mgr.restore(1, like={"params": params2})
    with torch.no_grad():
        for p, s in zip(tree_leaves(params2),
                        tree_leaves(restored["params"])):
            p.copy_(s)
    if o2 is not None:
        o2.load_state_dict(restored["opt"])
    run2()
    for a, b in zip(tree_leaves(params2), tree_leaves(ref)):
        assert torch.equal(a, b)


def test_watchdog_fast_fn_returns_value():
    assert run_with_watchdog(lambda: 42, timeout_s=5.0) == 42


def test_watchdog_slow_fn_times_out():
    with pytest.raises(WatchdogTimeout, match="stall-demo"):
        run_with_watchdog(lambda: time.sleep(3.0), timeout_s=0.2,
                          name="stall-demo", dump_stacks=False)


def test_watchdog_fn_exception_propagates():
    with pytest.raises(ValueError, match="inner"):
        run_with_watchdog(lambda: (_ for _ in ()).throw(ValueError("inner")),
                          timeout_s=5.0)


def test_block_until_ready_passthrough():
    x = torch.arange(8.0) * 2
    out = block_until_ready_with_timeout({"x": x}, timeout_s=10.0)
    assert out["x"] is x


def test_heartbeat_liveness_and_stall(tmp_path):
    hb_path = tmp_path / "hb"
    with Heartbeat(hb_path, interval_s=0.1) as hb:
        time.sleep(0.35)
        age = Heartbeat.age_s(hb_path)
        assert age is not None and age < 0.3
        assert not Heartbeat.is_stalled(hb_path, interval_s=0.1)
        hb.beat()
    # After exit the file stops updating → stall detection fires.
    time.sleep(0.5)
    assert Heartbeat.is_stalled(hb_path, interval_s=0.1)


def test_heartbeat_missing_file_is_stalled(tmp_path):
    assert Heartbeat.is_stalled(tmp_path / "never", interval_s=1.0)


def _run_cli(tmp, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "triton_dist_tpu_torch.examples.train",
         "--device", "cpu", "--ckpt-dir", str(tmp), "--seq", "16",
         "--batch", "2", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_train_cli_and_resume(tmp_path):
    first = _run_cli(tmp_path, "--steps", "4", "--ckpt-every", "2")
    assert "step    3" in first and "done" in first
    assert "resumed" not in first
    second = _run_cli(tmp_path, "--steps", "6", "--ckpt-every", "2")
    assert "resumed from step 3" in second
    assert "step    4" in second and "step    5" in second
    assert (tmp_path / "heartbeat.0").exists()


def test_train_cli_refuses_unported_options():
    from triton_dist_tpu_torch.examples import train

    for flags, item in ((["--opt", "adamw", "--tp", "2"], "ninth entry"),
                        (["--model", "moe", "--opt", "adamw", "--tp", "2"],
                         "ninth entry"),
                        (["--profile", "p"], "item 16")):
        with pytest.raises(NotImplementedError, match=item):
            train.main(["--device", "cpu", *flags])


# ---------------------------------------------------------------------------
# The MoE family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_pair():
    """(jax cfg, jax params on mesh1, port cfg, host params tree): the same
    ``MoEConfig.tiny()`` weights in both packages."""
    jcfg = jmoe.MoEConfig.tiny()
    jparams = jmoe.init_params(jcfg, jax.random.key(7))
    host = jax.device_get(jparams)
    return (jcfg, jmoe.place_params(jparams, jcfg, _mesh1()),
            tmoe.MoEConfig.tiny(), host)


def _moe_tokens(vocab, S=32, B=2, seed=8):
    return _tokens(vocab, S=S, B=B, seed=seed)


def test_moe_forward_matches_reference(moe_pair):
    """Logits [S, B, vocab] f32 and the aux loss against the reference's
    make_forward (f32; the two sum in different orders)."""
    jcfg, jparams, tcfg, host = moe_pair
    jtok, _, ttok, _ = _moe_tokens(jcfg.vocab)
    want, jaux = jmoe.make_forward(jcfg, _mesh1(), impl="xla")(jparams, jtok)
    tparams = tmoe.params_from_jax(host, tcfg, device="cpu")
    assert tparams["layers"][0]["router"].dtype == torch.float32
    n0 = tgg.group_gemm.launches
    with torch.no_grad():
        got, aux = tmoe.make_forward(tcfg)(tparams, ttok)
    assert tgg.group_gemm.launches == n0       # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (32, 2, jcfg.vocab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    assert_allclose(aux, np.asarray(jaux), atol=1e-6, rtol=1e-5)


def test_moe_routes_record_and_replay(moe_pair):
    """``routes``: an empty list records each layer's top-k experts; fed
    back, every layer routes by it and the forward (and its gradient) is
    the same to the bit; other routes give other logits."""
    jcfg, _, tcfg, host = moe_pair
    _, _, ttok, ttgt = _moe_tokens(jcfg.vocab)
    tparams = tmoe.params_from_jax(host, tcfg, device="cpu")
    routes = []
    with torch.no_grad():
        want, aux = tmoe.make_forward(tcfg)(tparams, ttok, routes=routes)
        assert len(routes) == tcfg.n_layers
        assert all(r.shape == (ttok.numel(), tcfg.topk)
                   and r.dtype == torch.int32 for r in routes)
        got, aux2 = tmoe.make_forward(tcfg, plain=True)(tparams, ttok,
                                                        routes=routes)
        other = [(r + 1) % tcfg.n_experts for r in routes]
        moved, _ = tmoe.make_forward(tcfg)(tparams, ttok, routes=other)
    assert torch.equal(got, want) and torch.equal(aux, aux2)
    assert len(routes) == tcfg.n_layers        # replay appends nothing
    assert (moved - want).abs().max() > 1e-3
    loss_a, g_a = value_and_grad(tmoe.loss_shard, tparams, ttok, ttgt, tcfg)
    loss_b, g_b = value_and_grad(tmoe.loss_shard, tparams, ttok, ttgt, tcfg,
                                 routes=routes)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g_a),
                                                  tree_leaves(g_b)))


def test_moe_make_grads_matches_reference(moe_pair):
    jcfg, jparams, tcfg, host = moe_pair
    jtok, jtgt, ttok, ttgt = _moe_tokens(jcfg.vocab)
    jloss, jgrads = jtraining.make_grads(jmoe, jcfg, _mesh1(),
                                         impl="xla")[0](jparams, jtok, jtgt)
    tparams = tmoe.params_from_jax(host, tcfg, device="cpu")
    tloss, tgrads = ttraining.make_grads(tmoe, tcfg)(tparams, ttok, ttgt)
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    got, want = tree_leaves(tgrads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-4)


def test_moe_sgd_step_matches_reference(moe_pair):
    """One in-place SGD step: the loss and every updated parameter, which
    moved (the router and the experts too: gradients flowed through the
    routing and the grouped GEMMs)."""
    jcfg, jparams, tcfg, host = moe_pair
    jtok, jtgt, ttok, ttgt = _moe_tokens(jcfg.vocab)
    jstep, _ = jmoe.make_train_step(jcfg, _mesh1(), impl="xla", lr=0.5)
    tparams = tmoe.params_from_jax(host, tcfg, device="cpu")
    jnew, jloss = jstep(jparams, jtok, jtgt)
    same, tloss = tmoe.make_train_step(tcfg, lr=0.5)(tparams, ttok, ttgt)
    assert same is tparams
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    _assert_params_close(tparams, jnew)
    for name in ("router", "w_gate", "w_down"):
        moved = np.abs(tparams["layers"][0][name].detach().numpy()
                       - host["layers"][0][name]).max()
        assert moved > 1e-6, name


def test_train_cli_moe_runs(capsys):
    from triton_dist_tpu_torch.examples import train

    train.main(["--model", "moe", "--device", "cpu", "--steps", "2",
                "--seq", "16", "--batch", "2", "--lr", "0.5"])
    out = capsys.readouterr().out
    assert "model=moe" in out and "step    1" in out and "done" in out


# ---------------------------------------------------------------------------
# Tensor parallelism: TP 4 on the virtual world
# ---------------------------------------------------------------------------


def _mesh4():
    return Mesh(np.array(jax.devices()[:4]), ("tp",))


@pytest.fixture(scope="module")
def tp_pair():
    """(jax cfg, jax params, port cfg, host tree): ``LlamaConfig.tiny()``
    weights (8 / 4 heads: 2 / 1 per rank at TP 4)."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(11))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), jax.device_get(jparams)


def _tokens4(vocab, S=128, B=4, seed=12):
    tok = np.random.default_rng(seed).integers(0, vocab, size=(S, B))
    tgt = np.roll(tok, -1, axis=0)
    sh = NamedSharding(_mesh4(), P("tp"))
    return (jax.device_put(jnp.asarray(tok, jnp.int32), sh),
            jax.device_put(jnp.asarray(tgt, jnp.int32), sh),
            torch.as_tensor(tok), torch.as_tensor(tgt))


def _tp4_params(host, tcfg):
    return tllama.shard_params(tllama.params_from_jax(host, tcfg,
                                                      device="cpu"), tcfg, 4)


def test_tp4_forward_matches_reference(tp_pair):
    """make_forward(cfg, 4) on shard_params(params_from_jax(...)) against
    the reference's make_forward over a 4-device mesh, S 128, B 4 (32
    positions per rank), f32 within 2e-5.  The reference runs
    ``impl="xla"``: its interpret-mode Pallas forward takes ~50 s on this
    CPU; its Pallas kernels are held to the port's plain versions in
    tests/test_torch_kernels.py."""
    jcfg, jparams, tcfg, host = tp_pair
    jtok, _, ttok, _ = _tokens4(jcfg.vocab)
    want = jllama.make_forward(jcfg, _mesh4(), impl="xla")(
        jllama.place_params(jparams, jcfg, _mesh4()), jtok)
    tparams = _tp4_params(host, tcfg)
    layer = tparams["layers"][0]
    assert layer["wq"].shape == (4, tcfg.dim, tcfg.dim // 4)
    assert layer["wdown"].shape == (4, tcfg.ffn_dim // 4, tcfg.dim)
    assert layer["attn_norm"].shape == (tcfg.dim,)
    with torch.no_grad():
        got = tllama.make_forward(tcfg, 4)(tparams, ttok)
    assert got.dtype == torch.float32 and got.shape == (128, 4, jcfg.vocab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_tp4_sgd_step_matches_reference(tp_pair):
    """One in-place SGD step at TP 4 against the reference's
    make_train_step over the 4-device mesh (``impl="xla"``): the loss
    within 1e-5 and every updated leaf (the sharded weights per rank, the
    replicated leaves with their gradients summed over the ranks) within
    5e-4, as for world 1."""
    jcfg, jparams, tcfg, host = tp_pair
    jtok, jtgt, ttok, ttgt = _tokens4(jcfg.vocab, seed=13)
    jstep, _ = jllama.make_train_step(jcfg, _mesh4(), impl="xla", lr=0.5)
    jnew, jloss = jstep(jllama.place_params(jparams, jcfg, _mesh4()), jtok,
                        jtgt)
    tparams = _tp4_params(host, tcfg)
    same, tloss = tllama.make_train_step(tcfg, 4, lr=0.5)(tparams, ttok,
                                                          ttgt)
    assert same is tparams
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    want = _tp4_params(jax.device_get(jnew), tcfg)
    got, ref = tree_leaves(tparams), tree_leaves(want)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert_allclose(g, w, atol=5e-4, rtol=5e-4)
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        got, tree_leaves(_tp4_params(host, tcfg))))
    assert moved > 1e-3


def test_tp4_grads_match_world1_grads(tp_pair):
    """The port's counterpart of test_llama.py::
    test_grads_match_single_device_reference: the loss and every gradient
    at TP 4 equal the world-1 ones, sharded alike (f32; the ranks' sums
    run in another order)."""
    _, _, tcfg, host = tp_pair
    _, _, ttok, ttgt = _tokens4(tcfg.vocab, S=64, B=2, seed=14)
    p1 = tllama.params_from_jax(host, tcfg, device="cpu")
    loss1, g1 = value_and_grad(tllama.loss_shard, p1, ttok, ttgt, tcfg)
    p4 = tllama.shard_params(p1, tcfg, 4)
    assert all(a is not b for a, b in zip(tree_leaves(p1),
                                          tree_leaves(p4)))
    loss4, g4 = value_and_grad(tllama.loss_shard, p4, ttok, ttgt, tcfg,
                               world=4)
    assert_allclose(loss4, loss1, atol=1e-6, rtol=1e-6)
    for a, b in zip(tree_leaves(g4), tree_leaves(
            tllama.shard_params(g1, tcfg, 4))):
        assert_allclose(a, b, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        tllama.shard_params(p1, tcfg, 3)
    with pytest.raises(ValueError, match="split over 4"):
        tllama.make_forward(tcfg, 4)(p4, ttok[:30])


def test_train_cli_tp4_runs(capsys):
    from triton_dist_tpu_torch.examples import train

    train.main(["--tp", "4", "--device", "cpu", "--steps", "2", "--seq",
                "16", "--batch", "2", "--lr", "0.5"])
    out = capsys.readouterr().out
    assert "tp=4" in out and "step    1" in out and "done" in out


def test_train_cli_refuses_unported_tp_options(capsys):
    """AdamW at --tp > 1 raises, naming its ROADMAP entry (Queue 1's
    ninth); the MoE family at --tp 2 runs."""
    from triton_dist_tpu_torch.examples import train

    for flags, item in ((["--tp", "4", "--opt", "adamw"], "ninth entry"),):
        with pytest.raises(NotImplementedError, match=item):
            train.main(["--device", "cpu", *flags])
    train.main(["--device", "cpu", "--model", "moe", "--tp", "2", "--steps",
                "1", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "model=moe" in out and "tp=2" in out and "done" in out


# ---------------------------------------------------------------------------
# The MoE family over 4 ranks: TP attention, expert-parallel FFN
# ---------------------------------------------------------------------------


def _ep4_params(host, tcfg):
    return tmoe.shard_params(tmoe.params_from_jax(host, tcfg, device="cpu"),
                             tcfg, 4)


def test_moe_ep4_forward_matches_reference(moe_pair):
    """make_forward(cfg, 4) on shard_params(params_from_jax(...)) against
    the reference's make_forward over mesh4 (``impl="xla"``), S 32, B 2
    (8 positions per rank): logits within 2e-5 and the aux loss (each
    rank's local-batch balance loss over 4, summed) within 1e-5; the
    expert stacks are the world-1 tensors, the attention weights cut per
    rank."""
    jcfg, _, tcfg, host = moe_pair
    jtok, _, ttok, _ = _tokens4(jcfg.vocab, S=32, B=2, seed=8)
    want, jaux = jmoe.make_forward(jcfg, _mesh4(), impl="xla")(
        jmoe.place_params(jax.tree.map(jnp.asarray, host), jcfg, _mesh4()),
        jtok)
    p1 = tmoe.params_from_jax(host, tcfg, device="cpu")
    tparams = tmoe.shard_params(p1, tcfg, 4)
    layer = tparams["layers"][0]
    assert layer["wq"].shape == (4, tcfg.dim, tcfg.dim // 4)
    assert layer["wo"].shape == (4, tcfg.dim // 4, tcfg.dim)
    assert layer["w_gate"] is p1["layers"][0]["w_gate"]
    assert layer["router"] is p1["layers"][0]["router"]
    with torch.no_grad():
        got, aux = tmoe.make_forward(tcfg, 4)(tparams, ttok)
    assert got.dtype == torch.float32 and got.shape == (32, 2, jcfg.vocab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    assert_allclose(aux, np.asarray(jaux), atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        tmoe.shard_params(p1, tcfg, 3)
    with pytest.raises(ValueError, match="split over 4"):
        tmoe.make_forward(tcfg, 4)(tparams, ttok[:30])


def test_moe_ep4_sgd_step_matches_reference(moe_pair):
    """One in-place SGD step over 4 ranks against the reference's
    make_train_step on mesh4 (``impl="xla"``): the loss within 1e-5 and
    every updated leaf within 5e-4 (the replicated leaves with the ranks'
    gradients summed); the experts and the router moved."""
    jcfg, _, tcfg, host = moe_pair
    jtok, jtgt, ttok, ttgt = _tokens4(jcfg.vocab, S=32, B=2, seed=9)
    jstep, _ = jmoe.make_train_step(jcfg, _mesh4(), impl="xla", lr=0.5)
    jnew, jloss = jstep(jmoe.place_params(jax.tree.map(jnp.asarray, host),
                                          jcfg, _mesh4()), jtok, jtgt)
    tparams = _ep4_params(host, tcfg)
    same, tloss = tmoe.make_train_step(tcfg, 4, lr=0.5)(tparams, ttok, ttgt)
    assert same is tparams
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    got = tree_leaves(tparams)
    want = tree_leaves(_ep4_params(jax.device_get(jnew), tcfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, w, atol=5e-4, rtol=5e-4)
    for name in ("router", "w_gate", "w_down"):
        moved = np.abs(tparams["layers"][0][name].detach().numpy()
                       - host["layers"][0][name]).max()
        assert moved > 1e-6, name


def test_moe_ep4_make_grads_matches_reference(moe_pair):
    """training.make_grads(moe, cfg, world=4) against the reference's
    make_grads on mesh4 (``impl="xla"``): the loss within 1e-5, every
    gradient leaf, sharded alike, within 1e-5 / 1e-4."""
    jcfg, _, tcfg, host = moe_pair
    jtok, jtgt, ttok, ttgt = _tokens4(jcfg.vocab, S=32, B=2, seed=10)
    jgrads_fn, _ = jtraining.make_grads(jmoe, jcfg, _mesh4(), impl="xla")
    jloss, jgrads = jgrads_fn(jmoe.place_params(
        jax.tree.map(jnp.asarray, host), jcfg, _mesh4()), jtok, jtgt)
    tloss, tgrads = ttraining.make_grads(tmoe, tcfg, world=4)(
        _ep4_params(host, tcfg), ttok, ttgt)
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    got = tree_leaves(tgrads)
    want = tree_leaves(_ep4_params(jax.device_get(jgrads), tcfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_allclose(g, w, atol=1e-5, rtol=1e-4)


def test_moe_ep4_routes_replay_world1_routes(moe_pair):
    """routes recorded at world 1 and at 4 ranks pick the same experts
    per token (rank r's are rows r S/W B ... of the world-1 list); the
    world-1 list replayed at 4 ranks gives the 4-rank forward, and its
    cross-entropy and logits equal world 1's (the aux loss differs by
    design: each rank balances its own batch)."""
    _, _, tcfg, host = moe_pair
    _, _, ttok, ttgt = _tokens4(tcfg.vocab, S=32, B=2, seed=11)
    p1 = tmoe.params_from_jax(host, tcfg, device="cpu")
    p4 = tmoe.shard_params(p1, tcfg, 4)
    r1, r4 = [], []
    with torch.no_grad():
        l1, aux1 = tmoe.make_forward(tcfg)(p1, ttok, routes=r1)
        l4, aux4 = tmoe.make_forward(tcfg, 4)(p4, ttok, routes=r4)
        l4r, aux4r = tmoe.make_forward(tcfg, 4)(p4, ttok, routes=r1)
    assert len(r1) == len(r4) == tcfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(r1, r4))
    assert torch.equal(l4r, l4) and torch.equal(aux4r, aux4)
    assert_allclose(l4, l1, atol=2e-5, rtol=2e-5)
    assert abs(float(aux4) - float(aux1)) > 1e-6
    ce = [F.cross_entropy(x.reshape(-1, tcfg.vocab), ttgt.reshape(-1))
          for x in (l1, l4r)]
    assert_allclose(ce[1], ce[0], atol=1e-6, rtol=1e-6)


def test_moe_ep4_capacity_truncation_matches_reference(moe_pair):
    """A tight capacity (max_tokens 8 of 32 assignments per rank) drops
    assignments over 4 ranks (tests/test_moe_model.py:115): finite logits
    of the right shape, within 2e-5 of the reference's mesh4 forward."""
    jcfg, _, tcfg, host = moe_pair
    jcfg8 = jmoe.MoEConfig(**{**jcfg.__dict__, "max_tokens": 8})
    tcfg8 = replace(tcfg, max_tokens=8)
    jtok, _, ttok, _ = _tokens4(jcfg.vocab, S=32, B=2, seed=12)
    want, jaux = jmoe.make_forward(jcfg8, _mesh4(), impl="xla")(
        jmoe.place_params(jax.tree.map(jnp.asarray, host), jcfg8, _mesh4()),
        jtok)
    with torch.no_grad():
        got, aux = tmoe.make_forward(tcfg8, 4)(_ep4_params(host, tcfg8),
                                               ttok)
    assert torch.isfinite(got).all() and got.shape == (32, 2, jcfg.vocab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    assert_allclose(aux, np.asarray(jaux), atol=1e-6, rtol=1e-5)


def test_train_cli_moe_tp4_runs(capsys):
    """examples/train.py --model moe --tp 4 on the CPU: the loss falls."""
    from triton_dist_tpu_torch.examples import train

    train.main(["--model", "moe", "--tp", "4", "--device", "cpu", "--steps",
                "3", "--seq", "16", "--batch", "2", "--lr", "0.5"])
    out = capsys.readouterr().out
    assert "model=moe" in out and "tp=4" in out and "done" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# Context parallelism: CP 4 on the virtual world
# ---------------------------------------------------------------------------


def _mesh_cp():
    return Mesh(np.array(jax.devices()[:4]), ("cp",))


@pytest.fixture(scope="module")
def cp_pair():
    """(jax cfg, jax params, port cfg, port params): ``LlamaConfig.tiny()``
    weights in both packages (the port's tree is the world-1 tree, which
    ``place_cp_params`` keeps as it is)."""
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(21))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    assert tcp.place_cp_params(tparams, tcfg, 4) is tparams
    return jcfg, jparams, tcfg, tparams


def _cp_tokens(vocab, S=64, B=2, seed=22):
    tok = np.random.default_rng(seed).integers(0, vocab, size=(S, B))
    return tok, np.roll(tok, -1, axis=0)


@pytest.mark.parametrize("attn,zigzag,S", [("ring", False, 64),
                                           ("ring", True, 64),
                                           ("ulysses", None, 64),
                                           ("ring", None, 1024)])
def test_cp_forward_matches_reference(cp_pair, attn, zigzag, S):
    """make_cp_forward over 4 ranks against the reference's on a
    four-device ``cp`` mesh (``impl="xla"``, zigzag as asked; at S 1024
    the port's auto rule takes the zigzag flash ring, the reference runs
    its dense ring in the same layout), logits f32 within 2e-5."""
    jcfg, jparams, tcfg, tparams = cp_pair
    tok, _ = _cp_tokens(jcfg.vocab, S=S, B=2 if S == 64 else 1)
    mesh = _mesh_cp()
    jz = zigzag
    if S == 1024:
        assert tcp._pick_zigzag(None, "ring", S, 4, "auto", 128)
        jz = True
    want = jcp.make_cp_forward(jcfg, mesh, attn=attn, impl="xla",
                               interpret=True, zigzag=jz)(
        jcp.place_cp_params(jparams, jcfg, mesh), jnp.asarray(tok))
    with torch.no_grad():
        got = tcp.make_cp_forward(tcfg, 4, attn=attn, zigzag=zigzag)(
            tparams, torch.as_tensor(tok))
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("attn,zigzag", [("ring", True), ("ulysses", None)])
def test_cp_sgd_step_matches_reference(cp_pair, attn, zigzag):
    """One in-place SGD step of make_cp_train_step over 4 ranks against
    the reference's on the ``cp`` mesh (``impl="xla"``): the loss within
    1e-5 and every updated leaf (each the world-1 tree's, its gradient
    summed over the ranks) within 5e-4; the weights moved."""
    jcfg, jparams, tcfg, _ = cp_pair
    tok, tgt = _cp_tokens(jcfg.vocab, seed=23)
    mesh = _mesh_cp()
    jstep, _ = jcp.make_cp_train_step(jcfg, mesh, attn=attn, impl="xla",
                                      interpret=True, lr=0.5, zigzag=zigzag)
    jnew, jloss = jstep(jcp.place_cp_params(jparams, jcfg, mesh),
                        jnp.asarray(tok), jnp.asarray(tgt))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    same, tloss = tcp.make_cp_train_step(tcfg, 4, attn=attn, lr=0.5,
                                         zigzag=zigzag)(
        tparams, torch.as_tensor(tok), torch.as_tensor(tgt))
    assert same is tparams
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    _assert_params_close(tparams, jnew)
    before = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                    device="cpu")
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(
        tree_leaves(tparams), tree_leaves(before)))
    assert moved > 1e-3


def test_cp_remat_and_world1(cp_pair):
    """``remat=True`` (torch.utils.checkpoint per layer) gives the same
    loss and gradients as no remat (1e-6), and the CP forward over 4
    ranks (ring, zigzag and not; Ulysses) equals the port's world-1
    forward within 5e-4; the dp axis and unknown schemes are refused."""
    _, _, tcfg, tparams = cp_pair
    tok, tgt = (torch.as_tensor(x) for x in _cp_tokens(tcfg.vocab, seed=24))

    def grads(remat):
        def loss(p, t, y):
            lg = tcp.cp_forward_shard(p, t.reshape(4, 16, 2), tcfg,
                                      remat=remat)
            return F.cross_entropy(lg.reshape(-1, tcfg.vocab),
                                   y.reshape(-1))
        return value_and_grad(loss, tparams, tok, tgt)

    (l0, g0), (l1, g1) = grads(False), grads(True)
    assert_allclose(l1, l0, atol=1e-6, rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g0)):
        assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        ref = tllama.make_forward(tcfg)(tparams, tok)
        for attn, zz in (("ring", False), ("ring", True), ("ulysses", None)):
            got = tcp.make_cp_forward(tcfg, 4, attn=attn, zigzag=zz)(
                tparams, tok)
            assert_allclose(got, ref, atol=5e-4, rtol=5e-4)
    with pytest.raises(NotImplementedError, match="ninth entry"):
        tcp.make_cp_train_step(tcfg, 4, dp_axis="dp")
    with pytest.raises(ValueError, match="attn"):
        tcp.make_cp_forward(tcfg, 4, attn="tree")
    with pytest.raises(ValueError, match="zigzag"):
        tcp.make_cp_forward(tcfg, 4, attn="ulysses", zigzag=True)(
            tparams, tok)


# ---------------------------------------------------------------------------
# Pipeline parallelism (dcn x pp x tp) with the hierarchical gradient
# all-reduce, and data parallelism in the family steps
# ---------------------------------------------------------------------------

def _jmesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def test_pipeline_spmd_matches_reference():
    """pipeline_spmd (only the live stage-microbatch pairs) on the
    reference's toy stack (4 layers x * w + 1, pp 2, 3 microbatches)
    against the reference's GPipe schedule on a (pp 2, tp 2) mesh, 1e-6;
    stack_layer_params stacks as the reference's does."""
    from jax.sharding import PartitionSpec as JP

    n_layers, n_micro, mb = 4, 3, 8
    ws = np.arange(1.0, n_layers + 1, dtype=np.float32)[:, None] * np.ones(
        (n_layers, 128), np.float32)
    xs = np.random.default_rng(400).standard_normal(
        (n_micro, mb, 128)).astype(np.float32)

    def shard_fn(w, x):
        out = jpipe.pipeline_spmd(lambda a, b: b * a[None, :] + 1.0, w, x,
                                  axis="pp", n_micro=n_micro)
        last = jax.lax.axis_index("pp") == jax.lax.axis_size("pp") - 1
        return jax.lax.psum(jnp.where(last, out, 0.0), "pp")

    want = jax.jit(jax.shard_map(
        shard_fn, mesh=_jmesh((2, 2), ("pp", "tp")),
        in_specs=(JP("pp"), JP()), out_specs=JP(), check_vma=False))(
        jnp.asarray(ws), jnp.asarray(xs))
    got = tpipe.pipeline_spmd(lambda a, b: b * a[None, :] + 1.0,
                              torch.as_tensor(ws).reshape(2, 2, 128),
                              torch.as_tensor(xs), n_micro=n_micro)
    assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
    layers = [{"w": torch.full((3,), float(i))} for i in range(4)]
    stacked = tpipe.stack_layer_params(layers)
    assert stacked["w"].shape == (4, 3) and stacked["w"][2, 0] == 2.0


def _pp_run(jcfg, tcfg, shape, names, *, dp_axis, hier, S, B, steps=2,
            remat=False):
    """The reference's make_pp_train_step (interpret mode, ``impl="xla"``
    projections) and the port's on the same weights and tokens: (ref
    losses, port losses, ref updated tree placed as the port's, port
    tree)."""
    jmesh, tmesh = _jmesh(shape, names), TMesh(shape, names, "cpu")
    jp = jpp.init_pp_params(jcfg, jax.random.key(21))
    host = jax.device_get(jp)
    tparams = tpp.place_pp_params(tpp.params_from_jax(host, tcfg, "cpu"),
                                  tcfg, tmesh)
    tok = np.random.default_rng(22).integers(0, jcfg.vocab, size=(S, B))
    tgt = np.roll(tok, -1, axis=0)
    jstep, _ = jpp.make_pp_train_step(
        jcfg, jmesh, dp_axis=dp_axis, n_micro=2, impl="xla",
        interpret=True, lr=0.3, hier_dp_fast_axis=hier, remat=remat)
    tstep, specs = tpp.make_pp_train_step(
        tcfg, tmesh, dp_axis=dp_axis, n_micro=2, lr=0.3,
        hier_dp_fast_axis=hier, remat=remat)
    assert specs == tpp.pp_param_specs(tcfg)
    jp = jpp.place_pp_params(jp, jcfg, jmesh)
    jl, tl = [], []
    for _ in range(steps):
        jp, loss = jstep(jp, jnp.asarray(tok, jnp.int32),
                         jnp.asarray(tgt, jnp.int32))
        jl.append(float(loss))
        tparams, loss = tstep(tparams, torch.as_tensor(tok),
                              torch.as_tensor(tgt))
        tl.append(float(loss))
    want = tpp.place_pp_params(tpp.params_from_jax(jax.device_get(jp), tcfg,
                                                   "cpu"), tcfg, tmesh)
    return jl, tl, want, tparams


def test_pp_llama_step_matches_reference():
    """make_pp_train_step for Llama tiny on (pp 2, tp 2), two SGD steps,
    against the reference's (``impl="xla"``) on the same weights
    (``params_from_jax``): the losses within 1e-5 and every updated leaf
    within 5e-4 (the world-1 tolerances; measured ~2e-7)."""
    jl, tl, want, got = _pp_run(jllama.LlamaConfig.tiny(),
                                tllama.LlamaConfig.tiny(), (2, 2),
                                ("pp", "tp"), dp_axis=None, hier=None, S=32,
                                B=4)
    assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert got["layers"]["wq"].shape == (2, 2, 1024, 512)
    assert got["layers"]["wo"].shape == (2, 2, 512, 1024)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert_allclose(g, w, atol=5e-4, rtol=5e-4)


def test_pp_moe_hier_step_matches_reference():
    """The hybrid step: MoE tiny on (dcn 2, pp 2, tp 2) with
    hier_dp_fast_axis="tp" (the reduce-scatter and all-gather over tp, the
    dcn sum between) against the reference's with its interpret-mode
    kernels: losses within 1e-5, every updated leaf within 5e-4."""
    jl, tl, want, got = _pp_run(jmoe.MoEConfig.tiny(), tmoe.MoEConfig.tiny(),
                                (2, 2, 2), ("dcn", "pp", "tp"),
                                dp_axis="dcn", hier="tp", S=16, B=8)
    assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    assert tl[1] < tl[0]
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert_allclose(g, w, atol=5e-4, rtol=5e-4)


def _pp_port(cfg, shape, names, *, dp_axis, hier, remat=False, S=16, B=8,
             seed=23):
    mesh = TMesh(shape, names, "cpu")
    params = tpp.place_pp_params(tpp.init_pp_params(cfg, seed=seed,
                                                    device="cpu"), cfg, mesh)
    tok = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(S, B)))
    tgt = torch.roll(tok, -1, dims=0)
    step, _ = tpp.make_pp_train_step(cfg, mesh, dp_axis=dp_axis, n_micro=2,
                                     lr=0.3, hier_dp_fast_axis=hier,
                                     remat=remat)
    losses = [float(step(params, tok, tgt)[1]) for _ in range(2)]
    return losses, params


def test_pp_hier_matches_psum():
    """The hierarchical dp reduction equals the plain psum (the same sums
    bracketed otherwise): MoE tiny on (dcn 2, pp 2, tp 2), two steps,
    losses and every leaf within 2e-4 (the reference's
    test_pp_hybrid_hier_dp_matches_plain bound); the hierarchical path
    needs a dp axis and names the tp axis."""
    cfg = tmoe.MoEConfig.tiny()
    names = ("dcn", "pp", "tp")
    lh, ph = _pp_port(cfg, (2, 2, 2), names, dp_axis="dcn", hier="tp")
    lp, pp_ = _pp_port(cfg, (2, 2, 2), names, dp_axis="dcn", hier=None)
    assert_allclose(lh, lp, atol=2e-4, rtol=2e-4)
    for a, b in zip(tree_leaves(ph), tree_leaves(pp_)):
        assert_allclose(a, b, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="hier_dp_fast_axis"):
        tpp.make_pp_train_step(cfg, TMesh((2, 2, 2), names, "cpu"),
                               dp_axis="dcn", hier_dp_fast_axis="pp")


def test_pp_remat_matches_no_remat():
    """remat=True (each layer checkpointed) gives the step without it:
    Llama tiny on (dcn 2, pp 2, tp 2) with the hierarchical reduction,
    losses and leaves within 1e-6."""
    cfg = tllama.LlamaConfig.tiny()
    names = ("dcn", "pp", "tp")
    l0, p0 = _pp_port(cfg, (2, 2, 2), names, dp_axis="dcn", hier="tp")
    l1, p1 = _pp_port(cfg, (2, 2, 2), names, dp_axis="dcn", hier="tp",
                      remat=True)
    assert_allclose(l1, l0, atol=1e-6, rtol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        assert_allclose(a, b, atol=1e-6, rtol=1e-6)


def test_pp_matches_non_pp_tp_step():
    """Microbatching and stages are math-neutral: the PP step on (pp 2, tp
    2) against the port's TP-2 make_train_step on the same weights and
    tokens, two steps: losses within 1e-5, every layer leaf within 5e-4."""
    cfg = tllama.LlamaConfig.tiny()
    mesh = TMesh((2, 2), ("pp", "tp"), "cpu")
    stacked = tpp.init_pp_params(cfg, seed=24, device="cpu")
    flat = {k: v.clone() for k, v in stacked.items() if k != "layers"}
    flat["layers"] = [{k: v[i].clone() for k, v in stacked["layers"].items()}
                      for i in range(cfg.n_layers)]
    tp_params = tllama.shard_params(flat, cfg, 2)
    pp_params = tpp.place_pp_params(stacked, cfg, mesh)
    tok = torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.vocab, size=(32, 4)))
    tgt = torch.roll(tok, -1, dims=0)
    tp_step = tllama.make_train_step(cfg, 2, lr=0.3)
    pp_step, _ = tpp.make_pp_train_step(cfg, mesh, n_micro=2, lr=0.3)
    # make_pp_grads: the step's gradients, in the PP layout
    lp, gp = tpp.make_pp_grads(cfg, mesh, n_micro=2)(pp_params, tok, tgt)
    lt, gt = value_and_grad(tllama.loss_shard, tp_params, tok, tgt, cfg,
                            world=2)
    assert_allclose(lp, lt, atol=1e-5, rtol=1e-5)
    for i, layer in enumerate(gt["layers"]):
        for k, v in layer.items():
            assert_allclose(gp["layers"][k][i], v, atol=1e-5, rtol=1e-4)
    assert_allclose(gp["embed"], gt["embed"], atol=1e-5, rtol=1e-4)
    for _ in range(2):
        _, lt = tp_step(tp_params, tok, tgt)
        _, lp = pp_step(pp_params, tok, tgt)
        assert_allclose(lp, lt, atol=1e-5, rtol=1e-5)
    for k in ("embed", "lm_head", "final_norm"):
        assert_allclose(pp_params[k], tp_params[k], atol=5e-4, rtol=5e-4)
    for i, layer in enumerate(tp_params["layers"]):
        for k, v in layer.items():
            assert_allclose(pp_params["layers"][k][i], v, atol=5e-4,
                            rtol=5e-4)


@pytest.mark.parametrize("family", ["llama", "moe"])
def test_dp_train_step_matches_reference(family):
    """make_train_step(cfg, 2, dp=2), the trainer's --dp 2 --tp 2, against
    the reference's make_train_step over a (dp 2, tp 2) mesh
    (``impl="xla"``): one step, the loss within 1e-5 and every updated
    leaf within 5e-4 (the MoE balance loss is each dp rank's own, their
    mean)."""
    jfam, tfam = (jllama, tllama) if family == "llama" else (jmoe, tmoe)
    jcfg, tcfg = jfam.LlamaConfig.tiny() if family == "llama" else \
        jfam.MoEConfig.tiny(), tfam.LlamaConfig.tiny() if family == "llama" \
        else tfam.MoEConfig.tiny()
    jmesh = _jmesh((2, 2), ("dp", "tp"))
    jparams = jfam.init_params(jcfg, jax.random.key(26))
    host = jax.device_get(jparams)
    tok = np.random.default_rng(27).integers(0, jcfg.vocab, size=(32, 4))
    tgt = np.roll(tok, -1, axis=0)
    sh = NamedSharding(jmesh, P("tp", "dp"))
    jstep, _ = jfam.make_train_step(jcfg, jmesh, axis="tp", dp_axis="dp",
                                    impl="xla", lr=0.5)
    jnew, jloss = jstep(jfam.place_params(jparams, jcfg, jmesh),
                        jax.device_put(jnp.asarray(tok, jnp.int32), sh),
                        jax.device_put(jnp.asarray(tgt, jnp.int32), sh))
    tparams = tfam.shard_params(tfam.params_from_jax(host, tcfg,
                                                     device="cpu"), tcfg, 2)
    _, tloss = tfam.make_train_step(tcfg, 2, lr=0.5, dp=2)(
        tparams, torch.as_tensor(tok), torch.as_tensor(tgt))
    assert_allclose(tloss, np.asarray(jloss), atol=1e-5, rtol=1e-5)
    want = tfam.shard_params(tfam.params_from_jax(jax.device_get(jnew), tcfg,
                                                  device="cpu"), tcfg, 2)
    for g, w in zip(tree_leaves(tparams), tree_leaves(want)):
        assert_allclose(g, w, atol=5e-4, rtol=5e-4)


def test_train_cli_dp_tp_runs(capsys):
    """examples/train.py --dp 2 --tp 2 on the CPU (the dcn x tp mesh): the
    loss falls; a batch that does not split over --dp is refused."""
    from triton_dist_tpu_torch.examples import train

    train.main(["--dp", "2", "--tp", "2", "--device", "cpu", "--steps", "3",
                "--seq", "16", "--batch", "4", "--lr", "0.5"])
    out = capsys.readouterr().out
    assert "dp=2" in out and "tp=2" in out and "done" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and losses[-1] < losses[0]
    with pytest.raises(SystemExit, match="does not split"):
        train.main(["--dp", "3", "--device", "cpu", "--batch", "4"])


# ---------------------------------------------------------------------------
# The torus (multi-axis) collectives and ring GEMMs against the reference's
# interpret-mode Pallas kernels (spied), at its tests' shapes
# ---------------------------------------------------------------------------


def _torus_jmesh(shape, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                names)


def _torus_spy(monkeypatch, module, name):
    """Record each trace of ``module.name`` (the Pallas kernel body)."""
    kernel, traced = getattr(module, name), []

    def spy(*a, **kw):
        traced.append(name)
        return kernel(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return traced


def _torus_per_rank(fn, jmesh, in_spec, x):
    """Every rank's result of jit(shard_map(fn)), stacked in world-rank
    order."""
    out = jax.jit(jax.shard_map(
        lambda s: fn(s)[None], mesh=jmesh, in_specs=(in_spec,),
        out_specs=P(jmesh.axis_names), check_vma=False))(x)
    return np.asarray(out.astype(jnp.float32))


def _torus_dtypes(dtype):
    return ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
            else (jnp.float32, torch.float32))


TORUS_AG_CASES = {
    # name: (mesh shape, names, joint axes, rows a rank, dtype): the
    # reference's test_torus2d_allgather rows 8 and 6 (uneven quarters) and
    # test_torus3d_allgather_bf16_uneven (rows 7: uneven sixths)
    "2x4_rows8": ((2, 4), ("x", "y"), ("x", "y"), 8, "f32"),
    "2x4_rows6": ((2, 4), ("x", "y"), ("x", "y"), 6, "f32"),
    "2x2x2_bf16_rows7": ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"), 7,
                         "bf16"),
}


@pytest.mark.parametrize("name", sorted(TORUS_AG_CASES))
def test_torus_all_gather_matches_pallas(name, monkeypatch):
    """``torus_all_gather_shard``'s plain version against the reference's
    interpret-mode ``_torus_ag_kernel`` (spied): every rank's gathered
    shards bit for bit, flat axes-major; the port's rank r holds the row
    block of its joint index."""
    from triton_dist_tpu.kernels import torus as jtorus
    from triton_dist_tpu_torch.kernels import torus as ttorus

    shape, names, axes, rows, dt = TORUS_AG_CASES[name]
    jdt, tdt = _torus_dtypes(dt)
    traced = _torus_spy(monkeypatch, jtorus, "_torus_ag_kernel")
    W = int(np.prod(shape))
    x = np.random.default_rng(400 + rows).standard_normal(
        (W * rows, 128)).astype(np.float32)
    want = _torus_per_rank(
        lambda s: jtorus.torus_all_gather_shard(s, axes, interpret=True),
        _torus_jmesh(shape, names), P(axes), jnp.asarray(x).astype(jdt))
    assert traced
    mesh = TMesh(shape, names, "cpu")
    xt = torch.from_numpy(x).to(tdt).reshape(W, rows, 128)
    xt = xt[torch.tensor(mesh.joint_index(axes))].reshape(*shape, rows, 128)
    got = ttorus.torus_all_gather_shard(xt, mesh, axes)
    assert got.shape == (*shape, W * rows, 128)
    assert np.array_equal(got.float().reshape(want.shape).numpy(), want)


TORUS_RS_CASES = {
    # name: (mesh shape, names, joint axes, rows a band, dtype): the
    # reference's 2-D RS with distinct partials (rows 5: uneven quarters)
    # and its 3-D RS (rows 6: one a path), that one in bf16
    "2x4_f32_rows5": ((2, 4), ("x", "y"), ("x", "y"), 5, "f32"),
    "2x2x2_bf16_rows6": ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z"), 6,
                         "bf16"),
}


@pytest.mark.parametrize("name", sorted(TORUS_RS_CASES))
def test_torus_reduce_scatter_matches_pallas(name, monkeypatch):
    """``torus_reduce_scatter_shard``'s plain version against the
    reference's interpret-mode ``_torus_rs_kernel`` (spied), a distinct
    partial on every rank: bit for bit in f32 and bf16 (the reference's
    torus order and rounding), where the joint-order sum differs."""
    from triton_dist_tpu.kernels import torus as jtorus
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs
    from triton_dist_tpu_torch.kernels import torus as ttorus

    shape, names, axes, rows, dt = TORUS_RS_CASES[name]
    jdt, tdt = _torus_dtypes(dt)
    traced = _torus_spy(monkeypatch, jtorus, "_torus_rs_kernel")
    W = int(np.prod(shape))
    parts = np.random.default_rng(410 + rows).standard_normal(
        (W, W * rows, 128)).astype(np.float32)
    want = _torus_per_rank(
        lambda s: jtorus.torus_reduce_scatter_shard(s[0], axes,
                                                    interpret=True),
        _torus_jmesh(shape, names), P(names), jnp.asarray(parts).astype(jdt))
    assert traced
    mesh = TMesh(shape, names, "cpu")
    xt = torch.from_numpy(parts).to(tdt).reshape(*shape, W * rows, 128)
    got = ttorus.torus_reduce_scatter_shard(xt, mesh, axes)
    assert got.shape == (*shape, rows, 128)
    assert np.array_equal(got.float().reshape(want.shape).numpy(), want)
    assert not torch.equal(got, trs.joint_sum_ref(xt, mesh, axes))


def test_torus_gemm_rs_matches_pallas(monkeypatch):
    """The host ``gemm_rs`` over ("x", "y") of a (2, 2) mesh against the
    reference's interpret-mode ``_torus_gemm_rs_kernel`` (spied) at
    test_torus_gemm_rs_fused_small's case (M 32, K 512, N 512, f32: k_loc
    128, so the fused kernel runs), within its 2e-3."""
    from triton_dist_tpu.kernels import gemm_reduce_scatter as jgrs
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as tgrs

    traced = _torus_spy(monkeypatch, jgrs, "_torus_gemm_rs_kernel")
    rng = np.random.default_rng(420)
    M, K, N = 32, 512, 512
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    want = jgrs.gemm_rs(jnp.asarray(a), jnp.asarray(b),
                        jgrs.GEMMReduceScatterContext(
                            mesh=_torus_jmesh((2, 2), ("x", "y")),
                            axis=("x", "y"), impl="pallas", interpret=True))
    assert traced
    ctx = tgrs.create_gemm_rs_context(TMesh((2, 2), ("x", "y"), "cpu"),
                                      axis=("x", "y"), impl="pallas")
    got = tgrs.gemm_rs(torch.from_numpy(a), torch.from_numpy(b), ctx)
    assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3)
    assert_allclose(got, a @ b, atol=2e-3, rtol=2e-3)


def test_torus_ag_gemm_matches_pallas(monkeypatch):
    """The host ``ag_gemm_gathered`` over ("x", "y") of a (2, 4) mesh
    against the reference's interpret-mode ``_torus_ag_gemm_kernel``
    (spied) at test_torus_ag_gemm's case (M 64, K 128, N 1024, f32):
    the gathered A bit for bit, C within its 2e-3."""
    from triton_dist_tpu.kernels import allgather_gemm as jagm
    from triton_dist_tpu_torch.kernels import allgather_gemm as tagm

    traced = _torus_spy(monkeypatch, jagm, "_torus_ag_gemm_kernel")
    rng = np.random.default_rng(430)
    M, K, N = 64, 128, 8 * 128
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    want_full, want_c = jagm.ag_gemm_gathered(
        jnp.asarray(a), jnp.asarray(b), jagm.AllGatherGEMMContext(
            mesh=_torus_jmesh((2, 4), ("x", "y")), axis=("x", "y"),
            impl="pallas", interpret=True))
    assert traced
    ctx = tagm.create_ag_gemm_context(TMesh((2, 4), ("x", "y"), "cpu"),
                                      axis=("x", "y"), impl="pallas")
    full, c = tagm.ag_gemm_gathered(torch.from_numpy(a),
                                    torch.from_numpy(b), ctx)
    assert np.array_equal(full.numpy(), np.asarray(want_full))
    assert_allclose(c, np.asarray(want_c), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------------
# Every model path hands the bf16 flash forward operands its TMA reads
# ---------------------------------------------------------------------------


def _model_path(path):
    """Run one model path's CPU forward at a small size (head dim 128:
    the port's ``tiny`` configs)."""
    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    cfg = tllama.LlamaConfig.tiny()
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1024, 1)))
    if path == "moe":
        mcfg = tmoe.MoEConfig.tiny()
        tmoe.forward_shard(tmoe.init_params(mcfg, device="cpu"), tok[:64],
                           mcfg)
        return
    params = tllama.init_params(cfg, device="cpu")
    if path == "llama_train":
        for leaf in params["layers"][0].values():
            leaf.requires_grad_()
        tllama.forward_shard(params, tok[:128], cfg).sum().backward()
    elif path == "llama_tp2":
        tllama.forward_shard(tllama.shard_params(params, cfg, 2), tok[:128],
                             cfg, world=2)
    elif path in ("cp_zigzag", "cp_ulysses"):
        attn, zz = ("ring", True) if path == "cp_zigzag" else ("ulysses",
                                                               None)
        # S 1024: the auto rule takes the zigzag flash ring (S_loc 256)
        tcp.make_cp_forward(cfg, 4, attn=attn, zigzag=zz)(params, tok)
    else:
        mesh = get_world(4, "cpu") if path == "sp_generator" else None
        gen = Generator(cfg, mesh=mesh, max_seq=256, device="cpu")
        st = gen.prefill_chunked(params, tok[:200].T.numpy(), chunk_size=48)
        gen.generate(params, st, 2)


@pytest.mark.parametrize("path", ["llama_train", "llama_tp2", "moe",
                                  "cp_zigzag", "cp_ulysses",
                                  "generator_chunked", "sp_generator"])
def test_model_paths_hand_flash_tma_operands(path, monkeypatch):
    """A hook on the flash forward records the (shape, strides, offset)
    of every q / k / v a model path passes; each must meet
    ``flash_operand_ok`` (the bf16 kernel's TMA rule, read at bf16), so
    no model path raises on the card."""
    from triton_dist_tpu_torch.kernels import flash_attention as tfa

    seen, real = [], tfa._flash_fwd

    def spy(q, k, v, **kw):
        seen.extend((tuple(x.shape), tuple(x.stride()), x.storage_offset())
                    for x in (q, k, v))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "_flash_fwd", spy)
    with torch.no_grad() if path != "llama_train" else torch.enable_grad():
        _model_path(path)
    assert seen, f"{path}: no flash forward call"
    bad = [s for s in seen
           if not tfa.flash_operand_ok(s[0], s[1], torch.bfloat16, s[2])]
    assert not bad, f"{path}: operands the kernel would refuse: {bad[:3]}"


def test_quantized_generator_hands_flash_i8_a_tma_q(monkeypatch):
    """The int8 flash forward reads q by TMA as the bf16 one does (and its
    int8 K / V rows by 1-D bulk copies): every call the int8-cache
    Generator's chunked prefill makes holds q to ``flash_operand_ok`` and
    the int8 rows to the copies' rule (unit last stride, 16-byte
    strides), so the quantized path never raises on the card."""
    from triton_dist_tpu_torch.kernels import flash_attention as tfa
    from triton_dist_tpu_torch.models.generate import Generator

    seen, real = [], tfa.flash_attention_ref

    def spy(q, k, v, **kw):
        if kw.get("k_scale") is not None:
            seen.append((tuple(q.shape), tuple(q.stride()),
                         q.storage_offset(), k.stride(), v.stride()))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention_ref", spy)
    cfg = tllama.LlamaConfig.tiny()
    tok = np.random.default_rng(5).integers(0, cfg.vocab, size=(1, 200))
    gen = Generator(cfg, max_seq=256, device="cpu", kv_dtype=torch.int8)
    with torch.no_grad():
        gen.prefill_chunked(tllama.init_params(cfg, device="cpu"), tok,
                            chunk_size=48)
    assert seen, "no int8 flash forward call"
    bad = [s for s in seen
           if not tfa.flash_operand_ok(s[0], s[1], torch.bfloat16, s[2])
           or any(st[-1] != 1 or any(x % 16 for x in st[:-1])
                  for st in s[3:])]
    assert not bad, f"operands the int8 kernel would refuse: {bad[:3]}"


# ---------------------------------------------------------------------------
# Every model path hands the uni AG-GEMM operands its TMA reads
# ---------------------------------------------------------------------------


def _ag_gemm_path(path):
    """Run one model path that reaches the AG-GEMM (TP 4 training, the W8A8
    TP-4 forward, a PP step on (pp 2, tp 2), the autotuned host entry) on
    the CPU at the tiny config."""
    from triton_dist_tpu_torch import autotuner as tat
    from triton_dist_tpu_torch.kernels import allgather_gemm as tag
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8

    cfg = tllama.LlamaConfig.tiny()
    rng = np.random.default_rng(7)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(128, 2)))
    if path == "llama_tp4_train":
        params = tllama.shard_params(tllama.init_params(cfg, device="cpu"),
                                     cfg, 4)
        for leaf in params["layers"][0].values():
            leaf.requires_grad_()
        tllama.forward_shard(params, tok, cfg, world=4).sum().backward()
    elif path == "w8a8_tp4":
        tq = tw8.place_w8a8_params(tw8.quantize_params_w8a8(
            tllama.init_params(cfg, device="cpu"), cfg, 4), cfg, 4)
        tw8.make_w8a8_forward(cfg, 4)(tq, tok)
    elif path == "pp":
        mesh = TMesh((2, 2), ("pp", "tp"), "cpu")
        params = tpp.place_pp_params(tpp.init_pp_params(cfg, device="cpu"),
                                     cfg, mesh)
        step, _ = tpp.make_pp_train_step(cfg, mesh, dp_axis=None, n_micro=2,
                                         lr=0.3)
        step(params, tok[:32], torch.roll(tok[:32], -1, 0))
    else:
        mesh = TMesh((4,), ("tp",), "cpu")
        a = torch.from_numpy(rng.standard_normal((256, 512)).astype(
            np.float32))
        b = torch.from_numpy(rng.standard_normal((512, 1024)).astype(
            np.float32))

        @tat.contextual_autotune(n_repeat=1, n_warmup=1)
        def op(x, w):
            return tag.ag_gemm_autotuned(x, w,
                                         tag.create_ag_gemm_context(mesh))

        op(a, b)


@pytest.mark.parametrize("path", ["llama_tp4_train", "w8a8_tp4", "pp",
                                  "autotuned"])
def test_model_paths_hand_ag_gemm_tma_operands(path, monkeypatch):
    """A hook on the AG-GEMM's dispatch records the (shape, strides,
    offset) of every rank-stacked a and b a model path passes (the uni
    bf16 calls, B^T ones of the backward included, and the int8 calls);
    each must meet ``ag_gemm_operand_ok`` (the uni kernels' TMA rule, read
    at bf16 or int8), so no model path raises on the card."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as tag

    seen, real = [], tag._ag_gemm

    def spy(a, b, **kw):
        dtype = torch.int8 if a.dtype == torch.int8 else torch.bfloat16
        seen.extend((tuple(x.shape), tuple(x.stride()), x.storage_offset(),
                     dtype, kw["trans_b"]) for x in (a, b))
        return real(a, b, **kw)

    monkeypatch.setattr(tag, "_ag_gemm", spy)
    with torch.enable_grad() if path in ("llama_tp4_train", "pp") else \
            torch.no_grad():
        _ag_gemm_path(path)
    assert seen, f"{path}: no AG-GEMM call"
    if path == "llama_tp4_train":
        assert any(s[4] for s in seen), "no B^T call in the backward"
    if path == "w8a8_tp4":
        assert all(s[3] == torch.int8 for s in seen)
    bad = [s for s in seen if not tag.ag_gemm_operand_ok(s[0], s[1], s[3],
                                                         s[2])]
    assert not bad, f"{path}: operands the kernel would refuse: {bad[:3]}"
