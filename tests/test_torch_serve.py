"""The port's serving stack against the JAX reference, on the CPU.

- The copied jax-free modules (``BlockManager``, ``FCFSScheduler``,
  ``Request``, ``RequestMetrics``) under the pure-index units of
  tests/test_serve_engine.py, pointed at the copies.
- The port's ``ServeEngine`` (world 1, float pools, plain attention on
  CPU tensors) against the JAX ``ServeEngine(prefix_cache=False)`` on the
  same weights and a staggered mix whose pool forces a preemption: greedy
  streams must be identical to the JAX engine's and to the port's own
  per-request ``Generator``, and the metrics counters equal to the JAX
  engine's (a deterministic +1-per-reading clock drives both).
- The same against the JAX engine serving quantized: int8 paged KV pools
  (``kv_dtype`` int8), alone and with W8A8 weights — identical streams,
  counters and KV capacity stats; the quantized stream reproducible and
  continuous batching equal to dedicated serving.
- Sharded serving over a virtual world: ``kv_shard="seq"`` and
  ``kv_shard="heads"`` (float and int8 pools: greedy streams identical to
  the port's world-1 engine and the reference's mesh engine; W8A8: its
  tokens against the reference's at the floor the test states), and each
  layout's geometry rejections.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu import serve as jserve
from triton_dist_tpu.models import llama as jllama
from triton_dist_tpu.models.generate import Generator as JGenerator
from triton_dist_tpu_torch import serve as tserve
from triton_dist_tpu_torch.models import llama as tllama
from triton_dist_tpu_torch.models.generate import Generator as TGenerator
from triton_dist_tpu_torch.serve.block_manager import (
    BlockExhausted,
    BlockManager,
)
from triton_dist_tpu_torch.serve.engine import build_bucket_ladder
from triton_dist_tpu_torch.serve.metrics import RequestMetrics, ServeMetrics
from triton_dist_tpu_torch.serve.request import (
    FinishReason,
    Request,
    SamplingParams,
)
from triton_dist_tpu_torch.serve.scheduler import (
    FCFSScheduler,
    ReqState,
    Status,
)

# ---------------------------------------------------------------------------
# pure-index units (tests/test_serve_engine.py, pointed at the copies)
# ---------------------------------------------------------------------------


def test_block_manager_alloc_extend_free():
    bm = BlockManager(num_blocks=9, page_size=4)  # 8 allocatable
    assert bm.num_allocatable == 8 and bm.num_free == 8
    a = bm.allocate("a", 9)            # ceil(9/4) = 3 pages
    assert len(a) == 3 and bm.num_free == 5
    assert bm.capacity_tokens("a") == 12
    assert bm.ensure("a", 11) == []    # already covered
    grown = bm.ensure("a", 13)         # needs a 4th page
    assert len(grown) == 1 and bm.capacity_tokens("a") == 16
    assert bm.utilization == pytest.approx(4 / 8)
    bm.allocate("b", 16)
    assert bm.num_free == 0
    with pytest.raises(BlockExhausted):
        bm.ensure("a", 17)
    with pytest.raises(BlockExhausted):
        bm.allocate("c", 1)
    bm.free("b")
    assert bm.num_free == 4 and bm.utilization == pytest.approx(4 / 8)
    with pytest.raises(ValueError):
        bm.allocate("a", 4)            # duplicate rid


def test_block_manager_null_block_reserved():
    bm = BlockManager(num_blocks=5, page_size=8)
    held = bm.allocate("a", 32)        # everything allocatable
    assert 0 not in held               # block 0 is the reserved null block
    padded = bm.padded_table("a", 6)
    assert padded[:4] == held and padded[4:] == [0, 0]
    with pytest.raises(ValueError):
        bm.padded_table("a", 3)        # narrower than the allocation
    bm.free("a")
    assert 0 not in bm._free


def _rs(rid, n_prompt, max_new=4):
    req = Request(rid, np.zeros((n_prompt,), np.int32),
                  SamplingParams(max_new_tokens=max_new))
    return ReqState(req=req, metrics=RequestMetrics(arrival_time=0.0))


def _sched(num_blocks=9, page=4, budget=8, chunk=4):
    bm = BlockManager(num_blocks, page)
    return FCFSScheduler(bm, prefill_budget=budget,
                         prefill_chunk=chunk), bm


def test_scheduler_fcfs_admission_and_headroom():
    sched, bm = _sched(num_blocks=8, page=4)    # 7 allocatable
    a, b = _rs("a", 26), _rs("b", 2)
    sched.add(a)
    sched.add(b)
    admitted = sched.admit([0, 1], now=1.0)
    assert [r.req.request_id for r in admitted] == ["a"]
    assert sched.queue_depth == 1
    assert a.status is Status.PREFILL and a.slot == 0
    assert a.metrics.first_scheduled_time == 1.0
    bm.free("a")
    assert [r.req.request_id for r in sched.admit([0], 2.0)] == ["b"]


def test_scheduler_prefill_budget_assignment():
    sched, bm = _sched(budget=8, chunk=4, num_blocks=33, page=4)
    rs1, rs2, rs3 = _rs("r1", 20), _rs("r2", 20), _rs("r3", 20)
    for r in (rs1, rs2, rs3):
        sched.add(r)
    sched.admit([0, 1, 2], now=0.0)
    plan = sched.prefill_plan([rs3, rs1, rs2])
    assert [(r.req.request_id, n) for r, n in plan] == [("r1", 8)]
    rs1.prefill_pos = 18
    plan = sched.prefill_plan([rs1, rs2, rs3])
    assert [(r.req.request_id, n) for r, n in plan] == [("r1", 2),
                                                        ("r2", 4)]
    sched.prefill_budget = 2
    rs1.prefill_pos = 0
    assert sched.prefill_plan([rs1]) == [(rs1, 4)]


def test_scheduler_prefill_plan_full_chunks_only():
    sched, bm = _sched(budget=10, chunk=4, num_blocks=33, page=4)
    rs1, rs2 = _rs("r1", 19), _rs("r2", 19)
    sched.add(rs1)
    sched.add(rs2)
    sched.admit([0, 1], now=0.0)
    for start in range(0, 19, 4):
        rs1.prefill_pos = start
        rs2.prefill_pos = 0
        for rs, n in sched.prefill_plan([rs1, rs2]):
            remaining = 19 - rs.prefill_pos
            assert n % 4 == 0 or n == remaining, (rs.req.request_id, n)


def test_scheduler_preempt_requeues_front_for_recompute():
    sched, bm = _sched(num_blocks=9, page=4)
    a, b = _rs("a", 4), _rs("b", 4)
    sched.add(a)
    sched.add(b)
    sched.admit([0, 1], now=0.0)
    b.generated = [7, 9]
    b.kv_len = 6
    held_before = bm.num_free
    assert sched.pick_victim([a, b], needy=a) is b
    assert sched.pick_victim([b], needy=b) is None
    sched.preempt(b)
    assert bm.num_free > held_before
    assert sched.waiting[0] is b and b.status is Status.WAITING
    assert list(b.work_prompt) == [0, 0, 0, 0, 7, 9]
    assert b.kv_len == 0 and b.slot is None
    assert b.metrics.n_preemptions == 1


def test_request_and_params_validation():
    with pytest.raises(ValueError):
        Request("x", np.zeros((0,), np.int32))
    with pytest.raises(ValueError):
        SamplingParams(max_new_tokens=0)
    with pytest.raises(ValueError):
        SamplingParams(temperature=-0.5)
    assert SamplingParams().greedy
    assert not SamplingParams(temperature=0.7).greedy


def test_metrics_latency_math():
    rm = RequestMetrics(arrival_time=10.0)
    rm.on_scheduled(12.0)
    rm.on_scheduled(13.0)          # first-write-wins
    for t in (15.0, 16.0, 18.0):
        rm.on_token(t)
    assert rm.ttft == 5.0 and rm.queue_time == 2.0
    assert rm.inter_token_latencies == [1.0, 2.0]
    assert rm.mean_itl == 1.5
    sm = ServeMetrics()
    sm.observe_step(queue_depth=3, running=2, kv_utilization=0.5)
    sm.observe_step(queue_depth=0, running=1, kv_utilization=0.25)
    sm.observe_finish("r", rm)
    s = sm.summary()
    assert s["max_queue_depth"] == 3
    assert s["peak_kv_utilization"] == 0.5
    assert s["mean_ttft"] == 5.0 and s["completed"] == 1
    assert s["requests"]["r"]["n_tokens"] == 3


def test_build_bucket_ladder():
    assert build_bucket_ladder(8, 63, 8) == [8, 16, 32, 64]
    assert build_bucket_ladder(16, 16, 8) == [16]
    assert build_bucket_ladder(4, 100, 8) == [8, 16, 32, 64, 104]
    ladder = build_bucket_ladder(5, 1000, 4)
    assert ladder[0] == 8 and ladder[-1] == 1000
    assert all(r % 4 == 0 for r in ladder)
    with pytest.raises(ValueError):
        build_bucket_ladder(0, 64, 8)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

SMALL = dict(vocab=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             ffn_dim=512, max_seq=64)
# a staggered mix: two long requests that cannot both reach full length in
# 7 blocks of 8 (the later one is preempted and recomputed), then two short
# ones joining mid-flight
MIX = [(16, 16), (16, 16), (5, 6), (11, 9)]
ENGINE_KW = dict(num_blocks=7, page_size=8, max_batch=2, prefill_chunk=8)


class _Tick:
    """Deterministic engine clock: +1 per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


@pytest.fixture(scope="module")
def served():
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**SMALL)
    jparams = jllama.init_params(jcfg, jax.random.key(1))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, SMALL["vocab"], size=n).astype(np.int32)
               for n, _ in MIX]

    def drive(mod, eng):
        reqs = [mod.Request(f"r{i}", p, mod.SamplingParams(max_new_tokens=m))
                for i, (p, (_, m)) in enumerate(zip(prompts, MIX))]
        outs, sub, step = {}, 0, 0
        while eng.has_work() or sub < len(reqs):
            if step % 2 == 0 and sub < len(reqs):
                eng.submit(reqs[sub])
                sub += 1
            for o in eng.step():
                outs[o.request_id] = o
            step += 1
            assert step < 500
        return outs

    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    jeng = jserve.ServeEngine(JGenerator(jcfg, mesh, axis="sp", max_seq=64),
                              jparams, prefix_cache=False, clock=_Tick(),
                              **ENGINE_KW)
    jouts = drive(jserve, jeng)
    tgen = TGenerator(tcfg, max_seq=64, device="cpu")
    teng = tserve.ServeEngine(tgen, tparams, clock=_Tick(), **ENGINE_KW)
    touts = drive(tserve, teng)
    return dict(prompts=prompts, jeng=jeng, jouts=jouts, teng=teng,
                touts=touts, tgen=tgen, tparams=tparams, tcfg=tcfg)


def test_engine_streams_match_jax_engine(served):
    jouts, touts = served["jouts"], served["touts"]
    assert sorted(touts) == sorted(jouts) == [f"r{i}" for i in
                                              range(len(MIX))]
    for rid in jouts:
        assert touts[rid].token_ids == jouts[rid].token_ids, rid
        assert touts[rid].finish_reason.value == \
            jouts[rid].finish_reason.value == "length"
    assert served["teng"].metrics.preemptions >= 1
    assert touts["r1"].metrics.n_preemptions >= 1   # LIFO victim


def test_engine_streams_match_generator(served):
    gen, params = served["tgen"], served["tparams"]
    for i, (p, (_, m)) in enumerate(zip(served["prompts"], MIX)):
        toks, _ = gen.generate(params, gen.prefill(params, p[None]), m)
        assert served["touts"][f"r{i}"].token_ids == toks[0].tolist()


def test_engine_metrics_match_jax_engine(served):
    js = served["jeng"].metrics.summary()
    ts = served["teng"].metrics.summary()
    for key in ("steps", "decode_steps", "prefill_tokens", "preemptions",
                "completed", "max_queue_depth", "peak_kv_utilization",
                "mean_kv_utilization", "mean_running", "mean_ttft",
                "max_ttft", "mean_itl"):
        assert ts[key] == pytest.approx(js[key]), key
    for key in ("decode_steps", "decode_tokens", "dispatches", "host_syncs"):
        assert ts["decode"][key] == js["decode"][key], key
    for key in ("ttft", "itl", "queue"):
        assert ts["latency"][key]["count"] == js["latency"][key]["count"]
        assert ts["latency"][key]["p50"] == pytest.approx(
            js["latency"][key]["p50"])
    for rid, jr in js["requests"].items():
        tr = ts["requests"][rid]
        for key in ("ttft", "queue_time", "mean_itl", "n_tokens",
                    "n_preemptions", "finish_time"):
            assert tr[key] == pytest.approx(jr[key]), (rid, key)
    # everything returned to the pool, every slot free
    eng = served["teng"]
    assert eng.bm.num_free == eng.bm.num_allocatable
    assert all(s is None for s in eng.slots)


def _small_engine(served, kv_dtype=None, **kw):
    gen = TGenerator(served["tcfg"], max_seq=64, device="cpu",
                     kv_dtype=kv_dtype)
    args = dict(ENGINE_KW, num_blocks=24, clock=_Tick())
    args.update(kw)
    return tserve.ServeEngine(gen, served["tparams"], **args)


def test_engine_sampled_streams_are_seeded(served):
    """Seeded draws keyed by (seed, emission index): two engines give the
    same stream, a different seed another one."""
    def run(seed):
        eng = _small_engine(served)
        p = served["prompts"][3]
        eng.submit(Request("s", p, SamplingParams(
            max_new_tokens=8, temperature=0.9, top_k=50, seed=seed)))
        return eng.run()["s"].token_ids

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    assert all(0 <= t < SMALL["vocab"] for t in a)


def test_engine_eos_and_streaming(served):
    greedy = served["touts"]["r2"].token_ids
    seen = []
    eng = _small_engine(served)
    eng.submit(Request("e", served["prompts"][2],
                       SamplingParams(max_new_tokens=6, eos_id=greedy[2]),
                       on_token=lambda rid, t: seen.append((rid, t))))
    out = eng.run()["e"]
    assert out.token_ids == greedy[:3]
    assert out.finish_reason is FinishReason.EOS
    assert seen == [("e", t) for t in greedy[:3]]


def test_engine_pool_too_small_retires_with_error(served):
    """A request that cannot grow even after preempting everyone else
    retires ERROR (partial output kept, blocks freed) instead of
    unwinding the step loop — the reference's no-victim exit."""
    eng = _small_engine(served, num_blocks=6, page_size=4, max_batch=1,
                        prefill_chunk=4)
    with pytest.raises(ValueError):           # can never fit: refused
        eng.submit(Request("huge", np.zeros((40,), np.int32),
                           SamplingParams(max_new_tokens=20)))
    p = np.arange(4, dtype=np.int32)
    eng.submit(Request("needy", p, SamplingParams(max_new_tokens=12)))
    eng.step()                                # admitted + first token
    # a foreign allocation eats the rest of the pool; "needy" is the only
    # slot holder, so its grow has no victim
    eng.bm.allocate("__foreign", 12)
    with pytest.raises(RuntimeError, match="no preemption victim"):
        eng._ensure_capacity(eng._states["needy"], 16)
    out = eng.run()["needy"]
    assert out.finish_reason is FinishReason.ERROR
    assert "no preemption victim" in out.error
    assert len(out.token_ids) >= 1
    eng.bm.free("__foreign")
    assert eng.bm.num_free == eng.bm.num_allocatable
    assert all(s is None for s in eng.slots)


@pytest.mark.parametrize("option", [
    dict(horizon=4), dict(prefix_cache=True), dict(spec_k=2),
    dict(class_aware=True), dict(mesh=object()), dict(max_queue=4),
    dict(snapshot_dir="snap"),
])
def test_engine_unported_options_raise(served, option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _small_engine(served, **option)


def test_engine_refuses_deadlines_and_duplicates(served):
    eng = _small_engine(served)
    p = served["prompts"][2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(Request("d", p, SamplingParams(deadline_s=5.0)))
    eng.submit(Request("x", p))
    with pytest.raises(ValueError):
        eng.submit(Request("x", p))


# ---------------------------------------------------------------------------
# quantized serving: int8 pools, alone and with W8A8 weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["int8", "int8_w8a8"])
def served_q(request, served):
    """The MIX (with its preemption) through the JAX and the port engines
    with int8 pools (and W8A8 weights), on the float fixture's weights."""
    w8a8 = request.param == "int8_w8a8"
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(1))
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    prompts = served["prompts"]

    def drive(mod, eng):
        reqs = [mod.Request(f"r{i}", p, mod.SamplingParams(max_new_tokens=m))
                for i, (p, (_, m)) in enumerate(zip(prompts, MIX))]
        outs, sub, step = {}, 0, 0
        while eng.has_work() or sub < len(reqs):
            if step % 2 == 0 and sub < len(reqs):
                eng.submit(reqs[sub])
                sub += 1
            for o in eng.step():
                outs[o.request_id] = o
            step += 1
            assert step < 500
        return outs

    jeng = jserve.ServeEngine(
        JGenerator(jcfg, mesh, axis="sp", max_seq=64, kv_dtype=jnp.int8),
        jparams, prefix_cache=False, clock=_Tick(), w8a8=w8a8, **ENGINE_KW)
    jouts = drive(jserve, jeng)
    teng = tserve.ServeEngine(
        TGenerator(served["tcfg"], max_seq=64, device="cpu",
                   kv_dtype=torch.int8),
        served["tparams"], clock=_Tick(), w8a8=w8a8, **ENGINE_KW)
    touts = drive(tserve, teng)
    return dict(jeng=jeng, jouts=jouts, teng=teng, touts=touts, w8a8=w8a8)


def test_quantized_engine_matches_jax_engine(served_q):
    """Identical greedy streams and counters; the LIFO preemption happens
    and its recompute re-quantizes nothing it should not (the streams
    would split)."""
    jouts, touts = served_q["jouts"], served_q["touts"]
    assert sorted(touts) == sorted(jouts)
    for rid in jouts:
        assert touts[rid].token_ids == jouts[rid].token_ids, rid
    js = served_q["jeng"].metrics.summary()
    ts = served_q["teng"].metrics.summary()
    for key in ("steps", "decode_steps", "prefill_tokens", "preemptions",
                "completed", "peak_kv_utilization", "mean_ttft",
                "mean_itl"):
        assert ts[key] == pytest.approx(js[key]), key
    assert ts["preemptions"] >= 1
    eng = served_q["teng"]
    assert eng.kv_quant and eng.w8a8 == served_q["w8a8"]
    layer = eng._pools[0][0]
    assert layer["q"].dtype == torch.int8 and layer["s"].dtype == \
        torch.float32
    if served_q["w8a8"]:
        assert eng.params["layers"][0]["wgate_q"].dtype == torch.int8
        assert "wgate" not in eng.params["layers"][0]


def test_quantized_kv_stats_match_jax(served_q, served):
    """Pool bytes count int8 pages and their f32 scales: 2 x layers x
    Hkv x (D + 4) bytes per token, as the reference's gauges say."""
    kv = served_q["teng"].metrics.kv_stats()
    assert kv == served_q["jeng"].metrics.kv_stats()
    cfg = served["tcfg"]
    want = 2 * cfg.n_layers * cfg.n_kv_heads * (cfg.head_dim + 4)
    assert kv["quantized"] and kv["bytes_per_token"] == want
    assert kv["token_slots"] == ENGINE_KW["num_blocks"] * \
        ENGINE_KW["page_size"]
    assert served_q["teng"].metrics.summary()["kv"] == kv
    fp = served["teng"].metrics.kv_stats()
    assert fp == served["jeng"].metrics.kv_stats() and not fp["quantized"]
    assert fp["bytes_per_token"] == 2 * cfg.n_layers * cfg.n_kv_heads * \
        cfg.head_dim * 4


def _mixed_reqs(prompts, new_tokens=6):
    """Greedy and seeded-sampled requests: both must be reproducible."""
    return [Request(f"q{i}", p, SamplingParams(
        max_new_tokens=new_tokens, temperature=0.0 if i % 2 == 0 else 0.6,
        top_k=8, seed=i)) for i, p in enumerate(prompts)]


def _serve(eng, reqs, stagger=2):
    sub = step = 0
    while eng.has_work() or sub < len(reqs):
        if step % stagger == 0 and sub < len(reqs):
            eng.submit(reqs[sub])
            sub += 1
        eng.step()
        step += 1
        assert step < 500
    return {rid: list(o.token_ids) for rid, o in eng._outputs.items()}


@pytest.mark.parametrize("w8a8", [False, True])
def test_quantized_engine_reproducible_and_batching_equals_dedicated(
        served, w8a8):
    """The same traffic through two fresh int8 engines is identical, and
    continuous batching over shared int8 pools equals each request served
    alone (pages quantize once at write; batching never re-quantizes a
    neighbour's pages) — tests/test_serve_kv_int8.py's gate (a)."""
    prompts = [p[:9] for p in served["prompts"]]
    kw = dict(kv_dtype=torch.int8, w8a8=w8a8)
    a = _serve(_small_engine(served, **kw), _mixed_reqs(prompts))
    b = _serve(_small_engine(served, **kw), _mixed_reqs(prompts))
    assert a == b
    for r in _mixed_reqs(prompts):
        alone = _serve(_small_engine(served, **kw), [r])
        assert alone[r.request_id] == a[r.request_id], r.request_id


# ---------------------------------------------------------------------------
# sequence-sharded serving: mesh=World(W), kv_shard="seq"
# ---------------------------------------------------------------------------

# two 16-token requests that contend for partition 0 (7 allocatable blocks
# of 8 rows: the seq allocator preempts), one whose span crosses into
# rank 1's partition (positions 32..63), one short one
SEQ_MIX = [(16, 16), (16, 16), (40, 12), (5, 6)]


def _seq_world(W=2):
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    return get_world(W, "cpu")


def _drive_seq(mod, eng, prompts, partitions=None):
    """SEQ_MIX, one request every 2 steps; greedy streams by id.
    ``partitions`` collects every partition that held a page."""
    reqs = [mod.Request(f"r{i}", p, mod.SamplingParams(max_new_tokens=m))
            for i, (p, (_, m)) in enumerate(zip(prompts, SEQ_MIX))]
    sub, step = 0, 0
    while eng.has_work() or sub < len(reqs):
        if step % 2 == 0 and sub < len(reqs):
            eng.submit(reqs[sub])
            sub += 1
        eng.step()
        step += 1
        if partitions is not None:
            for rid in list(eng.bm._tables):
                partitions |= {eng.bm.part_of_block(b)
                               for b in eng.bm.table(rid)}
        assert step < 500
    return {rid: list(o.token_ids) for rid, o in eng._outputs.items()}


@pytest.mark.parametrize("chunk", [8, 40])
def test_engine_seq_streams_match_world1_and_jax(served, chunk):
    """``ServeEngine(mesh=World(2), kv_shard="seq")``: block-partitioned
    pools, the decode through ``sp_gqa_decode_paged_shard`` and the
    combine, chunked prefill attending over rank spans (chunks of 8 ride
    the decode kernel, of 40 the per-rank flash partials): greedy streams
    identical to the port's world-1 engine and to the reference's
    ``ServeEngine(mesh=mesh2, kv_shard="seq")``, with a preemption (16
    blocks in 2 partitions) and a span crossing rank ownership."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, SMALL["vocab"], size=n).astype(np.int32)
               for n, _ in SEQ_MIX]
    kw = dict(page_size=8, max_batch=2, prefill_chunk=chunk, clock=_Tick())
    tgen = TGenerator(tcfg, max_seq=64, device="cpu")
    want = _drive_seq(tserve, tserve.ServeEngine(tgen, tparams,
                                                 num_blocks=24, **kw),
                      prompts)
    parts = set()
    eng = tserve.ServeEngine(tgen, tparams, num_blocks=16, mesh=_seq_world(),
                             kv_shard="seq", **kw)
    assert eng.sp_world == 2 and eng.bm.shards == 2
    got = _drive_seq(tserve, eng, prompts, parts)
    assert got == want
    assert eng.metrics.preemptions >= 1
    assert parts == {0, 1}
    assert eng.bm.num_free == eng.bm.num_allocatable
    # the reference's seq engine on mesh2, on the same weights
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(1))
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("sp",))
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("tp",))
    jeng = jserve.ServeEngine(JGenerator(jcfg, mesh1, axis="sp", max_seq=64),
                              jparams, num_blocks=16, mesh=mesh2,
                              kv_shard="seq", prefix_cache=False, **kw)
    assert _drive_seq(jserve, jeng, prompts) == got
    assert jeng.metrics.preemptions == eng.metrics.preemptions


def test_engine_seq_int8_pools_match_world1(served):
    """int8 paged pools under ``kv_shard="seq"`` (the scales ride with
    their pages; the decode dequantizes per rank, the combine is float):
    greedy streams identical to the port's world-1 int8 engine."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, SMALL["vocab"], size=n).astype(np.int32)
               for n, _ in SEQ_MIX]
    gen = TGenerator(tcfg, max_seq=64, device="cpu", kv_dtype=torch.int8)
    kw = dict(page_size=8, max_batch=2, prefill_chunk=8, clock=_Tick())
    want = _drive_seq(tserve, tserve.ServeEngine(gen, tparams,
                                                 num_blocks=24, **kw),
                      prompts)
    eng = tserve.ServeEngine(gen, tparams, num_blocks=16, mesh=_seq_world(),
                             kv_shard="seq", **kw)
    assert eng.kv_quant
    assert _drive_seq(tserve, eng, prompts) == want


def test_engine_seq_geometry_rejection_rows(served):
    """The ``seq`` rows of tests/test_serve_mesh.py's rejection matrix
    (8 logical pages of 8 rows), plus the layouts not ported yet and W8A8
    (a tensor-parallel weight layout) under seq."""
    tcfg, tparams = served["tcfg"], served["tparams"]
    gen = TGenerator(tcfg, max_seq=64, device="cpu")

    def build(mesh, **kw):
        base = dict(num_blocks=24, page_size=8, max_batch=2,
                    prefill_chunk=4, kv_shard="seq")
        base.update(kw)
        return tserve.ServeEngine(gen, tparams, mesh=mesh, **base)

    with pytest.raises(ValueError, match="kv_shard"):
        build(_seq_world(4), kv_shard="rows")
    with pytest.raises(ValueError, match="kv_shard"):
        build(None, kv_shard="rows")
    with pytest.raises(ValueError, match="logical pages"):
        build(_seq_world(3))                    # 8 pages % 3
    with pytest.raises(ValueError, match="num_blocks"):
        build(_seq_world(4), num_blocks=26)
    with pytest.raises(ValueError, match="null"):
        build(_seq_world(4), num_blocks=4)
    with pytest.raises(ValueError, match="page_size"):
        build(_seq_world(4), page_size=2, num_blocks=64)  # 32 pages, 2 % 4
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build(_seq_world(2), kv_shard="heads+seq")
    # heads is ported: this model's one KV head does not split over 2
    with pytest.raises(ValueError, match="n_kv_heads"):
        build(_seq_world(2), kv_shard="heads")
    # a mesh without a layout takes heads, the reference's default: this
    # model's one KV head refuses it there as here (the same calls on the
    # reference's mesh2)
    with pytest.raises(ValueError, match="n_kv_heads"):
        build(_seq_world(2), kv_shard=None)
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    jparams = jllama.init_params(jcfg, jax.random.key(1))
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("tp",))
    jgen = JGenerator(jcfg, Mesh(np.array(jax.devices()[:1]), ("sp",)),
                      axis="sp", max_seq=64)
    with pytest.raises(ValueError, match="n_kv_heads"):
        jserve.ServeEngine(jgen, jparams, num_blocks=24, page_size=8,
                           max_batch=2, prefill_chunk=4, mesh=mesh2,
                           prefix_cache=False)
    with pytest.raises(ValueError, match="w8a8"):
        build(_seq_world(2), w8a8=True)
    # a span that cannot fit its partition is rejected at submit
    eng = build(_seq_world(2), num_blocks=8)
    with pytest.raises(ValueError, match="partition"):
        eng.submit(Request("long", np.zeros((16,), np.int32),
                           SamplingParams(max_new_tokens=16)))


def test_seq_rebase_and_rank_tables_match_reference(mesh4):
    """``serve.mesh._rebase_local`` against the reference's under
    shard_map on mesh4 (every rank's (mine, local) of the same global
    ids), and the rank tables the SP decode reads (owned ids kept, foreign
    and padded ones on the rank's own null)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu.serve import mesh as jmesh
    from triton_dist_tpu_torch.serve import mesh as tmesh

    W, nb, n_pages = 4, 32, 8
    ids = np.array([[1, 2, 9, 10, 17, 0, 0, 0],
                    [3, 0, 11, 12, 0, 0, 0, 0]], np.int32)

    def shard(x):
        mine, loc = jmesh._rebase_local(x, axis="tp", world=W,
                                        num_blocks=nb)
        return mine[None], loc[None]

    jm, jl = jax.jit(jax.shard_map(shard, mesh=mesh4, in_specs=(P(),),
                                   out_specs=(P("tp"), P("tp")),
                                   check_vma=False))(jnp.asarray(ids))
    tm, tl = tmesh._rebase_local(torch.from_numpy(ids), world=W,
                                 num_blocks=nb)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    tabs = tmesh._rank_tables(torch.from_numpy(ids), world=W,
                              num_blocks=nb, n_pages_max=n_pages)
    assert tabs.tolist() == [[[1, 2], [3, 0]], [[9, 10], [11, 12]],
                             [[17, 16], [16, 16]], [[24, 24], [24, 24]]]


def test_serve_cli_mesh_seq_on_cpu():
    """``examples/serve.py --engine --mesh 4 --kv-shard seq`` serves on the
    CPU with prompts spanning three ranks' spans; the other layouts raise
    naming their ROADMAP entry; ``--kv-shard seq`` without ``--mesh`` is
    refused, and ``--kv-shard heads`` (the default) without it serves
    world 1, as the reference's CLI does."""
    from triton_dist_tpu_torch.examples import serve as cli

    args = ["--engine", "--device", "cpu", "--requests", "2",
            "--new-tokens", "3", "--prompt-len", "120"]
    assert cli.parse_args(args).kv_shard == "heads"
    outs = cli.run_engine(cli.parse_args(args + ["--mesh", "4",
                                                 "--kv-shard", "seq"]))
    want = cli.run_engine(cli.parse_args(args))
    assert {r: o.token_ids for r, o in outs.items()} == \
        {r: o.token_ids for r, o in want.items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(args + ["--mesh", "4", "--kv-shard", "heads+seq"])
    with pytest.raises(SystemExit):
        cli.main(args + ["--kv-shard", "seq"])
    cli.main(args + ["--kv-shard", "heads"])


# ---------------------------------------------------------------------------
# head-sharded serving: mesh=World(W), kv_shard="heads"
# ---------------------------------------------------------------------------

# whole KV heads on every rank of mesh2 and mesh4 (the reference's
# tests/test_serve_mesh.py model has 4 query = 4 KV heads too)
HEADS = dict(vocab=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=4,
             ffn_dim=512, max_seq=64)


@pytest.fixture(scope="module")
def heads_model():
    jcfg = jllama.LlamaConfig(**HEADS, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**HEADS)
    jparams = jllama.init_params(jcfg, jax.random.key(2))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, HEADS["vocab"], size=n).astype(np.int32)
               for n, _ in MIX]
    return jcfg, tcfg, jparams, tparams, prompts


def _drive_mix(mod, eng, prompts):
    """MIX, one request every 2 steps; greedy streams by id."""
    reqs = [mod.Request(f"r{i}", p, mod.SamplingParams(max_new_tokens=m))
            for i, (p, (_, m)) in enumerate(zip(prompts, MIX))]
    sub = step = 0
    while eng.has_work() or sub < len(reqs):
        if step % 2 == 0 and sub < len(reqs):
            eng.submit(reqs[sub])
            sub += 1
        eng.step()
        step += 1
        assert step < 500
    return {rid: list(o.token_ids) for rid, o in eng._outputs.items()}


def _jax_heads_engine(jcfg, jparams, world, kv_int8=False, **kw):
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("sp",))
    mesh = Mesh(np.array(jax.devices()[:world]), ("tp",))
    gen = JGenerator(jcfg, mesh1, axis="sp", max_seq=64,
                     kv_dtype=jnp.int8 if kv_int8 else None)
    return jserve.ServeEngine(gen, jparams, mesh=mesh, kv_shard="heads",
                              prefix_cache=False, clock=_Tick(),
                              **dict(ENGINE_KW, **kw))


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("world", [2, 4])
def test_engine_heads_streams_match_jax_and_world1(heads_model, world, kv):
    """``ServeEngine(mesh=World(W), kv_shard="heads")`` on MIX (its pool
    forces a preemption and a recompute): tensor-parallel weights, pools
    rank-stacked by KV head (int8 pools with their scale planes), one
    folded paged decode per step, the out and FFN seams summed over the
    ranks: greedy streams identical to the port's world-1 engine and to
    the reference's heads engine on mesh2 / mesh4 (the oracles of
    tests/test_serve_mesh.py at horizon 1 and of tests/test_serve_kv_int8.py
    ::test_mesh_quantized_bit_identical_world1)."""
    jcfg, tcfg, jparams, tparams, prompts = heads_model
    kv_dtype = torch.int8 if kv == "int8" else None
    gen = TGenerator(tcfg, max_seq=64, device="cpu", kv_dtype=kv_dtype)
    want = _drive_mix(tserve, tserve.ServeEngine(
        gen, tparams, clock=_Tick(), **ENGINE_KW), prompts)
    eng = tserve.ServeEngine(gen, tparams, mesh=_seq_world(world),
                             kv_shard="heads", clock=_Tick(), **ENGINE_KW)
    assert eng.tp_world == world and eng.sp_world == 1
    assert eng.bm.shards == 1
    pool = eng._pools[0][0]
    planes = (pool["q"], pool["s"]) if kv == "int8" else (pool,)
    for plane in planes:
        assert plane.shape[:3] == (world, ENGINE_KW["num_blocks"],
                                   HEADS["n_kv_heads"] // world)
    assert eng.params["layers"][0]["wq"].shape == (
        world, HEADS["dim"], HEADS["dim"] // world)
    got = _drive_mix(tserve, eng, prompts)
    assert got == want
    assert eng.metrics.preemptions >= 1
    assert eng.bm.num_free == eng.bm.num_allocatable
    jeng = _jax_heads_engine(jcfg, jparams, world, kv_int8=kv == "int8")
    assert _drive_mix(jserve, jeng, prompts) == got
    assert jeng.metrics.preemptions == eng.metrics.preemptions


def test_engine_heads_w8a8_matches_jax_and_reproducible(heads_model):
    """``w8a8=True`` under ``kv_shard="heads"`` on mesh2: the W8A8 serving
    tree quantized per rank k-chunk and laid out rank by rank, the hooks
    summing the ranks' dequantized partials (``axis=0``).  Two fresh
    engines serve identical streams (tests/test_serve_kv_int8.py::
    test_mesh_w8a8_heads_reproducible), and against the reference's W8A8
    heads engine on mesh2 at least 0.9 of the greedy tokens agree position
    by position (the two f32 forwards land ~1e-6 apart before each per-row
    quantization, and a value on a rounding boundary may move one int8
    step and, at a near-tie, a token)."""
    jcfg, tcfg, jparams, tparams, prompts = heads_model
    gen = TGenerator(tcfg, max_seq=64, device="cpu")

    def port():
        eng = tserve.ServeEngine(gen, tparams, mesh=_seq_world(2),
                                 kv_shard="heads", w8a8=True, clock=_Tick(),
                                 **ENGINE_KW)
        layer = eng.params["layers"][0]
        assert layer["wo_q"].dtype == torch.int8
        assert layer["wo_q"].shape == (2, HEADS["dim"] // 2, HEADS["dim"])
        assert layer["wo_s"].shape == (2, 1, HEADS["dim"])
        return _drive_mix(tserve, eng, prompts)

    a = port()
    assert a == port()
    want = _drive_mix(jserve, _jax_heads_engine(jcfg, jparams, 2,
                                                w8a8=True), prompts)
    same = sum(x == y for r in want for x, y in zip(a[r], want[r]))
    total = sum(len(t) for t in want.values())
    assert sorted(a) == sorted(want)
    assert same / total >= 0.9, (same, total)


def test_engine_heads_geometry_rejection_rows(heads_model):
    """The ``heads`` rows of tests/test_serve_mesh.py's rejection matrix
    (whole KV heads, ffn_dim by the world), the 2-D
    layout not ported yet (naming its ROADMAP entry) and W8A8 under
    ``seq``."""
    _, tcfg, _, tparams, _ = heads_model

    def build(cfg, world, params=tparams, **kw):
        gen = TGenerator(cfg, max_seq=64, device="cpu")
        base = dict(ENGINE_KW, num_blocks=24)
        base.update(kw)
        return tserve.ServeEngine(gen, params, mesh=_seq_world(world),
                                  **base)

    from dataclasses import replace

    with pytest.raises(ValueError, match="n_kv_heads"):
        build(replace(tcfg, n_heads=6, n_kv_heads=3), 2, kv_shard="heads")
    with pytest.raises(ValueError, match="ffn_dim"):
        build(replace(tcfg, ffn_dim=66), 4, kv_shard="heads")
    with pytest.raises(NotImplementedError, match="ninth entry"):
        build(tcfg, 2, kv_shard="heads+seq")
    with pytest.raises(ValueError, match="w8a8"):
        build(tcfg, 2, kv_shard="seq", w8a8=True)
    assert build(tcfg, 2, kv_shard="heads", w8a8=True).tp_world == 2


def test_engine_mesh_defaults_to_heads_as_reference(heads_model):
    """A mesh with no ``kv_shard`` serves ``heads``, the reference's
    default: ``ServeEngine(gen, params, mesh=World(2))`` lays out the
    tensor-parallel weights and head-sharded pools and serves the streams
    of the reference's engine on mesh2 built with no ``kv_shard`` either;
    ``w8a8=True`` on a mesh with no layout serves too (the streams of the
    explicit ``kv_shard="heads"`` W8A8 engine), where the reference's
    does."""
    jcfg, tcfg, jparams, tparams, prompts = heads_model
    gen = TGenerator(tcfg, max_seq=64, device="cpu")
    eng = tserve.ServeEngine(gen, tparams, mesh=_seq_world(2), clock=_Tick(),
                             **ENGINE_KW)
    assert (eng.kv_shard, eng.tp_world, eng.sp_world) == ("heads", 2, 1)
    got = _drive_mix(tserve, eng, prompts)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("sp",))
    mesh2 = Mesh(np.array(jax.devices()[:2]), ("tp",))
    jeng = jserve.ServeEngine(JGenerator(jcfg, mesh1, axis="sp", max_seq=64),
                              jparams, mesh=mesh2, prefix_cache=False,
                              clock=_Tick(), **ENGINE_KW)
    assert jeng.kv_shard == "heads"
    assert _drive_mix(jserve, jeng, prompts) == got

    def w8a8(**kw):
        e = tserve.ServeEngine(gen, tparams, mesh=_seq_world(2), w8a8=True,
                               clock=_Tick(), **ENGINE_KW, **kw)
        assert e.kv_shard == "heads" and e.tp_world == 2
        return _drive_mix(tserve, e, prompts)

    assert w8a8() == w8a8(kv_shard="heads")
    jw = jserve.ServeEngine(JGenerator(jcfg, mesh1, axis="sp", max_seq=64),
                            jparams, mesh=mesh2, w8a8=True,
                            prefix_cache=False, clock=_Tick(), **ENGINE_KW)
    assert jw.kv_shard == "heads" and jw.w8a8


def test_serve_cli_heads_and_w8a8_scoring_on_cpu():
    """``examples/serve.py --engine --mesh 2 --kv-shard heads`` (float,
    then ``--w8a8 --kv-int8``) serves every request on the CPU; the
    generation mode's ``--w8a8 --mesh 4`` scores prompt plus generated
    tokens through the tensor-parallel W8A8 forward at a cosine above
    0.999 against the float forward; ``--w8a8`` alone without
    ``--engine`` is refused."""
    from triton_dist_tpu_torch.examples import serve as cli

    args = ["--engine", "--device", "cpu", "--requests", "2",
            "--new-tokens", "3", "--prompt-len", "40", "--mesh", "2",
            "--kv-shard", "heads"]
    for extra in ([], ["--w8a8", "--kv-int8"]):
        outs = cli.run_engine(cli.parse_args(args + extra))
        assert sorted(outs) == ["req-0", "req-1"]
        assert all(len(o.token_ids) == 3 for o in outs.values())
    gen_args = cli.parse_args(["--device", "cpu", "--new-tokens", "4",
                               "--w8a8", "--mesh", "4"])
    from triton_dist_tpu_torch.models import llama as tl

    _, cfg = cli._config(gen_args)
    assert (cfg.n_heads, cfg.n_kv_heads) == (8, 4)
    params = tl.init_params(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 9))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 4)))
    assert cli.score_w8a8(gen_args, cfg, params, prompt, toks) > 0.999
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--w8a8"])
