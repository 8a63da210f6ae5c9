"""The port's model, sampling and generation code against the JAX reference.

A small Llama (dim 256, 2 query heads of 128, 1 KV head, 2 layers, vocab
512) in f32 on the CPU: the JAX parameters cross to the port through
``params_from_jax``, the same numpy prompts feed both packages, and the
port's attention runs its plain PyTorch versions (CPU tensors).

Tolerances: prompt logits agree to 1e-4 (f32; matmul and softmax sums run
in different orders in XLA and PyTorch, ~1e-6 relative at these widths);
greedy token streams must be identical; sampling distributions agree to
1e-6.  int8 caches: bytes may differ by one step where a value sits on a
rounding boundary (at most 1 LSB); scales (absmax / 127 of K/V rows that
the two f32 forwards compute ~1e-6 apart) agree to 4e-6 relative.  The
W8A8 tensor-parallel forward (``llama_w8a8``) against the reference's on
mesh4: int8 weights equal, logits within 1e-2 of the largest (one int8
step where a value sits on a rounding boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from triton_dist_tpu.models import llama as jllama
from triton_dist_tpu.models import sampling as jsampling
from triton_dist_tpu.models.generate import Generator as JGenerator
from triton_dist_tpu.models.generate import _prompt_forward as j_prompt
from triton_dist_tpu_torch.models import llama as tllama
from triton_dist_tpu_torch.models import sampling as tsampling
from triton_dist_tpu_torch.models.generate import Generator as TGenerator
from triton_dist_tpu_torch.models.generate import _chunk_forward
from triton_dist_tpu_torch.models.generate import _prompt_forward as t_prompt
from triton_dist_tpu_torch.runtime.utils import assert_allclose

SMALL = dict(vocab=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
             ffn_dim=512, max_seq=256)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**SMALL)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(seed, B, S):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab"], size=(B, S)).astype(np.int32)


def test_params_from_jax_round_trip(model):
    jcfg, tcfg, jparams, tparams = model
    host = jax.device_get(jparams)
    assert np.array_equal(tparams["embed"].numpy(), host["embed"])
    assert np.array_equal(tparams["lm_head"].numpy(), host["lm_head"])
    for jl, tl in zip(host["layers"], tparams["layers"]):
        assert set(jl) == set(tl)
        for name in jl:
            assert tl[name].shape == jl[name].shape
            assert np.array_equal(tl[name].numpy(), jl[name]), name
    bad = dict(host, layers=host["layers"][:1])
    with pytest.raises(ValueError):
        tllama.params_from_jax(bad, tcfg, device="cpu")


def test_w8a8_serving_tree_matches_jax(model):
    """``quantize_serve_params`` gives the reference's W8A8 serving tree
    bit for bit (int8 weights, f32 scales, the [1, N] row-weight scale
    stack), and ``params_from_jax`` carries the reference's tree across."""
    from triton_dist_tpu.models import llama_w8a8 as jw8
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8

    jcfg, tcfg, jparams, tparams = model
    jtree = jax.device_get(jw8.quantize_serve_params(jparams, jcfg, 1))
    ttree = tw8.quantize_serve_params(tparams, tcfg)
    carried = tllama.params_from_jax(jtree, tcfg, device="cpu")
    for jl, tl, cl in zip(jtree["layers"], ttree["layers"],
                          carried["layers"]):
        assert set(jl) == set(tl) == set(cl)
        for name in jl:
            assert tl[name].dtype == cl[name].dtype, name
            assert tl[name].shape == jl[name].shape, name
            assert np.array_equal(tl[name].numpy(), np.asarray(jl[name]))
            assert torch.equal(tl[name], cl[name]), name
    assert ttree["layers"][0]["wo_s"].shape == (1, SMALL["dim"])
    assert ttree["layers"][0]["wgate_q"].dtype == torch.int8
    assert ttree["embed"] is tparams["embed"]     # float parts shared


# the W8A8 tensor-parallel forward (reference tests/test_llama_w8a8.py)
W8 = dict(vocab=512, dim=512, n_layers=2, n_heads=4, n_kv_heads=4,
          ffn_dim=512, max_seq=64)


@pytest.fixture(scope="module")
def w8_model():
    jcfg = jllama.LlamaConfig(**W8, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**W8)
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_quantize_params_w8a8_matches_jax(w8_model):
    """``quantize_params_w8a8`` leaf by leaf against the reference's at
    world 4: the fused per-rank QKV and every int8 weight equal, every
    scale within 1e-6 relative (both quantize the same f32 weights; the
    absmax / 127 division rounds alike)."""
    from triton_dist_tpu.models import llama_w8a8 as jw8
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8

    jcfg, tcfg, jparams, tparams = w8_model
    jtree = jax.device_get(jw8.quantize_params_w8a8(jparams, jcfg, world=4))
    ttree = tw8.quantize_params_w8a8(tparams, tcfg, 4)
    for jl, tl in zip(jtree["layers"], ttree["layers"]):
        assert set(jl) == set(tl)
        for name, want in jl.items():
            got = tl[name]
            assert tuple(got.shape) == want.shape, name
            if name.endswith("_q"):
                assert got.dtype == torch.int8
                assert np.array_equal(got.numpy(), np.asarray(want)), name
            else:
                assert_allclose(got, np.asarray(want), atol=0, rtol=1e-6)
    assert ttree["layers"][0]["wo_s"].shape == (4, W8["dim"])
    assert ttree["embed"] is tparams["embed"]


def test_place_w8a8_params_matches_jax_shards(w8_model, mesh4):
    """``place_w8a8_params`` (``llama.shard_params`` of a W8A8 tree) holds
    at [r] exactly what the reference's ``place_w8a8_params`` puts on
    device r of mesh4: column weights and their scales by columns, row
    weights by rows with the rank's own [1, N] scale row."""
    from triton_dist_tpu.models import llama_w8a8 as jw8
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8

    jcfg, tcfg, jparams, tparams = w8_model
    jplaced = jw8.place_w8a8_params(
        jw8.quantize_params_w8a8(jparams, jcfg, world=4), jcfg, mesh4)
    tplaced = tw8.place_w8a8_params(
        tw8.quantize_params_w8a8(tparams, tcfg, 4), tcfg, 4)
    devs = list(mesh4.devices.flat)
    for jl, tl in zip(jplaced["layers"], tplaced["layers"]):
        for name, arr in jl.items():
            if name.endswith(("_q", "_s")):
                shards = {s.device: np.asarray(s.data)
                          for s in arr.addressable_shards}
                for r, d in enumerate(devs):
                    assert np.allclose(tl[name][r].numpy(), shards[d],
                                       rtol=1e-6, atol=0), (name, r)
            else:
                assert np.array_equal(tl[name].numpy(), np.asarray(arr))


@pytest.mark.parametrize("S,B", [(32, 4), (20, 1)])
def test_w8a8_forward_matches_jax(w8_model, mesh4, S, B):
    """``make_w8a8_forward(cfg, 4)`` over the plain versions against the
    reference's ``make_w8a8_forward`` on mesh4 (``impl="xla"``, the same
    math as its kernels), at S 32 x B 4 (32 rows per rank) and at a ragged
    S 20 x B 1 (5 rows per rank: the reference's XLA path, the port's
    masked row tail): logits within 1e-2 of the largest (the two f32
    forwards land ~1e-6 apart before each per-row quantization, and a value
    on a rounding boundary moves by one int8 step; measured 5e-3), argmax
    equal at >= 0.99 of positions; and both within the reference test's
    oracle against the float forward: cosine > 0.999, argmax agreement
    > 0.9."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu.models import llama_w8a8 as jw8
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8

    jcfg, tcfg, jparams, tparams = w8_model
    toks = np.random.default_rng(S).integers(
        0, W8["vocab"], size=(S, B)).astype(np.int32)
    jq = jw8.place_w8a8_params(jw8.quantize_params_w8a8(jparams, jcfg, 4),
                               jcfg, mesh4)
    want = np.asarray(jw8.make_w8a8_forward(jcfg, mesh4, impl="xla")(
        jq, jax.device_put(jnp.asarray(toks), NamedSharding(mesh4,
                                                              P("tp")))))
    tq = tw8.place_w8a8_params(tw8.quantize_params_w8a8(tparams, tcfg, 4),
                               tcfg, 4)
    got = tw8.make_w8a8_forward(tcfg, 4)(tq, torch.from_numpy(toks))
    assert got.shape == (S, B, W8["vocab"]) and got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    ref = tllama.make_forward(tcfg)(tparams, torch.from_numpy(toks)).numpy()
    for out in (got, want):
        cos = (out * ref).sum() / (np.linalg.norm(out) * np.linalg.norm(ref))
        assert cos > 0.999, cos
        assert (out.argmax(-1) == ref.argmax(-1)).mean() > 0.9


def test_init_params_scaling_and_seed():
    """Seeded torch draws with the reference's 1/sqrt(fan_in) scaling."""
    cfg = tllama.LlamaConfig(**SMALL)
    a = tllama.init_params(cfg, seed=3, device="cpu")
    b = tllama.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["layers"][1]["wdown"], b["layers"][1]["wdown"])
    w = a["layers"][0]["wgate"]
    assert w.shape == (cfg.dim, cfg.ffn_dim) and w.dtype == torch.float32
    assert abs(w.std().item() * cfg.dim ** 0.5 - 1.0) < 0.05
    assert abs(a["embed"].std().item() - 1.0) < 0.05
    assert torch.all(a["final_norm"] == 1)


def test_rms_norm_and_rope_match(model):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 2, 3, 128)).astype(np.float32)
    w = rng.standard_normal((128,)).astype(np.float32)
    pos = np.arange(7, 12, dtype=np.int32)
    assert_allclose(tllama._rms_norm(torch.from_numpy(x), torch.from_numpy(w),
                                     1e-5),
                    np.asarray(jllama._rms_norm(x, w, 1e-5)), atol=1e-6,
                    rtol=1e-6)
    assert_allclose(tllama._rope(torch.from_numpy(x), torch.from_numpy(pos),
                                 500000.0),
                    np.asarray(jllama._rope(x, pos, 500000.0)), atol=1e-6,
                    rtol=1e-6)


def test_prompt_forward_logits_match(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _prompts(0, 2, 40)
    jkvs, jl = j_prompt(jparams, jnp.asarray(toks), cfg=jcfg)
    tkvs, tl = t_prompt(tparams, torch.from_numpy(toks), cfg=tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, 40, SMALL["vocab"])
    assert_allclose(tl, np.asarray(jl), atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkvs, tkvs):
        assert_allclose(tk, np.asarray(jk), atol=1e-4, rtol=1e-4)
        assert_allclose(tv, np.asarray(jv), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_prefill_chunked_matches_prefill(model, chunk):
    """Chunks of 16 ride the multi-token decode path, chunks of 64 the
    flash prefill path; both rebuild the one-shot prefill's state."""
    _, tcfg, _, tparams = model
    toks = _prompts(1, 2, 40)
    gen = TGenerator(tcfg, max_seq=128, device="cpu")
    full = gen.prefill(tparams, toks)
    chunked = gen.prefill_chunked(tparams, toks, chunk_size=chunk)
    assert_allclose(chunked.last_logits, full.last_logits, atol=1e-4,
                    rtol=1e-4)
    for (fk, fv), (ck, cv) in zip(full.caches, chunked.caches):
        assert_allclose(ck, fk, atol=1e-5, rtol=1e-5)
        assert_allclose(cv, fv, atol=1e-5, rtol=1e-5)
    a, _ = gen.generate(tparams, full, 6)
    b, _ = gen.generate(tparams, chunked, 6)
    assert torch.equal(a, b)


def test_chunk_forward_padding_rows_write_zeros(model):
    """n_valid zero-masks a padded final chunk's K/V writes."""
    _, tcfg, _, tparams = model
    gen = TGenerator(tcfg, max_seq=64, device="cpu")
    caches = [gen.attn.init_cache(1, 1, 64, 128, dtype=torch.float32)
              for _ in range(tcfg.n_layers)]
    chunk = torch.from_numpy(_prompts(2, 1, 16))
    chunk[0, 10:] = 0
    caches, _ = _chunk_forward(tparams, chunk, caches, 8, cfg=tcfg,
                               extent=32, n_valid=10)
    for k, v in caches:
        assert torch.all(k[0, :, 18:] == 0) and torch.all(v[0, :, 18:] == 0)
        assert torch.all(k[0, :, :8] == 0)
        assert k[0, :, 8:18].abs().sum() > 0


def test_generate_greedy_streams_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    toks = _prompts(4, 2, 33)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    jgen = JGenerator(jcfg, mesh, axis="sp", max_seq=128)
    jtoks, _ = jgen.generate(jparams, jgen.prefill(jparams, jnp.asarray(toks)),
                             12)
    tgen = TGenerator(tcfg, max_seq=128, device="cpu")
    ttoks, st = tgen.generate(tparams, tgen.prefill(tparams, toks), 12)
    assert ttoks.dtype == torch.int32
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert st.kv_lens.tolist() == [45, 45]
    # eos: a row that emits it keeps emitting it
    eos = int(ttoks[0, 3])
    etoks, _ = tgen.generate(tparams, tgen.prefill(tparams, toks), 12,
                             eos_id=eos)
    assert torch.all(etoks[0, 3:] == eos)
    with pytest.raises(ValueError):
        tgen.generate(tparams, st, 100)


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7),
    dict(temperature=1.0, top_k=5),
    dict(temperature=1.3, top_p=0.9),
    dict(temperature=0.5, top_k=40, top_p=0.8),
])
def test_filtered_probs_match_jax(knobs):
    logits = np.random.default_rng(5).standard_normal(
        (3, 512)).astype(np.float32) * 3
    want = jsampling.filtered_probs(jnp.asarray(logits), **knobs)
    got = tsampling.filtered_probs(torch.from_numpy(logits), **knobs)
    assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)


def test_sample_logits_draws_from_the_filtered_support():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 512)).astype(np.float32))
    g1 = torch.Generator().manual_seed(9)
    g2 = torch.Generator().manual_seed(9)
    a = tsampling.sample_logits(logits, g1, temperature=0.8, top_k=3)
    b = tsampling.make_sampler(temperature=0.8, top_k=3)(logits, g2)
    assert torch.equal(a, b) and a.dtype == torch.int32
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert all(int(a[i]) in top3[i].tolist() for i in range(4))
    greedy = tsampling.sample_logits(logits, None, temperature=0.0)
    assert torch.equal(greedy, logits.argmax(-1).to(torch.int32))
    with pytest.raises(ValueError):
        tsampling.filtered_probs(logits, temperature=0.0)


def test_decode_layer_matches_jax_layer():
    """``SpGQAFlashDecodeAttention`` at world 1: cache init with prefill
    K/V, three appends, and attention after each, against the reference
    layer on a one-device mesh."""
    from triton_dist_tpu.layers.sp_flash_decode import (
        SpGQAFlashDecodeAttention as JLayer)
    from triton_dist_tpu_torch.layers.sp_flash_decode import (
        SpGQAFlashDecodeAttention as TLayer)

    B, Hq, Hkv, D, S, S0 = 2, 4, 2, 128, 256, 5
    rng = np.random.default_rng(8)
    k0, v0 = (rng.standard_normal((B, Hkv, S0, D)).astype(np.float32)
              for _ in range(2))
    jl = JLayer(Mesh(np.array(jax.devices()[:1]), ("sp",)), axis="sp",
                impl="xla")
    tl = TLayer(device="cpu")
    jk, jv = jl.init_cache(B, Hkv, S, D, jnp.float32, k_init=jnp.asarray(k0),
                           v_init=jnp.asarray(v0))
    tk, tv = tl.init_cache(B, Hkv, S, D, torch.float32,
                           k_init=torch.from_numpy(k0),
                           v_init=torch.from_numpy(v0))
    lens = np.array([S0, S0 - 2], np.int32)
    for _ in range(3):
        nk, nv = (rng.standard_normal((B, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        q = rng.standard_normal((B, Hq, D)).astype(np.float32)
        jk, jv = jl.append_kv(jk, jv, jnp.asarray(nk), jnp.asarray(nv),
                              jnp.asarray(lens))
        tk, tv = tl.append_kv(tk, tv, torch.from_numpy(nk),
                              torch.from_numpy(nv), torch.from_numpy(lens))
        lens = lens + 1
        want = jl(jnp.asarray(q), jk, jv, jnp.asarray(lens))
        got = tl(torch.from_numpy(q), tk, tv, torch.from_numpy(lens))
        assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
    assert np.array_equal(tk.numpy(), np.asarray(jk))


def test_unported_options_raise():
    from triton_dist_tpu_torch.layers.sp_flash_decode import (
        SpGQAFlashDecodeAttention)
    from triton_dist_tpu_torch.models import llama_w8a8

    # sequence parallelism is ported: a world of 2 builds, a world the
    # kernels cannot take is refused
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    assert SpGQAFlashDecodeAttention(get_world(2, "cpu")).world == 2
    with pytest.raises(ValueError):
        get_world(9, "cpu")
    # the W8A8 hooks under tensor parallelism take the rank axis of
    # rank-stacked operands (dim 0), not a mesh axis name
    x = torch.zeros((2, 256))
    layer = llama_w8a8.quantize_serve_params(
        tllama.init_params(tllama.LlamaConfig(**SMALL), device="cpu"),
        None)["layers"][0]
    with pytest.raises(ValueError, match="axis=0"):
        llama_w8a8.w8a8_serve_ffn(x, layer, axis="tp")
    with pytest.raises(ValueError, match="axis=0"):
        llama_w8a8.w8a8_serve_out_proj(x, layer, axis="tp")
    # a W8A8 tree quantized for one world cannot be laid out over another
    cfg = tllama.LlamaConfig(**dict(W8, dim=64, vocab=64))
    with pytest.raises(ValueError, match="quantized for a world of 1"):
        tllama.shard_params(llama_w8a8.quantize_serve_params(
            tllama.init_params(cfg, device="cpu"), cfg, world=1), cfg, 2)


def _assert_int8_caches_match(jcaches, tcaches):
    for jpair, tpair in zip(jcaches, tcaches):
        for jc, tc in zip(jpair, tpair):
            assert tc["q"].dtype == torch.int8
            lsb = np.abs(tc["q"].numpy().astype(np.int32)
                         - np.asarray(jc["q"]).astype(np.int32))
            assert lsb.max() <= 1
            assert_allclose(tc["s"], np.asarray(jc["s"]), atol=0,
                            rtol=4e-6)


@pytest.mark.parametrize("mode", ["prefill", "chunked16", "chunked64"])
def test_int8_generator_matches_jax(model, mode):
    """``Generator(kv_dtype=torch.int8)`` against the reference's
    ``Generator(kv_dtype=jnp.int8)``: prefill (quantized once), chunked
    prefill (chunks of 16 ride the int8 decode path, chunks of 64 the int8
    flash path), then 8 greedy steps — identical streams, caches within
    1 LSB and scales within 4e-6."""
    jcfg, tcfg, jparams, tparams = model
    toks = _prompts(9, 2, 40)
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    jgen = JGenerator(jcfg, mesh, axis="sp", max_seq=128, kv_dtype=jnp.int8)
    tgen = TGenerator(tcfg, max_seq=128, device="cpu", kv_dtype=torch.int8)
    assert tgen.attn.quantized
    if mode == "prefill":
        jst = jgen.prefill(jparams, jnp.asarray(toks))
        tst = tgen.prefill(tparams, toks)
    else:
        c = int(mode[len("chunked"):])
        jst = jgen.prefill_chunked(jparams, jnp.asarray(toks), chunk_size=c)
        tst = tgen.prefill_chunked(tparams, toks, chunk_size=c)
    _assert_int8_caches_match(jst.caches, tst.caches)
    assert_allclose(tst.last_logits, np.asarray(jst.last_logits), atol=1e-4,
                    rtol=1e-4)
    jtoks, jst = jgen.generate(jparams, jst, 8)
    ttoks, tst = tgen.generate(tparams, tst, 8)
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    _assert_int8_caches_match(jst.caches, tst.caches)


MOE_SMALL = dict(vocab=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                 n_experts=4, topk=2, expert_ffn_dim=64, max_seq=64,
                 block_m=8)


def test_moe_generator_streams_match_jax():
    """``MoEGenerator`` (prefill, then 8 greedy steps) against the
    reference's ``MoEGenerator`` on a one-device mesh at a small f32
    config (head_dim 128, 4 experts, top-2): identical streams, prefill
    logits within 1e-4."""
    from triton_dist_tpu.models import moe as jmoe
    from triton_dist_tpu.models.generate_moe import (
        MoEGenerator as JMoEGenerator,
        place_params_serving,
    )
    from triton_dist_tpu_torch.models import moe as tmoe
    from triton_dist_tpu_torch.models.generate_moe import (
        MoEGenerator as TMoEGenerator,
    )

    jcfg = jmoe.MoEConfig(**MOE_SMALL, dtype=jnp.float32)
    tcfg = tmoe.MoEConfig(**MOE_SMALL)
    host = jax.device_get(jmoe.init_params(jcfg, jax.random.key(5)))
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    jparams = place_params_serving(host, jcfg, mesh, axis="sp")
    tparams = tmoe.params_from_jax(host, tcfg, device="cpu")
    toks = np.random.default_rng(6).integers(0, 256, size=(2, 20)).astype(
        np.int32)
    jgen = JMoEGenerator(jcfg, mesh, axis="sp", max_seq=64)
    tgen = TMoEGenerator(tcfg, max_seq=64, device="cpu")
    jst = jgen.prefill(jparams, jnp.asarray(toks))
    tst = tgen.prefill(tparams, toks)
    assert_allclose(tst.last_logits, np.asarray(jst.last_logits), atol=1e-4,
                    rtol=1e-4)
    jtoks, _ = jgen.generate(jparams, jst, 8)
    ttoks, tst = tgen.generate(tparams, tst, 8)
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert tst.kv_lens.tolist() == [28, 28]
    # chunked prefill runs the same MoE FFN hook
    chunked = tgen.prefill_chunked(tparams, toks, chunk_size=8)
    assert_allclose(chunked.last_logits, np.asarray(jst.last_logits),
                    atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# sequence parallelism: Generator(mesh=World(4))
# ---------------------------------------------------------------------------

SP_WORLD = 4


def _unshard_seq(x):
    """[W, B, Hkv, S_loc, ...] rank spans -> [B, Hkv, W * S_loc, ...]."""
    W, B, H, s_loc = x.shape[:4]
    return x.movedim(0, 2).reshape(B, H, W * s_loc, *x.shape[4:])


def _sp_world():
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    return get_world(SP_WORLD, "cpu")


def _jax_sp_run(jcfg, jparams, mesh4, toks, n_new, max_seq=512):
    """The reference's ``Generator(cfg, mesh4, axis, interpret=True)``:
    prefill, then ``n_new`` greedy tokens (its SP decode and combine
    kernels in interpret mode)."""
    jgen = JGenerator(jcfg, mesh4, axis="tp", max_seq=max_seq,
                      interpret=True)
    jst = jgen.prefill(jparams, jnp.asarray(toks))
    jtoks, _ = jgen.generate(jparams, jst, n_new)
    return np.asarray(jst.last_logits), np.asarray(jtoks)


@pytest.fixture(scope="module")
def sp_oracle(model, mesh4):
    """A 300-token prompt (prompt rows on ranks 0-2 of 128-row spans)
    through the reference's SP Generator on mesh4: last prefill logits
    and 4 greedy tokens."""
    jcfg, _, jparams, _ = model
    toks = _prompts(11, 2, 300)
    logits, jtoks = _jax_sp_run(jcfg, jparams, mesh4, toks, 4)
    return toks, logits, jtoks


@pytest.mark.parametrize("mode", ["prefill", "chunked16", "chunked48"])
def test_sp_generator_matches_jax_and_world1(model, sp_oracle, mode):
    """``Generator(mesh=World(4, cpu))`` against the reference's SP
    Generator on mesh4 (last logits within 1e-4, greedy tokens identical)
    and against the port's world-1 Generator (identical tokens, the same
    cache rows in rank spans): prefill, and chunked prefill whose chunks
    of 16 ride ``sp_gqa_decode_shard`` and of 48 ``sp_flash_attention_
    shard`` (spans crossed mid-chunk)."""
    _, tcfg, _, tparams = model
    toks, jlogits, jtoks = sp_oracle
    gens = [TGenerator(tcfg, max_seq=512, device="cpu"),
            TGenerator(tcfg, mesh=_sp_world(), max_seq=512)]
    assert gens[1].world == SP_WORLD and gens[1].device.type == "cpu"
    states = []
    for gen in gens:
        if mode == "prefill":
            states.append(gen.prefill(tparams, toks))
        else:
            c = int(mode[len("chunked"):])
            states.append(gen.prefill_chunked(tparams, toks, chunk_size=c))
    w1, sp = states
    assert sp.caches[0][0].shape == (SP_WORLD, 2, 1, 128, 128)
    assert_allclose(sp.last_logits, jlogits, atol=1e-4, rtol=1e-4)
    for (k1, v1), (k4, v4) in zip(w1.caches, sp.caches):
        assert_allclose(_unshard_seq(k4), k1, atol=1e-5, rtol=1e-5)
        assert_allclose(_unshard_seq(v4), v1, atol=1e-5, rtol=1e-5)
    t1, _ = gens[0].generate(tparams, w1, 4)
    t4, st4 = gens[1].generate(tparams, sp, 4)
    assert np.array_equal(t4.numpy(), jtoks)
    assert torch.equal(t4, t1)
    assert st4.kv_lens.tolist() == [304, 304]


def test_sp_generator_windowed_matches_jax_and_world1(mesh4):
    """The windowed, soft-capped config of tests/test_generate.py:134-190
    (window 64, cap 10) at world 4: the global window spans rank
    boundaries as decode crosses position 256; prefill and chunked
    prefill (128) give the reference SP Generator's logits (1e-4) and
    tokens, and the port's world-1 tokens."""
    base = dict(vocab=64, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                ffn_dim=128, max_seq=512, attn_window=64,
                attn_soft_cap=10.0)
    jcfg = jllama.LlamaConfig(**base, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig(**base)
    jparams = jllama.init_params(jcfg, jax.random.key(3))
    tparams = tllama.params_from_jax(jax.device_get(jparams), tcfg,
                                     device="cpu")
    toks = np.random.default_rng(12).integers(0, 64, (1, 256)).astype(
        np.int32)
    jlogits, jtoks = _jax_sp_run(jcfg, jparams, mesh4, toks, 4)
    g1 = TGenerator(tcfg, max_seq=512, device="cpu")
    t1, _ = g1.generate(tparams, g1.prefill(tparams, toks), 4)
    g4 = TGenerator(tcfg, mesh=_sp_world(), max_seq=512)
    for st in (g4.prefill(tparams, toks),
               g4.prefill_chunked(tparams, toks, chunk_size=128)):
        assert_allclose(st.last_logits, jlogits, atol=1e-4, rtol=1e-4)
        t4, _ = g4.generate(tparams, st, 4)
        assert np.array_equal(t4.numpy(), jtoks)
        assert torch.equal(t4, t1)


def test_sp_layer_appends_and_paged_calls_match_jax(mesh4):
    """``SpGQAFlashDecodeAttention(mesh=World(4))``: prefill K/V cut into
    rank spans, appends at a span boundary and on the last rank (owner
    only), attention after each, int8 caches alike, and the paged call
    over ``init_paged_cache``'s pools; against the reference layer on
    mesh4 (``impl="xla"``), 2e-5 (int8 bytes within 1 LSB)."""
    from triton_dist_tpu.layers.sp_flash_decode import (
        SpGQAFlashDecodeAttention as JLayer)
    from triton_dist_tpu_torch.layers.sp_flash_decode import (
        SpGQAFlashDecodeAttention as TLayer)

    B, Hq, Hkv, D, S, S0 = 2, 4, 2, 128, 512, 127
    rng = np.random.default_rng(13)
    k0, v0 = (rng.standard_normal((B, Hkv, S0, D)).astype(np.float32)
              for _ in range(2))
    for kv_dtype in (None, "int8"):
        jl = JLayer(mesh4, axis="tp", impl="xla",
                    kv_dtype=None if kv_dtype is None else jnp.int8)
        tl = TLayer(mesh=_sp_world(),
                    kv_dtype=None if kv_dtype is None else torch.int8)
        assert tl.world == SP_WORLD
        jk, jv = jl.init_cache(B, Hkv, S, D, jnp.float32,
                               k_init=jnp.asarray(k0), v_init=jnp.asarray(v0))
        tk, tv = tl.init_cache(B, Hkv, S, D, torch.float32,
                               k_init=torch.from_numpy(k0),
                               v_init=torch.from_numpy(v0))
        lens = np.array([S0, 3 * 128 + 120], np.int32)
        for _ in range(3):      # 127 -> 128 -> 129 crosses ranks 0 / 1
            nk, nv = (rng.standard_normal((B, Hkv, D)).astype(np.float32)
                      for _ in range(2))
            q = rng.standard_normal((B, Hq, D)).astype(np.float32)
            jk, jv = jl.append_kv(jk, jv, jnp.asarray(nk), jnp.asarray(nv),
                                  jnp.asarray(lens))
            tk, tv = tl.append_kv(tk, tv, torch.from_numpy(nk),
                                  torch.from_numpy(nv),
                                  torch.from_numpy(lens))
            lens = lens + 1
            want = jl(jnp.asarray(q), jk, jv, jnp.asarray(lens))
            got = tl(torch.from_numpy(q), tk, tv, torch.from_numpy(lens))
            assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
        if kv_dtype is None:
            assert np.array_equal(_unshard_seq(tk).numpy(),
                                  np.asarray(jk))
        else:
            lsb = np.abs(_unshard_seq(tk["q"]).numpy().astype(np.int32)
                         - np.asarray(jk["q"]).astype(np.int32))
            assert lsb.max() <= 1
    # paged: the table and pools of init_paged_cache, filled alike
    jl = JLayer(mesh4, axis="tp", impl="xla")
    tl = TLayer(mesh=_sp_world())
    jkp, jvp, jtab = jl.init_paged_cache(B, Hkv, 16, 8, D, jnp.float32)
    tkp, tvp, ttab = tl.init_paged_cache(B, Hkv, 16, 8, D, torch.float32)
    assert np.array_equal(ttab.numpy(), np.asarray(jtab))
    assert tuple(tkp.shape) == tuple(jkp.shape)
    kp, vp = (rng.standard_normal(tuple(jkp.shape)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    plens = np.array([128, 37], np.int32)
    want = jl(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
              jnp.asarray(plens), block_table=jtab)
    got = tl(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
             torch.from_numpy(plens), block_table=ttab)
    assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)
