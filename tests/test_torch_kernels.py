"""The port's attention modules against the JAX reference kernels, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions
(``flash_attention_ref``, ``decode_ref``, ``decode_paged_ref``); the JAX
side runs the Pallas kernels themselves in interpret mode (``impl="pallas",
interpret=True``, as tests/test_flash_attention.py and
tests/test_flash_decode.py do), at kernel-legal shapes (D 128, S % 128 == 0,
page 128).  The same numpy inputs, drawn from a seed, feed both.

Tolerance: f32 throughout, 2e-5 absolute and relative — the two sides sum
in different orders (blockwise online softmax vs one dense pass), the same
bound the reference's own kernel-vs-dense tests use.  Against the
reference's int8 Pallas kernels in interpret mode, 2e-2: those cast the
dequantized K/V and the V-scaled P to q's dtype before their products.
The quantizers and the int8 GEMM are held to bit equality.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels import flash_attention as tfa
from triton_dist_tpu_torch.kernels import flash_decode as tfd
from triton_dist_tpu_torch.kernels import quant as tq
from triton_dist_tpu_torch.runtime.utils import assert_allclose

# the reference's kernels package re-exports functions under the module
# names, so the modules are fetched by their full path
jfa = importlib.import_module("triton_dist_tpu.kernels.flash_attention")
jfd = importlib.import_module("triton_dist_tpu.kernels.flash_decode")
jq = importlib.import_module("triton_dist_tpu.kernels.quant")

TOL = 2e-5
D = 128


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x):
    return torch.from_numpy(np.asarray(x))


FLASH_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, q_offset, window, soft_cap)
    "g1_causal": (1, 2, 2, 256, 256, 0, 0, 0.0),
    "g4_offset": (1, 4, 1, 128, 384, 256, 0, 0.0),
    "g2_window_cap": (2, 4, 2, 256, 256, 0, 96, 20.0),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(name):
    B, Hq, Hkv, Sq, Sk, off, window, cap = FLASH_CASES[name]
    q, k, v = _inputs(len(name), (B, Hq, Sq, D), (B, Hkv, Sk, D),
                      (B, Hkv, Sk, D))

    @jax.jit
    def ref(q, k, v, off):  # q_offset rides as a traced scalar
        return jfa.flash_attention(q, k, v, causal=True, q_offset=off,
                                   window=window, soft_cap=cap,
                                   return_lse=True, impl="pallas",
                                   interpret=True)

    j_out, j_lse = ref(q, k, v, jnp.int32(off))
    t_out, t_lse = tfa.flash_attention(
        _t(q), _t(k), _t(v), causal=True, q_offset=torch.tensor(off),
        window=window, soft_cap=cap, return_lse=True)
    assert t_out.dtype == torch.float32 and t_out.shape == (B, Hq, Sq, D)
    assert_allclose(t_out, np.asarray(j_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(j_lse), atol=TOL, rtol=TOL)


def test_flash_gqa_layout_and_unported_options():
    """The [S, B, H, D] wrapper and the loud refusals of what this slice
    does not port (segmented offsets, int8 K/V)."""
    q, k, v = _inputs(3, (64, 2, 4, D), (64, 2, 2, D), (64, 2, 2, D))
    got = tfa.flash_gqa_attention(_t(q), _t(k), _t(v))
    want = jfa.flash_gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), impl="xla")
    assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    qt = _t(q).permute(1, 2, 0, 3)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(qt, qt, qt, q_offset=(0, 32))
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(qt, qt, qt, kv_offset=(0, 32))


DECODE_CASES = {
    # name: (B, T, Hq, Hkv, S, lens, q_lens, window, soft_cap)
    "g1": (2, 1, 2, 2, 256, [256, 100], None, 0, 0.0),
    "g4": (2, 1, 8, 2, 256, [129, 256], None, 0, 0.0),
    "multi_dead_row": (2, 3, 4, 1, 256, [256, 200], [3, 0], 0, 0.0),
    "multi_window_cap": (2, 3, 4, 2, 256, [256, 150], [3, 2], 40, 15.0),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_plain_matches_pallas(name):
    B, T, Hq, Hkv, S, lens, q_lens, window, cap = DECODE_CASES[name]
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q, k, v = _inputs(len(name) + 10, qshape, (B, Hkv, S, D),
                      (B, Hkv, S, D))
    lens = np.asarray(lens, np.int32)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    j_out, j_lse = jfd.gqa_decode_shard(
        q, k, v, jnp.asarray(lens), block_s=128, impl="pallas",
        interpret=True, window=window, soft_cap=cap,
        q_lens=None if ql is None else jnp.asarray(ql))
    t_out, t_lse = tfd.gqa_decode_shard(
        _t(q), _t(k), _t(v), _t(lens), window=window, soft_cap=cap,
        q_lens=None if ql is None else _t(ql))
    assert t_out.dtype == torch.float32 and t_out.shape == qshape
    assert_allclose(t_out, np.asarray(j_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(j_lse), atol=TOL, rtol=TOL)
    if q_lens is not None and 0 in q_lens:
        dead = q_lens.index(0)
        assert torch.all(t_out[dead] == 0)
        assert torch.all(t_lse[dead] == tfd.NEG_INF)


@pytest.mark.parametrize("T", [1, 2])
def test_decode_paged_plain_matches_pallas(T):
    """Shuffled non-contiguous pages, the null block 0 past each length."""
    B, Hq, Hkv, page, n_pages = 2, 4, 2, 128, 3
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q, k_pool, v_pool = _inputs(20 + T, qshape, (6, Hkv, page, D),
                                (6, Hkv, page, D))
    table = np.array([[4, 1, 5], [2, 3, 0]], np.int32)
    lens = np.array([384, 130], np.int32)
    j_out, j_lse = jfd.gqa_decode_paged_shard(
        q, k_pool, v_pool, jnp.asarray(table), jnp.asarray(lens),
        impl="pallas", interpret=True)
    t_out, t_lse = tfd.gqa_decode_paged_shard(
        _t(q), _t(k_pool), _t(v_pool), _t(table), _t(lens))
    assert_allclose(t_out, np.asarray(j_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(j_lse), atol=TOL, rtol=TOL)
    # the paged plain version IS gather + contiguous decode
    c_out, _ = tfd.gqa_decode_shard(
        _t(q), tfd.paged_gather(_t(k_pool), _t(table)),
        tfd.paged_gather(_t(v_pool), _t(table)), _t(lens))
    assert torch.equal(c_out, t_out)


def test_pack_lens_arg_layouts():
    """The [B] / [2, B] / [3, B] lens layouts of the reference."""
    ll = torch.tensor([5, 7], dtype=torch.int32)
    wl = torch.tensor([6, 8], dtype=torch.int32)
    a, u = tfd.pack_lens_arg(ll, None, None, n_tok=1, window=0)
    assert a.shape == (2,) and not u
    a, u = tfd.pack_lens_arg(ll, wl, None, n_tok=1, window=4)
    assert a.tolist() == [[5, 7], [6, 8]] and not u
    a, u = tfd.pack_lens_arg(ll, None, None, n_tok=3, window=0)
    assert a.tolist() == [[5, 7], [5, 7], [3, 3]] and u
    jl, ju = jfd._pack_lens_arg(jnp.asarray(ll.numpy()), None,
                                jnp.asarray([2, 1], jnp.int32), n_tok=2,
                                window=0)
    tl, tu = tfd.pack_lens_arg(ll, None, torch.tensor([2, 1]), n_tok=2,
                               window=0)
    assert np.array_equal(np.asarray(jl), tl.numpy()) and ju == tu


def _bwd_inputs(seed, b, hq, hkv, sq, sk):
    return _inputs(seed, (b, hq, sq, D), (b, hkv, sk, D), (b, hkv, sk, D),
                   (b, hq, sq, D))


def _jax_grads(fn, q, k, v, w):
    """jax.grad of sum(fn(q, k, v) * w) — a non-uniform cotangent."""
    return jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * w),
                    argnums=(0, 1, 2))(q, k, v)


def _port_grads(q, k, v, w, **kw):
    """The port's plain backward from the plain forward's (out, lse)."""
    q, k, v, w = (_t(x) for x in (q, k, v, w))
    out, lse = tfa.flash_attention_ref(q, k, v, **kw)
    return tfa.flash_attention_bwd_ref(q, k, v, out, lse, w, **kw)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_plain_matches_pallas(causal):
    """flash_attention_bwd_ref against jax.grad through the Pallas forward
    and backward kernels in interpret mode, at the shapes and tolerance of
    tests/test_flash_attention.py's backward test (f32, 5e-5)."""
    q, k, v, w = _bwd_inputs(40 + causal, 1, 4, 2, 256, 256)
    want = _jax_grads(lambda q_, k_, v_: jfa.flash_attention(
        q_, k_, v_, causal=causal, impl="pallas", interpret=True), q, k, v, w)
    got = _port_grads(q, k, v, w, causal=causal)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(g, np.asarray(j), atol=5e-5, rtol=5e-5)


BWD_VARIANTS = {
    # name: (Hq, Hkv, Sq, Sk, q_offset, kv_offset, window, soft_cap)
    "window": (4, 2, 192, 192, 0, 0, 40, 0.0),
    "soft_cap": (4, 1, 128, 128, 0, 0, 0, 5.0),
    "offsets": (4, 2, 96, 224, 128, 0, 0, 0.0),
    "masked_rows": (2, 1, 128, 128, 0, 100, 0, 0.0),
}


@pytest.mark.parametrize("name", sorted(BWD_VARIANTS))
def test_flash_bwd_plain_variants_match_xla(name):
    """Window, soft-cap, offsets and rows with nothing visible (kv_offset
    puts keys in the future of the first 100 rows: zero, never NaN)
    against jax.grad of the reference's dense ``_flash_xla``."""
    Hq, Hkv, Sq, Sk, qo, ko, window, cap = BWD_VARIANTS[name]
    q, k, v, w = _bwd_inputs(len(name) + 50, 1, Hq, Hkv, Sq, Sk)
    kw = dict(causal=True, q_offset=qo, kv_offset=ko, window=window,
              soft_cap=cap)
    want = _jax_grads(lambda q_, k_, v_: jfa._flash_xla(
        q_, k_, v_, scale=1.0 / np.sqrt(D), **kw)[0], q, k, v, w)
    got = _port_grads(q, k, v, w, **kw)
    for g, j in zip(got, want):
        assert torch.isfinite(g).all()
        assert_allclose(g, np.asarray(j), atol=5e-5, rtol=5e-5)
    if name == "masked_rows":
        assert torch.all(got[0][:, :, :ko] == 0)


def test_flash_autograd_function_on_cpu():
    """Under autograd, flash_attention runs FlashAttentionFn (plain forward
    and plain backward on CPU tensors, no kernel launch) and its gradients
    equal autograd through flash_attention_ref, in the [S, B, H, D] model
    layout too."""
    q, k, v, w = (_t(x) for x in _inputs(60, (96, 2, 4, D), (96, 2, 2, D),
                                         (96, 2, 2, D), (96, 2, 4, D)))
    for x in (q, k, v):
        x.requires_grad_(True)
    n0 = (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
          tfa.flash_bwd_dkv.launches)
    for kw in (dict(), dict(window=17, soft_cap=7.0)):
        out = tfa.flash_gqa_attention(q, k, v, **kw)
        inner = out.grad_fn.next_functions[0][0]    # under the permute
        assert "FlashAttentionFn" in type(inner).__name__
        got = torch.autograd.grad((out * w).sum(), (q, k, v))
        want = torch.autograd.grad(
            (tfa.flash_gqa_attention(q, k, v, plain=True, **kw) * w).sum(),
            (q, k, v))
        for g, j in zip(got, want):
            assert g.shape == j.shape
            assert_allclose(g, j, atol=TOL, rtol=TOL)
    assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == n0
    with torch.no_grad():   # serving: no Function, the plain forward
        assert tfa.flash_gqa_attention(q, k, v).grad_fn is None


# ---------------------------------------------------------------------------
# quantized serving: the quantizers, the int8 GEMM, int8 K/V attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [((6, 300), 1), ((300, 40), 0),
                                        ((2, 3, 17, 128), -1)])
def test_symmetric_quantize_matches_jax(shape, axis):
    """Same int8 bytes; scales within 1e-7 relative; an all-zero slice
    gets scale 1 and zero bytes."""
    x = _inputs(70 + len(shape), shape)[0] * 3.0
    zero = [slice(None)] * len(shape)      # one all-zero slice along axis
    zero[axis - 1 if axis != 0 else 1] = 0
    x[tuple(zero)] = 0.0
    jq8, js = jq.symmetric_quantize(jnp.asarray(x), axis)
    tq8, ts = tq.symmetric_quantize(_t(x), axis)
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq8.numpy(), np.asarray(jq8))
    assert_allclose(ts, np.asarray(js), atol=0, rtol=1e-7)
    if axis == -1:
        kq8, ks = tfd.quantize_kv(_t(x))
        jk8, jks = jfd.quantize_kv(jnp.asarray(x))
        assert np.array_equal(kq8.numpy(), np.asarray(jk8))
        assert_allclose(ks, np.asarray(jks), atol=0, rtol=1e-7)
        assert torch.all(ks[0, 0, 0] == 1) and torch.all(kq8[0, 0, 0] == 0)
    assert torch.any(ts == 1)


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (8, 256, 128),
                                   (37, 96, 48)])
def test_matmul_i8_ref_exact(m, k, n):
    """matmul_i8 on CPU tensors (its plain version) equals the reference's
    XLA int32 dot bit for bit, and its Pallas kernel in interpret mode
    where the shape tiles (m % 32), with full-range int8 operands whose
    sums would wrap in int8 or overflow bf16's mantissa."""
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    n0 = tq.matmul_i8.launches
    got = tq.matmul_i8(_t(a), _t(b))
    assert got.dtype == torch.int32 and tq.matmul_i8.launches == n0
    assert torch.equal(got, tq.matmul_i8_ref(_t(a), _t(b)))
    want = np.asarray(jq.matmul_i8(jnp.asarray(a), jnp.asarray(b),
                                   impl="xla"))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(
        np.int64))
    if m % 32 == 0:
        pal = jq.matmul_i8(jnp.asarray(a), jnp.asarray(b),
                           config=jq.Int8MatmulConfig(32, 128, 128),
                           impl="pallas", interpret=True)
        assert np.array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_bit_equal(dtype):
    """Per-row activation quant, the int8 GEMM and the rank-1 dequant in
    the reference's order: f32 results bit-identical (bf16 ones too,
    being their rounding)."""
    x, w = _inputs(80, (9, 256), (256, 384))
    jw_q, jw_s = jq.quantize_channelwise(jnp.asarray(w))
    tw_q, tw_s = tq.quantize_channelwise(_t(w))
    assert np.array_equal(tw_q.numpy(), np.asarray(jw_q))
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    want = jq.w8a8_linear(jx, jw_q, jw_s, impl="xla")
    got = tq.w8a8_linear(tx, tw_q, tw_s)
    assert got.dtype == tx.dtype
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))
    plain = tq.w8a8_linear(tx, tw_q, tw_s, plain=True)
    assert torch.equal(plain, got)


def _quantized(seed, *shapes):
    """int8 + f32 scales of N(0, 1) data, as numpy (both packages')."""
    return [tuple(np.array(a) for a in jfd.quantize_kv(jnp.asarray(x)))
            for x in _inputs(seed, *shapes)]


I8_DECODE_CASES = {
    # name: (T, lens, q_lens, window, soft_cap)
    "t1_dead_row": (1, [256, 128, 0], None, 0, 0.0),
    "multi_window_cap": (3, [256, 150, 40], [3, 0, 2], 60, 12.0),
}


@pytest.mark.parametrize("name", sorted(I8_DECODE_CASES))
def test_decode_i8_plain_matches_reference(name):
    """decode_ref with scales against the reference's XLA int8 program and
    its Pallas ``_decode_kernel_i8`` in interpret mode, at
    tests/test_kv_int8.py's shape, a row with lens 0 included."""
    T, lens, q_lens, window, cap = I8_DECODE_CASES[name]
    B, Hq, Hkv, S = 3, 8, 4, 256
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q = _inputs(90 + T, qshape)[0]
    (kq, ks), (vq, vs) = _quantized(91 + T, (B, Hkv, S, D), (B, Hkv, S, D))
    lens = np.asarray(lens, np.int32)
    ql = None if q_lens is None else np.asarray(q_lens, np.int32)
    kw = dict(window=window, soft_cap=cap)
    jkw = dict(kw, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
               q_lens=None if ql is None else jnp.asarray(ql))
    x_out, x_lse = jfd.gqa_decode_shard(q, kq, vq, jnp.asarray(lens),
                                        impl="xla", **jkw)
    p_out, p_lse = jfd.gqa_decode_shard(q, kq, vq, jnp.asarray(lens),
                                        block_s=128, impl="pallas",
                                        interpret=True, **jkw)
    n0 = tfd.decode_i8.launches
    t_out, t_lse = tfd.gqa_decode_shard(
        _t(q), _t(kq), _t(vq), _t(lens), k_scale=_t(ks), v_scale=_t(vs),
        q_lens=None if ql is None else _t(ql), **kw)
    assert tfd.decode_i8.launches == n0
    assert_allclose(t_out, np.asarray(x_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(x_lse), atol=TOL, rtol=TOL)
    assert_allclose(t_out, np.asarray(p_out), atol=2e-2, rtol=2e-2)
    assert_allclose(t_lse, np.asarray(p_lse), atol=2e-2, rtol=2e-2)
    dead = 2 if q_lens is None else 1     # lens 0, or q_lens 0
    assert torch.all(t_out[dead] == 0)
    assert torch.all(t_lse[dead] == tfd.NEG_INF)


@pytest.mark.parametrize("T", [1, 2])
def test_decode_paged_i8_plain_matches_reference(T):
    """The paged int8 plain version against the reference's paged int8
    attend (``_paged_gather`` + ``_paged_gather_scale`` + XLA) with scale
    pools, shuffled pages and the null block past each length; it is the
    contiguous int8 version over the gathered pages."""
    B, Hq, Hkv, page = 2, 4, 2, 16
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q = _inputs(100 + T, qshape)[0]
    (kq, ks), (vq, vs) = _quantized(101 + T, (9, Hkv, page, D),
                                    (9, Hkv, page, D))
    table = np.array([[4, 1, 5, 8], [2, 3, 0, 0]], np.int32)
    lens = np.array([60, 21], np.int32)
    want = jfd.gqa_decode_paged_shard(
        q, kq, vq, jnp.asarray(table), jnp.asarray(lens),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tfd.gqa_decode_paged_shard(
        _t(q), _t(kq), _t(vq), _t(table), _t(lens), k_scale=_t(ks),
        v_scale=_t(vs))
    for g, w in zip(got, want):
        assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL)
    assert np.array_equal(
        tfd.paged_gather_scale(_t(ks), _t(table)).numpy(),
        np.asarray(jfd._paged_gather_scale(jnp.asarray(ks),
                                           jnp.asarray(table))))
    c_out, _ = tfd.gqa_decode_shard(
        _t(q), tfd.paged_gather(_t(kq), _t(table)),
        tfd.paged_gather(_t(vq), _t(table)), _t(lens),
        k_scale=tfd.paged_gather_scale(_t(ks), _t(table)),
        v_scale=tfd.paged_gather_scale(_t(vs), _t(table)))
    assert torch.equal(c_out, got[0])


@pytest.mark.parametrize("window,cap", [(0, 0.0), (96, 15.0)])
def test_flash_i8_plain_matches_reference(window, cap):
    """flash_attention_ref with scales against the reference's dense
    ``_flash_xla`` int8 program and its interpret-mode ``_flash_kernel_i8``
    (D 128, S % 128 == 0, a traced q_offset)."""
    B, Hq, Hkv, Sq, Sk, off = 1, 4, 2, 128, 256, 128
    q = _inputs(110, (B, Hq, Sq, D))[0]
    (kq, ks), (vq, vs) = _quantized(111, (B, Hkv, Sk, D), (B, Hkv, Sk, D))
    jkw = dict(causal=True, window=window, soft_cap=cap, return_lse=True,
               k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))

    @jax.jit
    def pallas(q, off):
        return jfa.flash_attention(q, kq, vq, q_offset=off, impl="pallas",
                                   interpret=True, **jkw)

    x_out, x_lse = jfa.flash_attention(q, kq, vq, q_offset=off, impl="xla",
                                       **jkw)
    p_out, p_lse = pallas(q, jnp.int32(off))
    n0 = (tfa.flash_fwd_i8.launches, tfa.flash_attention.launches)
    t_out, t_lse = tfa.flash_attention(
        _t(q), _t(kq), _t(vq), causal=True, q_offset=off, window=window,
        soft_cap=cap, return_lse=True, k_scale=_t(ks), v_scale=_t(vs))
    assert (tfa.flash_fwd_i8.launches, tfa.flash_attention.launches) == n0
    assert_allclose(t_out, np.asarray(x_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(x_lse), atol=TOL, rtol=TOL)
    assert_allclose(t_out, np.asarray(p_out), atol=2e-2, rtol=2e-2)
    assert_allclose(t_lse, np.asarray(p_lse), atol=2e-2, rtol=2e-2)


def test_flash_i8_is_forward_only():
    """The quantized path refuses autograd, as the reference's does."""
    q = torch.zeros((1, 2, 8, D), requires_grad=True)
    k = torch.zeros((1, 2, 8, D), dtype=torch.int8)
    s = torch.ones((1, 2, 8))
    with pytest.raises(NotImplementedError, match="forward-only"):
        tfa.flash_attention(q, k, k, k_scale=s, v_scale=s)
    with torch.no_grad():
        out = tfa.flash_attention(q, k, k, k_scale=s, v_scale=s)
    assert out.shape == q.shape
