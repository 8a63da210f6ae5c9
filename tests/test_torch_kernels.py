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

The MoE modules (routing helpers, the grouped GEMM and its autograd, the
all-to-all and its autograd, dispatch / combine, ``DistributedMoELayer``)
against the reference at world 1: identical integers, f32 within 1e-6
(helpers) or 1e-5 (layer, against ``impl="xla"``), 2e-2 against
interpret-mode Pallas in bf16, 1e-4 for the VJP (the reference test's),
exact int8 and exact all-to-all (a copy).  Over W ranks (the conftest's
``mesh2`` / ``mesh4``): the all-to-all against the interpret-mode Pallas
``_a2a_kernel`` on every row below each split and on the split counts,
and against ``impl="xla"`` whole, exact (fp8 bit for bit); its VJP
exact; ``EPAll2AllLayer`` and ``DistributedMoELayer`` (bf16, f32, W8A8)
at the world-1 tolerances.

Tensor parallelism: the plain versions of the AG-GEMM and the GEMM-RS at
W in {1, 2, 4} against the reference's interpret-mode Pallas ring kernels
(spied) on the conftest's meshes, and the dense GEMM's against the
interpret-mode ``matmul`` with a K tail, f32 within 1e-5; the TP linears'
autograd Functions against ``jax.vjp`` of the reference's custom VJPs
inside ``shard_map`` (``impl="xla"``), 1e-5.  The AG-GEMM's int8 mode
against the interpret-mode kernel on int8 A, exact; row counts that are
no multiple of the kernels' tile (m_loc 8 and 24 against the Pallas
kernels, 5 against the XLA path), 1e-5; the W8A8 TP linears against the
reference's (``impl="xla"``), 1e-5, and its oracle (median relative error
against the float product < 0.02).

Collectives over a mesh (``runtime/bootstrap.Mesh``): the all-gather's
plain version (three methods, odd rows, a user's function around it,
grouped axes of a (2, 4) mesh) bit for bit against the interpret-mode
Pallas kernels (spied), the reduce-scatter's (ring and bidir at rows 8,
5, 1; the host entry) bit-equal in f32, the XLA method within 1e-6;
``choose_allgather_method``; ``fast_allgather`` and ``AllGatherLayer``
exact; the barrier's host entry; the hierarchical all-gather,
reduce-scatter and all-reduce bit for bit, ``hier_grad_allreduce`` within
1e-2 (its test's bound, a bf16 leaf), the two-stage all-to-all exact on
every valid row (``impl="xla"`` and interpret-mode Pallas).

The TP ring GEMMs' modes against the interpret-mode kernels (spied, on
``mesh2`` / ``mesh4``, m_loc 16-32, n_loc 128): the bidir AG-GEMM (A_full
bit for bit, C within 1e-5); the int8 wire (payload equal to the
reference's ``quantize_rowwise``, scales within 1 ulp: under jit XLA
divides by 127 as a product with 1 / 127, so the rebuilt A within 2 ulp,
C within 1e-5); chunks 1 / 2 / 4 equal, and the chunk clamp and every
schedule choice equal to the reference's (read from the kernel its trace
reaches); the bidir GEMM-RS within 1e-5 and bit-equal on integer-valued
inputs; the int8 GEMM-RS exactly; the host entries on a port ``Mesh``
against the reference's (1e-5; A_full bit for bit); the autotuner's cases
of tests/test_autotuner.py on torch tensors, and the autotuned entries
equal to the plain versions whichever config wins.

The MoE overlap kernels (AG-GroupGEMM, GroupGEMM-RS): ``_segment_plans``
bit-equal to the reference's (block_m 8, 16, 128; balanced, skewed and
one-empty-expert routing); the host entries ``ag_group_gemm`` and
``moe_reduce_rs`` on a port Mesh against the reference's interpret-mode
kernels (spied) at its own tests' cases (``mesh4`` f32 within 2e-4,
``mesh2`` bf16 within 5e-2, world 1) and against their dense oracles,
the port's sorted h bit-equal to the reference's; the reduce-scatter's
hop order; the load-aware default's m_pad; the autotuned entries (every
config's output equal to the host entry's, the prunes' survivors); the
host planner (native and numpy) equal to the reference's.

The torus (multi-axis) schedules against the reference's XLA math over
the joint axes (every oracle mesh, a reordered and a subset tuple,
degenerate size-1 axes): the gathers bit for bit, ``psum_scatter`` and
the GEMM host entries within 1e-5 / 2e-3, int8 exact; the composition at
untileable shapes; the dispatch and refusals under a tuple axis and the
autotuner's one torus schedule.  The interpret-mode Pallas torus kernels
are held in test_torch_train.py (their time kept off this file).
"""

import importlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding, PartitionSpec as P

from triton_dist_tpu_torch import autotuner as tat
from triton_dist_tpu_torch.kernels import allgather_gemm as tag
from triton_dist_tpu_torch.kernels import allgather_group_gemm as tagg
from triton_dist_tpu_torch.kernels import flash_attention as tfa
from triton_dist_tpu_torch.kernels import flash_decode as tfd
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as trs
from triton_dist_tpu_torch.kernels import group_gemm as tgg
from triton_dist_tpu_torch.kernels import moe_utils as tmu
from triton_dist_tpu_torch.kernels import quant as tq
from triton_dist_tpu_torch.runtime.bootstrap import Mesh as TMesh
from triton_dist_tpu_torch.runtime.utils import assert_allclose

# the reference's kernels package re-exports functions under the module
# names, so the modules are fetched by their full path
jfa = importlib.import_module("triton_dist_tpu.kernels.flash_attention")
jfd = importlib.import_module("triton_dist_tpu.kernels.flash_decode")
jq = importlib.import_module("triton_dist_tpu.kernels.quant")
jgg = importlib.import_module("triton_dist_tpu.kernels.group_gemm")
jmu = importlib.import_module("triton_dist_tpu.kernels.moe_utils")
jagm = importlib.import_module("triton_dist_tpu.kernels.allgather_gemm")
jgrs = importlib.import_module("triton_dist_tpu.kernels.gemm_reduce_scatter")
jgemm = importlib.import_module("triton_dist_tpu.kernels.gemm")

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
    """The [S, B, H, D] wrapper, and the offsets the port once refused:
    run-start tuples (segmented layouts) now give the reference's dense
    ``_flash_xla`` with the same tuples (f32, 2e-5); rows that do not
    split into the runs are refused loudly."""
    q, k, v = _inputs(3, (64, 2, 4, D), (64, 2, 2, D), (64, 2, 2, D))
    got = tfa.flash_gqa_attention(_t(q), _t(k), _t(v))
    want = jfa.flash_gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), impl="xla")
    assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
    qt, kt = (_t(x).permute(1, 2, 0, 3) for x in (q, k))
    for qo, ko in (((0, 32), 0), (0, (0, 32)), ((32, 0), (16, 48))):
        got, lse = tfa.flash_attention(qt, kt, kt, q_offset=qo,
                                       kv_offset=ko, return_lse=True)
        want, wlse = jfa._flash_xla(
            jnp.asarray(qt.numpy()), jnp.asarray(kt.numpy()),
            jnp.asarray(kt.numpy()), causal=True, scale=1.0 / np.sqrt(D),
            q_offset=qo, kv_offset=ko)
        assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)
        assert_allclose(lse, np.asarray(wlse), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="equal runs"):
        tfa.flash_attention(qt, qt, qt, q_offset=(0, 32, 64))


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


def _visible_positions(llen, wlen, qlen, T, use_qlens, window, S):
    """The positions some live query of one pair sees, by the plain
    version's own rule (``decode_ref``'s mask, written out per query)."""
    seen = set()
    for t in range(T):
        d = (qlen - 1 - t) if use_qlens else 0
        if d < 0:
            continue
        end = (wlen - d) if use_qlens else S + 1
        for pos in range(min(llen, S)):
            if pos >= end:
                continue
            if window and pos < wlen - d - window:
                continue
            seen.add(pos)
    return seen


@pytest.mark.parametrize("seed", range(6))
def test_decode_split_rule_covers_each_live_tile_once(seed):
    """The decode kernel's split rule (``live_tiles`` + ``split_tiles``,
    which ``csrc/decode.cu`` mirrors) over random lens, window lens,
    windows, q_lens and split counts: the live tiles hold every position a
    live query sees; the splits cover every live tile exactly once, in
    order; a pair's splits differ by at most one tile; dead pairs
    (q_lens 0) and empty ones (length 0) give empty ranges."""
    rng = np.random.default_rng(seed)
    tile = tfd.TILE
    for _ in range(60):
        S = int(rng.integers(1, 9)) * tile - int(rng.integers(0, 2)) * 17
        T = int(rng.choice([1, 1, 3, 8]))
        use_qlens = T > 1 or bool(rng.integers(0, 2))
        llen = int(rng.integers(0, S + 1))
        wlen = llen + int(rng.integers(-3, 4)) if use_qlens else llen
        qlen = int(rng.integers(0, T + 1)) if use_qlens else T
        window = int(rng.choice([0, 0, 1, 40, 100, 300]))
        n_split = int(rng.integers(1, 12))
        t_lo, t_hi = tfd.live_tiles(llen, wlen, qlen, use_qlens=use_qlens,
                                    window=window, S_total=S)
        seen = _visible_positions(llen, wlen, qlen, T, use_qlens, window, S)
        assert all(t_lo * tile <= p < t_hi * tile for p in seen)
        if (use_qlens and qlen == 0) or llen == 0:
            assert t_lo == t_hi
        shares = [tfd.split_tiles(t_lo, t_hi, n_split, s)
                  for s in range(n_split)]
        tiles = [t for a, b in shares for t in range(a, b)]
        assert tiles == list(range(t_lo, t_hi))
        sizes = [b - a for a, b in shares]
        assert max(sizes) - min(sizes) <= 1
        if t_hi - t_lo >= n_split:
            assert min(sizes) >= 1


@pytest.mark.parametrize("int8", [False, True])
def test_decode_split_plan_fits_the_merge_in_the_ring(int8):
    """``split_plan``'s split count, over pair counts, cache lengths, query
    rows (T * G up to the kernel's 128) and SM counts: at least one, at
    most one a cache tile and about BLOCKS_PER_SM blocks an SM, and never
    more than lets a pair's merge keep its (n_split + 2) * rows f32 in the
    kernel's ring (``RING_BYTES``, which ``csrc/decode.cu`` checks): one
    pair of 128 rows over 16k keys is capped by the ring, not the grid."""
    ring = tfd.RING_BYTES[int8]
    assert ring == (3 * (2 * tfd.TILE * (D + 16) + 2 * tfd.TILE * 4) if int8
                    else 2 * 2 * tfd.TILE * (D + 8) * 2)
    for n_pairs in (1, 2, 3, 8, 64, 500):
        for S in (1, 63, 64, 2048, 16384, 1 << 17):
            for rows in (1, 4, 16, 17, 64, 100, 128):
                for sms in (1, 78, 132):
                    n = tfd.split_plan(n_pairs, S, sms, rows, int8)
                    assert 1 <= n <= max(1, -(-S // tfd.TILE))
                    assert n <= max(1, tfd.BLOCKS_PER_SM * sms // n_pairs)
                    assert (n + 2) * rows * 4 <= ring
    capped = tfd.split_plan(1, 16384, 132, 128, int8)
    assert capped == ring // 512 - 2 < tfd.BLOCKS_PER_SM * 132


SPLIT_MERGE_CASES = [
    # (paged, int8, T, q_lens, window, soft_cap)
    (False, False, 1, None, 0, 0.0),
    (False, False, 3, [3, 0, 1, 2], 70, 0.0),
    (False, True, 1, None, 90, 20.0),
    (False, True, 2, [2, 1, 0, 2], 0, 0.0),
    (True, False, 1, None, 0, 15.0),
    (True, False, 3, [0, 3, 2, 1], 50, 0.0),
    (True, True, 1, None, 0, 0.0),
    (True, True, 2, [1, 2, 2, 0], 120, 10.0),
]


@pytest.mark.parametrize("case", SPLIT_MERGE_CASES)
def test_decode_split_and_merge_equals_whole(case):
    """What the kernel computes, on the plain versions: ``decode_ref``
    over each split's share of the live tiles, merged by
    ``combine_partials`` (the merge the kernel's last split does, lse by
    the same log-sum-exp), equals ``decode_ref`` over the whole cache to
    1e-5, split counts 1..9 (empty splits among them), a dead row
    (q_lens 0) and a length-0 row included; contiguous and paged, f32 and
    int8 caches."""
    paged, int8, T, q_lens, window, cap = case
    B, Hq, Hkv, S, page = 4, 4, 2, 5 * tfd.TILE - 20, 20
    rng = np.random.default_rng(sum(map(ord, repr(case))))
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q = _t(rng.standard_normal(qshape).astype(np.float32))
    lens = _t(np.array([S, 130, 0, 65], np.int32))
    ql = None if q_lens is None else _t(np.array(q_lens, np.int32))
    kw = dict(soft_cap=cap, window=window, q_lens=ql)
    n_pages = -(-S // page)
    if paged:
        n_blocks = B * n_pages + 1
        k, v = (_t(rng.standard_normal((n_blocks, Hkv, page, D)).astype(
            np.float32)) for _ in range(2))
        table = _t((1 + rng.permutation(B * n_pages)).reshape(
            B, n_pages).astype(np.int32))
    else:
        k, v = (_t(rng.standard_normal((B, Hkv, S, D)).astype(np.float32))
                for _ in range(2))
    if int8:
        (k, ks), (v, vs) = tfd.quantize_kv(k), tfd.quantize_kv(v)
        kw.update(k_scale=ks, v_scale=vs)

    def ref(**extra):
        if paged:
            return tfd.decode_paged_ref(q, k, v, table, lens, **kw, **extra)
        return tfd.decode_ref(q, k, v, lens, **kw, **extra)

    want_out, want_lse = ref()
    S_total = n_pages * page if paged else S
    for n_split in range(1, 10):
        outs, lses = [], []
        for s in range(n_split):
            lo, hi = [], []
            for b in range(B):
                llen = int(lens[b])
                qlen = T if ql is None else int(ql[b])
                a, z = tfd.split_tiles(*tfd.live_tiles(
                    llen, llen, qlen, use_qlens=T > 1 or ql is not None,
                    window=window, S_total=S_total), n_split, s)
                lo.append(a * tfd.TILE)
                hi.append(z * tfd.TILE)
            o, l = ref(positions=(lo, hi))
            outs.append(o)
            lses.append(l)
        outs, lses = torch.stack(outs), torch.stack(lses)
        got_out = tfd.combine_partials(outs, lses)
        m = lses.amax(dim=0)
        got_lse = torch.where(
            m > tfd.NEG_INF / 2,
            m + torch.log(torch.exp(lses - m).sum(dim=0)),
            torch.full_like(m, tfd.NEG_INF))
        assert_allclose(got_out, want_out, atol=1e-5, rtol=1e-5)
        assert_allclose(got_lse, want_lse, atol=1e-5, rtol=1e-5)
    assert torch.all(want_out[2] == 0)            # the length-0 row
    if q_lens is not None:
        dead = q_lens.index(0)
        assert torch.all(want_out[dead] == 0)
        assert torch.all(want_lse[dead] == tfd.NEG_INF)


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


# ---------------------------------------------------------------------------
# MoE: routing helpers, the grouped GEMM, dispatch / combine, the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,topk,block_m", [(64, 4, 2, 16), (37, 8, 2, 8),
                                              (5, 3, 1, 8)])
def test_routing_helpers_match_reference(T, E, topk, block_m):
    """topk_routing, sort_align, gather_sorted and combine_topk against
    the reference: identical integers, f32 within 1e-6."""
    logits, x, y = _inputs(120 + T, (T, E), (T, 24), (T * topk + E * block_m,
                                                     40))
    m_pad = jmu.padded_rows(T * topk, E, block_m)
    ys = y[:m_pad]

    @jax.jit
    def ref(logits, x, ys):
        w, e = jmu.topk_routing(logits, topk)
        plan = jmu.sort_align(e, E, block_m)
        xs = jmu.gather_sorted(x, plan["dest"], m_pad)
        return (w, e, plan["dest"], plan["tile_expert"], plan["valid_rows"],
                xs, jmu.combine_topk(ys, plan["dest"], w))

    want = ref(jnp.asarray(logits), jnp.asarray(x), jnp.asarray(ys))
    tw, te = tmu.topk_routing(_t(logits), topk)
    tplan = tmu.sort_align(te, E, block_m)
    assert tplan["m_pad"] == m_pad and te.dtype == torch.int32
    got = (tw, te, tplan["dest"], tplan["tile_expert"], tplan["valid_rows"],
           tmu.gather_sorted(_t(x), tplan["dest"], m_pad),
           tmu.combine_topk(_t(ys), tplan["dest"], tw))
    for i in (1, 2, 3, 4, 5):          # integers, masks, copied rows
        assert np.array_equal(got[i].numpy(), np.asarray(want[i])), i
    for i in (0, 6):
        assert_allclose(got[i], np.asarray(want[i]), atol=1e-6, rtol=1e-6)


def test_group_gemm_plain_matches_pallas_bf16():
    """group_gemm on CPU bf16 tensors (its plain version) against the
    reference's Pallas ``_kernel`` in interpret mode at
    tests/test_group_gemm.py's bf16 shape (f32 accumulation, bf16 out on
    both sides: 2e-2); the dx mode equals the plain product with the slabs
    transposed (to one bf16 step: the f32 sums run in another order)."""
    E, block_m, K, N, n_tiles = 8, 32, 256, 384, 6
    x, w = _inputs(130, (n_tiles * block_m, K), (E, K, N))
    te = np.random.default_rng(131).integers(0, E, n_tiles).astype(np.int32)
    xb, wb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
    want = jgg.group_gemm(xb, wb, jnp.asarray(te), block_m=block_m,
                          impl="pallas", interpret=True)
    n0 = tgg.group_gemm.launches
    tx, tw = _t(x).bfloat16(), _t(w).bfloat16()
    got = tgg.group_gemm(tx, tw, _t(te), block_m=block_m)
    assert got.dtype == torch.bfloat16 and tgg.group_gemm.launches == n0
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=2e-2,
                    rtol=2e-2)
    dy = _t(_inputs(132, (n_tiles * block_m, N))[0]).bfloat16()
    dx = tgg.group_gemm_dx(dy, tw, _t(te), block_m=block_m)
    want_dx = tgg.group_gemm_ref(dy, tw.transpose(1, 2).contiguous(),
                                 _t(te), block_m=block_m)
    assert dx.shape == (n_tiles * block_m, K)
    assert_allclose(dx.float(), want_dx.float(), atol=1e-2, rtol=1e-2)


def test_group_gemm_int8_exact_and_padding_rows_zero():
    """int8: exact int32 against the reference's Pallas kernel and numpy
    (tests/test_group_gemm.py:150-167); padding rows of a sort_align plan
    come out as exact zeros in f32 and int8 (:76-87)."""
    rng = np.random.default_rng(0)
    E, bm, K, N, n_tiles = 4, 8, 128, 128, 6
    x = rng.integers(-127, 128, (n_tiles * bm, K), dtype=np.int8)
    w = rng.integers(-127, 128, (E, K, N), dtype=np.int8)
    te = rng.integers(0, E, (n_tiles,), dtype=np.int32)
    n0 = tgg.group_gemm_i8.launches
    got = tgg.group_gemm(_t(x), _t(w), _t(te), block_m=bm)
    assert got.dtype == torch.int32 and tgg.group_gemm_i8.launches == n0
    want = jgg.group_gemm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(te),
                          block_m=bm, impl="pallas", interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    for t in range(n_tiles):
        ref = (x[t * bm:(t + 1) * bm].astype(np.int64)
               @ w[te[t]].astype(np.int64))
        assert np.array_equal(got[t * bm:(t + 1) * bm].numpy(), ref)

    plan = tmu.sort_align(torch.tensor([[0], [2], [2]]), 3, 8)
    xs = tmu.gather_sorted(_t(_inputs(133, (3, K))[0]), plan["dest"],
                           plan["m_pad"])
    y = tgg.group_gemm(xs, torch.ones((3, K, N)), plan["tile_expert"],
                       block_m=8)
    assert torch.all(y[~plan["valid_rows"]] == 0)
    q = tgg.group_gemm(xs.to(torch.int8), torch.ones((3, K, N),
                                                     dtype=torch.int8),
                       plan["tile_expert"], block_m=8)
    assert torch.all(q[~plan["valid_rows"]] == 0)


def test_group_gemm_autograd_matches_reference_vjp():
    """dx (the transposed mode) and dW (per-expert sums) of GroupGemmFn
    against jax.grad through the reference's custom VJP over the Pallas
    kernel in interpret mode (tests/test_group_gemm.py:119-147, f32,
    1e-4)."""
    E, bm, K, N, n_tiles = 4, 8, 128, 128, 6
    x, w = _inputs(134, (n_tiles * bm, K), (E, K, N))
    w = w / np.sqrt(K)
    te = np.array([0, 2, 2, 1, 3, 0], np.int32)

    def loss(x_, w_):
        return jnp.sum(jnp.sin(jgg.group_gemm(x_, w_, jnp.asarray(te),
                                              block_m=bm, impl="pallas",
                                              interpret=True)))

    jgx, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    n0 = (tgg.group_gemm.launches, tgg.group_gemm_dx.launches)
    y = tgg.group_gemm(tx, tw, _t(te), block_m=bm)
    assert "GroupGemmFn" in type(y.grad_fn).__name__
    gx, gw = torch.autograd.grad(torch.sin(y).sum(), (tx, tw))
    assert (tgg.group_gemm.launches, tgg.group_gemm_dx.launches) == n0
    assert_allclose(gx, np.asarray(jgx), atol=1e-4, rtol=1e-4)
    assert_allclose(gw, np.asarray(jgw), atol=1e-4, rtol=1e-4)


def _jax_ep(fn, *args):
    """Run a reference shard-level function on a one-device mesh."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=tuple(P() for _ in args),
                                 out_specs=P(), check_vma=False))(*args)


@pytest.mark.parametrize("max_tokens", [None, 5])
def test_ep_dispatch_combine_world1_match_reference(max_tokens):
    """ep_dispatch_shard / ep_combine_shard at world 1 (rank-stacked
    inputs, W = 1) against the reference's on a one-device mesh: the same
    receive buffer, expert ids, splits and dropped count (capacity 5 drops
    assignments), and the same combined output (f32, 1e-6); the same
    tokens split over two ranks combine to the same output."""
    from triton_dist_tpu.layers import ep_a2a as jep
    from triton_dist_tpu_torch.layers import ep_a2a as tep

    T, H, E, topk = 6, 16, 4, 2
    x, wts = _inputs(140, (T, H), (T, topk))
    experts = np.random.default_rng(141).integers(0, E, (T, topk)).astype(
        np.int32)

    def ref(x_, e_, w_):
        recv, re, sp, plan, nd = jep.ep_dispatch_shard(
            x_, e_, axis="tp", n_experts=E, max_tokens=max_tokens,
            impl="xla", interpret=False)
        out = jep.ep_combine_shard(recv * 2.0 + 1.0, w_, plan, axis="tp",
                                   impl="xla", interpret=False)
        return recv, re, sp, nd, out

    want = _jax_ep(ref, jnp.asarray(x), jnp.asarray(experts),
                   jnp.asarray(wts))
    from triton_dist_tpu_torch.kernels import all_to_all as ta

    n0 = ta.fast_all_to_all_shard.launches
    recv, re, sp, plan, nd = tep.ep_dispatch_shard(
        _t(x)[None], _t(experts)[None], n_experts=E, max_tokens=max_tokens)
    out = tep.ep_combine_shard(recv * 2.0 + 1.0, _t(wts)[None], plan)
    assert ta.fast_all_to_all_shard.launches == n0    # plain on the CPU
    assert np.array_equal(recv[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(re[0].numpy(), np.asarray(want[1]))
    assert np.array_equal(sp[0].numpy(), np.asarray(want[2]))
    assert int(nd) == int(want[3]) == (0 if max_tokens is None else 7)
    assert_allclose(out[0], np.asarray(want[4]), atol=1e-6, rtol=1e-6)
    if max_tokens is None:
        recv2, _, _, plan2, nd2 = tep.ep_dispatch_shard(
            _t(x).reshape(2, T // 2, H), _t(experts).reshape(2, T // 2, topk),
            n_experts=E)
        out2 = tep.ep_combine_shard(recv2 * 2.0 + 1.0,
                                    _t(wts).reshape(2, T // 2, topk), plan2)
        assert recv2.shape[:2] == (2, 2) and int(nd2) == 0
        assert torch.equal(out2.reshape(T, H), out[0])


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_all_to_all_world1_matches_pallas(dtype, monkeypatch):
    """fast_all_to_all_shard at world 1 (send [1, 1, max_tokens, H]; its
    plain version on CPU tensors) against the reference's Pallas
    ``_a2a_kernel`` in interpret mode on a one-device mesh (spied, so the
    kernel is known to trace): recv equals send, padding rows past the
    split included, and recv_splits equals splits — exact; over two ranks
    the same call is the transpose of the rank dimensions."""
    ja = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    from triton_dist_tpu_torch.kernels import all_to_all as ta

    traced = []
    kernel = ja._a2a_kernel

    def spy(*args, **kw):
        traced.append(kw["world"])
        return kernel(*args, **kw)

    monkeypatch.setattr(ja, "_a2a_kernel", spy)
    rng = np.random.default_rng(160)
    send = (rng.standard_normal((1, 24, 128)) * 100).astype(dtype)
    splits = np.array([17], np.int32)
    want = _jax_ep(lambda s, p: ja.fast_all_to_all_shard(
        s, p, axis="tp", impl="pallas", interpret=True),
        jnp.asarray(send), jnp.asarray(splits))
    assert traced == [1]
    n0 = ta.fast_all_to_all_shard.launches
    recv, recv_splits = ta.fast_all_to_all_shard(_t(send)[None],
                                                 _t(splits)[None])
    assert ta.fast_all_to_all_shard.launches == n0
    assert np.array_equal(recv[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(recv_splits[0].numpy(), np.asarray(want[1]))
    assert recv.data_ptr() != _t(send).data_ptr()       # a copy, not a view
    send2 = _t((rng.standard_normal((2, 2, 4, 8)) * 100).astype(dtype))
    splits2 = torch.tensor([[1, 4], [0, 3]], dtype=torch.int32)
    recv2, rsplits2 = ta.fast_all_to_all_shard(send2, splits2)
    assert torch.equal(recv2, send2.transpose(0, 1))
    assert torch.equal(rsplits2, splits2.t())


def test_all_to_all_autograd_matches_reference_vjp():
    """The differentiable shuffle at world 1 against jax.grad through the
    reference's custom VJP: the cotangent comes back with the rows past
    the split zeroed (f32, exact: the two only copy and mask)."""
    ja = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    from triton_dist_tpu_torch.kernels import all_to_all as ta

    send, ct = _inputs(161, (1, 12, 16), (1, 12, 16))
    splits = np.array([7], np.int32)

    def loss(s):
        recv, _ = ja.fast_all_to_all_shard_diff(s, jnp.asarray(splits), "tp",
                                                "xla", False)
        return jnp.sum(recv * jnp.asarray(ct))

    want = _jax_ep(jax.grad(loss), jnp.asarray(send))
    ts = _t(send)[None].requires_grad_()
    recv, recv_splits = ta.fast_all_to_all_shard_diff(ts, _t(splits)[None])
    assert "AllToAllFn" in type(recv.grad_fn).__name__
    (got,) = torch.autograd.grad((recv * _t(ct)[None]).sum(), (ts,))
    assert np.array_equal(got[0].numpy(), np.asarray(want))
    assert torch.all(got[0, 0, 7:] == 0) and torch.equal(got[0, 0, :7],
                                                          _t(ct)[0, :7])


# splits [src, dst] over 2 and 4 ranks: 0, below a block, equal to
# max_tokens (8), and above it (clamped by the kernel, raw in recv_splits)
A2A_SPLITS = {2: [[0, 8], [3, 5]],
              4: [[0, 3, 8, 1], [8, 0, 2, 5], [4, 8, 0, 7], [1, 2, 3, 0]]}


def _a2a_case(world, dtype, seed):
    """(send [W * W, 8, 128] in ``dtype`` with NaN-free rows, splits
    [W * W] int32) as the reference's host layout."""
    rng = np.random.default_rng(seed)
    send = rng.standard_normal((world * world, 8, 128)).astype(np.float32)
    splits = np.array(A2A_SPLITS[world], np.int32).reshape(-1)
    return jnp.asarray(send).astype(getattr(jnp, dtype)), splits


def _as_torch(a):
    """A numpy / jax array as a torch tensor; fp8 through its bytes."""
    a = np.array(a)
    if a.dtype.name.startswith("float8"):
        return torch.from_numpy(a.view(np.uint8)).view(
            getattr(torch, a.dtype.name))
    return torch.from_numpy(a)


@pytest.mark.parametrize("world,dtype", [(2, "float32"), (4, "float32"),
                                         (2, "float8_e4m3fn")])
def test_all_to_all_peers_match_pallas(world, dtype, monkeypatch, request):
    """fast_all_to_all_shard over W ranks (its plain version on CPU
    tensors) against the reference's ``_a2a_kernel`` in interpret mode on
    the conftest's ``mesh{W}`` (spied): every rank's rows below each split
    and recv_splits exactly equal, splits of 0, of max_tokens and above it
    included, fp8 bit for bit (tests/test_all_to_all.py:53); and the whole
    buffers equal to the reference's ``impl="xla"`` full-segment
    shuffle."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import all_to_all as ta

    ja = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    traced = []
    kernel = ja._a2a_kernel

    def spy(*args, **kw):
        traced.append(kw["world"])
        return kernel(*args, **kw)

    monkeypatch.setattr(ja, "_a2a_kernel", spy)
    send, splits = _a2a_case(world, dtype, 162 + world)
    mesh = _mesh(world, request)
    outs = {}
    for impl in ("pallas", "xla"):
        outs[impl] = _shard_map(
            lambda s, p, impl=impl: ja.fast_all_to_all_shard(
                s, p, axis="tp", impl=impl, interpret=impl == "pallas"),
            mesh, (P("tp"), P("tp")), (P("tp"), P("tp")), send,
            jnp.asarray(splits))
    assert traced and set(traced) == {world}
    mt = send.shape[1]
    n0 = ta.fast_all_to_all_shard.launches
    recv, recv_splits = ta.fast_all_to_all_shard(
        _as_torch(send).reshape(world, world, mt, 128),
        _t(splits).reshape(world, world))
    assert ta.fast_all_to_all_shard.launches == n0
    raw = recv.view(torch.uint8) if recv.element_size() == 1 else recv
    want_splits = np.asarray(outs["pallas"][1]).reshape(world, world)
    assert np.array_equal(recv_splits.numpy(), want_splits)
    pallas = _as_torch(outs["pallas"][0]).reshape(world, world, mt, 128)
    pallas = pallas.view(torch.uint8) if recv.element_size() == 1 else pallas
    for p in range(world):
        for r in range(world):
            k = min(int(want_splits[p, r]), mt)
            assert torch.equal(raw[p, r, :k], pallas[p, r, :k]), (p, r)
    xla = _as_torch(outs["xla"][0]).reshape(world, world, mt, 128)
    xla = xla.view(torch.uint8) if recv.element_size() == 1 else xla
    assert torch.equal(raw, xla)
    assert np.array_equal(recv_splits.numpy().reshape(-1),
                          np.asarray(outs["xla"][1]))


def test_all_to_all_peers_vjp_matches_reference(mesh4):
    """AllToAllFn over 4 ranks against jax.grad through the reference's
    custom VJP inside shard_map on mesh4 (``impl="xla"``): exact; the
    rows past each split come back zero."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import all_to_all as ta

    ja = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    send, _ = _a2a_case(4, "float32", 170)
    ct = _inputs(171, tuple(send.shape))[0]
    splits = np.array(A2A_SPLITS[4], np.int32).reshape(-1)

    def shard(s, p, c):
        def loss(s_):
            recv, _ = ja.fast_all_to_all_shard_diff(s_, p, "tp", "xla",
                                                    False)
            return jnp.sum(recv * c)
        return jax.grad(loss)(s)

    want = _shard_map(shard, mesh4, (P("tp"), P("tp"), P("tp")), P("tp"),
                      send, jnp.asarray(splits), jnp.asarray(ct))
    ts = _t(np.asarray(send)).reshape(4, 4, 8, 128).requires_grad_()
    recv, _ = ta.fast_all_to_all_shard_diff(ts, _t(splits).reshape(4, 4))
    (got,) = torch.autograd.grad(
        (recv * _t(ct).reshape(4, 4, 8, 128)).sum(), (ts,))
    assert np.array_equal(got.numpy().reshape(16, 8, 128), np.asarray(want))
    sp = _t(splits).reshape(4, 4)
    for r in range(4):
        for p in range(4):
            assert torch.all(got[r, p, sp[r, p]:] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_all_to_all_debug_poison_and_consumers_mask(dtype):
    """``debug_poison``: every peer segment's rows past min(split,
    max_tokens) hold NaN (integers: the type's maximum), the own segment
    and the rows below the splits are the shuffle's; dispatch with
    ``zero_undefined`` and combine, both poisoned, give exactly the
    unpoisoned output (each consumer masks)."""
    from triton_dist_tpu_torch.kernels import all_to_all as ta
    from triton_dist_tpu_torch.layers import ep_a2a as tep

    send = (_t(np.asarray(_a2a_case(4, "float32", 172)[0])) * 100).to(
        dtype).reshape(4, 4, 8, 128)
    splits = torch.tensor(A2A_SPLITS[4], dtype=torch.int32)
    clean, rs = ta.fast_all_to_all_shard(send, splits)
    recv, rs2 = ta.fast_all_to_all_shard(send, splits, debug_poison=True)
    assert torch.equal(rs, rs2)
    sentinel = (float("nan") if dtype.is_floating_point
                else torch.iinfo(dtype).max)
    for p in range(4):
        for r in range(4):
            k = 8 if p == r else min(int(rs[p, r]), 8)
            assert torch.equal(recv[p, r, :k], clean[p, r, :k])
            tail = recv[p, r, k:]
            assert (torch.isnan(tail).all() if dtype.is_floating_point
                    else (tail == sentinel).all())
    assert torch.isnan(recv).any() or not dtype.is_floating_point

    T, H, E, topk = 32, 128, 8, 2
    x, wts = (_t(a) for a in _inputs(173, (4, T // 4, H), (4, T // 4, topk)))
    experts = _t(np.random.default_rng(174).integers(
        0, E, (4, T // 4, topk)).astype(np.int32))
    outs = []
    for poison in (False, True):
        recv, re, _, plan, _ = tep.ep_dispatch_shard(
            x, experts, n_experts=E, max_tokens=3, zero_undefined=True,
            debug_poison=poison)
        assert torch.isfinite(recv).all()
        outs.append(tep.ep_combine_shard(recv * 2.0 + 1.0, wts, plan,
                                         debug_poison=poison))
    assert torch.isfinite(outs[1]).all() and torch.equal(outs[0], outs[1])


def test_all_to_all_context_entry_and_post_process(mesh4):
    """fast_all_to_all over an AllToAllContext against the reference's
    host entry on mesh4 (``impl="xla"``, tests/test_all_to_all.py:33):
    recv[d][s] = send[s][d] and the splits likewise, exact; its shape and
    max_tokens checks; all_to_all_post_process's flattening and mask; a
    2-tuple axis raises."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from triton_dist_tpu_torch.kernels import all_to_all as ta

    ja = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    send, splits = _a2a_case(4, "float32", 175)
    sh = NamedSharding(mesh4, P("tp"))
    jctx = ja.create_all_to_all_context(mesh4, 8, 128, axis="tp",
                                        impl="xla")
    want, want_splits = ja.fast_all_to_all(
        jax.device_put(send, sh), jax.device_put(jnp.asarray(splits), sh),
        jctx)
    ctx = ta.create_all_to_all_context(4, 8, 128, device="cpu")
    assert ctx.size == 4 and ctx.world.size == 4
    recv, recv_splits = ta.fast_all_to_all(_as_torch(send), _t(splits), ctx)
    assert recv.shape == (16, 8, 128)
    assert np.array_equal(recv.numpy(), np.asarray(want))
    assert np.array_equal(recv_splits.numpy(), np.asarray(want_splits))
    with pytest.raises(ValueError, match="ctx sizing"):
        ta.fast_all_to_all(_as_torch(send)[:8], _t(splits), ctx)
    with pytest.raises(ValueError, match="explicit ctx.max_tokens"):
        ta.fast_all_to_all(_as_torch(send), _t(splits),
                           ta.create_all_to_all_context(4, None, 128,
                                                        device="cpu"))
    local = recv.reshape(4, 4, 8, 128)[1]
    tokens, mask = ta.all_to_all_post_process(local,
                                              recv_splits.reshape(4, 4)[1])
    jt, jm = ja.all_to_all_post_process(jnp.asarray(local.numpy()),
                                        jnp.asarray(recv_splits.reshape(
                                            4, 4)[1].numpy()))
    assert np.array_equal(tokens.numpy(), np.asarray(jt))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    # a (slow, fast) axis is the two-stage path: it needs a Mesh of them
    with pytest.raises(ValueError, match="needs a Mesh"):
        ta.create_all_to_all_context(4, 8, 128, axis=("dp", "tp"),
                                     device="cpu")


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ep_layer_w4_matches_reference(impl, mesh4, mesh2):
    """EPAll2AllLayer over 4 ranks against the reference's on mesh4
    (tests/test_ep_layer.py:31): dispatch's receive buffer (against the
    reference's interpret-mode Pallas kernel: the rows below each split),
    expert ids, splits and dropped count, and the round trip through a
    per-expert scale (f32, 1e-6); the capacity drop of
    tests/test_ep_layer.py:62 on mesh2 (8 dropped, the survivors
    exact)."""
    from triton_dist_tpu.kernels.all_to_all import (
        create_all_to_all_context as jcreate)
    from triton_dist_tpu.kernels.moe_utils import topk_routing as jtopk
    from triton_dist_tpu.layers.ep_a2a import EPAll2AllLayer as JLayer
    from triton_dist_tpu_torch.kernels.all_to_all import (
        create_all_to_all_context)
    from triton_dist_tpu_torch.layers.ep_a2a import EPAll2AllLayer

    W, T, H, E, topk = 4, 32, 64, 8, 2
    x, logits = _inputs(176, (T, H), (T, E))
    wts, experts = jtopk(jnp.asarray(logits), topk)
    jl = JLayer(ctx=jcreate(mesh4, (T // W) * topk, H, axis="tp", impl=impl,
                            interpret=impl == "pallas"), n_experts=E,
                topk=topk)
    jrecv, jre, jsp, jplan, jnd = jl.dispatch(jnp.asarray(x), experts)
    scale = (1.0 + jre.astype(jnp.float32))[..., None]
    jout = jl.combine((jrecv * scale).astype(jrecv.dtype), wts, jplan)

    tl = EPAll2AllLayer(ctx=create_all_to_all_context(
        W, (T // W) * topk, H, device="cpu"), n_experts=E, topk=topk)
    recv, re, sp, plan, nd = tl.dispatch(_t(x), _t(np.asarray(experts)))
    assert int(nd) == int(jnd) == 0
    assert np.array_equal(sp.numpy(), np.asarray(jsp))
    assert np.array_equal(re.numpy(), np.asarray(jre))
    rows = np.arange(recv.shape[1])[None, :] < sp.numpy()[:, None]
    assert np.array_equal(recv.numpy()[rows], np.asarray(jrecv)[rows])
    for got, want in zip(plan, jplan):
        assert np.array_equal(got.numpy(), np.asarray(want))
    out = tl.combine(recv * (1.0 + re.float())[..., None],
                     _t(np.asarray(wts)), plan)
    assert_allclose(out, np.asarray(jout), atol=1e-6, rtol=1e-6)

    # capacity: every token to expert 0 on rank 0, 4 slots per source
    T2, H2 = 16, 32
    x2 = _inputs(177, (T2, H2))[0]
    jl2 = JLayer(ctx=jcreate(mesh2, 4, H2, axis="tp", impl="xla"),
                 n_experts=2, topk=1)
    e2 = np.zeros((T2, 1), np.int32)
    w2 = np.ones((T2, 1), np.float32)
    jrecv2, _, jsp2, jplan2, jnd2 = jl2.dispatch(jnp.asarray(x2),
                                                 jnp.asarray(e2))
    jout2 = jl2.combine(jrecv2, jnp.asarray(w2), jplan2)
    tl2 = EPAll2AllLayer(ctx=create_all_to_all_context(2, 4, H2,
                                                       device="cpu"),
                         n_experts=2, topk=1)
    recv2, _, sp2, plan2, nd2 = tl2.dispatch(_t(x2), _t(e2))
    assert int(nd2) == int(jnd2) == 8
    assert sp2.reshape(2, 2).tolist() == [[4, 4], [0, 0]]
    out2 = tl2.combine(recv2, _t(w2), plan2)
    assert np.array_equal(out2.numpy(), np.asarray(jout2))


def _moe_layers(dtype_name, mesh=None, **kw):
    """The reference's DistributedMoELayer on ``mesh`` (one device by
    default) and the port's over as many ranks, with the same weights (T
    32, H 128, F 128, E 8, top-2, block_m 8: tests/test_moe_inference.py's
    sizes)."""
    from jax.sharding import Mesh
    from triton_dist_tpu.layers.moe_inference import (
        DistributedMoELayer as JLayer)
    from triton_dist_tpu_torch.layers.moe_inference import (
        DistributedMoELayer as TLayer)

    if mesh is None:
        mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    opts = dict(n_experts=8, topk=2, hidden=128, intermediate=128, block_m=8)
    jl = JLayer(mesh=mesh, axis="tp", dtype=getattr(jnp, dtype_name),
                impl="xla", **opts, **kw)
    w = jax.device_get(jl.init_weights(jax.random.key(3)))
    tl = TLayer(dtype=getattr(torch, dtype_name), device="cpu",
                world=mesh.size, **opts, **kw)
    tl.weights = {k: _t(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else tl.dtype) for k, v in w.items()}
    x = _inputs(150, (32, 128))[0]
    return jl, tl, x


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
def test_moe_layer_matches_reference(dtype_name, tol):
    """DistributedMoELayer (internal router) against the reference's layer
    at world 1 with impl="xla": f32 within 1e-5; bf16 within 2e-2 (both
    round each grouped GEMM's f32 sums to bf16, in different orders); the
    same layer over two ranks gives the same output."""
    jl, tl, x = _moe_layers(dtype_name)
    want = jl.forward(jnp.asarray(x, getattr(jnp, dtype_name)))
    n0 = tgg.group_gemm.launches
    got = tl.forward(_t(x))
    assert got.dtype == tl.dtype and tgg.group_gemm.launches == n0
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=tol,
                    rtol=tol)
    tl2 = type(tl)(n_experts=8, topk=2, hidden=128, intermediate=128,
                   block_m=8, dtype=tl.dtype, world=2, device="cpu")
    tl2.weights = tl.weights
    assert tl2.experts_per_rank == 4
    assert_allclose(tl2.forward(_t(x)).float(), got.float(), atol=tol,
                    rtol=tol)


@pytest.mark.parametrize("dtype_name,tol", [("float32", 1e-5),
                                            ("bfloat16", 2e-2)])
def test_moe_layer_w4_matches_reference(dtype_name, tol, mesh4):
    """DistributedMoELayer over 4 ranks against the reference's layer on
    mesh4 (tests/test_moe_inference.py:47, :70, :106; impl="xla"), with
    the internal router and with given routing: f32 within 1e-5, bf16
    within 2e-2; ``weight_specs`` cut what the reference's cut; a tuple
    axis and an expert count that does not split raise."""
    jl, tl, x = _moe_layers(dtype_name, mesh=mesh4)
    xj = jnp.asarray(x, getattr(jnp, dtype_name))
    want = jl.forward(xj)
    got = tl.forward(_t(x))
    assert got.dtype == tl.dtype and got.shape == (32, 128)
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=tol,
                    rtol=tol)
    rng = np.random.default_rng(151)
    ex = rng.integers(0, 8, (32, 2)).astype(np.int32)
    wts = rng.dirichlet(np.ones(2), 32).astype(np.float32)
    want = jl.forward(xj, experts=jnp.asarray(ex),
                      routing_weights=jnp.asarray(wts))
    got = tl.forward(_t(x), experts=_t(ex), routing_weights=_t(wts))
    assert_allclose(got.float(), np.asarray(want, np.float32), atol=tol,
                    rtol=tol)
    specs = {k: (0 if len(v) and v[0] == "tp" else None)
             for k, v in jl.weight_specs().items()}
    assert tl.weight_specs() == specs and tl.experts_per_rank == 2
    with pytest.raises(NotImplementedError, match="ninth entry"):
        type(tl)(n_experts=8, topk=2, hidden=128, intermediate=128,
                 world=8, axis=("dp", "tp"), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        type(tl)(n_experts=6, topk=2, hidden=128, intermediate=128,
                 world=4, device="cpu")


def test_moe_layer_w8a8_matches_reference():
    """After quantize_weights(): the same int8 stacks and scales as the
    reference's (bit for bit), and the W8A8 forward within 1e-4 of the
    reference's W8A8 forward (f32; its row quantization may round a value
    on a boundary one int8 step apart); it also tracks the float layer as
    the reference's test asks (median relative error < 0.05, cosine >
    0.995)."""
    _check_w8a8_layer(*_moe_layers("float32"))


def test_moe_layer_w4_w8a8_matches_reference(mesh4):
    """test_moe_layer_w8a8_matches_reference over 4 ranks, against the
    reference's layer on mesh4 (tests/test_moe_inference.py:106)."""
    _check_w8a8_layer(*_moe_layers("float32", mesh=mesh4))


def _check_w8a8_layer(jl, tl, x):
    wts, ex = jl.route(jnp.asarray(x))
    ref_float = np.asarray(jl.forward(jnp.asarray(x), experts=ex,
                                      routing_weights=wts))
    jq = jax.device_get(jl.quantize_weights())
    tq_ = tl.quantize_weights()
    assert tl.is_quantized and set(tq_) == set(jq)
    for k in jq:
        assert np.array_equal(tq_[k].numpy(), np.asarray(jq[k])), k
    want = np.asarray(jl.forward(jnp.asarray(x), experts=ex,
                                 routing_weights=wts))
    n0 = tgg.group_gemm_i8.launches
    got = tl.forward(_t(x), experts=_t(np.array(ex)),
                     routing_weights=_t(np.array(wts)))
    assert tgg.group_gemm_i8.launches == n0
    assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    rel = np.abs(got.numpy() - ref_float) / (np.abs(ref_float) + 1e-2)
    assert np.median(rel) < 0.05
    cos = (got.numpy() * ref_float).sum() / (np.linalg.norm(got.numpy())
                                             * np.linalg.norm(ref_float))
    assert cos > 0.995


# ---------------------------------------------------------------------------
# Tensor parallelism: the dense GEMM, the AG-GEMM and GEMM-RS plain
# versions, and the TP linears' VJPs
# ---------------------------------------------------------------------------


def _mesh(world, request):
    """The conftest's ``mesh2`` / ``mesh4`` fixtures, or one device."""
    if world > 1:
        return request.getfixturevalue(f"mesh{world}")
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]), ("tp",))


def _shard_map(fn, mesh, in_specs, out_specs, *args):
    """A fresh jit(shard_map(fn)) per call, so the kernel always traces."""
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))(*args)


def _stack_cols(b, world):
    """[K, N] -> [W, K, N/W]: rank r's column shard at [r]."""
    return torch.stack(_t(b).chunk(world, dim=1))


def _stack_rows(b, world):
    """[K, N] -> [W, K/W, N]: rank r's row shard at [r]."""
    return torch.stack(_t(b).chunk(world, dim=0))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ag_gemm_plain_matches_pallas(world, monkeypatch, request):
    """ag_gemm (its plain version on CPU tensors) against the reference's
    ``_ag_gemm_kernel`` in interpret mode on a ``world``-device mesh (spied,
    so the kernel is known to trace), per-device shapes that pass
    ``pallas_shapes_ok`` (m_loc 16, K 256, n_loc 128): every rank's
    gathered A bit for bit, every rank's C within 1e-5 (f32)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import allgather_gemm as tag

    jag = importlib.import_module("triton_dist_tpu.kernels.allgather_gemm")
    traced = []
    kernel = jag._ag_gemm_kernel

    def spy(*args, **kw):
        traced.append(kw["world"])
        return kernel(*args, **kw)

    monkeypatch.setattr(jag, "_ag_gemm_kernel", spy)
    m_loc, K, n_loc = 16, 256, 128
    a, b = _inputs(170 + world, (world * m_loc, K), (K, world * n_loc))
    b /= np.sqrt(K)          # unit outputs, as the reference's own tests

    def shard(x, w):
        a_full, c = jag.ag_gemm_shard(x, w, axis="tp", impl="pallas", bm=16,
                                      bn=128, bk=128, interpret=True)
        return a_full[None], c[None]

    want_full, want_c = _shard_map(shard, _mesh(world, request),
                                   (P("tp", None), P(None, "tp")),
                                   (P("tp"), P("tp")), jnp.asarray(a),
                                   jnp.asarray(b))
    assert traced and set(traced) == {world}
    n0 = tag.ag_gemm_shard.launches
    a_full, c = tag.ag_gemm_shard(_t(a).reshape(world, m_loc, K),
                            _stack_cols(b, world))
    assert tag.ag_gemm_shard.launches == n0       # CPU: the plain version
    assert a_full.shape == (world, world * m_loc, K)
    assert np.array_equal(a_full.numpy(), np.asarray(want_full))
    assert_allclose(c, np.asarray(want_c), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("world,m_loc,N,trans_b", [
    pytest.param(1, 16, 256, False, id="1"),
    pytest.param(2, 16, 256, False, id="2"),
    pytest.param(4, 16, 256, False, id="4"),
    # the uni kernel's 128 x 256 tiles: a chunk of 136 rows (a second row
    # tile of 8), N % 256 == 128 (a half-empty column tile), B^T
    pytest.param(2, 136, 384, True, id="2-ragged-bt"),
    pytest.param(2, 136, 384, False, id="2-ragged"),
    pytest.param(4, 16, 384, True, id="4-bt")])
def test_gemm_rs_plain_matches_pallas(world, m_loc, N, trans_b, monkeypatch,
                                      request):
    """gemm_rs (its plain version on CPU tensors) against the reference's
    ``_gemm_rs_kernel`` in interpret mode (spied) on a ``world``-device
    mesh, per-device (m_loc, k_loc 128, N): every rank's reduced chunk
    within 1e-5 (f32: the plain version's f32 sum in rank order and the
    reference's ring adds differ by f32 rounding only); with ``trans_b``
    the port reads the weight stored [N, k] (the reference's b
    transposed)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as trs

    jrs = importlib.import_module(
        "triton_dist_tpu.kernels.gemm_reduce_scatter")
    traced = []
    kernel = jrs._gemm_rs_kernel

    def spy(*args, **kw):
        traced.append(kw["world"])
        return kernel(*args, **kw)

    monkeypatch.setattr(jrs, "_gemm_rs_kernel", spy)
    k_loc = 128
    a, b = _inputs(180 + world + m_loc + N, (world * m_loc, world * k_loc),
                   (world * k_loc, N))
    b /= np.sqrt(world * k_loc)
    want = _shard_map(
        lambda x, w: jrs.gemm_rs_shard(x, w, axis="tp", impl="pallas",
                                       bm=16, bn=128, bk=128,
                                       interpret=True),
        _mesh(world, request), (P(None, "tp"), P("tp", None)), P("tp"),
        jnp.asarray(a), jnp.asarray(b))
    assert traced and set(traced) == {world}
    n0 = trs.gemm_rs_shard.launches
    b_r = _stack_rows(b, world)
    if trans_b:
        b_r = b_r.transpose(1, 2).contiguous()
    out = trs.gemm_rs_shard(torch.stack(_t(a).chunk(world, dim=1)), b_r,
                            trans_b=trans_b)
    assert trs.gemm_rs_shard.launches == n0
    assert out.shape == (world, m_loc, N)
    assert_allclose(out.reshape(world * m_loc, N), np.asarray(want),
                    atol=1e-5, rtol=1e-5)


def test_ring_plain_versions_stage_in_the_operand_dtype():
    """The plain versions' rounding: gemm_rs stages each rank's partial in
    a's dtype and sums the partials in f32 in rank order, rounding once
    (bf16 here, against a float64 reference of the same staging); the
    transposed modes equal the products with the weight transposed."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as tag
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as trs

    a, b = (_t(x) for x in _inputs(190, (4, 32, 64), (4, 64, 48)))
    a16, b16 = a.bfloat16(), b.bfloat16()
    out = trs.gemm_rs_shard(a16, b16)
    parts = [(a16[q].double() @ b16[q].double()).bfloat16().double()
             .reshape(4, 8, 48) for q in range(4)]
    want = (((parts[0] + parts[1]) + parts[2]) + parts[3])
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.float().bfloat16())
    assert torch.equal(trs.gemm_rs_shard(a, b.transpose(1, 2).contiguous(),
                                   trans_b=True), trs.gemm_rs_shard(a, b))
    a_loc = a[:, :8]
    full_t, c_t = tag.ag_gemm_shard(a_loc, b.transpose(1, 2).contiguous(),
                              trans_b=True)
    full, c = tag.ag_gemm_shard(a_loc, b)
    assert torch.equal(full_t, full) and torch.equal(c_t, c)


@pytest.mark.parametrize("m,k,n", [(40, 200, 256), (16, 128, 128)])
def test_matmul_plain_matches_pallas(m, k, n):
    """gemm.matmul (its plain version on CPU tensors) against the
    reference's ``matmul`` in interpret mode, with a K tail (k 200 over
    block_k 128: the kernel's masked last block) and a ragged M edge (m 40
    over block_m 16), f32 within 1e-5; the out_dtype rule."""
    from triton_dist_tpu_torch.kernels import gemm as tgemm

    jg = importlib.import_module("triton_dist_tpu.kernels.gemm")
    a, b = _inputs(200 + k, (m, k), (k, n))
    want = jg.matmul(jnp.asarray(a), jnp.asarray(b),
                     config=jg.MatmulConfig(block_m=16, block_n=128,
                                            block_k=128), interpret=True)
    n0 = tgemm.matmul.launches
    got = tgemm.matmul(_t(a), _t(b))
    assert tgemm.matmul.launches == n0
    assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    half = tgemm.matmul(_t(a).bfloat16(), _t(b).bfloat16(),
                        out_dtype=torch.float32)
    assert half.dtype == torch.float32
    assert torch.equal(half, _t(a).bfloat16().float()
                       @ _t(b).bfloat16().float())


@pytest.mark.parametrize("kind", ["column", "row"])
def test_tp_linear_vjp_matches_reference(kind, mesh4):
    """column_parallel_linear / row_parallel_linear (their autograd
    Functions over the plain versions) against ``jax.vjp`` of the
    reference's custom-VJP linears inside ``shard_map`` on a 4-device mesh
    (``impl="xla"``): the output, dA and dB of every rank within 1e-5
    (f32)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.layers import tp_linear as ttl

    jtl = importlib.import_module("triton_dist_tpu.layers.tp_linear")
    W, m_loc, K, n_loc = 4, 8, 64, 16
    if kind == "column":
        a, b, ct = _inputs(210, (W * m_loc, K), (K, W * n_loc),
                           (W, W * m_loc, n_loc))
        fn, specs = jtl.column_parallel_linear, (P("tp", None),
                                                 P(None, "tp"))
        ta = _t(a).reshape(W, m_loc, K)
        tb = _stack_cols(b, W)
        port = ttl.column_parallel_linear
    else:
        a, b, ct = _inputs(211, (W * m_loc, W * n_loc), (W * n_loc, K),
                           (W, m_loc, K))
        fn, specs = jtl.row_parallel_linear, (P(None, "tp"), P("tp", None))
        ta = torch.stack(_t(a).chunk(W, dim=1))
        tb = _stack_rows(b, W)
        port = ttl.row_parallel_linear

    def shard(x, w, g):
        y, vjp = jax.vjp(lambda x_, w_: fn(x_, w_, "tp", "xla"), x, w)
        dx, dw = vjp(g[0])
        return y[None], dx[None], dw[None]

    want = _shard_map(shard, mesh4, (*specs, P("tp")),
                      (P("tp"), P("tp"), P("tp")), jnp.asarray(a),
                      jnp.asarray(b), jnp.asarray(ct))
    xg, wg = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    y = port(xg, wg)
    assert type(y.grad_fn).__name__.endswith("ParallelLinearFnBackward")
    dx, dw = torch.autograd.grad(y, (xg, wg), _t(ct))
    for got, w_ in zip((y, dx, dw), want):
        assert_allclose(got, np.asarray(w_), atol=1e-5, rtol=1e-5)
    # world 1 (2-D operands): a plain product
    assert torch.equal(port(ta[0], tb[0]), ta[0] @ tb[0])
    # the W8A8 twins are forward-only: no autograd Function
    assert not hasattr(ttl, "ColumnParallelLinearW8A8Fn")


def _spy(monkeypatch, module, name):
    """Record the ``world`` of every trace of ``module.name``."""
    traced = []
    kernel = getattr(module, name)

    def spy(*args, **kw):
        traced.append(kw["world"])
        return kernel(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return traced


def test_ag_gemm_i8_plain_matches_pallas(monkeypatch, mesh4):
    """The AG-GEMM's int8 mode: ``ag_gemm`` on int8 CPU tensors (its plain
    version, ``ag_gemm_i8``'s count unmoved) against the reference's
    ``_ag_gemm_kernel`` on int8 A in interpret mode (spied) on mesh4,
    per-device (m_loc 16, K 256, n_loc 128): the gathered int8 A and the
    int32 C of every rank exactly equal (the accumulation is exact)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import allgather_gemm as tag

    jag = importlib.import_module("triton_dist_tpu.kernels.allgather_gemm")
    traced = _spy(monkeypatch, jag, "_ag_gemm_kernel")
    W, m_loc, K, n_loc = 4, 16, 256, 128
    rng = np.random.default_rng(175)
    a = rng.integers(-127, 128, size=(W * m_loc, K), dtype=np.int8)
    b = rng.integers(-127, 128, size=(K, W * n_loc), dtype=np.int8)

    def shard(x, w):
        a_full, c = jag.ag_gemm_shard(x, w, axis="tp", impl="pallas", bm=16,
                                      bn=128, bk=128, interpret=True)
        return a_full[None], c[None]

    want_full, want_c = _shard_map(shard, mesh4,
                                   (P("tp", None), P(None, "tp")),
                                   (P("tp"), P("tp")), jnp.asarray(a),
                                   jnp.asarray(b))
    assert traced and set(traced) == {W}
    assert np.asarray(want_c).dtype == np.int32
    n0 = (tag.ag_gemm_shard.launches, tag.ag_gemm_i8.launches)
    a_full, c = tag.ag_gemm_shard(_t(a).reshape(W, m_loc, K),
                                  _stack_cols(b, W))
    assert (tag.ag_gemm_shard.launches, tag.ag_gemm_i8.launches) == n0
    assert a_full.dtype == torch.int8 and c.dtype == torch.int32
    assert np.array_equal(a_full.numpy(), np.asarray(want_full))
    assert np.array_equal(c.numpy(), np.asarray(want_c))
    with pytest.raises(ValueError, match="without trans_b"):
        tag.ag_gemm_shard(_t(a).reshape(W, m_loc, K),
                    _stack_cols(b, W).transpose(1, 2).contiguous(),
                    trans_b=True)


@pytest.mark.parametrize("m_loc,impl", [(8, "pallas"), (24, "pallas"),
                                        (5, "xla")])
@pytest.mark.parametrize("op", ["ag_gemm", "gemm_rs"])
def test_ring_plain_versions_take_ragged_rows(op, m_loc, impl, monkeypatch,
                                              mesh4):
    """Row counts that are no multiple of the kernels' 128-row tile: the
    plain versions of ag_gemm and gemm_rs (the kernels mask each segment's
    row tail on the card) against the reference at m_loc 8 and 24 (its
    Pallas ring kernels in interpret mode, spied) and 5 (its XLA path,
    which takes any row count) on mesh4, f32 within 1e-5 (the gathered A
    bit for bit)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import allgather_gemm as tag
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as trs

    W, K, n = 4, 256, 128
    kw = dict(axis="tp", impl=impl, interpret=impl == "pallas")
    if impl == "pallas":
        kw.update(bm=8, bn=128, bk=128)
    if op == "ag_gemm":
        jag = importlib.import_module(
            "triton_dist_tpu.kernels.allgather_gemm")
        traced = _spy(monkeypatch, jag, "_ag_gemm_kernel")
        a, b = _inputs(220 + m_loc, (W * m_loc, K), (K, W * n))
        b /= np.sqrt(K)

        def shard(x, w):
            a_full, c = jag.ag_gemm_shard(x, w, **kw)
            return a_full[None], c[None]

        want_full, want_c = _shard_map(shard, mesh4,
                                       (P("tp", None), P(None, "tp")),
                                       (P("tp"), P("tp")), jnp.asarray(a),
                                       jnp.asarray(b))
        a_full, c = tag.ag_gemm_shard(_t(a).reshape(W, m_loc, K),
                                _stack_cols(b, W))
        assert np.array_equal(a_full.numpy(), np.asarray(want_full))
        assert_allclose(c, np.asarray(want_c), atol=1e-5, rtol=1e-5)
    else:
        jrs = importlib.import_module(
            "triton_dist_tpu.kernels.gemm_reduce_scatter")
        traced = _spy(monkeypatch, jrs, "_gemm_rs_kernel")
        a, b = _inputs(230 + m_loc, (W * m_loc, W * K), (W * K, n))
        b /= np.sqrt(W * K)
        want = _shard_map(lambda x, w: jrs.gemm_rs_shard(x, w, **kw), mesh4,
                          (P(None, "tp"), P("tp", None)), P("tp"),
                          jnp.asarray(a), jnp.asarray(b))
        out = trs.gemm_rs_shard(torch.stack(_t(a).chunk(W, dim=1)),
                          _stack_rows(b, W))
        assert out.shape == (W, m_loc, n)
        assert_allclose(out.reshape(W * m_loc, n), np.asarray(want),
                        atol=1e-5, rtol=1e-5)
    assert (set(traced) == {W}) if impl == "pallas" else not traced


def _median_rel_err(y, ref):
    y, ref = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    return np.median(np.abs(y - ref) / (np.abs(ref) + 1e-3))


@pytest.mark.parametrize("kind", ["column", "row"])
def test_tp_linear_w8a8_matches_reference(kind, mesh4):
    """``column_parallel_linear_w8a8`` / ``row_parallel_linear_w8a8`` over
    the plain versions against the reference's inside shard_map on mesh4
    (``impl="xla"``, tests/test_tp_linear_w8a8.py's shapes and per-rank
    quantization), every rank's output within 1e-5 (the same int8 bytes,
    the exact int32 products, f32 dequant in the reference's order; the
    row sum over ranks in f32), and both within that test's oracle: median
    relative error against the float product < 0.02."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.layers import tp_linear as ttl

    jtl = importlib.import_module("triton_dist_tpu.layers.tp_linear")
    W, M, K, N = 4, 64, 4 * 128, 4 * 128
    a, w = _inputs(240 if kind == "column" else 241, (M, K), (K, N))
    w /= 8.0
    if kind == "column":
        w_q, w_s = jq.quantize_channelwise(jnp.asarray(w))
        want = _shard_map(
            lambda x, q, sc: jtl.column_parallel_linear_w8a8(
                x, q, sc, "tp", impl="xla"), mesh4,
            (P("tp", None), P(None, "tp"), P("tp")), P(None, "tp"),
            jnp.asarray(a), w_q, w_s)
        got = ttl.column_parallel_linear_w8a8(
            _t(a).reshape(W, M // W, K), _stack_cols(np.array(w_q), W),
            torch.stack(_t(np.array(w_s)).chunk(W)))
        assert got.shape == (W, M, N // W)
        got = torch.cat(list(got), dim=1)                    # [M, N]
    else:
        k_loc = K // W
        chunks = [jq.quantize_channelwise(jnp.asarray(w[i * k_loc:
                                                        (i + 1) * k_loc]))
                  for i in range(W)]
        w_q = jnp.concatenate([c[0] for c in chunks], axis=0)
        w_s = jnp.stack([c[1] for c in chunks], axis=0)      # [W, N]
        want = _shard_map(
            lambda x, q, sc: jtl.row_parallel_linear_w8a8(
                x, q, sc[0], "tp", impl="xla"), mesh4,
            (P(None, "tp"), P("tp", None), P("tp", None)), P("tp", None),
            jnp.asarray(a), w_q, w_s)
        got = ttl.row_parallel_linear_w8a8(
            torch.stack(_t(a).chunk(W, dim=1)),
            _stack_rows(np.array(w_q), W), _t(np.array(w_s)))
        assert got.shape == (W, M // W, N)
        got = got.reshape(M, N)
    assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    assert _median_rel_err(got.numpy(), a @ w) < 0.02
    assert _median_rel_err(np.asarray(want), a @ w) < 0.02


# ---------------------------------------------------------------------------
# sequence parallelism: the combine, the SP decodes, SP flash
# ---------------------------------------------------------------------------

SP_TOL = 1e-5


def _sp_partials(seed, world, B, H):
    """Rank-stacked decode partials with rank 1 dead (it holds nothing of
    any row) and row (0, 0) dead on every rank (out 0, lse NEG_INF)."""
    out, lse = _inputs(seed, (world, B, H, D), (world, B, H))
    lse = 3 * lse
    out[1], lse[1] = 0, tfd.NEG_INF
    out[:, 0, 0], lse[:, 0, 0] = 0, tfd.NEG_INF
    return out, lse


def test_sp_combine_plain_matches_pallas(mesh4):
    """The port's plain combine (``sp_combine_shard`` on CPU tensors)
    against the reference's comm-fused ``_sp_combine_kernel`` in interpret
    mode under shard_map on mesh4 (tests/test_flash_decode.py's
    harness), within 1e-5; the dead row merges to exactly 0 on both
    sides, and every rank holds the same result."""
    from jax.sharding import PartitionSpec as P

    world, B, H = 4, 2, 8
    out, lse = _sp_partials(30, world, B, H)

    def shard(o, l):
        r = jax.lax.axis_index("tp")
        return jfd.sp_combine_shard(o[r], l[r], axis="tp", interpret=True)

    want = _shard_map(shard, mesh4, (P(), P()), P(), jnp.asarray(out),
                      jnp.asarray(lse))
    got = tfd.sp_combine_shard(_t(out), _t(lse), all_ranks=True)
    assert got.shape == (world, B, H, D) and got.dtype == torch.float32
    for r in range(world):
        assert_allclose(got[r], np.asarray(want), atol=SP_TOL, rtol=SP_TOL)
    assert torch.all(got[:, 0, 0] == 0) and np.all(np.asarray(want)[0, 0]
                                                   == 0)
    assert_allclose(tfd.combine_partials(_t(out), _t(lse)),
                    np.asarray(jfd.combine_partials(out, lse)), atol=SP_TOL,
                    rtol=SP_TOL)
    # world 1 passes through
    assert torch.equal(tfd.sp_combine_shard(_t(out[:1]), _t(lse[:1])),
                       _t(out[0]))


def _combine_protocol(sch):
    """Walk csrc/sp_combine.cu's loops for every rank over a schedule:
    (signals per flag, waits per flag, merged rows per owner), flags keyed
    (rank holding it, kind, source or 0, chunk)."""
    W, per_chunk = sch.world, -(-sch.chunk_rows // sch.merge_rows)
    signals, waits, merged = {}, {}, {o: [] for o in range(W)}

    def bump(d, key):
        d[key] = d.get(key, 0) + 1

    for me in range(W):
        for c in range(sch.n_chunk):               # scatter
            bump(signals, (c // sch.cpo, "scatter", me, c))
        for it in range(sch.cpo * per_chunk):      # merge items
            c = me * sch.cpo + it // per_chunk
            if c >= sch.n_chunk:
                break
            r0, r1 = sch.chunk(c)
            pieces = -(-(r1 - r0) // sch.merge_rows)
            piece = it % per_chunk
            if piece >= pieces:
                continue
            for src in range(W):
                bump(waits, (me, "scatter", src, c))
            a = r0 + piece * sch.merge_rows
            merged[me].extend(range(a, min(a + sch.merge_rows, r1)))
            if piece == pieces - 1:                # the count's last piece
                for dst in range(W):
                    bump(signals, (dst, "final", 0, c))
        for c in range(sch.n_chunk):               # closing wait
            bump(waits, (me, "final", 0, c))
    return signals, waits, merged


@pytest.mark.parametrize("world", range(2, 9))
@pytest.mark.parametrize("which", ["1", "W-1", "W", "257", "16384"])
def test_combine_schedule_owns_every_row_once(world, which):
    """The owner merge's plan (``combine_schedule``, what
    ``csrc/sp_combine.cu`` runs): chunks tile the rows, every chunk (so
    every row) has one owner whose band holds it, the merge items cover
    each owned chunk once, and walking the kernel's loops, every flag a
    rank waits on is set exactly once per call (per source and owned
    chunk on the owner; per chunk on every rank), each merge wait once,
    and the flag counts equal the schedule's."""
    bh = {"1": 1, "W-1": world - 1, "W": world, "257": 257,
          "16384": 16384}[which]
    sch = tfd.combine_schedule(world, bh, D)
    assert sch.n_chunk == -(-bh // sch.chunk_rows)
    assert sch.cpo == -(-sch.n_chunk // world)
    assert sch.chunk_rows * (D + tfd.SP_PLANE_PAD) * 4 <= tfd.SP_CHUNK_BYTES
    assert sch.merge_rows * (D // 4) <= \
        tfd.SP_COMBINE_VEC * tfd.SP_COMBINE_THREADS
    rows = [r for c in range(sch.n_chunk) for r in range(*sch.chunk(c))]
    assert rows == list(range(bh))
    owned = [c for o in range(world) for c in sch.owned(o)]
    assert owned == list(range(sch.n_chunk))
    band = sch.cpo * sch.chunk_rows
    for o in range(world):
        for c in sch.owned(o):
            r0, r1 = sch.chunk(c)
            assert o * band <= r0 < r1 <= (o + 1) * band
    signals, waits, merged = _combine_protocol(sch)
    for o in range(world):
        owned_rows = sorted(r for c in sch.owned(o)
                            for r in range(*sch.chunk(c)))
        assert sorted(merged[o]) == owned_rows
        assert sum(1 for k in waits if k[:2] == (o, "scatter")) == \
            sch.scatter_waits(o)
        assert sum(1 for k in waits if k[:2] == (o, "final")) == \
            sch.final_waits()
        assert sum(sch.pieces(c) for c in sch.owned(o)) == sum(
            1 for k, n in waits.items()
            if k[:3] == (o, "scatter", 0) for _ in range(n))
    assert set(signals) == {k for k in waits}
    assert all(n == 1 for n in signals.values())
    if bh < world:     # owners past the last row have an empty band
        assert all(not sch.owned(o) for o in range(bh, world))


FLASH_OPERANDS = {
    # name: (tensor factory, accepted)
    "contiguous": (lambda: torch.empty(2, 8, 96, 128), True),
    "seq_first_view": (lambda: torch.empty(300, 2, 8, 128).permute(
        1, 2, 0, 3), True),
    "chunk_transpose": (lambda: torch.empty(2, 96, 32, 128).transpose(
        1, 2), True),
    "cache_slice": (lambda: torch.empty(1, 2, 512, 128)[:, :, 7:200], True),
    "one_row_dims": (lambda: torch.empty(1, 1, 5, 128).as_strided(
        (1, 1, 5, 128), (3, 5, 128, 1)), True),
    "s_stride_264B": (lambda: torch.empty(1, 2, 64, 132)[..., :128], False),
    "offset_8B": (lambda: torch.empty(4 + 2 * 64 * 128)[4:].view(
        1, 2, 64, 128), False),
    "broadcast_s": (lambda: torch.empty(1, 2, 1, 128).expand(1, 2, 64, 128),
                    False),
    "head_dim_64": (lambda: torch.empty(1, 2, 64, 64), False),
    "d_stride_2": (lambda: torch.empty(1, 2, 64, 256)[..., ::2], False),
}


@pytest.mark.parametrize("name", sorted(FLASH_OPERANDS))
def test_flash_operand_predicate(name):
    """``flash_operand_ok``, what the bf16 forward kernel's TMA reads, as
    a function of the layout: views the model paths make are accepted,
    a misaligned s-stride or base, a broadcast dim, another head dim or
    a strided d are refused; f32 is refused whatever the layout."""
    make, ok = FLASH_OPERANDS[name]
    x = make()       # element strides: the predicate reads them as bf16
    assert tfa.flash_operand_ok(x.shape, x.stride(), torch.bfloat16,
                                x.storage_offset()) is ok
    assert not tfa.flash_operand_ok(x.shape, x.stride(), torch.float32,
                                    x.storage_offset())


SP_DECODE_CASES = {
    # name: (B, T, Hq, Hkv, lens, q_lens, window, soft_cap, int8)
    "t1": (3, 1, 4, 2, [512, 300, 77], None, 0, 0.0, False),
    "multi": (2, 3, 4, 1, [400, 129], [3, 2], 0, 0.0, False),
    "window": (2, 1, 4, 2, [500, 260], None, 200, 20.0, False),
    "multi_window": (2, 2, 4, 2, [385, 300], [2, 0], 150, 0.0, False),
    "int8": (2, 1, 4, 2, [512, 90], None, 0, 0.0, True),
}


def _sp_decode_jax(world, request, q, k, v, lens, *, paged=None, **kw):
    """The reference's ``sp_gqa_decode_shard`` (or, with ``paged =
    (tables [W, B, n], nb_loc)``, ``sp_gqa_decode_paged_shard`` over
    per-rank pools) inside shard_map on the conftest's mesh, its local
    decode and combine in interpret mode (int8 caches: ``impl="xla"``,
    the reference's own plain path)."""
    from jax.sharding import PartitionSpec as P

    mesh = _mesh(world, request)
    scales = kw.pop("scales", None)
    impl = dict(impl="xla") if scales is not None else dict(
        impl="pallas", interpret=True)
    if kw.get("q_lens") is not None:
        kw["q_lens"] = jnp.asarray(kw["q_lens"])
    seq = P(None, None, "tp")
    if paged is None:
        def shard(q_, k_, v_, l_, *sc):
            ks, vs = sc if sc else (None, None)
            return jfd.sp_gqa_decode_shard(q_, k_, v_, l_, axis="tp",
                                           block_s=128, k_scale=ks,
                                           v_scale=vs, **impl, **kw)

        args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(lens)]
        specs = [P(), seq, seq, P()]
        if scales is not None:
            args += [jnp.asarray(s) for s in scales]
            specs += [seq, seq]
        return np.asarray(_shard_map(shard, mesh, tuple(specs), P(), *args))
    tables, nb_loc = paged

    def shard(q_, kp, vp, tab, l_, *sc):
        ks, vs = sc if sc else (None, None)
        r = jax.lax.axis_index("tp")
        return jfd.sp_gqa_decode_paged_shard(
            q_, kp, vp, tab[r] - r * nb_loc, l_, axis="tp", k_scale=ks,
            v_scale=vs, **impl, **kw)

    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(tables), jnp.asarray(lens)]
    specs = [P(), P("tp"), P("tp"), P(), P()]
    if scales is not None:
        args += [jnp.asarray(s) for s in scales]
        specs += [P("tp"), P("tp")]
    return np.asarray(_shard_map(shard, mesh, tuple(specs), P(), *args))


def _sp_decode_inputs(name, world):
    B, T, Hq, Hkv, lens, q_lens, window, cap, int8 = SP_DECODE_CASES[name]
    S = 512
    qshape = (B, T, Hq, D) if T > 1 else (B, Hq, D)
    q, k, v = _inputs(40 + world + len(name), qshape, (B, Hkv, S, D),
                      (B, Hkv, S, D))
    kw = dict(window=window, soft_cap=cap,
              q_lens=None if q_lens is None else np.asarray(q_lens,
                                                            np.int32))
    return q, k, v, np.asarray(lens, np.int32), kw, int8


@pytest.mark.parametrize("name,world", [
    ("t1", 4), ("t1", 2), ("multi", 2), ("window", 4), ("multi_window", 2),
    ("int8", 4)])
def test_sp_decode_plain_matches_reference(name, world, request):
    """``sp_gqa_decode_shard`` (rank-stacked spans, every rank's decode
    folded into one batch, then the combine) against the reference's on
    mesh2 / mesh4: single- and multi-token q (a dead query row), the
    global window rule with a soft cap, int8 scales, and a request live on
    rank 0 only (77 / 90 tokens); within 1e-5.  The context entry
    ``sp_gqa_decode`` gives the same."""
    q, k, v, lens, kw, int8 = _sp_decode_inputs(name, world)
    scales = None
    if int8:
        (k, ks), (v, vs) = (tuple(np.asarray(x) for x in
                                  jfd.quantize_kv(jnp.asarray(c)))
                            for c in (k, v))
        scales = (ks, vs)
    want = _sp_decode_jax(world, request, q, k, v, lens, scales=scales,
                          **dict(kw))
    tkw = dict(kw, q_lens=None if kw["q_lens"] is None else _t(kw["q_lens"]))
    shard = [tfd.shard_seq(_t(x), world) for x in (k, v)]
    sc = {} if scales is None else dict(
        k_scale=tfd.shard_seq(_t(scales[0]), world),
        v_scale=tfd.shard_seq(_t(scales[1]), world))
    got = tfd.sp_gqa_decode_shard(_t(q), *shard, _t(lens), **sc, **tkw)
    assert got.shape == q.shape and got.dtype == torch.float32
    assert_allclose(got, want, atol=SP_TOL, rtol=SP_TOL)
    if not (int8 or kw["q_lens"] is not None):
        ctx = tfd.create_sp_decode_context(world, window=kw["window"],
                                           soft_cap=kw["soft_cap"],
                                           device="cpu")
        assert torch.equal(tfd.sp_gqa_decode(_t(q), *shard, _t(lens), ctx),
                           got)


@pytest.mark.parametrize("name,world", [
    ("t1", 4), ("multi_window", 2), ("int8", 2)])
def test_sp_decode_paged_plain_matches_reference(name, world, request):
    """``sp_gqa_decode_paged_shard`` over ONE pool holding every rank's
    pages (rank r's rows [r * nb_loc, (r + 1) * nb_loc), shuffled; the
    rank-stacked tables point into them) against the reference's over
    per-rank pools and local tables on mesh2 / mesh4, page 128 (the
    Pallas paged kernel's page); within 1e-5."""
    q, k, v, lens, kw, int8 = _sp_decode_inputs(name, world)
    B, Hkv, S = k.shape[:3]
    page = 128
    n_loc = S // page // world
    nb_loc = B * n_loc + 1                       # + the rank's null row
    rng = np.random.default_rng(50 + world)
    tables = np.zeros((world, B, n_loc), np.int32)
    pool_k = np.zeros((world * nb_loc, Hkv, page, D), np.float32)
    pool_v = np.zeros_like(pool_k)
    for r in range(world):
        tables[r] = (r * nb_loc + 1 + rng.permutation(B * n_loc)).reshape(
            B, n_loc)
        span = slice(r * n_loc * page, (r + 1) * n_loc * page)
        for src, pool in ((k, pool_k), (v, pool_v)):
            pool[tables[r]] = src[:, :, span].reshape(
                B, Hkv, n_loc, page, D).transpose(0, 2, 1, 3, 4)
    scales = None
    if int8:
        (pool_k, ks), (pool_v, vs) = (
            tuple(np.asarray(x) for x in jfd.quantize_kv(jnp.asarray(c)))
            for c in (pool_k, pool_v))
        scales = (ks, vs)
    want = _sp_decode_jax(world, request, q, pool_k, pool_v, lens,
                          paged=(tables, nb_loc), scales=scales, **dict(kw))
    tkw = dict(kw, q_lens=None if kw["q_lens"] is None else _t(kw["q_lens"]))
    sc = {} if scales is None else dict(k_scale=_t(scales[0]),
                                        v_scale=_t(scales[1]))
    got = tfd.sp_gqa_decode_paged_shard(_t(q), _t(pool_k), _t(pool_v),
                                        _t(tables), _t(lens), **sc, **tkw)
    assert_allclose(got, want, atol=SP_TOL, rtol=SP_TOL)


@pytest.mark.parametrize("q_offset,window,dead", [(256, 0, 3),
                                                   (320, 100, 0)])
def test_sp_flash_attention_plain_matches_pallas(q_offset, window, dead,
                                                 mesh4):
    """``sp_flash_attention_shard`` (a flash call per rank at its global
    ``kv_offset``, the partials merged over the rank dimension) against
    the reference's under shard_map on mesh4 with its flash kernel in
    interpret mode: a 128-row chunk over 512 keys (128 per rank; one
    rank's span sees nothing, in the future or outside the window, and
    merges away), within 1e-5."""
    from jax.sharding import PartitionSpec as P

    world, B, Hq, Hkv, Sq, S = 4, 1, 4, 2, 128, 512
    q, k, v = _inputs(60 + window, (B, Hq, Sq, D), (B, Hkv, S, D),
                      (B, Hkv, S, D))

    def shard(q_, k_, v_):
        return jfa.sp_flash_attention_shard(
            q_, k_, v_, axis="tp", causal=True, q_offset=q_offset,
            impl="pallas", interpret=True, window=window)

    seq = P(None, None, "tp")
    want = _shard_map(shard, mesh4, (P(), seq, seq), P(), jnp.asarray(q),
                      jnp.asarray(k), jnp.asarray(v))
    got = tfa.sp_flash_attention_shard(
        _t(q), tfd.shard_seq(_t(k), world), tfd.shard_seq(_t(v), world),
        causal=True, q_offset=q_offset, window=window)
    assert got.shape == q.shape
    assert_allclose(got, np.asarray(want), atol=SP_TOL, rtol=SP_TOL)
    outs, lses = tfa.sp_flash_partials(
        _t(q), tfd.shard_seq(_t(k), world), tfd.shard_seq(_t(v), world),
        q_offset=q_offset, window=window)
    assert torch.all(lses[dead] == tfd.NEG_INF)
    assert torch.all(outs[dead] == 0)


# ---------------------------------------------------------------------------
# Context parallelism: segmented flash, ring attention, Ulysses
# ---------------------------------------------------------------------------

jra = importlib.import_module("triton_dist_tpu.kernels.ring_attention")
jua = importlib.import_module("triton_dist_tpu.kernels.ulysses_attention")
GRAD_TOL = 5e-4


SEG_CASES = {
    # name: (q_offset, kv_offset, window, soft_cap): Sq = Sk = 256 in two
    # runs of 128 (a zigzag shard's two chunks against another block's)
    "zigzag_own": ((0, 896), (0, 896), 0, 0.0),
    "zigzag_peer": ((256, 640), (128, 768), 0, 0.0),
    "window_cap": ((256, 640), (384, 512), 300, 9.0),
}


@pytest.mark.parametrize("name", sorted(SEG_CASES))
def test_flash_segmented_plain_matches_pallas(name):
    """The segmented mode (run-start tuples) of ``flash_attention_ref``
    and ``flash_attention_bwd_ref`` against the reference's Pallas
    ``_flash_kernel`` and ``_flash_bwd_pallas`` (dq and dkv kernels) with
    the same tuples, in interpret mode: Sq 256 in two runs of 128, f32,
    forward 2e-5, gradients (``grad_dtype`` f32, the ring's) 5e-5; rows
    that see no key give out 0 and lse NEG_INF on both sides."""
    qo, ko, window, cap = SEG_CASES[name]
    B, Hq, Hkv, S = 1, 4, 2, 256
    q, k, v, do = _inputs(70 + len(name), (B, Hq, S, D), (B, Hkv, S, D),
                          (B, Hkv, S, D), (B, Hq, S, D))
    kw = dict(causal=True, q_offset=qo, kv_offset=ko, window=window,
              soft_cap=cap)
    j_out, j_lse = jfa.flash_attention(q, k, v, return_lse=True,
                                       impl="pallas", interpret=True, **kw)
    t_out, t_lse = tfa.flash_attention(_t(q), _t(k), _t(v), return_lse=True,
                                       **kw)
    assert_allclose(t_out, np.asarray(j_out), atol=TOL, rtol=TOL)
    assert_allclose(t_lse, np.asarray(j_lse), atol=TOL, rtol=TOL)
    scale = 1.0 / np.sqrt(D)
    want = jfa._flash_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), j_out, j_lse,
        jnp.asarray(do), qo, ko, True, scale, True, soft_cap=cap,
        window=window, grad_dtype=jnp.float32)
    got = tfa.flash_attention_bwd(_t(q), _t(k), _t(v), t_out, t_lse, _t(do),
                                  grad_dtype=torch.float32, **kw)
    for g, j in zip(got, want):
        assert g.dtype == torch.float32
        assert_allclose(g, np.asarray(j), atol=5e-5, rtol=5e-5)


def test_flash_per_row_offsets_match_rowwise_calls():
    """The port's fold of ranks into the batch: one call with per-batch-
    row run starts equals one call per row with that row's starts (the
    plain versions), forward and gradients, exactly."""
    q, k, v, do = (_t(x) for x in _inputs(77, (3, 4, 256, D), (3, 2, 256, D),
                                          (3, 2, 256, D), (3, 4, 256, D)))
    rows_q = ((0, 896), (128, 768), (256, 640))
    rows_k = ((256, 640), (0, 896), (512, 384))
    out, lse = tfa.flash_attention(q, k, v, q_offset=rows_q,
                                   kv_offset=rows_k, return_lse=True)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, q_offset=rows_q,
                                    kv_offset=rows_k)
    for b in range(3):
        sl = slice(b, b + 1)
        o_b, l_b = tfa.flash_attention(q[sl], k[sl], v[sl],
                                       q_offset=rows_q[b],
                                       kv_offset=rows_k[b], return_lse=True)
        assert torch.equal(o_b, out[sl]) and torch.equal(l_b, lse[sl])
        g_b = tfa.flash_attention_bwd(q[sl], k[sl], v[sl], o_b, l_b, do[sl],
                                      q_offset=rows_q[b],
                                      kv_offset=rows_k[b])
        for x, y in zip(g_b, grads):
            assert_allclose(x, y[sl], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="per-row"):
        tfa.flash_attention(q, k, v, q_offset=rows_q[:2])


RING_PLAN_LAYOUTS = {
    # name: (S_loc, B, Hq, Hkv, causal, window, zigzag)
    "contiguous": (256, 1, 8, 2, True, 0, False),
    "zigzag": (384, 1, 4, 1, True, 0, True),       # 192-row chunks
    "window": (300, 2, 8, 1, True, 200, False),    # a row tail too
    "noncausal": (128, 1, 16, 2, False, 0, False),
}


def _ref_live_count(world, s_loc, group, rank, qt, *, causal, window,
                    zigzag):
    """Live K / V tiles of compute item (rank, q tile qt) over the W ring
    steps by the reference's ``_block_live`` on each tile's first and last
    positions (``RING_BM`` folded rows, ``RING_BN`` keys), positions from
    the reference's ``_shard_starts``."""
    from triton_dist_tpu_torch.kernels import ring_attention as tra

    def pos(r, i):
        starts = jra._shard_starts(r, s_loc, world, zigzag)
        run = s_loc // len(starts)
        return starts[i // run] + i % run

    bq = tra.RING_BM // group
    i0, i1 = qt * bq, min(qt * bq + bq, s_loc) - 1
    qf, ql = pos(rank, i0), pos(rank, i1)
    n = 0
    for s in range(world):
        src = (rank - s) % world
        for k0 in range(0, s_loc, tra.RING_BN):
            kf = pos(src, k0)
            kl = pos(src, min(k0 + tra.RING_BN, s_loc) - 1)
            n += bool(jfa._block_live(qf, kf, causal=causal, window=window,
                                      bq=ql - qf + 1, bk=kl - kf + 1))
    return n


@pytest.mark.parametrize("world", range(1, 9))
@pytest.mark.parametrize("layout", sorted(RING_PLAN_LAYOUTS))
def test_ring_plan_item_table(layout, world):
    """The fused ring kernel's one item list over every folded rank, as
    ``_ring_plan`` builds it (an int32 tensor on the workspace's device):
    every copy item (s, rank, pair, chunk) once, all before every compute
    item and in step order; every compute item (rank, pair, q tile) once;
    compute costs non-increasing along the list, each equal to the live
    tile count by the reference's ``_block_live`` rule."""
    from triton_dist_tpu_torch.kernels import ring_attention as tra
    from triton_dist_tpu_torch.runtime.bootstrap import get_world

    s_loc, b, hq, hkv, causal, window, zigzag = RING_PLAN_LAYOUTS[layout]
    group, bh = hq // hkv, b * hkv
    kw = dict(causal=causal, window=window, zigzag=zigzag)
    ws = get_world(world, torch.device("cpu")).workspace
    plan = tra._ring_plan(ws, bh, s_loc, D, group=group, **kw)
    n_rc, items, n_copy = plan[1], plan[-2], plan[-1]
    assert items.dtype == torch.int32 and items.device.type == "cpu"
    items = items.numpy()
    assert n_copy == (world - 1) * world * bh * n_rc
    copy, comp = items[:n_copy], items[n_copy:]
    assert sorted(map(tuple, copy)) == [
        (s, r, p, c) for s in range(1, world) for r in range(world)
        for p in range(bh) for c in range(n_rc)]
    assert np.all(np.diff(copy[:, 0]) >= 0)          # step by step
    n_qt = -(-s_loc // (tra.RING_BM // group))
    assert np.all(comp[:, 0] == 0)
    assert sorted(map(tuple, comp[:, 1:])) == [
        (r, p, t) for r in range(world) for p in range(bh)
        for t in range(n_qt)]
    cost = [_ref_live_count(world, s_loc, group, r, t, **kw)
            for _, r, _, t in comp]
    assert all(a >= b for a, b in zip(cost, cost[1:]))
    _, _, costs = tra._ring_items(world, s_loc, bh, group, n_rc, **kw)
    assert list(costs[n_copy:]) == cost


def _ring_qkv(seed, S, B=2, Hq=4, Hkv=2, hd=D):
    return _inputs(seed, (S, B, Hq, hd), (S, B, Hkv, hd), (S, B, Hkv, hd))


def _port_ring(q, k, v, world, **kw):
    """The port's host entry ``ring_attention`` on CPU tensors."""
    from triton_dist_tpu_torch.kernels import ring_attention as tra

    plain = kw.pop("plain", False)
    ctx = tra.create_ring_attention_context(world, axis="tp", device="cpu",
                                            plain=plain, **kw)
    return tra.ring_attention(_t(q), _t(k), _t(v), ctx)


RING_CASES = {
    # name: (causal, window, soft_cap, zigzag) at S 32 over mesh4
    "causal": (True, 0, 0.0, False),
    "full": (False, 0, 0.0, False),
    "window_cap": (True, 19, 7.0, False),
    "zigzag": (True, 0, 0.0, True),
}


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_pallas_kernel(name, mesh4):
    """The port's dense ring (``plain``) and fused ring (``impl="fused"``:
    ``ring_attn``'s plain version on CPU tensors) against the reference's
    ``impl="pallas"`` in interpret mode (the TPU ``_ring_attn_kernel``
    itself) on mesh4: S 32 (8 positions per rank), hd 128, causal and
    not, window S/2 + 3 with cap 7, zigzag; f32 within 2e-5."""
    causal, window, cap, zigzag = RING_CASES[name]
    q, k, v = _ring_qkv(80 + len(name), 32)
    kw = dict(causal=causal, window=window, soft_cap=cap, zigzag=zigzag)
    ctx = jra.create_ring_attention_context(mesh4, axis="tp", impl="pallas",
                                            interpret=True, **kw)
    want = np.asarray(jra.ring_attention(q, k, v, ctx))
    for impl, plain in (("fused", False), ("auto", True)):
        got = _port_ring(q, k, v, 4, impl=impl, plain=plain, **kw)
        assert got.shape == q.shape
        assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_flash_ring_matches_pallas_flash_ring(mesh4):
    """The port's flash ring (``impl="flash"``: per step one flash call
    over every rank with per-row offsets) against the reference's
    ``impl="flash"`` in interpret mode on mesh4, S 512 (128 per rank),
    causal; f32 within 2e-5; the dense ring agrees too."""
    q, k, v = _ring_qkv(91, 512, B=1)
    ctx = jra.create_ring_attention_context(mesh4, axis="tp", impl="flash",
                                            interpret=True)
    want = np.asarray(jra.ring_attention(q, k, v, ctx))
    for kw in (dict(impl="flash"), dict(plain=True)):
        assert_allclose(_port_ring(q, k, v, 4, **kw), want, atol=TOL,
                        rtol=TOL)


def _jax_ring_grads(q, k, v, w, mesh, **kw):
    import functools

    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(functools.partial(jra.ring_attention_shard, axis="tp",
                                         **kw),
                       mesh=mesh, in_specs=(P("tp"),) * 3, out_specs=P("tp"),
                       check_vma=False)
    return jax.jit(jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * w),
                            argnums=(0, 1, 2)))(jnp.asarray(q),
                                                jnp.asarray(k),
                                                jnp.asarray(v))


@pytest.mark.parametrize("S,impl,zigzag", [(32, "xla", False),
                                           (32, "xla", True),
                                           (512, "flash", False)])
def test_ring_attention_grads_match_reference(S, impl, zigzag, mesh4):
    """Gradients of every port algorithm (the dense ring under autograd,
    the fused kernel's Function whose backward is the dense VJP, and at
    S 512 the flash ring's reverse ring over the flash backward kernels)
    against ``jax.grad`` of the reference's ``ring_attention_shard``
    (``impl="xla"``, or ``"flash"`` in interpret mode) on mesh4, under a
    non-uniform cotangent; f32 within 5e-4."""
    from triton_dist_tpu_torch.kernels import ring_attention as tra

    q, k, v = _ring_qkv(95 + S, S, B=1)
    if zigzag:
        q, k, v = (np.asarray(jra.to_zigzag(jnp.asarray(x), 4))
                   for x in (q, k, v))
    w = _inputs(96, q.shape)[0]
    want = _jax_ring_grads(q, k, v, w, mesh4, impl=impl, zigzag=zigzag,
                           interpret=impl != "xla")
    algos = [dict(plain=True), dict(impl="fused")]
    if S == 512:
        algos.append(dict(impl="flash"))
    for kw in algos:
        x = [_t(a).reshape(4, S // 4, *a.shape[1:]).requires_grad_()
             for a in (q, k, v)]
        out = tra.ring_attention_shard(*x, zigzag=zigzag, **kw)
        got = torch.autograd.grad((out.reshape(q.shape) * _t(w)).sum(), x)
        for g, j in zip(got, want):
            assert_allclose(g.reshape(j.shape), np.asarray(j),
                            atol=GRAD_TOL, rtol=GRAD_TOL)


def test_zigzag_indices_round_trip():
    """zigzag_indices equal the reference's; to_zigzag / from_zigzag are
    inverse permutations and agree with the reference's on a global
    array; a sequence that does not split into 2W chunks is refused."""
    from triton_dist_tpu_torch.kernels import ring_attention as tra

    for S, w in ((32, 4), (48, 2), (8192, 4)):
        assert np.array_equal(tra.zigzag_indices(S, w),
                              jra.zigzag_indices(S, w))
    x = _inputs(97, (32, 3))[0]
    z = tra.to_zigzag(_t(x), 4)
    assert torch.equal(z, _t(np.asarray(jra.to_zigzag(jnp.asarray(x), 4))))
    assert torch.equal(tra.from_zigzag(z, 4), _t(x))
    with pytest.raises(ValueError, match="2\\*world"):
        tra.zigzag_indices(30, 4)


def _ulysses_jax(q, k, v, mesh, w=None):
    import functools

    from jax.sharding import PartitionSpec as P

    fn = jax.shard_map(functools.partial(jua.ulysses_attention_shard,
                                         axis="tp", impl="xla"),
                       mesh=mesh, in_specs=(P("tp"),) * 3, out_specs=P("tp"),
                       check_vma=False)
    args = [jnp.asarray(x) for x in (q, k, v)]
    if w is None:
        return np.asarray(jax.jit(fn)(*args))
    return jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                            argnums=(0, 1, 2)))(*args)


@pytest.mark.parametrize("plain", [False, True])
def test_ulysses_matches_reference(plain, mesh4):
    """``ulysses_attention_shard`` (two all-to-alls, one attention call
    over every rank's heads) and its host entry against the reference's
    ``impl="xla"`` on mesh4: S 64, B 2, Hq 8 / Hkv 4 (2 / 1 per rank),
    forward 2e-5 and gradients 5e-4; heads that do not divide by W are
    refused."""
    from triton_dist_tpu_torch.kernels import ulysses_attention as tua

    q, k, v = _ring_qkv(98, 64, Hq=8, Hkv=4)
    want = _ulysses_jax(q, k, v, mesh4)
    ctx = tua.create_ulysses_context(4, axis="tp", device="cpu", plain=plain)
    got = tua.ulysses_attention(_t(q), _t(k), _t(v), ctx)
    assert_allclose(got, want, atol=TOL, rtol=TOL)
    w = _inputs(99, q.shape)[0]
    jg = _ulysses_jax(q, k, v, mesh4, w)
    x = [_t(a).reshape(4, 16, *a.shape[1:]).requires_grad_()
         for a in (q, k, v)]
    out = tua.ulysses_attention_shard(*x, plain=plain)
    got = torch.autograd.grad((out.reshape(q.shape) * _t(w)).sum(), x)
    for g, j in zip(got, jg):
        assert_allclose(g.reshape(j.shape), np.asarray(j), atol=GRAD_TOL,
                        rtol=GRAD_TOL)
    q3, k3, v3 = (_t(a).reshape(4, 16, *a.shape[1:])
                  for a in _ring_qkv(98, 64, Hq=6, Hkv=2))
    with pytest.raises(ValueError, match="divisible by world"):
        tua.ulysses_attention_shard(q3, k3, v3)


# ---------------------------------------------------------------------------
# Collectives over a mesh: barrier, all-gather, reduce-scatter, the
# latency-tuned all-gather and its layer, the hierarchical compositions
# ---------------------------------------------------------------------------

jag = importlib.import_module("triton_dist_tpu.kernels.allgather")
jrs = importlib.import_module("triton_dist_tpu.kernels.reduce_scatter")
jhi = importlib.import_module("triton_dist_tpu.kernels.hierarchical")


def _tmesh(shape, names):
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    return Mesh(shape, names, "cpu")


def _jmesh(shape, names):
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def _per_rank(fn, mesh, spec, *args):
    """jit(shard_map(fn)) with every rank's result stacked on a new leading
    dimension, sharded like the inputs (``spec``)."""
    from jax.sharding import PartitionSpec as P

    return np.asarray(_shard_map(lambda *a: fn(*a)[None], mesh,
                                 tuple(P(spec) for _ in args), P(spec),
                                 *[jnp.asarray(a) for a in args]))


AG_CASES = {
    # name: (method, rows per rank, multiply after the gather)
    "ring": ("RING_1D", 8, 1.0),
    "bidir": ("RING_BIDIR", 8, 1.0),
    "full_mesh": ("FULL_MESH_PUSH", 8, 1.0),
    "bidir_odd_rows": ("RING_BIDIR", 9, 1.0),
    "ring_in_user_shard": ("RING_1D", 8, 2.0),
}


@pytest.mark.parametrize("name", sorted(AG_CASES))
def test_all_gather_plain_matches_pallas(name, mesh4, monkeypatch):
    """all_gather_shard (its plain version, a concatenation, on CPU
    tensors) against the reference's interpret-mode Pallas kernels on
    mesh4 (spied: the kernel of the method traces), every rank's gathered
    [4 rows, 128] f32 bit for bit; bidir on odd rows takes the ring, as
    the reference does; a user function around the gather (x 2) too."""
    from triton_dist_tpu_torch.kernels import allgather as tag

    meth, rows, scale = AG_CASES[name]
    traced = []
    jmeth = getattr(jag.AllGatherMethod, meth)
    kern_meth = (jag.AllGatherMethod.RING_1D if rows % 2 and
                 meth == "RING_BIDIR" else jmeth)
    kernel, n_sem = jag._KERNELS[kern_meth]

    def spy(*a, **kw):
        traced.append(kw["world"])
        return kernel(*a, **kw)

    monkeypatch.setitem(jag._KERNELS, kern_meth, (spy, n_sem))
    x = _inputs(300 + rows, (4 * rows, 128))[0]
    want = _per_rank(lambda s: jag.all_gather_shard(
        s, "tp", method=jmeth, interpret=True) * scale, mesh4, "tp", x)
    assert traced and set(traced) == {4}
    n0 = tag.all_gather_shard.launches
    got = tag.all_gather_shard(_t(x).reshape(4, rows, 128),
                               _tmesh((4,), ("tp",)), "tp",
                               getattr(tag.AllGatherMethod, meth)) * scale
    assert tag.all_gather_shard.launches == n0
    assert got.shape == (4, 4 * rows, 128)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("axis,meth", [("tp", "RING_BIDIR"),
                                       ("dcn", "FULL_MESH_PUSH")])
def test_all_gather_grouped_axis_matches_pallas(axis, meth):
    """Over one axis of a (2, 4) mesh every group gathers alone: the plain
    version against the interpret-mode kernels on a ("dcn", "tp") mesh,
    every rank bit for bit; the host entry gathers a global array."""
    from triton_dist_tpu_torch.kernels import allgather as tag

    x = _inputs(310, (8 * 4, 128))[0]
    want = _per_rank(lambda s: jag.all_gather_shard(
        s, axis, method=getattr(jag.AllGatherMethod, meth),
        interpret=True), _jmesh((2, 4), ("dcn", "tp")), ("dcn", "tp"), x)
    mesh = _tmesh((2, 4), ("dcn", "tp"))
    got = tag.all_gather_shard(_t(x).reshape(2, 4, 4, 128), mesh, axis,
                               getattr(tag.AllGatherMethod, meth))
    assert np.array_equal(got.reshape(want.shape).numpy(), want)
    ctx = tag.create_allgather_context(mesh, axis="tp")
    assert ctx.world == 4
    assert np.array_equal(tag.all_gather(_t(x[:16]), ctx).numpy(), x[:16])


RS_CASES = {
    # name: (method, rows per chunk, ranks T, dtype)
    "ring_8": ("RING_1D", 8, 4, "f32"), "bidir_8": ("RING_BIDIR", 8, 4, "f32"),
    "bidir_5": ("RING_BIDIR", 5, 4, "f32"),
    "bidir_1": ("RING_BIDIR", 1, 4, "f32"), "xla_8": ("XLA", 8, 4, "f32"),
    "ring_8_t2": ("RING_1D", 8, 2, "f32"),
    "bidir_8_t2": ("RING_BIDIR", 8, 2, "f32"),
    "ring_8_bf16": ("RING_1D", 8, 4, "bf16"),
    "bidir_5_bf16": ("RING_BIDIR", 5, 4, "bf16"),
    "ring_8_t2_bf16": ("RING_1D", 8, 2, "bf16"),
    "bidir_8_t2_bf16": ("RING_BIDIR", 8, 2, "bf16")}


def _ring_fold(parts, T, rows, bidir, dtype):
    """Every coordinate's chunk folded in ``ring_fold_order``'s order, in
    torch: parts [T src, T chunk, rows, 128] -> [T, rows, 128]; bidir folds
    the first rows // 2 rightward, the rest leftward."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs

    x = _t(parts).to(dtype)
    ra = rows // 2 if bidir else rows
    out = []
    for c in range(T):
        halves = []
        for d, r0, r1 in ((1, 0, ra), (-1, ra, rows)):
            if r1 > r0:
                first, *rest = trs.ring_fold_order(T, c, d)
                acc = x[first, c, r0:r1]
                for src in rest:
                    acc = x[src, c, r0:r1] + acc
                halves.append(acc)
        out.append(torch.cat(halves))
    return torch.stack(out)


@pytest.mark.parametrize("name", sorted(RS_CASES))
def test_reduce_scatter_plain_matches_pallas(name, monkeypatch, request):
    """reduce_scatter_shard's plain version against the reference's
    interpret-mode ring kernels on mesh2 / mesh4 (spied), distinct
    partials [T rows, 128] per rank, f32 and bf16: bit-equal in the ring
    order, bidir at rows 8 and 5 (unequal halves) and 1 (the ring), and so
    is a fold in ``ring_fold_order``'s order, the table the kernel takes;
    the XLA method within 1e-6 (rank order against XLA's sum)."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs

    meth, rows, T, dt = RS_CASES[name]
    mesh = request.getfixturevalue(f"mesh{T}")
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    traced = []
    kname = "_bidir_ring_rs_kernel" if meth == "RING_BIDIR" and rows >= 2 \
        else "_ring_rs_kernel"
    kernel = getattr(jrs, kname)

    def spy(*a, **kw):
        traced.append(kw["world"])
        return kernel(*a, **kw)

    monkeypatch.setattr(jrs, kname, spy)
    parts = _inputs(320 + rows, (T, T * rows, 128))[0]
    jparts = jnp.asarray(parts)
    if dt == "bf16":
        jparts = jparts.astype(jnp.bfloat16)
    jmeth = getattr(jrs.ReduceScatterMethod, meth)
    want = _shard_map(lambda p: jrs.reduce_scatter_shard(
        p[0], "tp", method=jmeth, interpret=True), mesh,
        (jax.sharding.PartitionSpec("tp"),), jax.sharding.PartitionSpec("tp"),
        jparts)
    want = np.asarray(want, dtype=np.float32)
    assert meth == "XLA" or (traced and set(traced) == {T})
    n0 = trs.reduce_scatter_shard.launches
    got = trs.reduce_scatter_shard(_t(parts).to(tdt), _tmesh((T,), ("tp",)),
                                   "tp", getattr(trs.ReduceScatterMethod,
                                                 meth))
    assert trs.reduce_scatter_shard.launches == n0
    assert got.shape == (T, rows, 128) and got.dtype == tdt
    if meth == "XLA":
        assert_allclose(got.reshape(-1, 128), want, atol=1e-6, rtol=1e-6)
    else:
        assert np.array_equal(got.float().reshape(-1, 128).numpy(), want)
        folded = _ring_fold(parts.reshape(T, T, rows, 128), T, rows,
                            meth == "RING_BIDIR" and rows >= 2, tdt)
        assert np.array_equal(folded.float().reshape(-1, 128).numpy(), want)


def test_ring_fold_order_and_table():
    """``ring_fold_order`` is the reference's ring order (rank c + d
    first, c last) and ``fold_table`` lays it out [8][2][8] for the
    kernel, zeros past T; more than 8 ranks are refused."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs

    assert trs.ring_fold_order(4, 1, 1) == [2, 3, 0, 1]
    assert trs.ring_fold_order(4, 1, -1) == [0, 3, 2, 1]
    assert trs.ring_fold_order(2, 0, 1) == trs.ring_fold_order(2, 0, -1)
    table = np.array(trs.fold_table(3)).reshape(8, 2, 8)
    assert table[2, 0, :3].tolist() == [0, 1, 2]
    assert table[2, 1, :3].tolist() == [1, 0, 2]
    assert not table[3:].any() and not table[:, :, 3:].any()
    with pytest.raises(ValueError, match="ranks"):
        trs.fold_table(9)


def test_reduce_scatter_host_entry_matches_reference(mesh4):
    """The host entry's stacked-partials contract against the reference's
    (ring, interpret mode): bit-equal; a leading dimension other than the
    axis size is refused with the reference's message."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs

    x = _inputs(330, (4, 32, 128))[0]
    want = jrs.reduce_scatter(jnp.asarray(x), jrs.ReduceScatterContext(
        mesh=mesh4, method=jrs.ReduceScatterMethod.RING_1D, interpret=True))
    ctx = trs.create_reduce_scatter_context(
        _tmesh((4,), ("tp",)), method=trs.ReduceScatterMethod.RING_1D)
    got = trs.reduce_scatter(_t(x), ctx)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert trs.resolve_method() is trs.ReduceScatterMethod.RING_BIDIR
    assert trs.resolve_method(plain=True) is trs.ReduceScatterMethod.XLA
    with pytest.raises(ValueError, match="stacked partials"):
        trs.reduce_scatter(_t(x[:3]), ctx)


def test_choose_allgather_method_matches_reference():
    """choose_allgather_method against the reference's on its own cases and
    over several axes; a gather over two real axes (the torus schedule)
    gathers flat axes-major, a degenerate axis tuple over its one axis."""
    from triton_dist_tpu_torch.kernels import allgather as tag

    M = tag.AllGatherMethod
    assert tag.choose_allgather_method(1024, 8) is M.FULL_MESH_PUSH
    assert tag.choose_allgather_method(64 << 20, 8) is M.RING_BIDIR
    assert tag.choose_allgather_method(64 << 20, 2) is M.FULL_MESH_PUSH
    for args in ((1024, 8), (64 << 20, 8), (64 << 20, 2), (300 << 10, 4),
                 (1 << 20, 8, (2, 4)), (4096, 8, (2, 4)),
                 (1 << 20, 4, (1, 4))):
        assert tag.choose_allgather_method(*args).value == \
            jag.choose_allgather_method(*args).value, args
    mesh = _tmesh((2, 4), ("dcn", "tp"))
    x = torch.arange(2 * 4 * 3.).reshape(2, 4, 3, 1).expand(2, 4, 3, 128)
    got = tag.all_gather_shard(x, mesh, ("dcn", "tp"))
    assert got.shape == (2, 4, 24, 128)
    assert got[1, 2, :, 0].tolist() == list(range(24))
    one = _tmesh((1, 4), ("dcn", "tp"))
    got = tag.all_gather_shard(torch.arange(12.).reshape(1, 4, 3, 1), one,
                               ("dcn", "tp"))
    assert got[0, 2].flatten().tolist() == list(range(12))


def test_fast_allgather_matches_reference(mesh8, mesh2d):
    """fast_allgather at one level (8 ranks) and two (tp then dp over a
    (2, 4) mesh) against the reference's interpret-mode full-mesh push,
    bit for bit; the (out, lse) payload round trip."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from triton_dist_tpu_torch.kernels import low_latency_allgather as tll

    jll = importlib.import_module(
        "triton_dist_tpu.kernels.low_latency_allgather")
    x = _inputs(340, (64, 256))[0]
    want = jll.fast_allgather(
        jax.device_put(jnp.asarray(x), NamedSharding(mesh8, P("tp"))),
        jll.create_fast_ag_context(mesh8, impl="pallas", interpret=True))
    got = tll.fast_allgather(_t(x), tll.create_fast_ag_context(
        _tmesh((8,), ("tp",))))
    assert np.array_equal(got.numpy(), np.asarray(want))
    x2 = x[:, :128]
    want = jll.fast_allgather(
        jax.device_put(jnp.asarray(x2), NamedSharding(mesh2d,
                                                      P(("dp", "tp")))),
        jll.create_fast_ag_context(mesh2d, axis="tp", inter_axis="dp",
                                   impl="pallas", interpret=True))
    ctx = tll.create_fast_ag_context(_tmesh((2, 4), ("dp", "tp")),
                                     axis="tp", inter_axis="dp")
    assert ctx.world == 8
    assert np.array_equal(tll.fast_allgather(_t(x2), ctx).numpy(),
                          np.asarray(want))
    out, lse = _inputs(341, (4, 8, 128), (4, 8))
    buf = tll.pack_payload(_t(out), _t(lse))
    assert buf.shape == (4, 8, 129)
    assert np.array_equal(buf.numpy(), np.asarray(
        jll.pack_payload(jnp.asarray(out), jnp.asarray(lse))))
    o2, l2 = tll.unpack_payload(buf[None])
    assert torch.equal(o2[0], _t(out)) and torch.equal(l2[0], _t(lse))
    with pytest.raises(ValueError, match="impl"):
        tll.create_fast_ag_context(ctx.mesh, impl="pallas")


@pytest.mark.parametrize("impl", ["auto", "xla"])
def test_allgather_layer_matches_reference(impl, mesh2):
    """AllGatherLayer's size policy (push at or under LATENCY_BOUND_BYTES
    per rank, the ring above) gathers x whole either way, and
    forward_packed's per-rank (out, lse) partials equal the reference's
    (impl="xla", mesh2)."""
    from triton_dist_tpu_torch.layers import allgather_layer as tal
    from triton_dist_tpu_torch.kernels import low_latency_allgather as tll

    jal = importlib.import_module("triton_dist_tpu.layers.allgather_layer")
    jll = importlib.import_module(
        "triton_dist_tpu.kernels.low_latency_allgather")
    x = _t(_inputs(350, (32, 128))[0])
    ctx = tll.create_fast_ag_context(_tmesh((4,), ("tp",)), impl=impl)
    layer = tal.AllGatherLayer(ctx=ctx)
    assert layer.latency_bound_bytes == jal.LATENCY_BOUND_BYTES
    for got in (layer.forward_push(x), layer.forward_ring(x),
                layer.forward(x),
                tal.AllGatherLayer(ctx=ctx, latency_bound_bytes=1).forward(x)):
        assert torch.equal(got, x)
    out, lse = _inputs(351, (4, 8, 32), (4, 8))
    jo, jl = jal.AllGatherLayer(ctx=jll.create_fast_ag_context(
        mesh2, impl="xla")).forward_packed(jnp.asarray(out), jnp.asarray(lse))
    to, tl = tal.AllGatherLayer(ctx=tll.create_fast_ag_context(
        _tmesh((2,), ("tp",)), impl=impl)).forward_packed(_t(out), _t(lse))
    assert to.shape == (2, 2, 8, 32)
    assert np.array_equal(to.numpy(), np.asarray(jo))
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_barrier_plain_matches_reference(mesh4):
    """barrier_all_on_mesh returns the reference's [T] int32 zeros (its
    interpret-mode barrier kernel on mesh4); on CPU tensors barrier_shard
    is the identity over every axis of a (2, 2, 2) mesh and launches
    nothing; the mesh's groups and strides, and the hybrid mesh's shape
    contract (the slow axis leading, as the reference's
    ``create_hybrid_mesh``)."""
    from triton_dist_tpu_torch.kernels import common_ops as tco

    jco = importlib.import_module("triton_dist_tpu.kernels.common_ops")
    want = np.asarray(jco.barrier_all_on_mesh(mesh4, "tp", interpret=True))
    got = tco.barrier_all_on_mesh(_tmesh((4,), ("tp",)), "tp")
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    mesh = _tmesh((2, 2, 2), ("dcn", "pp", "tp"))
    x = torch.arange(8, dtype=torch.int32).reshape(2, 2, 2)
    n0 = tco.barrier_shard.launches
    for axis in mesh.axis_names:
        assert torch.equal(tco.barrier_shard(x, mesh, axis), x)
    assert tco.barrier_shard.launches == n0
    assert tco.barrier_all_on_mesh(mesh, "pp").shape == (2,)
    assert mesh.axis_groups("tp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.axis_groups("dcn") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert [mesh.axis_stride(a) for a in mesh.axis_names] == [4, 2, 1]
    from triton_dist_tpu_torch.runtime.bootstrap import create_hybrid_mesh

    hyb = create_hybrid_mesh({"pp": 2, "tp": 2}, n_slow=2, device="cpu")
    assert hyb.axis_names == ("dcn", "pp", "tp") and hyb.shape == (2, 2, 2)
    assert hyb.world is mesh.world
    with pytest.raises(ValueError, match="int32"):
        tco.barrier_shard(x.float(), mesh, "tp")


def _hier_fn(op):
    """The reference's shard-level hierarchical op on a ("dcn", "tp")
    mesh, interpret mode, per rank."""
    M = jrs.ReduceScatterMethod
    if op == "all_gather":
        return lambda s: jhi.hier_all_gather_shard(
            s, slow_axis="dcn", fast_axis="tp", interpret=True,
            fast_method=jag.AllGatherMethod.RING_BIDIR)
    if op == "reduce_scatter":
        return lambda p: jhi.hier_reduce_scatter_shard(
            p[0], slow_axis="dcn", fast_axis="tp", interpret=True,
            fast_method=M.RING_BIDIR)
    return lambda p: jhi.hier_all_reduce_shard(
        p[0], slow_axis="dcn", fast_axis="tp", interpret=True)


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter",
                                "all_reduce"])
def test_hier_collectives_match_pallas(op):
    """hier_all_gather_shard (flat order restored), hier_reduce_scatter_
    shard (band ``hier_rs_band_index``) and hier_all_reduce_shard (RS over
    tp, the dcn sum, AG over tp) against the reference's interpret-mode
    kernels on a (2, 4) mesh, every rank bit for bit (f32: the same sums
    in the same order)."""
    from triton_dist_tpu_torch.kernels import hierarchical as thi

    jmesh = _jmesh((2, 4), ("dcn", "tp"))
    mesh = _tmesh((2, 4), ("dcn", "tp"))
    if op == "all_gather":
        x = _inputs(360, (8 * 4, 128))[0]
        want = _per_rank(_hier_fn(op), jmesh, ("dcn", "tp"), x)
        got = thi.hier_all_gather_shard(
            _t(x).reshape(2, 4, 4, 128), mesh, slow_axis="dcn",
            fast_axis="tp",
            fast_method=thi.AllGatherMethod.RING_BIDIR)
        assert np.array_equal(got.reshape(want.shape).numpy(), want)
        return
    x = _inputs(361, (8, 8 * 8, 128))[0]
    want = _per_rank(_hier_fn(op), jmesh, ("dcn", "tp"), x)
    fn = (thi.hier_reduce_scatter_shard if op == "reduce_scatter"
          else thi.hier_all_reduce_shard)
    got = fn(_t(x).reshape(2, 4, 64, 128), mesh, slow_axis="dcn",
             fast_axis="tp")
    assert np.array_equal(got.reshape(want.shape).numpy(), want)
    if op == "reduce_scatter":
        idx = thi.hier_rs_band_index(mesh, "dcn", "tp")
        total = x.sum(axis=0)
        for i in range(2):
            for j in range(4):
                b = int(idx[i, j])
                assert b == j * 2 + i
                assert_allclose(got[i, j], total[b * 8:(b + 1) * 8],
                                atol=1e-4, rtol=1e-4)


def test_hier_grad_allreduce_matches_reference():
    """hier_grad_allreduce over ragged leaves (one bf16) against the
    reference's on a (2, 4) mesh, 1e-2 as its test (the bf16 leaf is cast
    back)."""
    from jax.sharding import PartitionSpec as P

    from triton_dist_tpu_torch.kernels import hierarchical as thi

    w, b, e = _inputs(370, (2, 4, 17, 5), (2, 4, 3), (2, 4, 2, 2, 7))
    tree = {"w": w, "b": b, "e": e}

    def shard_fn(parts):
        i, j = jax.lax.axis_index("dcn"), jax.lax.axis_index("tp")
        mine = {k: v[i, j] for k, v in parts.items()}
        mine["e"] = mine["e"].astype(jnp.bfloat16)
        return jhi.hier_grad_allreduce(mine, slow_axis="dcn", fast_axis="tp",
                                       interpret=True)

    want = jax.jit(jax.shard_map(
        shard_fn, mesh=_jmesh((2, 4), ("dcn", "tp")), in_specs=(P(),),
        out_specs=P(), check_vma=False))(
        {k: jnp.asarray(v) for k, v in tree.items()})
    ttree = {"w": _t(w), "b": _t(b), "e": _t(e).to(torch.bfloat16)}
    got = thi.hier_grad_allreduce(ttree, _tmesh((2, 4), ("dcn", "tp")),
                                  slow_axis="dcn", fast_axis="tp")
    for k in tree:
        assert got[k].dtype == ttree[k].dtype
        assert got[k].shape == ttree[k].shape
        for i in range(2):
            for j in range(4):
                assert_allclose(got[k][i, j].float(),
                                np.asarray(want[k], np.float32), atol=1e-2,
                                rtol=1e-2)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_hier_all_to_all_matches_reference(impl, mesh2d):
    """hier_all_to_all_shard (two stages over the all-to-all kernel's plain
    version, bundles compacted) against the reference's on a (2, 4) mesh
    (``impl="xla"``, and interpret-mode Pallas): split counts equal, every
    row below a split bit for bit, padding rows ZERO; the host entry over
    a (dp, tp) context gives the same."""
    from triton_dist_tpu_torch.kernels import all_to_all as ta
    from triton_dist_tpu_torch.kernels import hierarchical as thi

    jaa = importlib.import_module("triton_dist_tpu.kernels.all_to_all")
    world, T, H = 8, 4, 32
    x = _inputs(380, (world * world, T, H))[0]
    splits = np.random.default_rng(381).integers(
        0, T + 1, size=(world * world,)).astype(np.int32)

    def hier(send, sp):
        return jhi.hier_all_to_all_shard(send, sp, slow_axis="dp",
                                         fast_axis="tp", impl=impl,
                                         interpret=impl == "pallas")

    from jax.sharding import PartitionSpec as P

    spec = P(("dp", "tp"))
    jr, js = jax.jit(jax.shard_map(hier, mesh=mesh2d, in_specs=(spec, spec),
                                   out_specs=(spec, spec), check_vma=False))(
        jnp.asarray(x), jnp.asarray(splits))
    jr, js = np.asarray(jr), np.asarray(js)
    mesh = _tmesh((2, 4), ("dp", "tp"))
    n0 = ta.fast_all_to_all_shard.launches
    recv, rs = thi.hier_all_to_all_shard(
        _t(x).reshape(2, 4, world, T, H), _t(splits).reshape(2, 4, world),
        mesh, slow_axis="dp", fast_axis="tp")
    assert ta.fast_all_to_all_shard.launches == n0
    assert np.array_equal(rs.reshape(-1).numpy(), js)
    got = recv.reshape(world * world, T, H).numpy()
    for blk in range(world * world):
        k = int(js[blk])
        assert np.array_equal(got[blk, :k], jr[blk, :k])
        assert not got[blk, k:].any()
    ctx = ta.create_all_to_all_context(mesh, T, H, axis=("dp", "tp"))
    r2, s2 = ta.fast_all_to_all(_t(x), _t(splits), ctx)
    assert torch.equal(r2, recv.reshape(world * world, T, H))
    assert torch.equal(s2, rs.reshape(-1))

# ---------------------------------------------------------------------------
# The TP ring GEMMs' modes, host entries and the autotuner
# ---------------------------------------------------------------------------

RING_TOL = 1e-5
# the wire's rebuilt A: q * scale with the reference's scale (computed
# under jit) within 1 ulp of the port's, so the products within 2 ulp
WIRE_A_RTOL = 2.5e-7


def _spy_kernels(monkeypatch, module, *names):
    """Record (kernel name, its keyword arguments) of every trace of
    ``module.name`` for each name."""
    traced = []
    for name in names:
        kernel = getattr(module, name)

        def spy(*args, _k=kernel, _n=name, **kw):
            traced.append((_n, kw))
            return _k(*args, **kw)

        monkeypatch.setattr(module, name, spy)
    return traced


def _ag_inputs(seed, world, m_loc, k, n_loc):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((world * m_loc, k)).astype(np.float32),
            (rng.standard_normal((k, world * n_loc)) / np.sqrt(k)
             ).astype(np.float32))


def _ag_reference(mesh, a, b, **kw):
    """The reference's per-device AG-GEMM in interpret mode inside
    shard_map: (A_full [W, W m_loc, K], C [W, W m_loc, n_loc])."""
    from jax.sharding import PartitionSpec as P

    def shard(x, w):
        a_full, c = jagm.ag_gemm_shard(x, w, axis="tp", impl="pallas", bm=8,
                                      bn=128, bk=128, interpret=True, **kw)
        return a_full[None], c[None]

    full, c = _shard_map(shard, mesh, (P("tp", None), P(None, "tp")),
                         (P("tp"), P("tp")), jnp.asarray(a), jnp.asarray(b))
    return np.asarray(full), np.asarray(c)




@pytest.mark.parametrize("world", [2, 4])
def test_ag_gemm_bidir_matches_pallas(world, monkeypatch, request):
    """ring_mode="bidir" against ``_ag_gemm_bidir_kernel`` (spied): every
    rank's gathered A bit for bit, C within 1e-5; the port moves no
    launch counter on the CPU."""
    traced = _spy_kernels(monkeypatch, jagm, "_ag_gemm_bidir_kernel")
    m_loc, k, n_loc = 16, 128, 128
    a, b = _ag_inputs(300 + world, world, m_loc, k, n_loc)
    want_full, want_c = _ag_reference(_mesh(world, request), a, b,
                                      ring_mode="bidir")
    assert traced and {kw["world"] for _, kw in traced} == {world}
    n0 = dict(tag.ag_gemm_shard.mode_launches)
    full, c = tag.ag_gemm_shard(_t(a).reshape(world, m_loc, k),
                                _stack_cols(b, world), ring_mode="bidir")
    assert tag.ag_gemm_shard.mode_launches == n0
    assert np.array_equal(full.numpy(), want_full)
    assert_allclose(c, want_c, atol=RING_TOL, rtol=RING_TOL)


def test_ag_gemm_wire_payload_and_result_match_pallas(monkeypatch, mesh4):
    """wire_dtype="int8": the port's int8 payload equal to the reference's
    ``quantize_rowwise`` of each rank's rows and its scales within 1 ulp;
    A_full (rebuilt from the payload) bit for bit and C within 1e-5 of the
    reference's wire kernel (``_ag_gemm_kernel`` traced with wire=True)."""
    traced = _spy_kernels(monkeypatch, jagm, "_ag_gemm_kernel")
    W, m_loc, k, n_loc = 4, 16, 256, 128
    a, b = _ag_inputs(310, W, m_loc, k, n_loc)
    want_full, want_c = _ag_reference(mesh4, a, b, wire_dtype="int8")
    assert traced and all(kw["wire"] for _, kw in traced)
    ag_q, ag_s, c_plain = tag.ag_gemm_wire_ref(
        _t(a).reshape(W, m_loc, k), _stack_cols(b, W))
    # eagerly and under jit (where the reference's wire path runs, and XLA
    # divides by 127 as a product with 1 / 127)
    for quant in (jq.quantize_rowwise, jax.jit(jq.quantize_rowwise)):
        q_ref, s_ref = (np.asarray(x) for x in quant(jnp.asarray(a)))
        for r in range(W):
            assert np.array_equal(ag_q[r].numpy(), q_ref)
            ulp = np.spacing(np.abs(s_ref))
            assert np.all(np.abs(ag_s[r].numpy() - s_ref) <= ulp)
    full, c = tag.ag_gemm_shard(_t(a).reshape(W, m_loc, k),
                                _stack_cols(b, W), wire_dtype="int8")
    assert torch.equal(c, c_plain)
    assert_allclose(full, want_full, atol=0, rtol=WIRE_A_RTOL)
    assert_allclose(c, want_c, atol=RING_TOL, rtol=RING_TOL)


def test_ag_gemm_chunks_equal_chunks_1(monkeypatch, mesh4):
    """chunks 1, 2 and 4 give the same result (the chunking moves bytes,
    not values), equal to the reference's chunked kernel within 1e-5."""
    traced = _spy_kernels(monkeypatch, jagm, "_ag_gemm_kernel")
    W, m_loc, k, n_loc = 4, 32, 128, 128
    a, b = _ag_inputs(320, W, m_loc, k, n_loc)
    ta, tb = _t(a).reshape(W, m_loc, k), _stack_cols(b, W)
    full1, c1 = tag.ag_gemm_shard(ta, tb)
    for chunks in (2, 4):
        full, c = tag.ag_gemm_shard(ta, tb, chunks=chunks)
        assert torch.equal(full, full1) and torch.equal(c, c1)
    want_full, want_c = _ag_reference(mesh4, a, b, chunks=4)
    assert [kw["chunks"] for _, kw in traced] == [4]
    assert np.array_equal(full1.numpy(), want_full)
    assert_allclose(c1, want_c, atol=RING_TOL, rtol=RING_TOL)


def _traced_ag_schedule(monkeypatch, mesh, m_loc, int8, **kw):
    """The schedule the reference's ag_gemm_shard takes, from the kernel
    its trace reaches (traced only: ``make_jaxpr``, nothing runs)."""
    traced = _spy_kernels(monkeypatch, jagm, "_ag_gemm_kernel",
                  "_ag_gemm_bidir_kernel")
    world = mesh.shape["tp"]
    dt = jnp.int8 if int8 else jnp.float32
    a = jnp.zeros((world * m_loc, 128), dt)
    b = jnp.zeros((128, world * 128), dt)
    jax.make_jaxpr(jax.shard_map(
        lambda x, w: jagm.ag_gemm_shard(x, w, axis="tp", impl="pallas",
                                       bm=8, bn=128, bk=128, interpret=True,
                                       **kw)[1],
        mesh=mesh, in_specs=(P("tp", None), P(None, "tp")),
        out_specs=P(None, "tp"), check_vma=False))(a, b)
    (name, k), = traced
    if name == "_ag_gemm_bidir_kernel":
        return tag.Schedule("bidir", 1, False)
    return tag.Schedule("uni", k["chunks"], k.get("wire", False))


@pytest.mark.parametrize("m_loc", [8, 16, 24, 40, 48, 96])
def test_ag_gemm_chunk_clamp_matches_reference(m_loc, monkeypatch, mesh2):
    """The port's clamp of ``chunks`` equals the reference's (:787-788)
    over a grid of (m_loc, chunks), read from the chunks its kernel
    traces with."""
    for chunks in (1, 2, 3, 4, 5, 8):
        want = _traced_ag_schedule(monkeypatch, mesh2, m_loc, False,
                                   chunks=chunks)
        monkeypatch.undo()
        assert tag.ag_gemm_schedule(m_loc, 2, False, chunks=chunks) == \
            want, (m_loc, chunks)
        assert tag.clamp_chunks(m_loc, chunks) == want.chunks


SCHEDULE_CASES = [
    # (world, m_loc, int8, kwargs): bidir taken; bidir giving way for a
    # half that does not tile by 8, an odd m_loc, int8 A; the wire taken,
    # and ignored for int8 A; chunks with the wire
    (2, 16, False, dict(ring_mode="bidir")),
    (4, 32, False, dict(ring_mode="bidir")),
    (2, 24, False, dict(ring_mode="bidir")),
    (2, 8, False, dict(ring_mode="bidir")),
    (2, 16, True, dict(ring_mode="bidir")),
    (2, 16, False, dict(wire_dtype="int8")),
    (2, 16, True, dict(wire_dtype="int8")),
    (2, 32, False, dict(wire_dtype="int8", chunks=4)),
    (2, 16, False, dict(ring_mode="other")),
]


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_ag_gemm_schedule_matches_reference(case, monkeypatch, request):
    """Which schedule a call takes (bidir or uni, the chunks, the wire)
    equals the reference's."""
    world, m_loc, int8, kw = case
    want = _traced_ag_schedule(monkeypatch, _mesh(world, request), m_loc,
                               int8, **kw)
    assert tag.ag_gemm_schedule(m_loc, world, int8, **kw) == want


def test_ring_mode_rejections_match_reference(mesh4):
    """bidir refuses the wire and chunks > 1 with a ValueError naming
    "bidir", before any shape check, in both packages; a wire dtype other
    than int8 raises in both."""
    a, b = _ag_inputs(330, 4, 16, 128, 128)
    port_mesh = TMesh((4,), ("tp",), "cpu")
    ja = jax.device_put(jnp.asarray(a), NamedSharding(mesh4, P("tp", None)))
    jb = jax.device_put(jnp.asarray(b), NamedSharding(mesh4, P(None, "tp")))
    for kw, match in ((dict(ring_mode="bidir", wire_dtype="int8"), "bidir"),
                      (dict(ring_mode="bidir", chunks=4), "bidir"),
                      (dict(wire_dtype="fp8"), "wire_dtype")):
        with pytest.raises(ValueError, match=match):
            jagm.ag_gemm(ja, jb, jagm.create_ag_gemm_context(
                mesh4, impl="pallas", interpret=True, **kw))
        with pytest.raises(ValueError, match=match):
            tag.ag_gemm(_t(a), _t(b), tag.create_ag_gemm_context(
                port_mesh, **kw))
    # before any shape check: operands that are not rank-stacked
    with pytest.raises(ValueError, match="bidir"):
        tag.ag_gemm_shard(torch.zeros(3, 8), torch.zeros(8, 16),
                          ring_mode="bidir", chunks=2)


# ---------------------------------------------------------------------------
# The GEMM-RS's modes
# ---------------------------------------------------------------------------


def _rs_reference(mesh, a, b, **kw):
    return np.asarray(_shard_map(
        lambda x, w: jgrs.gemm_rs_shard(x, w, axis="tp", impl="pallas", bm=8,
                                       bn=128, bk=128, interpret=True, **kw),
        mesh, (P(None, "tp"), P("tp", None)), P("tp"), jnp.asarray(a),
        jnp.asarray(b)))


@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_gemm_rs_bidir_matches_pallas(world, ints, monkeypatch, request):
    """ring_mode="bidir" against ``_gemm_rs_bidir_kernel`` (spied): f32
    within 1e-5 relative; on integer-valued inputs (every product and sum
    exact) bit-equal, which pins the chunk each rank ends with and each
    half's direction."""
    traced = _spy_kernels(monkeypatch, jgrs, "_gemm_rs_bidir_kernel")
    m_loc, k_loc, N = 16, 128, 256
    rng = np.random.default_rng(340 + world + 10 * ints)
    if ints:
        a = rng.integers(-4, 5, (world * m_loc, world * k_loc))
        b = rng.integers(-4, 5, (world * k_loc, N))
    else:
        a = rng.standard_normal((world * m_loc, world * k_loc))
        b = rng.standard_normal((world * k_loc, N)) / np.sqrt(world * k_loc)
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = _rs_reference(_mesh(world, request), a, b, ring_mode="bidir")
    assert traced and {kw["world"] for _, kw in traced} == {world}
    out = trs.gemm_rs_shard(torch.stack(_t(a).chunk(world, dim=1)),
                            _stack_rows(b, world), ring_mode="bidir")
    got = out.reshape(world * m_loc, N).numpy()
    if ints:
        assert np.array_equal(got, want)
    else:
        assert_allclose(got, want, atol=RING_TOL, rtol=RING_TOL)


def test_gemm_rs_bidir_plain_adds_in_hop_order():
    """The plain bidir sums add in the partials' dtype in the reference's
    hop order: against a float64 model of the same bf16 roundings."""
    W, m_loc, k, N = 4, 8, 64, 256
    rng = np.random.default_rng(345)
    a = _t(rng.standard_normal((W, W * m_loc, k)).astype(np.float32))
    b = _t(rng.standard_normal((W, k, N)).astype(np.float32))
    a16, b16 = a.bfloat16(), b.bfloat16()
    out = trs.gemm_rs_shard(a16, b16, ring_mode="bidir")
    parts = [(a16[q].double() @ b16[q].double()).bfloat16()
             .reshape(W, m_loc, N) for q in range(W)]
    for c in range(W):
        for d, sign in ((0, 1), (1, -1)):
            cols = slice(d * N // 2, (d + 1) * N // 2)
            acc = parts[(c + sign) % W][c][:, cols]
            for j in range(2, W + 1):
                acc = (parts[(c + sign * j) % W][c][:, cols].double()
                       + acc.double()).bfloat16()
            assert torch.equal(out[c][:, cols], acc)


@pytest.mark.parametrize("n", [256, 384, 128])
@pytest.mark.parametrize("world", [1, 2])
def test_gemm_rs_schedule_matches_reference(world, n, monkeypatch, request):
    """bidir is taken where the reference's is (world > 1, (N / 2) % 128
    == 0), else the uni ring, read from the kernel the trace reaches."""
    if world == 1:
        from jax.sharding import Mesh

        mesh = Mesh(np.array(jax.devices()[:1]), ("tp",))
    else:
        mesh = _mesh(world, request)
    traced = _spy_kernels(monkeypatch, jgrs, "_gemm_rs_kernel",
                  "_gemm_rs_bidir_kernel")
    a = jnp.zeros((world * 16, world * 128), jnp.float32)
    b = jnp.zeros((world * 128, n), jnp.float32)
    jax.make_jaxpr(jax.shard_map(
        lambda x, w: jgrs.gemm_rs_shard(x, w, axis="tp", impl="pallas", bm=8,
                                       bn=128, bk=128, interpret=True,
                                       ring_mode="bidir"),
        mesh=mesh, in_specs=(P(None, "tp"), P("tp", None)),
        out_specs=P("tp"), check_vma=False))(a, b)
    (name, _), = traced
    want = "bidir" if name == "_gemm_rs_bidir_kernel" else "uni"
    assert trs.gemm_rs_schedule(world, n, "bidir") == want


@pytest.mark.parametrize("ring_mode", ["uni", "bidir"])
def test_gemm_rs_int8_exact_against_reference(mesh4, ring_mode):
    """The int8 GEMM-RS through the host entries in each ring mode: the
    port equal to the reference's interpret-mode kernel of that mode
    (``_gemm_rs_kernel``, or ``_gemm_rs_bidir_kernel``: N / 2 = 128
    takes it) and to test_gemm_rs_int8_exact's oracle (an int32
    product), exactly."""
    M, K, N = 64, 4 * 128, 256
    assert trs.gemm_rs_schedule(4, N, ring_mode) == ring_mode
    rng = np.random.default_rng(0)
    a = rng.integers(-64, 64, (M, K), dtype=np.int8)
    b = rng.integers(-64, 64, (K, N), dtype=np.int8)
    ja = jax.device_put(jnp.asarray(a), NamedSharding(mesh4, P(None, "tp")))
    jb = jax.device_put(jnp.asarray(b), NamedSharding(mesh4, P("tp", None)))
    want = np.asarray(jgrs.gemm_rs(ja, jb, jgrs.create_gemm_rs_context(
        mesh4, axis="tp", impl="pallas", interpret=True,
        ring_mode=ring_mode)))
    oracle = a.astype(np.int32) @ b.astype(np.int32)
    assert np.array_equal(want, oracle)
    port_mesh = TMesh((4,), ("tp",), "cpu")
    c = trs.gemm_rs(_t(a), _t(b), trs.create_gemm_rs_context(
        port_mesh, ring_mode=ring_mode))
    assert c.dtype == torch.int32
    assert np.array_equal(c.numpy(), want)


@pytest.mark.parametrize("case", [
    # (G, m_loc, N, bidir, staging a rank, flags a rank): int32 tiles of
    # 128 x 256 values, 256 x 128 above m_loc 128; the bidir ring tiles
    # each half N / 2
    (4, 512, 4096, False, (4, 64, 32768), 256),     # row 15i at down / wo
    (4, 16, 4096, False, (4, 16, 32768), 64),       # m16: 128 x 256
    (4, 128, 4112, False, (4, 17, 32768), 68),      # the last 128 x 256
    (4, 129, 4096, False, (4, 32, 32768), 128),     # the first 256 x 128
    (8, 250, 4112, False, (8, 33, 32768), 264),     # N 4,112: a ragged band
    (2, 256, 4096, False, (2, 32, 32768), 64),      # row 16i over one axis
    (4, 512, 4096, True, (2, 3, 32, 32768), 192),   # row 15bi at down / wo
    (4, 16, 4096, True, (2, 3, 8, 32768), 48),      # 15bi at m16
    (8, 1, 32, True, (2, 7, 1, 32768), 14),         # one row, 16 a half
])
def test_gemm_rs_i8_workspace(case):
    """The int8 wgmma kernels' workspace a rank: the uni kernel's G slots
    of int32 tiles in fragment order and a flag per (slot, tile), the
    bidir ring's 2 (W - 1) landing slots of a half's tiles."""
    G, m_loc, n, bidir, stage, n_flags = case
    assert trs.i8_tile(m_loc) == ((128, 256) if m_loc <= 128 else (256, 128))
    assert trs.wg_workspace(G, m_loc, n, int8=True, bidir=bidir) == (
        stage, n_flags)


@pytest.mark.parametrize("case", [
    # (G, m_loc, N, axes, staging a rank, flags a rank, part ends, the
    # 256-column tiles that span two parts): phase 22's shapes on (2, 4)
    # and (2, 2, 2), and N 640, where column 384 (the end of part 1) falls
    # inside tile 1
    (8, 256, 4096, 2, (8, 32, 32768), 256, [8, 16, 24, 32], []),
    (8, 16, 4096, 2, (8, 16, 32768), 128, [8, 16, 24, 32], []),
    (8, 256, 4096, 3, (8, 32, 32768), 256, [6, 12, 17, 22, 27, 32],
     [8, 13]),
    (8, 256, 640, 2, (8, 6, 32768), 48, [2, 3, 4, 5], [1]),
])
def test_gemm_rs_torus_workspace(case):
    """The bf16 torus mode of the uni kernel takes the uni kernel's
    workspace (G slots of 128 x 256 bf16 tiles in fragment order, a flag
    per (slot, tile)) and folds each 128-column unit of a tile in the plan
    of its part (``part_ends``, the kernel's ``part_end``; ``torus_part``
    in ``csrc/gemm_rs.cu``: the first part whose end lies past the unit),
    so a tile that spans a part boundary folds its halves in two
    orders."""
    from triton_dist_tpu_torch.kernels import torus as ttorus

    G, m_loc, n, axes, stage, n_flags, ends, split = case
    assert trs.wg_workspace(G, m_loc, n) == (stage, n_flags)
    assert ttorus.part_ends(n // trs.TORUS_UNIT, axes) == ends
    part = [next(q for q, e in enumerate(ends) if u < e)
            for u in range(n // trs.TORUS_UNIT)]
    tiles = -(-n // trs.WG_TILE[1])
    assert [j for j in range(tiles) if 2 * j + 1 < len(part)
            and part[2 * j] != part[2 * j + 1]] == split
    # every part's columns, in the reference's paths, are the units the
    # kernel gives it
    for q, (off, ln, _, _) in enumerate(ttorus._paths_for(len(part), axes)):
        assert [u for u, p in enumerate(part) if p == q] == list(
            range(off, off + ln))


def test_matmul_kernel_choice_rule():
    """``gemm.matmul_kernel_for``: the persistent wgmma kernel wherever
    TMA reads the operands in place (K and N multiples of 8, 16-byte
    aligned bases; any M), else the element-wise tile loop; a pure
    function of the shape and the alignment (no knob).  On CPU tensors
    ``matmul`` launches neither."""
    from triton_dist_tpu_torch.kernels import gemm as tgemm

    f = tgemm.matmul_kernel_for
    for m, n, k in ((2048, 14336, 4096), (16, 14336, 4096), (1, 8, 64),
                    (130, 4096, 200), (64, 136, 40), (7, 8, 8)):
        assert f(m, n, k, True) == "wgmma", (m, n, k)
        assert f(m, n, k, False) == "tile", (m, n, k)    # a base off 16 B
    for m, n, k in ((130, 97, 200), (2048, 14340, 4096), (64, 136, 41),
                    (256, 384, 513), (1, 1, 1)):
        assert f(m, n, k, True) == "tile", (m, n, k)     # ragged N or K
    modes0 = dict(tgemm.matmul.mode_launches)
    tgemm.matmul(torch.ones((4, 8)), torch.ones((8, 8)))
    assert tgemm.matmul.mode_launches == modes0 == {
        "wgmma": modes0["wgmma"], "tile": modes0["tile"]}


def test_gemm_rs_i8_refuses_what_its_kernels_do_not_take():
    """The int8 kernels' operand rule, checked before any launch: int8
    operands, at most 8 ranks, K % 32 and N % 16 (the wrappers' check),
    and TMA's 16-byte aligned base (the uni and bidir launches')."""
    def z(*shape, dtype=torch.int8):
        return torch.zeros(shape, dtype=dtype)

    def check(a, b):
        world, k, n = a.shape[0], a.shape[2], b.shape[2]
        trs.check_kernel_operands("gemm_rs (int8)", a, b,
                                  a.shape[1] // world, k, n,
                                  dtype=torch.int8, k_mult=32, n_mult=16)

    check(z(4, 64, 96), z(4, 96, 4112))
    with pytest.raises(ValueError, match="multiples of 32 and 16"):
        check(z(4, 64, 48), z(4, 48, 256))
    with pytest.raises(ValueError, match="multiples of 32 and 16"):
        check(z(4, 64, 64), z(4, 64, 264))
    with pytest.raises(TypeError, match="int8"):
        check(z(4, 64, 64), z(4, 64, 256, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="at most 8 ranks"):
        check(z(9, 72, 64), z(9, 64, 256))
    a = z(4 * 64 * 64 + 1)[1:].view(4, 64, 64)
    with pytest.raises(ValueError, match="TMA"):
        trs._uni(a, z(4, 64, 256), 16, 256, False, "gemm_rs_i8", 4)
    with pytest.raises(ValueError, match="TMA"):
        trs._bidir_i8(a, z(4, 64, 256), 16, 256)


# ---------------------------------------------------------------------------
# The host entries against the reference's
# ---------------------------------------------------------------------------

HOST_MODES = {"uni": {}, "bidir": dict(ring_mode="bidir"),
              "chunks2": dict(chunks=2), "wire": dict(wire_dtype="int8")}


@pytest.mark.parametrize("mode", sorted(HOST_MODES))
def test_ag_gemm_host_entries_match_reference(mode, mesh4):
    """Reference-style code on a port Mesh: ``ag_gemm(a, b,
    create_ag_gemm_context(mesh, ...))`` and ``ag_gemm_gathered`` against
    the reference's on mesh4 (interpret-mode kernels): A_full bit for bit,
    C within 1e-5; the xla impl equal to the port's plain versions."""
    kw = HOST_MODES[mode]
    M, K, N = 64, 256, 512
    rng = np.random.default_rng(350)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    ja = jax.device_put(jnp.asarray(a), NamedSharding(mesh4, P("tp", None)))
    jb = jax.device_put(jnp.asarray(b), NamedSharding(mesh4, P(None, "tp")))
    jctx = jagm.create_ag_gemm_context(
        mesh4, impl="pallas", interpret=True,
        config=jgemm.MatmulConfig(block_m=8, block_n=128, block_k=128), **kw)
    want_full, want_c = jagm.ag_gemm_gathered(ja, jb, jctx)
    port_mesh = TMesh((4,), ("tp",), "cpu")
    ctx = tag.create_ag_gemm_context(port_mesh, **kw)
    full, c = tag.ag_gemm_gathered(_t(a), _t(b), ctx)
    assert full.shape == (M, K) and c.shape == (M, N)
    if mode == "wire":
        assert_allclose(full, np.asarray(want_full), atol=0,
                        rtol=WIRE_A_RTOL)
    else:
        assert np.array_equal(full.numpy(), np.asarray(want_full))
    assert_allclose(c, np.asarray(want_c), atol=RING_TOL, rtol=RING_TOL)
    assert torch.equal(tag.ag_gemm(_t(a), _t(b), ctx), c)
    assert torch.equal(tag.ag_gemm(_t(a), _t(b), tag.create_ag_gemm_context(
        port_mesh, impl="xla", **kw)), c)


@pytest.mark.parametrize("mode", ["uni", "bidir"])
def test_gemm_rs_host_entry_matches_reference(mode, mesh4):
    """``gemm_rs(a, b, create_gemm_rs_context(mesh, ...))`` on a port Mesh
    against the reference's on mesh4, within 1e-5."""
    M, K, N = 64, 512, 256
    rng = np.random.default_rng(360)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    ja = jax.device_put(jnp.asarray(a), NamedSharding(mesh4, P(None, "tp")))
    jb = jax.device_put(jnp.asarray(b), NamedSharding(mesh4, P("tp", None)))
    want = jgrs.gemm_rs(ja, jb, jgrs.create_gemm_rs_context(
        mesh4, impl="pallas", interpret=True, ring_mode=mode,
        config=jgemm.MatmulConfig(block_m=8, block_n=128, block_k=128)))
    port_mesh = TMesh((4,), ("tp",), "cpu")
    c = trs.gemm_rs(_t(a), _t(b), trs.create_gemm_rs_context(
        port_mesh, ring_mode=mode))
    assert c.shape == (M, N)
    assert_allclose(c, np.asarray(want), atol=RING_TOL, rtol=RING_TOL)


def test_host_entries_refuse_other_real_axes():
    """The ring kernels serve one flat world: a mesh whose other axes have
    more than one rank raises; axes of one rank are fine."""
    a, b = torch.zeros(16, 32), torch.zeros(32, 64)
    with pytest.raises(NotImplementedError, match="flat world"):
        tag.ag_gemm(a, b, tag.create_ag_gemm_context(
            TMesh((2, 2), ("dp", "tp"), "cpu")))
    c = tag.ag_gemm(a, b, tag.create_ag_gemm_context(
        TMesh((1, 4), ("dp", "tp"), "cpu")))
    assert c.shape == (16, 64)
    with pytest.raises(ValueError, match="impl"):
        tag.ag_gemm(a, b, tag.create_ag_gemm_context(
            TMesh((4,), ("tp",), "cpu"), impl="mosaic"))


# ---------------------------------------------------------------------------
# The autotuner (tests/test_autotuner.py's CPU cases on torch tensors)
# ---------------------------------------------------------------------------


def make_slow_fast(counter):
    @tat.autotune(configs=[tat.Config(slow=True), tat.Config(slow=False)])
    def fn(x, *, slow):
        counter[slow] = counter.get(slow, 0) + 1
        if slow:
            time.sleep(0.005)
        return x + 1

    return fn


def test_eager_tuning_picks_fast_config():
    counter = {}
    fn = make_slow_fast(counter)
    out = fn(torch.ones(4))
    assert float(out[0]) == 2.0
    assert fn.best_config == {"slow": False}
    n_slow = counter[True]
    fn(torch.ones(4))
    assert counter[True] == n_slow
    (sweep,) = fn.sweeps.values()
    assert [c for c, _ in sweep] == [{"slow": True}, {"slow": False}]


def test_contextual_tuning_two_inner_tuners():
    c1, c2 = {}, {}
    inner1, inner2 = make_slow_fast(c1), make_slow_fast(c2)
    outer_calls = []

    @tat.contextual_autotune(n_repeat=2, n_warmup=1)
    def op(x):
        outer_calls.append(1)
        return inner2(inner1(x))

    out = op(torch.zeros(4))
    assert float(out[0]) == 2.0
    assert inner1.best_config == {"slow": False}
    assert inner2.best_config == {"slow": False}
    assert len(outer_calls) >= 6


def test_bad_configs_are_skipped():
    @tat.autotune(configs=[tat.Config(bm=999), tat.Config(bm=4)])
    def fn(x, *, bm):
        if bm > x.shape[0]:
            raise ValueError("tile larger than array")
        return x * 2

    assert float(fn(torch.ones(8))[0]) == 2.0
    assert fn.best_config == {"bm": 4}


def test_all_bad_configs_raise_with_the_cause():
    @tat.autotune(configs=[tat.Config(a=1), tat.Config(a=2)])
    def fn(x, *, a):
        raise ValueError("root cause here")

    with pytest.raises(RuntimeError, match="no valid config") as ei:
        fn(torch.ones(2))
    assert isinstance(ei.value.__cause__, ValueError)


def test_cache_keyed_on_shape_dtype_and_key_args():
    calls = []

    @tat.autotune(configs=[tat.Config(c=0), tat.Config(c=1)], key=["mode"])
    def fn(x, *, mode, c):
        calls.append((tuple(x.shape), mode, c))
        return x

    fn(torch.ones(4), mode="a")
    n = len(calls)
    fn(torch.ones(4), mode="a")   # cache hit: one call
    assert len(calls) == n + 1
    fn(torch.ones(8), mode="a")   # new shape: re-tune
    assert len(calls) > n + 2
    fn(torch.ones(8, dtype=torch.float64), mode="a")   # new dtype
    assert len(fn.cache) == 3


def test_single_config_runs_directly():
    @tat.autotune(configs=[tat.Config(k=3)])
    def fn(x, *, k):
        return x * k

    assert float(fn(torch.ones(()))) == 3.0


def test_contextual_with_bad_config_inside():
    @tat.autotune(configs=[tat.Config(bm=999), tat.Config(bm=2)])
    def inner(x, *, bm):
        if bm > x.shape[0]:
            raise ValueError("bad tile")
        return x + 1

    @tat.contextual_autotune(n_repeat=1, n_warmup=0)
    def op(x):
        return inner(x)

    assert float(op(torch.zeros(4))[0]) == 1.0
    assert inner.best_config == {"bm": 2}
    assert isinstance(inner, tat.AutotunedFunction)


def test_distinct_keys_tuned_in_one_contextual_region():
    calls = []

    @tat.autotune(configs=[tat.Config(c=0), tat.Config(c=1)])
    def inner(x, *, c):
        calls.append((x.shape[0], c))
        return x

    @tat.contextual_autotune(n_repeat=1, n_warmup=0)
    def op(a, b):
        return inner(a), inner(b)

    op(torch.zeros(4), torch.zeros(8))
    assert len(inner.cache) == 2
    assert {(4, 0), (4, 1), (8, 0), (8, 1)} <= set(calls)


def test_scalar_kwargs_split_cache_entries():
    @tat.autotune(configs=[tat.Config(c=0), tat.Config(c=1)])
    def fn(x, *, flag=False, c):
        return x

    fn(torch.ones(4), flag=True)
    fn(torch.ones(4), flag=False)
    assert len(fn.cache) == 2


def test_aborted_region_does_not_poison_next():
    boom = {"on": True}

    @tat.autotune(configs=[tat.Config(c=0), tat.Config(c=1)])
    def inner(x, *, c):
        return x + c

    @tat.contextual_autotune(n_repeat=1, n_warmup=0)
    def op(x):
        y = inner(x)
        if boom["on"]:
            raise RuntimeError("unrelated op failure")
        return y

    with pytest.raises(RuntimeError, match="unrelated"):
        op(torch.zeros(4))
    boom["on"] = False
    out = op(torch.zeros(4))
    assert inner.best_config in ({"c": 0}, {"c": 1})
    assert float(out[0]) == inner.best_config["c"]


def test_all_bad_configs_in_region_then_retry_raises_cleanly():
    @tat.autotune(configs=[tat.Config(a=1), tat.Config(a=2)])
    def inner(x, *, a):
        raise ValueError("nope")

    @tat.contextual_autotune(n_repeat=1, n_warmup=0)
    def op(x):
        return inner(x)

    for _ in range(2):
        with pytest.raises(RuntimeError, match="no valid config"):
            op(torch.zeros(2))


def test_measure_hook_overrides_timing():
    calls = []

    def fake_measure(fn, args, kwargs, config):
        calls.append(dict(config))
        return fn(*args, **{**kwargs, **config}), (
            1.0 if config["bm"] == 256 else 10.0)

    f = tat.AutotunedFunction(
        lambda x, *, bm: x * bm,
        [tat.Config(bm=128), tat.Config(bm=256), tat.Config(bm=512)],
        measure=fake_measure)
    f(torch.ones(4))
    assert f.best_config == {"bm": 256}
    assert {c["bm"] for c in calls} == {128, 256, 512}
    assert float(f(torch.ones(4))[0]) == 256.0


def test_is_dist_is_the_identity_in_one_process():
    """``is_dist`` MAX-reduces only over a process group of more than one
    process; without one the times pass through."""
    assert tat._allreduce_max([1.0, 3.0]) == [1.0, 3.0]


def test_ring_tune_spaces_prune_to_distinct_schedules():
    """No two configs of a sweep launch the same kernel with the same
    arguments: at m_loc 16 chunks 4 clamps to 2 (dropped); at m_loc 12
    chunks 2 and 4 clamp to 1 and bidir gives way (all but the first
    dropped); the GEMM-RS's bidir gives way at N/2 % 128 != 0."""
    mesh = TMesh((4,), ("tp",), "cpu")
    ctx = tag.create_ag_gemm_context(mesh)
    fn = tag._ag_gemm_tunable
    assert fn._configs_for((torch.zeros(64, 128), torch.zeros(128, 512)),
                           {"ctx": ctx}) == [
        {"chunks": 1}, {"chunks": 2}, {"chunks": 1, "ring_mode": "bidir"}]
    assert fn._configs_for((torch.zeros(48, 128), torch.zeros(128, 512)),
                           {"ctx": ctx}) == [{"chunks": 1}]
    rctx = trs.create_gemm_rs_context(mesh)
    assert trs._gemm_rs_tunable._configs_for(
        (torch.zeros(64, 512), torch.zeros(512, 384)), {"ctx": rctx}) == [
            {"ring_mode": "uni"}]
    assert len(trs._gemm_rs_tunable._configs_for(
        (torch.zeros(64, 512), torch.zeros(512, 256)), {"ctx": rctx})) == 2


@pytest.mark.parametrize("winner", [0, 1, 2, 3])
def test_autotuned_entries_equal_plain_whichever_config_wins(winner,
                                                             monkeypatch):
    """``ag_gemm_autotuned`` / ``gemm_rs_autotuned`` inside one
    contextual region, with a measure hook making config ``winner`` the
    fastest: the winner is that config and the outputs equal the plain
    host entries (the AG-GEMM's modes bit for bit, the GEMM-RS's within
    1e-5: bidir adds in another order)."""
    mesh = TMesh((4,), ("tp",), "cpu")
    rng = np.random.default_rng(370)
    a = _t(rng.standard_normal((128, 128)).astype(np.float32))
    b = _t(rng.standard_normal((128, 512)).astype(np.float32))
    a2 = _t(rng.standard_normal((128, 512)).astype(np.float32))
    b2 = _t(rng.standard_normal((512, 256)).astype(np.float32))

    def rig(fn):
        configs = fn._configs_for  # the pruned sweep of these shapes

        def measure(f, args, kwargs, config):
            order = configs(args, kwargs)
            fast = order[winner % len(order)]
            return f(*args, **{**kwargs, **config}), (
                1.0 if config == fast else 5.0)

        monkeypatch.setattr(fn, "measure", measure)
        monkeypatch.setattr(fn, "cache", {})
        monkeypatch.setattr(fn, "sweeps", {})

    rig(tag._ag_gemm_tunable)
    rig(trs._gemm_rs_tunable)

    @tat.contextual_autotune(n_repeat=1, n_warmup=1)
    def op(x, w, x2, w2):
        return (tag.ag_gemm_autotuned(x, w, tag.create_ag_gemm_context(
            mesh)), trs.gemm_rs_autotuned(x2, w2, trs.create_gemm_rs_context(
                mesh)))

    c, c2 = op(a, b, a2, b2)
    ag_cfgs = tag._ag_gemm_tunable._configs_for((a, b), {
        "ctx": tag.create_ag_gemm_context(mesh)})
    rs_cfgs = trs._gemm_rs_tunable._configs_for((a2, b2), {
        "ctx": trs.create_gemm_rs_context(mesh)})
    assert tag._ag_gemm_tunable.best_config == ag_cfgs[winner % len(ag_cfgs)]
    assert trs._gemm_rs_tunable.best_config == rs_cfgs[winner % len(rs_cfgs)]
    assert torch.equal(c, tag.ag_gemm(a, b, tag.create_ag_gemm_context(
        mesh)))
    assert_allclose(c2, trs.gemm_rs(a2, b2, trs.create_gemm_rs_context(
        mesh)), atol=RING_TOL, rtol=RING_TOL)


# ---------------------------------------------------------------------------
# The MoE overlap kernels (AG-GroupGEMM, GroupGEMM-RS), their host and
# autotuned entries, and the AG-GroupGEMM feeder's host planner
# ---------------------------------------------------------------------------

jagg = importlib.import_module("triton_dist_tpu.kernels.allgather_group_gemm")
jmrs = importlib.import_module("triton_dist_tpu.kernels.moe_reduce_rs")
jho = importlib.import_module("triton_dist_tpu.runtime.host_ops")
tagg = importlib.import_module("triton_dist_tpu_torch.kernels."
                               "allgather_group_gemm")
tmrs = importlib.import_module("triton_dist_tpu_torch.kernels.moe_reduce_rs")
tho = importlib.import_module("triton_dist_tpu_torch.runtime.host_ops")

ROUTINGS = ("balanced", "skewed", "empty")


def _routing(rng, T, E, topk, kind="balanced"):
    """(weights, experts) from the reference's router on seeded logits:
    N(0, 1), ``skewed`` (+4 on experts 0 and 1: most assignments land
    there) or ``empty`` (expert E - 1 gets no token)."""
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if kind == "skewed":
        logits[:, :2] += 4.0
    elif kind == "empty":
        logits[:, -1] = -1e9
    return jmu.topk_routing(jnp.asarray(logits), topk)


def _dense_moe(x, w, weights, experts):
    """out[t] = sum_k weights[t, k] x[t] @ w[experts[t, k]] in f32 (the
    reference tests' oracle)."""
    xn, wn = np.asarray(x, np.float32), np.asarray(w, np.float32)
    wts, exp = np.asarray(weights), np.asarray(experts)
    out = np.zeros((xn.shape[0], wn.shape[-1]), np.float32)
    for t in range(xn.shape[0]):
        for k in range(wts.shape[1]):
            out[t] += wts[t, k] * (xn[t] @ wn[exp[t, k]])
    return out


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("block_m", [8, 16, 128])
def test_segment_plans_match_reference(block_m, routing):
    """``_segment_plans`` on the port's sort_align: dest, tile_expert and
    m_pad bit-equal to the reference's, per segment, under each
    routing."""
    W, t_loc, topk, E = 4, 24, 2, 8
    _, experts = _routing(np.random.default_rng(block_m), W * t_loc, E,
                          topk, routing)
    exp = np.asarray(experts)
    if routing == "empty":
        assert (exp != E - 1).all()
    jd, jte, jm = jagg._segment_plans(jnp.asarray(exp.reshape(
        W, t_loc, topk)), E, block_m)
    td, tte, tm = tagg._segment_plans(_t(exp).view(W, t_loc, topk), E,
                                      block_m)
    assert tm == jm
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tte.numpy(), np.asarray(jte))
    assert tte.dtype == torch.int32


AGG_CASES = {
    # name: (W, T, D, F, E, block_m, dtype, tol): tests/test_ag_group_gemm.py
    "mesh4_f32": (4, 64, 128, 512, 4, 8, "float32", 2e-4),
    "mesh2_bf16": (2, 32, 256, 256, 8, 16, "bfloat16", 5e-2),
    "world1": (1, 16, 128, 128, 4, 8, "float32", 2e-4),
}


@pytest.mark.parametrize("name", sorted(AGG_CASES))
def test_ag_group_gemm_matches_reference(name, monkeypatch, request):
    """The host entry ``ag_group_gemm(x, weights, experts, w_stack, ctx)``
    on a port Mesh against the reference's on the same inputs (its
    interpret-mode ``_ag_group_gemm_kernel``, spied) and against the dense
    oracle, within the reference test's tolerance; ``impl="xla"`` equal
    to the default on CPU tensors, and no launch counted."""
    W, T, Dm, F, E, bm, dt, tol = AGG_CASES[name]
    traced = _spy_kernels(monkeypatch, jagg, "_ag_group_gemm_kernel")
    rng = np.random.default_rng(400 + W)
    x = rng.standard_normal((T, Dm)).astype(np.float32)
    w = (rng.standard_normal((E, Dm, F)) / np.sqrt(Dm)).astype(np.float32)
    weights, experts = _routing(rng, T, E, 2)
    jx, jw = jnp.asarray(x, dt), jnp.asarray(w, dt)
    want = jagg.ag_group_gemm(jx, weights, experts, jw,
                              jagg.create_ag_group_gemm_context(
                                  _mesh(W, request), n_experts=E, topk=2,
                                  block_m=bm, impl="pallas",
                                  interpret=True))
    assert traced
    tx, tw = (_t(np.asarray(a.astype(jnp.float32))).to(getattr(torch, dt))
              for a in (jx, jw))
    port_mesh = TMesh((W,), ("tp",), "cpu")
    args = (tx, _t(np.asarray(weights)), _t(np.asarray(experts)), tw)
    n0 = tagg.ag_group_gemm_shard.launches
    got = tagg.ag_group_gemm(*args, tagg.create_ag_group_gemm_context(
        port_mesh, n_experts=E, topk=2, block_m=bm))
    assert got.shape == (T, F) and got.dtype == tx.dtype
    assert tagg.ag_group_gemm_shard.launches == n0
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got), _dense_moe(jx, jw, weights,
                                                     experts),
                               rtol=tol, atol=tol)
    assert torch.equal(got, tagg.ag_group_gemm(
        *args, tagg.create_ag_group_gemm_context(
            port_mesh, n_experts=E, topk=2, block_m=bm, impl="xla")))


def _rs_case(W, T, Dm, E, topk, block_m, dt, seed):
    """The reference test's case (tests/test_moe_reduce_rs.py): the first
    layer is the identity (F == D), h the sorted tokens; returns the
    reference's (h, w, weights, experts) and the port's h built through
    the port's plans."""
    rng = np.random.default_rng(seed)
    t_loc = T // W
    x = jnp.asarray(rng.standard_normal((T, Dm)).astype(np.float32), dt)
    w = jnp.asarray((rng.standard_normal((E, Dm, Dm)) / np.sqrt(Dm))
                    .astype(np.float32), dt)
    weights, experts = _routing(rng, T, E, topk)
    jd, _, m_pad = jagg._segment_plans(experts.reshape(W, t_loc, topk), E,
                                       block_m)
    h = jnp.concatenate([jmu.gather_sorted(x.reshape(W, t_loc, Dm)[s],
                                           jd[s], m_pad) for s in range(W)])
    tx = _t(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dt))
    td, _, tm = tagg._segment_plans(_t(np.asarray(experts)).view(
        W, t_loc, topk), E, block_m)
    th = torch.cat([tmu.gather_sorted(tx.view(W, t_loc, Dm)[s], td[s], tm)
                    for s in range(W)])
    return x, h, w, weights, experts, th


RS_REF_CASES = {
    # name: (W, T, D, E, block_m, dtype, rtol, atol): the reference's three
    "mesh4_f32": (4, 64, 512, 4, 8, "float32", 2e-4, 2e-4),
    "mesh2_bf16": (2, 32, 256, 8, 16, "bfloat16", 5e-2, 5e-1),
    "world1": (1, 16, 128, 4, 8, "float32", 2e-4, 2e-4),
}


@pytest.mark.parametrize("name", sorted(RS_REF_CASES))
def test_moe_reduce_rs_matches_reference(name, monkeypatch, request):
    """``moe_reduce_rs(h, w_stack, weights, experts, ctx)`` on a port
    Mesh: the port's h (its plans, its gather) bit-equal to the
    reference's, the output against the reference's interpret-mode
    ``_moe_rs_kernel`` (spied) and the dense oracle within the reference
    test's tolerances; no launch counted on CPU tensors."""
    W, T, Dm, E, bm, dt, rtol, atol = RS_REF_CASES[name]
    traced = _spy_kernels(monkeypatch, jmrs, "_moe_rs_kernel")
    x, h, w, weights, experts, th = _rs_case(W, T, Dm, E, 2, bm, dt,
                                              410 + W)
    assert np.array_equal(_f32(th), _f32(h.astype(jnp.float32)))
    want = jmrs.moe_reduce_rs(h, w, weights, experts,
                              jmrs.create_moe_rs_context(
                                  _mesh(W, request), n_experts=E, topk=2,
                                  block_m=bm, impl="pallas",
                                  interpret=True))
    assert traced
    tw = _t(np.asarray(w.astype(jnp.float32))).to(getattr(torch, dt))
    n0 = tmrs.moe_reduce_rs_shard.launches
    got = tmrs.moe_reduce_rs(th, tw, _t(np.asarray(weights)),
                             _t(np.asarray(experts)),
                             tmrs.create_moe_rs_context(
                                 TMesh((W,), ("tp",), "cpu"), n_experts=E,
                                 topk=2, block_m=bm))
    assert got.shape == (T, Dm) and tmrs.moe_reduce_rs_shard.launches == n0
    np.testing.assert_allclose(_f32(got), _f32(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(_f32(got), _dense_moe(x, w, weights, experts),
                               rtol=rtol, atol=atol)


def test_moe_rs_plain_adds_in_hop_order():
    """The plain reduce-scatter sums segment c's bf16 partials in the
    reference's hop order: rank c + 1's first, then ``acc = local + acc``
    at c + 2, ..., c, each add rounded to bf16 (integer-valued partials
    past bf16's 8-bit mantissa show any other order)."""
    W, m_pad, f_loc, D, E, bm = 4, 8, 8, 8, 2, 8
    te = torch.tensor([[0], [1], [0], [1]], dtype=torch.int32)
    h = torch.zeros((W, W * m_pad, f_loc), dtype=torch.bfloat16)
    w = torch.zeros((W, E, f_loc, D), dtype=torch.bfloat16)
    vals = [256.0, 1.0, 1.0, 1.0]     # rank q's partial of every segment
    for q in range(W):
        h[q, :, 0] = 1.0
        w[q, :, 0, :] = vals[q]
    out = tmrs.moe_rs_ref(h, w, te, block_m=bm)
    for c in range(W):
        acc = torch.tensor(vals[(c + 1) % W], dtype=torch.bfloat16)
        for j in range(2, W + 1):
            acc = torch.tensor(vals[(c + j) % W], dtype=torch.bfloat16) + acc
        assert torch.all(out[c] == acc), (c, out[c, 0, 0], acc)
    # 256 + 1 rounds to 256 in bf16 and 3 + 256 to 260: the order decides
    assert {float(out[c, 0, 0]) for c in range(W)} == {256.0, 260.0}


def test_moe_rs_operand_rule():
    """``grouped_operand_ok``, what ``tdt_moe_rs``'s tensor maps read: the
    views ``moe_reduce_rs`` builds at Mixtral-8x7B TP-4 widths (h [W, W
    m_pad, F_loc] of the sorted [W m_pad, F] and the down slabs [W, E,
    F_loc, D] of [E, F, D], each rank's F block in place; shapes on the
    meta device) pass, at one rank too; a zero rank or expert stride (a
    stack expanded over the ranks), a stride off 16 bytes, a misaligned
    base, a non-unit last stride, f32 and a 2-D operand fail."""
    ok = tagg.grouped_operand_ok
    bf = torch.bfloat16
    W, m_pad, F, D, E = 4, 5120, 14336, 4096, 8
    h = torch.empty((W * m_pad, F), dtype=bf, device="meta")
    h_r = h.view(W * m_pad, W, F // W).permute(1, 0, 2)
    w = torch.empty((E, F, D), dtype=bf, device="meta")
    w_r = w.view(E, W, F // W, D).permute(1, 0, 2, 3)
    for t in (h_r, w_r, h_r[:1], w_r[:1], w_r[:, :1]):
        assert ok(tuple(t.shape), t.stride(), bf), (t.shape, t.stride())
    assert not ok(tuple(w_r.shape), (0, *w_r.stride()[1:]), bf)
    assert not ok(tuple(w_r.shape), (w_r.stride(0), 0, *w_r.stride()[2:]),
                  bf)
    assert not ok((4, 512, 256), (260, 1040, 1), bf)    # 520-byte ranks
    assert not ok(tuple(h_r.shape), h_r.stride(), bf, offset=4)
    assert not ok((4, 512, 256), (256, 1, 512), bf)     # transposed rows
    assert not ok(tuple(h_r.shape), h_r.stride(), torch.float32)
    assert not ok((512, 256), (256, 1), bf)
    with pytest.raises(ValueError, match="TMA"):
        tag._check_tma("moe_reduce_rs", w[:1].expand(W, E, F, D),
                        rule=tagg.grouped_operand_ok)


@pytest.mark.parametrize("world,block_m,n", [(1, 128, 256), (2, 256, 384),
                                              (4, 512, 3584), (8, 128, 128)])
def test_ag_group_gemm_tile_order_writes_each_tile_once(world, block_m, n):
    """``allgather_group_gemm.tile_order``, the expert-major walk of
    ``tdt_ag_group_gemm`` (sorted plans with an empty expert and padding
    tiles clamped to E - 1): every rank writes each (segment, row tile,
    column band) of its output once, each tile against its own expert;
    an expert's tiles are contiguous in the list, experts ascending; and
    its first row group holds the rank's own segment's tiles of it
    first."""
    rng = np.random.default_rng(world * block_m + n)
    n_bt, E = 6, 5
    te = np.sort(rng.integers(0, E - 1, (world, n_bt)), axis=1)
    te[:, -2:] = E - 1        # padding tiles clamp to the last expert
    per, tiles_n = block_m // 128, -(-n // 256)
    for me in range(world):
        order = list(tagg.tile_order(te, me, n, block_m))
        seen = {(s, i, c) for s, i, c, _ in order}
        assert len(order) == len(seen) == world * n_bt * per * tiles_n
        assert all(te[s][i // per] == e for s, i, _, e in order)
        experts = [e for *_, e in order]
        assert experts == sorted(experts)
        for e in set(experts):
            first = [s for s, _, _, x in order if x == e][:8]
            own = sum(1 for x in te[me] if x == e) * per
            assert first[:min(own, 8)] == [me] * min(own, 8)


def test_ag_group_gemm_and_torus_ag_gemm_operand_rules():
    """The TMA rules the row 19 and torus AG-GEMM wrappers check before a
    launch.  ``grouped_operand_ok`` takes the views ``ag_group_gemm``
    builds at Mixtral-8x7B TP-4 widths (the sorted segments xs [W, m_pad,
    D], the gathered [W, W m_pad, D] and the gate slabs [W, E, D, F_loc] of
    [E, D, F], each rank's F block in place; shapes on the meta device), at
    one rank and one expert too; ``ag_gemm_operand_ok`` takes the torus
    operands at ``chip_smoke.py`` phase 22's widths (Llama-3-8B TP 8 on
    (2, 4): a [8, 256, 4096], gate/up and QKV B and B^T, the gathered [8,
    2048, 4096], int8 a and B).  A zero rank stride (one stack expanded
    over the ranks), F blocks 7,176 bytes apart, a misaligned base, f32, a
    2-D operand and 8-byte int8 rows fail, and ``_check_tma`` raises on
    the expanded stack."""
    ok, bf, i8 = tagg.grouped_operand_ok, torch.bfloat16, torch.int8
    W, m_pad, D, F, E = 4, 5120, 4096, 14336, 8
    xs = torch.empty((W, m_pad, D), dtype=bf, device="meta")
    gathered = torch.empty((W, W * m_pad, D), dtype=bf, device="meta")
    w = torch.empty((E, D, F), dtype=bf, device="meta")
    w_r = w.view(E, D, W, F // W).permute(2, 0, 1, 3)
    for t in (xs, gathered, w_r, xs[:1], w_r[:1], w_r[:, :1]):
        assert ok(tuple(t.shape), t.stride(), bf), (t.shape, t.stride())
    assert not ok(tuple(w_r.shape), (0, *w_r.stride()[1:]), bf)
    w_odd = torch.empty((E, D, W * 3588), dtype=bf, device="meta").view(
        E, D, W, 3588).permute(2, 0, 1, 3)
    assert not ok(tuple(w_odd.shape), w_odd.stride(), bf)
    assert not ok(tuple(xs.shape), xs.stride(), bf, offset=4)
    assert not ok(tuple(xs.shape), xs.stride(), torch.float32)
    assert not ok((m_pad, D), (D, 1), bf)
    with pytest.raises(ValueError, match="TMA"):
        tag._check_tma("ag_group_gemm", w_r[:1].expand(W, E, D, F // W),
                       rule=ok)
    G, m_loc = 8, 256
    for shape, dt in (((G, m_loc, D), bf), ((G, D, F // G), bf),
                      ((G, F // G, D), bf), ((G, D, 6144 // G), bf),
                      ((G, 6144 // G, D), bf), ((G, G * m_loc, D), bf),
                      ((G, m_loc, D), i8), ((G, D, F // G), i8),
                      ((G, G * m_loc, D), i8)):
        t = torch.empty(shape, dtype=dt, device="meta")
        assert tag.ag_gemm_operand_ok(shape, t.stride(), dt), (shape, dt)
    assert not tag.ag_gemm_operand_ok((G, D, 8), (D * 8, 8, 1), i8)
    assert not tag.ag_gemm_operand_ok((G, m_loc, D), (m_loc * D, D, 1), bf,
                                      offset=1)


@pytest.mark.parametrize("W,m_pad,n,slots,flags", [
    (4, 5120, 4096, (3, 640, 32768), 1920),   # Mixtral TP 4, block_m 512
    (4, 256, 384, (3, 4, 32768), 12),         # a ragged 128-column band
    (8, 128, 384, (7, 2, 32768), 14),
    (1, 512, 4096, (0, 64, 32768), 0),        # no hop: no slot, no flag
])
def test_moe_rs_workspace_sizes(W, m_pad, n, slots, flags):
    """``moe_rs_workspace``: W - 1 landing slots a rank, each every 128 x
    256 tile of [m_pad, n] (ceil(n / 256) column bands), and a flag per
    (slot, tile)."""
    assert tmrs.moe_rs_workspace(W, m_pad, n) == (slots, flags)


@pytest.mark.parametrize("T,E,topk", [(64, 4, 2), (32, 8, 2), (2048, 8, 2),
                                      (4096, 8, 2), (256, 32, 8)])
def test_default_block_m_gives_reference_m_pad(T, E, topk):
    """Without a ``block_m`` the entries take the reference's load-aware
    tile (:258, :263) and so its sorted layout: the same m_pad, so an h
    built for the reference's default fits the port's; h of any other
    row count raises (the reference's assert)."""
    W = 4
    ref_bm = jgg.load_aware_block_m(T * topk, E)
    ref_m_pad = jmu.padded_rows(T // W * topk, E, ref_bm)
    ctx = tmrs.create_moe_rs_context(TMesh((W,), ("tp",), "cpu"),
                                     n_experts=E, topk=topk)
    assert tagg.launch_keys([{}], T, ctx) == [(ref_bm, ref_m_pad)]
    if T <= 64:
        rng = np.random.default_rng(T)
        weights, experts = _routing(rng, T, E, topk)
        wts, exp = _t(np.asarray(weights)), _t(np.asarray(experts))
        w = torch.zeros((E, 128, 16))
        out = tmrs.moe_reduce_rs(torch.zeros((W * ref_m_pad, 128)), w, wts,
                                 exp, ctx)
        assert out.shape == (T, 16)
        with pytest.raises(ValueError, match="m_pad"):
            tmrs.moe_reduce_rs(torch.zeros((W * ref_m_pad - 8, 128)), w,
                               wts, exp, ctx)


def test_moe_host_entries_refuse_other_real_axes_and_unknown_impls():
    """As the ring GEMMs' entries: a mesh whose other axes have more than
    one rank raises (one flat world), axes of one rank are fine; an
    unknown ``impl`` raises."""
    rng = np.random.default_rng(430)
    weights, experts = _routing(rng, 16, 4, 2)
    wts, exp = _t(np.asarray(weights)), _t(np.asarray(experts))
    x, w = torch.zeros(16, 32), torch.zeros(4, 32, 64)
    for shape, names in (((2, 2), ("dp", "tp")), ((1, 4), ("dp", "tp"))):
        ctx = tagg.create_ag_group_gemm_context(TMesh(shape, names, "cpu"),
                                                n_experts=4, topk=2,
                                                block_m=8)
        if shape[0] > 1:
            with pytest.raises(NotImplementedError, match="flat world"):
                tagg.ag_group_gemm(x, wts, exp, w, ctx)
        else:
            assert tagg.ag_group_gemm(x, wts, exp, w, ctx).shape == (16, 64)
    rctx = tmrs.create_moe_rs_context(TMesh((2, 2), ("dp", "tp"), "cpu"),
                                      n_experts=4, topk=2, block_m=8)
    with pytest.raises(NotImplementedError, match="flat world"):
        tmrs.moe_reduce_rs(torch.zeros(8, 64), torch.zeros(4, 64, 32), wts,
                           exp, rctx)
    with pytest.raises(ValueError, match="impl"):
        tagg.ag_group_gemm(x, wts, exp, w, tagg.create_ag_group_gemm_context(
            TMesh((4,), ("tp",), "cpu"), n_experts=4, topk=2, impl="mosaic"))


def _tuning_rig(monkeypatch, fn, winner, outputs):
    """A measure hook that makes config ``winner`` of ``fn``'s pruned sweep
    the fastest and records each config's output."""
    def measure(f, args, kwargs, config):
        order = fn._configs_for(args, kwargs)
        ret = f(*args, **{**kwargs, **config})
        outputs.append((dict(config), ret))
        return ret, 1.0 if config == order[winner % len(order)] else 5.0

    monkeypatch.setattr(fn, "measure", measure)
    monkeypatch.setattr(fn, "cache", {})
    monkeypatch.setattr(fn, "sweeps", {})


@pytest.mark.parametrize("winner", [0, 1, 2])
def test_moe_autotuned_entries_equal_host_entries(winner, monkeypatch):
    """``ag_group_gemm_autotuned`` (the case of tests/test_autotuner.py:330:
    W 4, T 64, D 128, F 512, E 4) and ``moe_reduce_rs_autotuned`` (:385:
    W 2, t_loc 16, F 256, D 128, block_m 8) in one contextual region, a
    measure hook making config ``winner`` the fastest: the AG side's
    prune keeps its three block_m, the RS side's one of its three (bn, bk)
    (one launch on the fixed tile); every config's output equals the host
    entry's at that config, the winner is best_config, and the AG output
    is within the reference test's 2e-3 of the dense oracle."""
    rng = np.random.default_rng(420)
    T, Dm, F, E = 64, 128, 512, 4
    x = rng.standard_normal((T, Dm)).astype(np.float32)
    w = (rng.standard_normal((E, Dm, F)) / np.sqrt(Dm)).astype(np.float32)
    weights, experts = _routing(rng, T, E, 2)
    ag_args = (_t(x), _t(np.asarray(weights)), _t(np.asarray(experts)),
               _t(w))
    ag_ctx = tagg.create_ag_group_gemm_context(TMesh((4,), ("tp",), "cpu"),
                                               n_experts=E, topk=2)
    W2, t_loc, F2, D2, bm = 2, 16, 256, 128, 8
    weights2, experts2 = _routing(rng, W2 * t_loc, E, 2)
    td, _, m_pad = tagg._segment_plans(_t(np.asarray(experts2)).view(
        W2, t_loc, 2), E, bm)
    xs = _t(rng.standard_normal((W2, t_loc * 2, F2)).astype(np.float32))
    h = torch.cat([tmu.gather_sorted(xs[s], td[s], m_pad)
                   for s in range(W2)])
    rs_args = (h, _t((rng.standard_normal((E, F2, D2)) / np.sqrt(F2))
                     .astype(np.float32)),
               _t(np.asarray(weights2)), _t(np.asarray(experts2)))
    rs_ctx = tmrs.create_moe_rs_context(TMesh((W2,), ("tp",), "cpu"),
                                        n_experts=E, topk=2, block_m=bm)
    ag_fn, rs_fn = tagg._ag_group_gemm_tunable, tmrs._moe_reduce_rs_tunable
    assert ag_fn._configs_for(ag_args, {"ctx": ag_ctx}) == \
        tagg.AG_GROUP_GEMM_TUNE_SPACE
    assert rs_fn._configs_for(rs_args, {"ctx": rs_ctx}) == \
        tmrs.MOE_RS_TUNE_SPACE[:1]
    ag_out, rs_out = [], []
    _tuning_rig(monkeypatch, ag_fn, winner, ag_out)
    _tuning_rig(monkeypatch, rs_fn, winner, rs_out)

    @tat.contextual_autotune(n_repeat=1, n_warmup=1)
    def op():
        return (tagg.ag_group_gemm_autotuned(*ag_args, ag_ctx),
                tmrs.moe_reduce_rs_autotuned(*rs_args, rs_ctx))

    out, out2 = op()
    assert ag_fn.best_config == tagg.AG_GROUP_GEMM_TUNE_SPACE[winner]
    assert rs_fn.best_config == tmrs.MOE_RS_TUNE_SPACE[0]
    assert {c["block_m"] for c, _ in ag_out} == {128, 256, 512}
    host = {bm_: tagg.ag_group_gemm(*ag_args, tagg.create_ag_group_gemm_context(
        ag_ctx.mesh, n_experts=E, topk=2, block_m=bm_))
        for bm_ in (128, 256, 512)}
    for cfg, ret in ag_out:
        assert torch.equal(ret, host[cfg["block_m"]]), cfg
    assert torch.equal(out, host[ag_fn.best_config["block_m"]])
    np.testing.assert_allclose(out.numpy(), _dense_moe(x, w, weights,
                                                       experts),
                               rtol=2e-3, atol=2e-3)
    want2 = tmrs.moe_reduce_rs(*rs_args, rs_ctx)
    assert rs_out and all(torch.equal(ret, want2) for _, ret in rs_out)
    assert torch.equal(out2, want2) and out2.shape == (W2 * t_loc, D2)


HOST_PLAN_CASES = [
    # (n_ranks, tokens, topk, n_experts, block_m): tests/test_host_ops.py's
    # cases and its native-vs-numpy one
    (1, 32, 2, 4, 8), (4, 16, 4, 8, 16), (2, 1, 1, 2, 8), (8, 64, 4, 16, 32),
]


@pytest.mark.parametrize("impl", ["native", "numpy"])
@pytest.mark.parametrize("case", HOST_PLAN_CASES)
def test_host_planner_matches_reference(impl, case):
    """``host_ops.moe_ag_scatter_align_block_size`` (the C library built
    from the port's own source, or numpy) equal to the reference's numpy
    planner in every array and the padded total, with the default and a
    custom ``pad_value``."""
    n_ranks, tokens, topk, E, bm = case
    flat = np.random.default_rng(42).integers(
        0, E, n_ranks * tokens * topk).astype(np.int32)
    for pad in (-1, 7):
        got = tho.moe_ag_scatter_align_block_size(flat, n_ranks, E, bm,
                                                  pad_value=pad, impl=impl)
        want = jho.moe_ag_scatter_align_block_size(flat, n_ranks, E, bm,
                                                   pad_value=pad,
                                                   impl="numpy")
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), (k, pad)
        n = got["total_padded"]
        assert (got["sorted_token_ids"][n:] == pad).all()


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_host_planner_refuses_out_of_range_experts(impl):
    with pytest.raises(ValueError):
        tho.moe_ag_scatter_align_block_size(np.array([0, 1, 99], np.int32),
                                            1, 4, 8, impl=impl)
    with pytest.raises(ValueError):
        tho.moe_ag_scatter_align_block_size(np.array([0, -1], np.int32), 1,
                                            4, 8, impl=impl)
    with pytest.raises(ValueError, match="divisible"):
        tho.moe_ag_scatter_align_block_size(np.zeros(5, np.int32), 2, 4, 8,
                                            impl=impl)


def test_stable_rank_in_group_host_matches_reference():
    """The host twin of ``stable_rank_in_group`` through the native
    library: the reference test's case (tests/test_host_ops.py), and the
    device version's ranks and counts on seeded keys."""
    assert tho.native_available()
    rank, counts = tho.stable_rank_in_group_host(
        np.array([2, 0, 2, 1, 0, 2], np.int32), 3)
    assert rank.tolist() == [0, 0, 1, 0, 1, 2] and counts.tolist() == [2, 1, 3]
    keys = np.random.default_rng(3).integers(0, 5, 64).astype(np.int32)
    rank, counts = tho.stable_rank_in_group_host(keys, 5)
    want_rank, want_counts = tmu.stable_rank_in_group(_t(keys), 5)
    assert np.array_equal(rank, want_rank.numpy())
    assert np.array_equal(counts, want_counts.numpy())
    with pytest.raises(ValueError):
        tho.stable_rank_in_group_host(np.array([0, 9], np.int32), 3)



# ---------------------------------------------------------------------------
# The torus (multi-axis) collectives and ring GEMMs against the reference's
# XLA math over the joint axes (the interpret-mode kernels' parity tests
# are in test_torch_train.py), and their dispatch and contract
# ---------------------------------------------------------------------------

TORUS_XLA_MESHES = {
    # name: (mesh shape, names, joint axes): the reference's oracle meshes,
    # a reordered tuple, a subset tuple (two groups of four), degenerate
    # size-1 axes (one real axis left; two left of three)
    "2x4": ((2, 4), ("x", "y"), ("x", "y")),
    "4x2": ((4, 2), ("x", "y"), ("x", "y")),
    "2x2x2": ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z")),
    "2x4_yx": ((2, 4), ("x", "y"), ("y", "x")),
    "2x2x2_yz": ((2, 2, 2), ("x", "y", "z"), ("y", "z")),
    "1x4": ((1, 4), ("x", "y"), ("x", "y")),
    "2x1x4": ((2, 1, 4), ("x", "y", "z"), ("x", "y", "z")),
}


def _torus_xla_case(name):
    shape, names, axes = TORUS_XLA_MESHES[name]
    sizes = dict(zip(names, shape))
    return (_jmesh(shape, names), _tmesh(shape, names), axes,
            int(np.prod([sizes[a] for a in axes])), int(np.prod(shape)))


@pytest.mark.parametrize("name", sorted(TORUS_XLA_MESHES))
def test_torus_collectives_match_xla(name):
    """The tuple-axis all-gather (80 KiB a rank: the torus schedule) bit
    for bit against ``lax.all_gather`` over the joint axes, the
    reduce-scatter (distinct f32 partials) within 1e-5 of
    ``lax.psum_scatter`` over them (another order of adds), and RS(AG(x))
    = G x band for band within 1e-5 (the reference's round trip)."""
    from triton_dist_tpu_torch.kernels import allgather as tag_
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs_

    jmesh, mesh, axes, G, W = _torus_xla_case(name)
    rows = 160
    x = _inputs(440, (G * rows, 128))[0]
    want = np.asarray(_shard_map(
        lambda s: jax.lax.all_gather(s, axes, axis=0, tiled=True)[None],
        jmesh, (P(axes),), P(jmesh.axis_names), jnp.asarray(x)))
    idx = torch.tensor(mesh.joint_index(axes))
    xt = _t(x).reshape(G, rows, 128)[idx].reshape(*mesh.shape, rows, 128)
    got = tag_.all_gather_shard(xt, mesh, axes)
    assert np.array_equal(got.reshape(want.shape).numpy(), want)
    parts = _inputs(441, (W, G * 8, 128))[0]
    want = _shard_map(lambda p: jax.lax.psum_scatter(
        p[0], axes, scatter_dimension=0, tiled=True)[None], jmesh,
        (P(jmesh.axis_names),), P(jmesh.axis_names), jnp.asarray(parts))
    got = trs_.reduce_scatter_shard(
        _t(parts).reshape(*mesh.shape, G * 8, 128), mesh, axes)
    assert_allclose(got.reshape(W, 8, 128), np.asarray(want), atol=1e-5,
                    rtol=1e-5)
    back = trs_.reduce_scatter_shard(got_ag := tag_.all_gather_shard(
        xt, mesh, axes), mesh, axes)
    assert got_ag.shape[-2] == G * rows
    assert_allclose(back, G * xt, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(TORUS_XLA_MESHES))
def test_torus_gemm_host_entries_match_xla(name):
    """``ag_gemm_gathered`` and ``gemm_rs`` with a tuple axis on a port
    Mesh against the reference's host entries (``impl="xla"``: XLA's
    joint gather and ``psum_scatter`` around ``jnp.dot``): A_full bit for
    bit, C within the reference tests' 2e-3; a's rows and b's columns (or
    a's columns and b's rows) sharded flat axes-major."""
    jmesh, mesh, axes, G, W = _torus_xla_case(name)
    rng = np.random.default_rng(450)
    a = rng.standard_normal((8 * G, 128)).astype(np.float32)
    b = rng.standard_normal((128, 128 * G)).astype(np.float32)
    ja = jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P(axes, None)))
    jb = jax.device_put(jnp.asarray(b), NamedSharding(jmesh, P(None, axes)))
    want_full, want_c = jagm.ag_gemm_gathered(
        ja, jb, jagm.create_ag_gemm_context(jmesh, axis=axes, impl="xla"))
    full, c = tag.ag_gemm_gathered(_t(a), _t(b), tag.create_ag_gemm_context(
        mesh, axis=axes))
    assert np.array_equal(full.numpy(), np.asarray(want_full))
    assert_allclose(c, np.asarray(want_c), atol=2e-3, rtol=2e-3)
    a2 = rng.standard_normal((8 * G, 128 * G)).astype(np.float32)
    b2 = (rng.standard_normal((128 * G, 256)) / np.sqrt(128 * G)).astype(
        np.float32)
    ja = jax.device_put(jnp.asarray(a2), NamedSharding(jmesh, P(None, axes)))
    jb = jax.device_put(jnp.asarray(b2), NamedSharding(jmesh, P(axes, None)))
    want = jgrs.gemm_rs(ja, jb, jgrs.create_gemm_rs_context(
        jmesh, axis=axes, impl="xla"))
    got = trs.gemm_rs(_t(a2), _t(b2), trs.create_gemm_rs_context(
        mesh, axis=axes))
    assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3)
    assert_allclose(got, a2 @ b2, atol=2e-3, rtol=2e-3)


def test_torus_int8_gemms_exact():
    """int8 through the torus schedules is exact: the GEMM-RS at
    test_torus_gemm_rs_int8_exact's case ((2, 4) mesh, M 64, K 1024, N
    512, integers in [-63, 64) from default_rng(3)) and at an untileable
    k (the reference composes; int32 sums agree in any order), and an
    int8-A AG-GEMM over the (2, 2, 2) mesh, each against numpy's int64
    product."""
    mesh = _tmesh((2, 4), ("x", "y"))
    rng = np.random.default_rng(3)
    a = rng.integers(-63, 64, (64, 1024), np.int8)
    b = rng.integers(-63, 64, (1024, 512), np.int8)
    ref = a.astype(np.int64) @ b.astype(np.int64)
    ctx = trs.create_gemm_rs_context(mesh, axis=("x", "y"))
    got = trs.gemm_rs(_t(a), _t(b), ctx)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), ref)
    got = trs.gemm_rs(_t(a[:, :8 * 40]), _t(b[:8 * 40]), ctx)
    assert np.array_equal(got.numpy().astype(np.int64),
                          a[:, :320].astype(np.int64) @ b[:320])
    mesh3 = _tmesh((2, 2, 2), ("x", "y", "z"))
    a = rng.integers(-127, 128, (64, 256), np.int8)
    b = rng.integers(-127, 128, (256, 8 * 128), np.int8)
    full, c = tag.ag_gemm_gathered(_t(a), _t(b), tag.create_ag_gemm_context(
        mesh3, axis=("x", "y", "z")))
    assert np.array_equal(full.numpy(), a)
    assert c.dtype == torch.int32
    assert np.array_equal(c.numpy().astype(np.int64),
                          a.astype(np.int64) @ b.astype(np.int64))


def test_torus_gemm_rs_composes_at_untileable_shapes():
    """At shapes the reference's fused kernel cannot tile (k 64, m_loc 4,
    N 200) the torus GEMM-RS composes as the reference does: the uni
    GEMM-RS over the first axis, then a reduce-scatter over the other;
    against the reference's host entry (``impl="xla"``) within 2e-3, and
    the bands stay flat axes-major; ``impl="pallas"`` raises there, as the
    reference's first step does."""
    jmesh, mesh, axes = (_jmesh((2, 4), ("x", "y")),
                         _tmesh((2, 4), ("x", "y")), ("y", "x"))
    rng = np.random.default_rng(460)
    for M, K, N in ((64, 512, 200), (32, 512, 256), (64, 8 * 64, 256)):
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
        ja = jax.device_put(jnp.asarray(a), NamedSharding(jmesh,
                                                          P(None, axes)))
        jb = jax.device_put(jnp.asarray(b), NamedSharding(jmesh,
                                                          P(axes, None)))
        want = jgrs.gemm_rs(ja, jb, jgrs.create_gemm_rs_context(
            jmesh, axis=axes, impl="xla"))
        got = trs.gemm_rs(_t(a), _t(b), trs.create_gemm_rs_context(
            mesh, axis=axes))
        assert_allclose(got, np.asarray(want), atol=2e-3, rtol=2e-3)
        with pytest.raises(ValueError, match="impl='pallas'"):
            trs.gemm_rs(_t(a), _t(b), trs.create_gemm_rs_context(
                mesh, axis=axes, impl="pallas"))


def test_torus_dispatch_and_contract(monkeypatch):
    """The reference's routing and refusals under a tuple axis: a gather of
    64 KiB or less a rank takes XLA's joint gather (the plain math), a
    larger one, or any method but XLA, the torus schedule; the
    reduce-scatter's XLA method sums in joint order, every other the
    torus schedule; more than three axes raise ValueError; ``wire_dtype``
    raises NotImplementedError; ``ring_mode="bidir"`` with ``chunks > 1``
    raises ValueError first, and is otherwise ignored, as ``chunks`` is;
    ``impl="pallas"`` off the tiling raises; the MoE overlap kernels
    refuse a joint group."""
    from triton_dist_tpu_torch.kernels import allgather as tag_
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as tagg
    from triton_dist_tpu_torch.kernels import reduce_scatter as trs_
    from triton_dist_tpu_torch.kernels import torus as ttorus

    calls = []
    for fn in ("torus_all_gather_ref", "torus_all_gather_shard",
               "torus_reduce_scatter_shard"):
        orig = getattr(ttorus, fn)
        monkeypatch.setattr(ttorus, fn, lambda *a, _o=orig, _n=fn, **kw: (
            calls.append(_n), _o(*a, **kw))[1])
    monkeypatch.setattr(trs_, "joint_sum_ref", lambda *a, _o=trs_.
                        joint_sum_ref: (calls.append("joint_sum_ref"),
                                        _o(*a))[1])
    mesh, axes = _tmesh((2, 4), ("x", "y")), ("x", "y")
    M = tag_.AllGatherMethod
    for rows, method, want in ((128, M.AUTO, "torus_all_gather_ref"),
                               (129, M.AUTO, "torus_all_gather_shard"),
                               (4, M.RING_1D, "torus_all_gather_shard"),
                               (4096, M.XLA, "torus_all_gather_ref")):
        calls.clear()
        x = torch.randn(2, 4, rows, 128)          # 512 bytes a row
        got = tag_.all_gather_shard(x, mesh, axes, method)
        assert calls[0] == want, (rows, method, calls)
        assert torch.equal(got, ttorus.torus_all_gather_ref(x, mesh, axes))
    R = trs_.ReduceScatterMethod
    for method, want in ((R.XLA, "joint_sum_ref"),
                         (R.AUTO, "torus_reduce_scatter_shard"),
                         (R.RING_1D, "torus_reduce_scatter_shard")):
        calls.clear()
        trs_.reduce_scatter_shard(torch.randn(2, 4, 16, 128), mesh, axes,
                                  method)
        assert calls == [want]
    mesh4 = _tmesh((2, 2, 2, 1), ("a", "b", "c", "d"))
    with pytest.raises(ValueError, match="1-3 axes"):
        tag_.all_gather_shard(torch.randn(2, 2, 2, 1, 8, 128), mesh4,
                              ("a", "b", "c", "d"))
    a, b = torch.randn(64, 128), torch.randn(128, 1024)
    with pytest.raises(NotImplementedError, match="wire_dtype"):
        tag.ag_gemm(a, b, tag.create_ag_gemm_context(
            mesh, axis=axes, wire_dtype="int8"))
    with pytest.raises(ValueError, match="bidir"):
        tag.ag_gemm(a, b, tag.create_ag_gemm_context(
            mesh, axis=axes, ring_mode="bidir", chunks=2))
    with pytest.raises(ValueError, match="bidir"):
        tag.ag_gemm_shard(torch.randn(8, 8, 128), torch.randn(8, 128, 128),
                          ring_mode="bidir", chunks=2, mesh=mesh, axis=axes)
    base = tag.ag_gemm(a, b, tag.create_ag_gemm_context(mesh, axis=axes))
    for kw in (dict(ring_mode="bidir"), dict(chunks=4)):
        assert torch.equal(tag.ag_gemm(a, b, tag.create_ag_gemm_context(
            mesh, axis=axes, **kw)), base)
    assert tag.ag_gemm_schedule(8, 8, False, chunks=4, torus=True) == \
        tag.ag_gemm_schedule(8, 8, False, ring_mode="bidir", torus=True)
    assert trs.gemm_rs_schedule(8, 512, "bidir", torus=True) == "torus"
    with pytest.raises(ValueError, match="impl='pallas'"):
        tag.ag_gemm(a[:60], b, tag.create_ag_gemm_context(
            mesh, axis=axes, impl="pallas"))
    with pytest.raises(NotImplementedError, match="flat world"):
        tagg.ag_group_gemm(torch.zeros(16, 32), torch.ones(16, 2),
                           torch.zeros(16, 2, dtype=torch.long),
                           torch.zeros(4, 32, 64),
                           tagg.create_ag_group_gemm_context(
                               mesh, n_experts=4, topk=2, axis=axes))


def test_torus_autotuner_dedupes_to_one_schedule():
    """Under a tuple axis every config of the ring GEMMs' sweeps resolves
    to the torus schedule, so the prune keeps one (the reference's sweep
    collapses to one program); the autotuned entries equal the host
    entries."""
    mesh, axes = _tmesh((2, 2, 2), ("x", "y", "z")), ("x", "y", "z")
    ctx = tag.create_ag_gemm_context(mesh, axis=axes)
    a, b = torch.randn(64, 128), torch.randn(128, 1024)
    assert tag._ag_gemm_tunable._configs_for((a, b), {"ctx": ctx}) == [
        {"chunks": 1}]
    rctx = trs.create_gemm_rs_context(mesh, axis=axes)
    a2, b2 = torch.randn(64, 1024), torch.randn(1024, 256)
    assert trs._gemm_rs_tunable._configs_for((a2, b2), {"ctx": rctx}) == [
        {"ring_mode": "uni"}]
    assert torch.equal(tag.ag_gemm_autotuned(a, b, ctx),
                       tag.ag_gemm(a, b, ctx))
    assert torch.equal(trs.gemm_rs_autotuned(a2, b2, rctx),
                       trs.gemm_rs(a2, b2, rctx))


# ---------------------------------------------------------------------------
# The uni AG-GEMM on sm90_gemm.cuh: its TMA operand rule and its schedule
# ---------------------------------------------------------------------------


def test_ag_gemm_operand_ok_rule():
    """``ag_gemm_operand_ok``: contiguous rank-stacked bf16 and int8
    operands at the model paths' widths pass (a rank of one row too);
    a misaligned base, a row or rank stride off 16 bytes, a non-unit last
    stride, another dtype or rank fail."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as tag

    ok = tag.ag_gemm_operand_ok
    bf, i8 = torch.bfloat16, torch.int8
    for shape, dt in (((4, 512, 4096), bf), ((4, 4096, 3584), bf),
                      ((4, 1024, 4096), bf), ((8, 1, 8), bf),
                      ((1, 250, 4096), bf), ((4, 512, 4096), i8),
                      ((4, 4096, 1536), i8), ((2, 16, 32), i8)):
        x = torch.empty(shape, dtype=torch.float32 if dt == bf else dt)
        assert ok(shape, x.stride(), dt), (shape, dt)
    full = torch.empty(4, 512, 4096)
    assert ok((4, 512, 4096), full.stride(), bf, offset=8)
    assert not ok((4, 512, 4096), full.stride(), bf, offset=1)
    assert not ok((4, 512, 4), (2048, 4, 1), bf)        # 8-byte rows
    assert not ok((4, 512, 8), (4097, 8, 1), bf)        # odd rank stride
    assert not ok((4, 512, 4096), (2097152, 1, 512), bf)  # transposed view
    assert not ok((4, 512, 8), (4096, 8, 1), i8)        # 8-byte int8 rows
    assert not ok((4, 512, 64), (32768, 64, 1), torch.float32)
    assert not ok((512, 4096), (4096, 1), bf)
    assert ok((1, 512, 4096), (7, 4096, 1), bf)         # one rank: never stepped


def _uni_walk(world, m_loc, n, crow, bn, bm=128):
    """Walk ``ag_gemm_wg_kernel``'s loops for every rank (``item_of`` with
    column bands outermost in a segment, ``push_piece``, the producer's
    flag wait and box): the pushed rows per (receiver, segment, chunk)
    with their piece counts, the output tiles written, and the flags
    waited on."""
    from collections import Counter, defaultdict

    tiles, tiles_n = -(-m_loc // bm), -(-n // bn)
    ppc, n_chunks = -(-crow // bm), m_loc // crow
    per_peer = n_chunks * ppc
    n_copy = world * per_peer
    pieces, rows_in = Counter(), defaultdict(list)
    written, waited = Counter(), Counter()
    for me in range(world):
        for it in range(n_copy + world * tiles * tiles_n):
            if it < n_copy:
                p, rest = divmod(it, per_peer)
                to = (me + 1 + p) % world
                chunk, piece = divmod(rest, ppc)
                rows = min(bm, crow - piece * bm)
                r0 = chunk * crow + piece * bm
                pieces[to, me, chunk] += 1
                rows_in[to, me, chunk].append((r0, r0 + rows))
                continue
            t = it - n_copy
            seg = (me + t // (tiles * tiles_n)) % world
            col, tile = divmod(t % (tiles * tiles_n), tiles)
            rows = min(bm, m_loc - tile * bm)
            row0 = tile * bm
            # the box: rows [row0, row0 + bm) of a map bounded at m_loc
            assert 0 <= row0 < m_loc and row0 + rows == min(row0 + bm, m_loc)
            written[me, seg, tile, col] += 1
            if seg != me:
                c0, c1 = row0 // crow, (row0 + rows - 1) // crow
                assert c1 - c0 + 1 <= 32    # one lane of warp 0 a flag
                assert c0 * crow <= row0 and row0 + rows <= (c1 + 1) * crow
                for c in range(c0, c1 + 1):
                    waited[me, seg, c] += 1
    return pieces, rows_in, written, waited, (tiles, tiles_n, ppc, n_chunks)


@pytest.mark.parametrize("world", [2, 3, 4, 5, 6, 7, 8])
def test_ag_gemm_uni_schedule_walk(world):
    """The uni kernels' item list (``csrc/ag_gemm.cu``
    ``ag_gemm_wg_kernel``, 128 x 256 tiles in bf16 and int8) walked
    in Python for m_loc 1..2,048 and chunks 1..4 (clamped as the wrapper
    clamps): every output tile of every rank is written once; every
    chunk's flag at every receiver collects exactly its piece count (so it
    is raised once a call) from pieces that tile the chunk's rows, and
    every flag a tile waits on is one of them; no tile's box reaches past
    its segment's m_loc rows; a tile waits on at most 32 flags."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as tag

    for m_loc in (1, 2, 7, 8, 16, 100, 128, 129, 250, 256, 384, 512, 1000,
                  2048):
        for chunks in (1, 2, 3, 4):
            crow = m_loc // tag.clamp_chunks(m_loc, chunks)
            for n in (8, 16, 520, 1536):
                pieces, rows_in, written, waited, (tiles, tiles_n, ppc,
                                                   n_chunks) = _uni_walk(
                    world, m_loc, n, crow, 256)
                assert set(written.values()) == {1}
                assert len(written) == world * world * tiles * tiles_n
                assert len(pieces) == world * world * n_chunks
                assert set(pieces.values()) == {ppc}
                for (to, seg, c), spans in rows_in.items():
                    assert sorted(spans)[0][0] == c * crow
                    covered = sum(b - a for a, b in spans)
                    assert covered == crow and max(b for _, b in spans) == \
                        (c + 1) * crow
                assert set(waited) <= set(pieces)
                want = {(me, s, c) for me in range(world)
                        for s in range(world) if s != me
                        for c in range(n_chunks)}
                assert set(waited) == want


# ---------------------------------------------------------------------------
# Rows 8 and 9 on the persistent GEMM of sm90_gemm.cuh: the tile order, the
# int8 GEMM's kernel choice and the TMA operand rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_pad,n,block_m,int8", [
    (m_pad, n, bm, int8) for m_pad, n, bm in (
        (5120, 14336, 128),      # Mixtral gate/up, T 2,048
        (1152, 14336, 128),      # T 8 (decode width)
        (5120, 4096, 128),       # down / the dx of gate/up
        (17408, 14336, 512),     # EP 4
        (17408, 4096, 256),
        (3072, 14336, 256),
        (640, 384, 128),         # a ragged last column band
        (128, 128, 128))
    for int8 in (False, True)] + [
    (192, 384, 64, True),        # int8 at block_m % 128 == 64: 64-row tiles
    (768, 384, 192, True)])
def test_group_gemm_tile_order_writes_each_tile_once(m_pad, n, block_m,
                                                     int8):
    """``group_gemm.tile_order``, the walk of ``tdt_gemm90::tile_rc`` over
    the tiles of ``tile_shape`` (bf16 128 x 256; int8 256 x 128 at block_m
    % 256, 64-row tiles at block_m % 128 == 64): every (row tile, column
    band) once; each tile's rows inside one block_m row tile, so the B
    coordinate its producer reads (``tile_expert[row0 // block_m]``) is
    the expert of every row it writes; and the first GROUP x bands tiles
    stay in the first GROUP row tiles, band by band."""
    rng = np.random.default_rng(m_pad + n + block_m)
    te = np.sort(rng.integers(0, 8, m_pad // block_m))
    rows_of = np.arange(m_pad) // block_m
    order = list(tgg.tile_order(m_pad, n, block_m, int8))
    tr, tc = tgg.tile_shape(block_m, int8)
    assert (tr, tc) == ((256, 128) if int8 and block_m % 256 == 0 else
                        (128 if block_m % 128 == 0 else 64, 256))
    seen = set()
    for row0, rows, col0, cols, blk in order:
        assert (rows, cols) == (tr, tc)
        assert blk == row0 // block_m and row0 + rows <= m_pad
        assert set(te[rows_of[row0:row0 + rows]]) == {te[blk]}
        seen.add((row0, col0))
    want = {(r, c) for r in range(0, m_pad, tr) for c in range(0, n, tc)}
    assert len(order) == len(want) and seen == want
    bands = -(-n // tc)
    first = order[:tgg.GROUP * bands]
    g_rows = min(tgg.GROUP, m_pad // tr)
    assert {o[0] for o in first} == {i * tr for i in range(g_rows)}
    assert [o[2] for o in first[:g_rows]] == [0] * g_rows


def test_matmul_i8_kernel_choice_rule():
    """``quant.matmul_i8_kernel_for``, the measured crossover: the split-K
    tile loop at decode width (m <= 32: no library call takes m <= 16,
    and it reaches ~58% of its bytes bound) and wherever the wgmma
    kernel's 256 x 128 tiles number fewer than WG_MIN_TILES (down at m <=
    256), the persistent wgmma kernel elsewhere; a pure function of (m,
    n, k), monotone in m (no knob)."""
    f = tq.matmul_i8_kernel_for
    assert tq.SPLIT_K_MAX_M == 32 and tq.WG_MIN_TILES == 64
    for n, k in ((14336, 4096), (4096, 14336), (4096, 1024),
                 (4096, 3584), (3584, 4096), (16, 32)):
        kinds = [f(m, n, k) for m in range(1, 8193)] + ["wg"]
        assert "split_k" not in kinds[kinds.index("wg"):]
        assert all(f(m, n, k) == "split_k" for m in (1, 8, 16, 32))
    assert [f(m, 14336, 4096) for m in (33, 64, 512, 2048)] == ["wg"] * 4
    assert [f(m, 4096, 14336) for m in (64, 256, 257, 512)] == [
        "split_k", "split_k", "wg", "wg"]
    assert f(2048, 4096, 1024) == f(2048, 4096, 3584) == "wg"   # TP-4 rows


def test_gemm_operand_ok_rule():
    """``quant.gemm_operand_ok`` (TMA's rule for the GEMMs on
    ``csrc/sm90_gemm.cuh``; their entries take no strides): dense
    row-major bf16 and int8 operands at the model paths' widths pass, a
    view one row long too; a misaligned base, a padded or transposed row
    stride, 8-byte rows, another dtype fail."""
    ok = tq.gemm_operand_ok
    bf, i8 = torch.bfloat16, torch.int8
    for shape, dt in (((5120, 4096), bf), ((8, 4096, 14336), bf),
                      ((8, 14336, 4096), bf), ((17408, 14336), bf),
                      ((512, 4096), i8), ((4096, 14336), i8),
                      ((14336, 4096), i8), ((1, 32), i8), ((8, 1024), i8),
                      ((8, 4096, 14336), i8), ((0, 4096), i8)):
        x = torch.empty(shape, dtype=torch.float32 if dt == bf else dt)
        assert ok(shape, x.stride(), dt), (shape, dt)
    w = torch.empty(4, 4096, 3584, dtype=i8)
    assert ok((4096, 3584), w[1].stride(), i8, w[1].storage_offset())
    assert ok((1, 4096), (7, 1), bf)                 # one row: never stepped
    assert not ok((512, 4096), (4096, 1), bf, offset=1)
    assert not ok((512, 4096), (4104, 1), bf)        # padded rows
    assert not ok((512, 4096), (1, 512), bf)         # transposed view
    assert not ok((4, 512, 64), (65536, 64, 1), bf)  # strided slab
    assert not ok((512, 8), (8, 1), i8)              # 8-byte rows
    assert not ok((512, 64), (64, 1), torch.float32)
    assert not ok((), (), bf)


def _gemm_path(path):
    """Run one model path that reaches matmul_i8 or the grouped GEMM on the
    CPU at a tiny config: the MoE forward and SGD step at world 1 and 4
    (EP), the W8A8 MoE layer, W8A8 serving's hooks (decode and prefill
    rows) and the W8A8 TP-4 forward."""
    from dataclasses import replace

    from triton_dist_tpu_torch.layers.moe_inference import (
        DistributedMoELayer,
    )
    from triton_dist_tpu_torch.models import llama as tllama
    from triton_dist_tpu_torch.models import llama_w8a8 as tw8
    from triton_dist_tpu_torch.models import moe as tmoe

    rng = np.random.default_rng(11)
    if path in ("moe", "moe_ep4"):
        cfg = replace(tmoe.MoEConfig.tiny(), n_layers=1)
        world = 4 if path == "moe_ep4" else 1
        params = tmoe.init_params(cfg, seed=2, device="cpu")
        if world > 1:
            params = tmoe.shard_params(params, cfg, world)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(16, 2)))
        with torch.no_grad():
            tmoe.make_forward(cfg, world)(params, tok)
        tmoe.make_train_step(cfg, world, lr=0.1)(params, tok,
                                                 torch.roll(tok, -1, 0))
    elif path == "w8a8_moe":
        layer = DistributedMoELayer(n_experts=8, topk=2, hidden=128,
                                    intermediate=128, block_m=8,
                                    dtype=torch.float32, device="cpu")
        layer.weights = layer.init_weights(3)
        layer.quantize_weights()
        layer.forward(torch.from_numpy(rng.standard_normal(
            (32, 128)).astype(np.float32)))
    elif path == "w8a8_serving":
        cfg = tllama.LlamaConfig.tiny()
        q = tw8.quantize_serve_params(tllama.init_params(cfg, device="cpu"),
                                      cfg)
        for rows in (2, 32):
            h = torch.from_numpy(rng.standard_normal(
                (rows, cfg.dim)).astype(np.float32))
            tw8.w8a8_serve_ffn(h, q["layers"][0])
            o = torch.from_numpy(rng.standard_normal(
                (rows, q["layers"][0]["wo_q"].shape[0])).astype(np.float32))
            tw8.w8a8_serve_out_proj(o, q["layers"][0])
    else:
        cfg = tllama.LlamaConfig.tiny()
        tq_ = tw8.place_w8a8_params(tw8.quantize_params_w8a8(
            tllama.init_params(cfg, device="cpu"), cfg, 4), cfg, 4)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab, size=(64, 2)))
        tw8.make_w8a8_forward(cfg, 4)(tq_, tok)


@pytest.mark.parametrize("path", ["moe", "moe_ep4", "w8a8_moe",
                                  "w8a8_serving", "w8a8_tp4"])
def test_model_paths_hand_gemm_tma_operands(path, monkeypatch):
    """Hooks on the plain versions the CPU wrappers run (``group_gemm_ref``
    for the forward, dx and int8 modes; ``matmul_i8_ref``) record the
    (shape, strides, offset) of every operand a model path hands the
    grouped GEMM and matmul_i8; each must meet ``quant.gemm_operand_ok``
    (TMA's rule for the kernels on ``csrc/sm90_gemm.cuh``, read at bf16 or
    int8), so no model path raises on the card."""
    seen, real_gg, real_i8 = [], tgg.group_gemm_ref, tq.matmul_i8_ref

    def note(name, *ts):
        for x in ts:
            dt = torch.int8 if x.dtype == torch.int8 else torch.bfloat16
            seen.append((name, tuple(x.shape), tuple(x.stride()),
                         x.storage_offset(), dt))

    def gg_spy(x, w, tile_expert, **kw):
        note("group_gemm" + ("_dx" if kw.get("trans_w") else ""), x, w)
        return real_gg(x, w, tile_expert, **kw)

    def i8_spy(a, b):
        note("matmul_i8", a, b)
        return real_i8(a, b)

    monkeypatch.setattr(tgg, "group_gemm_ref", gg_spy)
    monkeypatch.setattr(tq, "matmul_i8_ref", i8_spy)
    _gemm_path(path)
    names = {s[0] for s in seen}
    want = {"moe": {"group_gemm", "group_gemm_dx"},
            "moe_ep4": {"group_gemm", "group_gemm_dx"},
            "w8a8_moe": {"group_gemm"},
            "w8a8_serving": {"matmul_i8"}, "w8a8_tp4": {"matmul_i8"}}[path]
    assert names == want, names
    if path.startswith("w8a8"):
        assert all(s[4] == torch.int8 for s in seen)
    bad = [s for s in seen if not tq.gemm_operand_ok(s[1], s[2], s[4],
                                                     s[3])]
    assert not bad, f"{path}: operands the kernel would refuse: {bad[:3]}"
