"""The port's Hopper kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device: the ``cuda`` fixture skips inside the
test when there is none (never at import, so every pytest-xdist worker
collects the same tests).  The module imports no JAX, so it also runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Inputs are bf16 (the kernels' type); int8 K/V are ``quantize_kv`` of
N(0, 1) data, fed to the kernel and its plain version alike.  Tolerances:
the kernels round P to bf16 before the PV product (as the TPU kernels do)
while the plain versions keep it in f32, and flash_fwd writes bf16 output
— so outputs agree to ~1e-2 absolute at unit-scale inputs; the
log-sum-exp is f32 on both sides and agrees to 1e-3.  The int8 GEMMs
(dense, grouped, and the AG-GEMM's int8 mode) are exact and are held to
equality with their float64 plain versions; the bf16 grouped GEMM to 2e-2 of the plain
output's largest magnitude and 1e-2 relative L2 over each row tile.  The
dense GEMM and the two tensor-parallel ring kernels (over a virtual world
of W ranks on the one card) follow the same bf16 rule over the whole
output (f32 output: 1e-4 of the largest magnitude), the gathered A bit
for bit.  The all-to-all moves bytes and is held to its plain version bit
for bit on every row it defines (below each split, the own segment).
The collectives over a mesh of the virtual world (barrier, every mode of
the all-gather and the reduce-scatter) are held to their plain versions
bit for bit (the reduce-scatter sums in the same ring order), and the
hierarchical PP step to the psum step at the bf16 gates (losses 1e-3
relative, leaves 2e-2 relative L2).  The MoE overlap kernels
(AG-GroupGEMM, GroupGEMM-RS) follow the grouped GEMM's row-tile rule on
each rank's output (padding tiles exactly zero), the gathered sorted x
bit for bit.  The torus kernels over a joint group (2-3 axes, reordered
and subset tuples): the all-gather and the reduce-scatter bit for bit
(the reduce-scatter in the same torus order), the torus GEMMs by the bf16
rule over the whole output and each 128-row tile (bit for bit on
integer-valued GEMM-RS operands), int8 exactly.
"""

import zlib

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels import flash_attention as fa
from triton_dist_tpu_torch.kernels import flash_decode as fd

OUT_TOL = 2e-2
LSE_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the "
                    "card only)")
    return torch.device("cuda")


def _randn(gen, shape, dev):
    x = torch.from_numpy(gen.standard_normal(shape).astype(np.float32))
    return x.to(device=dev, dtype=torch.bfloat16)


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"max abs err {err} > {tol}"


FLASH_CASES = [
    # (B, Hq, Hkv, Sq, Sk, q_offset, causal, window, soft_cap)
    (1, 4, 4, 128, 128, 0, True, 0, 0.0),       # G = 1
    (2, 8, 2, 100, 100, 0, True, 0, 0.0),       # G = 4, ragged
    (1, 8, 2, 96, 300, 204, True, 0, 0.0),      # chunk at an offset
    (1, 8, 2, 130, 130, 0, False, 0, 0.0),      # non-causal
    (1, 8, 2, 200, 200, 0, True, 48, 0.0),      # sliding window
    (1, 8, 2, 64, 192, 128, True, 0, 30.0),     # soft-cap
    (1, 32, 8, 512, 2048, 1536, True, 0, 0.0),  # the main path's chunk
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_fwd_matches_plain(cuda, case):
    B, Hq, Hkv, Sq, Sk, off, causal, window, cap = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = _randn(g, (B, Hq, Sq, 128), cuda)
    k = _randn(g, (B, Hkv, Sk, 128), cuda)
    v = _randn(g, (B, Hkv, Sk, 128), cuda)
    kw = dict(causal=causal, q_offset=off, window=window, soft_cap=cap)
    n0 = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


@pytest.mark.gpu
def test_flash_fwd_strided_views(cuda):
    """The [S, B, H, D] model layout reaches the kernel as strided views."""
    g = np.random.default_rng(7)
    q = _randn(g, (160, 2, 8, 128), cuda)
    k = _randn(g, (160, 2, 2, 128), cuda)
    v = _randn(g, (160, 2, 2, 128), cuda)
    got = fa.flash_gqa_attention(q, k, v)
    want = fa.flash_gqa_attention(q, k, v, plain=True)
    _close(got, want, OUT_TOL)


@pytest.mark.gpu
def test_flash_fwd_refuses_f32(cuda):
    q = torch.zeros((1, 2, 64, 128), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


# The wgmma forward's grid: every group size it folds, ragged Sq / Sk
# around its 128-row q tiles and 128-key tiles (1, 63, 200, 513, 2048),
# q_offset > 0 (a chunk against a longer extent), the window, the
# soft-cap and the non-causal mode.
WG_SIZES = [(1, 1), (63, 63), (200, 200), (513, 513), (2048, 2048),
            (1, 2048), (63, 513), (200, 2048)]
WG_CASES = [(G, sq, sk, sk - sq, True, 0, 0.0)
            for G in (1, 2, 4, 8) for sq, sk in WG_SIZES] + [
    # (G, Sq, Sk, q_offset, causal, window, cap)
    (4, 200, 513, 700, True, 0, 0.0),     # every key in the past
    (2, 513, 513, 0, False, 0, 0.0),      # non-causal, ragged
    (8, 63, 200, 0, False, 0, 30.0),      # non-causal, soft-capped
    (1, 513, 2048, 1535, True, 300, 0.0),  # windowed chunk
    (4, 200, 200, 0, True, 64, 20.0),     # window and soft-cap
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", WG_CASES)
def test_flash_fwd_wg_grid_matches_plain(cuda, case):
    """The bf16 forward (``flash_fwd_wg_kernel``) against its plain
    version over the group sizes and ragged edges of its tiles: out 2e-2,
    lse 1e-3 (natural log), one launch each."""
    G, Sq, Sk, off, causal, window, cap = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = _randn(g, (1, 2 * G, Sq, 128), cuda)
    k = _randn(g, (1, 2, Sk, 128), cuda)
    v = _randn(g, (1, 2, Sk, 128), cuda)
    kw = dict(causal=causal, q_offset=off, window=window, soft_cap=cap)
    n0 = fa.flash_attention.launches
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


@pytest.mark.gpu
def test_flash_fwd_wg_masked_rows(cuda):
    """kv_offset leaves the first 100 rows with nothing visible: out
    exactly 0 and lse NEG_INF there, the plain version elsewhere."""
    g = np.random.default_rng(3)
    q = _randn(g, (2, 8, 200, 128), cuda)
    k = _randn(g, (2, 2, 300, 128), cuda)
    v = _randn(g, (2, 2, 300, 128), cuda)
    out, lse = fa.flash_attention(q, k, v, kv_offset=100, return_lse=True)
    torch.cuda.synchronize()
    assert torch.all(out[:, :, :100] == 0)
    assert torch.all(lse[:, :, :100] == fd.NEG_INF)
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, kv_offset=100)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["seq_first", "chunk", "sliced"])
def test_flash_fwd_wg_strided_operands(cuda, layout):
    """Views the model paths hand the kernel, read by TMA in place: the
    [S, B, H, D] layout, a [B, c, H, D] chunk's transpose, and k / v
    sliced out of a longer cache; a misaligned s-stride is refused."""
    g = np.random.default_rng(zlib.crc32(layout.encode()))
    if layout == "seq_first":
        q, k, v = (_randn(g, (300, 2, h, 128), cuda).permute(1, 2, 0, 3)
                   for h in (16, 4, 4))
    elif layout == "chunk":
        q = _randn(g, (2, 96, 32, 128), cuda).transpose(1, 2)
        k, v = (_randn(g, (2, 8, 96, 128), cuda) for _ in range(2))
    else:
        q = _randn(g, (1, 8, 77, 128), cuda)
        k, v = (_randn(g, (1, 2, 512, 128), cuda)[:, :, :200]
                for _ in range(2))
    assert all(fa.flash_operand_ok(x.shape, x.stride(), x.dtype,
                                   x.storage_offset()) for x in (q, k, v))
    out, lse = fa.flash_attention(q, k, v, q_offset=k.shape[2] - q.shape[2],
                                  return_lse=True)
    ref_out, ref_lse = fa.flash_attention_ref(
        q, k, v, q_offset=k.shape[2] - q.shape[2])
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    bad = _randn(g, (1, 2, 64, 132), cuda)[..., :128]   # s-stride 264 B
    assert not fa.flash_operand_ok(bad.shape, bad.stride(), bad.dtype)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q[:1, :8, :64], bad, bad)


@pytest.mark.gpu
def test_flash_fwd_wg_autograd_through_lse(cuda):
    """Training's path through the new forward: the backward kernels read
    its lse (natural log) at G 1 with a window and a soft-cap and at G 4
    at an offset; gradients against autograd through the plain version
    by the bf16 gradient rule."""
    for case in ((1, 300, 300, 0, 96, 15.0), (4, 200, 456, 256, 0, 0.0)):
        G, Sq, Sk, off, window, cap = case
        g = np.random.default_rng(zlib.crc32(repr(case).encode()))
        q = _randn(g, (1, 2 * G, Sq, 128), cuda).requires_grad_()
        k = _randn(g, (1, 2, Sk, 128), cuda).requires_grad_()
        v = _randn(g, (1, 2, Sk, 128), cuda).requires_grad_()
        w = _randn(g, (1, 2 * G, Sq, 128), cuda)
        kw = dict(q_offset=off, window=window, soft_cap=cap)
        n0 = (fa.flash_attention.launches, fa.flash_bwd_dq.launches)
        got = torch.autograd.grad(
            (fa.flash_attention(q, k, v, **kw).float() * w).sum(), (q, k, v))
        assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches) == (
            n0[0] + 1, n0[1] + 1)
        want = torch.autograd.grad(
            (fa.flash_attention_ref(q, k, v, **kw)[0].float() * w).sum(),
            (q, k, v))
        for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
            _rel_close(gt, wt, name)


DECODE_CASES = [
    # (B, T, Hq, Hkv, S, window, cap, q_lens)
    (2, 1, 8, 2, 300, 0, 0.0, None),
    (8, 1, 32, 8, 2048, 0, 0.0, None),          # the main path's shape
    (3, 4, 32, 8, 512, 0, 0.0, [4, 2, 0]),      # multi-token, a dead row
    (2, 1, 8, 2, 700, 100, 0.0, None),          # window
    (2, 3, 8, 2, 256, 40, 25.0, [3, 1]),        # window + cap + q_lens
    (1, 32, 16, 4, 600, 0, 0.0, None),          # 32-token chunk, 128 rows
    (4, 2, 8, 2, 60, 0, 0.0, [2, 1, 0, 2]),     # one tile: a single split
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_matches_plain(cuda, case):
    B, T, Hq, Hkv, S, window, cap, q_lens = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    shape = (B, T, Hq, 128) if T > 1 else (B, Hq, 128)
    q = _randn(g, shape, cuda)
    k = _randn(g, (B, Hkv, S, 128), cuda)
    v = _randn(g, (B, Hkv, S, 128), cuda)
    lens = torch.from_numpy(g.integers(T, S + 1, size=B).astype(
        np.int32)).to(cuda)
    lens[0] = S
    ql = (None if q_lens is None
          else torch.tensor(q_lens, dtype=torch.int32, device=cuda))
    kw = dict(window=window, soft_cap=cap, q_lens=ql)
    n0 = fd.gqa_decode_shard.launches
    out, lse = fd.gqa_decode_shard(q, k, v, lens, **kw)
    torch.cuda.synchronize()
    assert fd.gqa_decode_shard.launches == n0 + 1
    ref_out, ref_lse = fd.decode_ref(q, k, v, lens, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    if q_lens is not None and 0 in q_lens:
        dead = q_lens.index(0)
        assert torch.all(out[dead] == 0)
        assert torch.all(lse[dead] <= -1e29)


def _shuffled_pool(g, B, Hkv, page, n_pages, lens, dev):
    """Pools holding each row's live pages at shuffled rows, block 0 the
    null block, table entries past each length pointing at it."""
    need = [-(-int(n) // page) for n in lens]
    n_blocks = 1 + sum(need)
    ids = 1 + g.permutation(n_blocks - 1)
    table = np.zeros((B, n_pages), np.int32)
    at = 0
    for b in range(B):
        table[b, :need[b]] = ids[at:at + need[b]]
        at += need[b]
    k_pool = _randn(g, (n_blocks, Hkv, page, 128), dev)
    v_pool = _randn(g, (n_blocks, Hkv, page, 128), dev)
    return k_pool, v_pool, torch.from_numpy(table).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [16, 48, 256])
@pytest.mark.parametrize("T", [1, 4])
def test_decode_paged_matches_plain(cuda, page, T):
    B, Hq, Hkv, n_pages = 8, 32, 8, 2048 // page + 1
    g = np.random.default_rng(page * 10 + T)
    lens = g.integers(T, n_pages * page - page, size=B).astype(np.int32)
    k_pool, v_pool, table = _shuffled_pool(g, B, Hkv, page, n_pages, lens,
                                           cuda)
    shape = (B, T, Hq, 128) if T > 1 else (B, Hq, 128)
    q = _randn(g, shape, cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    ql = (torch.tensor([T, 1] + [T] * (B - 2), dtype=torch.int32,
                       device=cuda) if T > 1 else None)
    n0 = fd.gqa_decode_paged_shard.launches
    out, lse = fd.gqa_decode_paged_shard(q, k_pool, v_pool, table, lens_t,
                                         q_lens=ql)
    torch.cuda.synchronize()
    assert fd.gqa_decode_paged_shard.launches == n0 + 1
    ref_out, ref_lse = fd.decode_paged_ref(q, k_pool, v_pool, table, lens_t,
                                           q_lens=ql)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


@pytest.mark.gpu
def test_decode_paged_refuses_page_size(cuda):
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros((4, 2, 24, 128), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    lens = torch.tensor([50], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fd.gqa_decode_paged_shard(q, pool, pool, table, lens)


BWD_CASES = [
    # (B, Hq, Hkv, Sq, Sk, q_offset, causal, window, soft_cap)
    (1, 4, 4, 128, 128, 0, True, 0, 0.0),        # G = 1
    (1, 8, 2, 256, 256, 0, False, 0, 0.0),       # non-causal, G = 4
    (2, 16, 2, 1000, 1000, 0, True, 0, 0.0),     # G = 8, ragged S
    (1, 8, 2, 300, 300, 0, True, 64, 0.0),       # sliding window
    (1, 8, 2, 192, 192, 0, True, 0, 30.0),       # soft-cap
    (1, 8, 2, 96, 300, 204, True, 0, 0.0),       # q offset, Sq != Sk
    (1, 32, 8, 2048, 2048, 0, True, 0, 0.0),     # the training shape
    # the edges of the 128-row / 128-key tiles
    (1, 8, 2, 64, 64, 0, True, 0, 0.0),          # one half tile
    (1, 8, 2, 129, 129, 0, True, 0, 0.0),        # one row past a tile
    (2, 4, 4, 200, 200, 0, True, 0, 0.0),        # G = 1 at 128-row tiles
    (1, 16, 2, 1000, 1000, 0, False, 0, 0.0),    # G = 8, non-causal
    (1, 8, 2, 1000, 1000, 0, True, 48, 0.0),     # window shorter than a tile
    (1, 8, 1, 200, 200, 0, True, 0, 25.0),       # soft-cap, G = 8
    (1, 4, 2, 129, 1000, 871, True, 0, 0.0),     # q offset, Sq != Sk
]


def _rel_close(got, want, name, *, seq_first=False, tile=64):
    """The kernels round P and dS to bf16 before their products (as the
    TPU kernels do) and write bf16 gradients; the plain version keeps f32
    throughout.  Held to: max |kernel - plain| <= 2e-2 max |plain|;
    ||kernel - plain|| <= 1e-2 ||plain|| over the tensor; and the same
    ratio <= 2e-2 over each (batch, head, 64-row block) of the [B, H, S, D]
    layout ([S, B, H, D] when ``seq_first``), so a fault confined to some
    rows shows."""
    assert torch.isfinite(got).all(), f"{name}: not finite"
    err, want = got.float() - want.float(), want.float()
    scale = want.abs().max().item()
    amax = err.abs().max().item()
    assert amax <= 2e-2 * scale, f"{name}: max abs err {amax} > 2e-2 * {scale}"
    tiny = torch.finfo(torch.float32).tiny
    l2 = (err.norm() / want.norm().clamp_min(tiny)).item()
    assert l2 <= 1e-2, f"{name}: relative L2 {l2} > 1e-2"
    x, w = (t.movedim(0, 2) if seq_first else t for t in (err, want))
    B, H, S, D = w.shape
    pad = -S % tile
    n = [torch.nn.functional.pad(t, (0, 0, 0, pad)).reshape(
        B, H, (S + pad) // tile, tile * D).norm(dim=-1) for t in (x, w)]
    worst = (n[0] / n[1].clamp_min(tiny)).max().item()
    assert worst <= 2e-2, f"{name}: worst 64-row block relative L2 {worst}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_matches_plain(cuda, case):
    B, Hq, Hkv, Sq, Sk, off, causal, window, cap = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = _randn(g, (B, Hq, Sq, 128), cuda)
    k = _randn(g, (B, Hkv, Sk, 128), cuda)
    v = _randn(g, (B, Hkv, Sk, 128), cuda)
    do = _randn(g, (B, Hq, Sq, 128), cuda)
    kw = dict(causal=causal, q_offset=off, window=window, soft_cap=cap)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    n0 = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for gt, wt, name, x in zip(got, want, ("dq", "dk", "dv"), (q, k, v)):
        assert gt.shape == x.shape and gt.dtype == torch.bfloat16
        _rel_close(gt, wt, name)
    f32 = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                 grad_dtype=torch.float32, **kw)
    for gt, wt, name in zip(f32, want, ("dq", "dk", "dv")):
        assert gt.dtype == torch.float32
        _rel_close(gt, wt, name)


@pytest.mark.gpu
def test_flash_bwd_autograd_strided_views(cuda):
    """Training's path: [S, B, H, D] views under autograd, a
    non-contiguous cotangent, gradients shaped like the inputs."""
    g = np.random.default_rng(11)
    q = _randn(g, (300, 2, 16, 128), cuda).requires_grad_()
    k = _randn(g, (300, 2, 2, 128), cuda).requires_grad_()
    v = _randn(g, (300, 2, 2, 128), cuda).requires_grad_()
    w = _randn(g, (2, 300, 16, 128), cuda).transpose(0, 1)
    n0 = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    got = torch.autograd.grad(
        (fa.flash_gqa_attention(q, k, v).float() * w).sum(), (q, k, v))
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    want = torch.autograd.grad(
        (fa.flash_gqa_attention(q, k, v, plain=True).float() * w).sum(),
        (q, k, v))
    for gt, wt, name, x in zip(got, want, "qkv", (q, k, v)):
        assert gt.shape == x.shape
        _rel_close(gt, wt, "d" + name, seq_first=True)


@pytest.mark.gpu
def test_flash_bwd_masked_rows_zero(cuda):
    """kv_offset puts every key in the future of every query: lse is
    NEG_INF on every row and every gradient is exactly zero, never NaN."""
    g = np.random.default_rng(5)
    q = _randn(g, (1, 8, 128, 128), cuda)
    k = _randn(g, (1, 2, 128, 128), cuda)
    v = _randn(g, (1, 2, 128, 128), cuda)
    do = _randn(g, (1, 8, 128, 128), cuda)
    out, lse = fa.flash_attention(q, k, v, kv_offset=4096, return_lse=True)
    for gr in fa.flash_attention_bwd(q, k, v, out, lse, do, kv_offset=4096):
        assert torch.all(gr == 0)


@pytest.mark.gpu
def test_flash_bwd_refuses_f32_and_head_dim(cuda):
    q = torch.zeros((1, 2, 64, 128), device=cuda)
    lse = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
    h = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd(h, h, h, h, lse, h)


# ---------------------------------------------------------------------------
# int8 K/V attention and the int8 GEMM (quantized serving)
# ---------------------------------------------------------------------------


def _quantized(g, shape, dev):
    """int8 rows and f32 per-position scales of N(0, 1) data."""
    x = torch.from_numpy(g.standard_normal(shape).astype(np.float32))
    return fd.quantize_kv(x.to(dev))


DECODE_I8_CASES = [
    # (B, T, Hq, Hkv, S, window, cap, q_lens)
    (8, 1, 32, 8, 2048, 0, 0.0, None),          # the main path's shape
    (3, 4, 32, 8, 700, 100, 20.0, [4, 2, 0]),   # window + cap, a dead row
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_I8_CASES)
def test_decode_i8_matches_plain(cuda, case):
    B, T, Hq, Hkv, S, window, cap, q_lens = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    shape = (B, T, Hq, 128) if T > 1 else (B, Hq, 128)
    q = _randn(g, shape, cuda)
    kq, ks = _quantized(g, (B, Hkv, S, 128), cuda)
    vq, vs = _quantized(g, (B, Hkv, S, 128), cuda)
    lens = torch.from_numpy(g.integers(T, S + 1, size=B).astype(
        np.int32)).to(cuda)
    lens[0] = S
    ql = (None if q_lens is None
          else torch.tensor(q_lens, dtype=torch.int32, device=cuda))
    kw = dict(window=window, soft_cap=cap, q_lens=ql, k_scale=ks,
              v_scale=vs)
    n0 = (fd.decode_i8.launches, fd.gqa_decode_shard.launches)
    out, lse = fd.gqa_decode_shard(q, kq, vq, lens, **kw)
    torch.cuda.synchronize()
    assert (fd.decode_i8.launches, fd.gqa_decode_shard.launches) == (
        n0[0] + 1, n0[1])
    ref_out, ref_lse = fd.decode_ref(q, kq, vq, lens, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    if q_lens is not None and 0 in q_lens:
        dead = q_lens.index(0)
        assert torch.all(out[dead] == 0)
        assert torch.all(lse[dead] <= -1e29)


@pytest.mark.gpu
@pytest.mark.parametrize("page,T,window", [(16, 1, 0), (64, 4, 90)])
def test_decode_paged_i8_matches_plain(cuda, page, T, window):
    """int8 pools and their scale pools read through one shuffled table;
    T 4 carries a dead row (q_lens 0) and a window."""
    B, Hq, Hkv, n_pages = 8, 32, 8, 2048 // page + 1
    g = np.random.default_rng(page * 10 + T)
    lens = g.integers(T, n_pages * page - page, size=B).astype(np.int32)
    k_pool, v_pool, table = _shuffled_pool(g, B, Hkv, page, n_pages, lens,
                                           cuda)
    kq, ks = fd.quantize_kv(k_pool.float())
    vq, vs = fd.quantize_kv(v_pool.float())
    shape = (B, T, Hq, 128) if T > 1 else (B, Hq, 128)
    q = _randn(g, shape, cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    ql = (torch.tensor([T, 0] + [T] * (B - 2), dtype=torch.int32,
                       device=cuda) if T > 1 else None)
    kw = dict(q_lens=ql, window=window, k_scale=ks, v_scale=vs)
    n0 = (fd.decode_paged_i8.launches, fd.gqa_decode_paged_shard.launches)
    out, lse = fd.gqa_decode_paged_shard(q, kq, vq, table, lens_t, **kw)
    torch.cuda.synchronize()
    assert (fd.decode_paged_i8.launches,
            fd.gqa_decode_paged_shard.launches) == (n0[0] + 1, n0[1])
    ref_out, ref_lse = fd.decode_paged_ref(q, kq, vq, table, lens_t, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    if ql is not None:
        assert torch.all(out[1] == 0) and torch.all(lse[1] <= -1e29)


FLASH_I8_CASES = [
    # (B, Hq, Hkv, Sq, Sk, q_offset, kv_offset, window, soft_cap)
    (1, 32, 8, 512, 2048, 1536, 0, 0, 0.0),     # the main path's chunk
    (2, 8, 2, 200, 330, 0, 100, 48, 25.0),      # dead rows, window, cap
    (1, 8, 8, 300, 700, 400, 0, 0, 0.0),        # G 1, ragged Sk
    (2, 16, 8, 256, 517, 261, 0, 0, 0.0),       # G 2, ragged Sk
    (1, 64, 8, 130, 1000, 870, 0, 128, 0.0),    # G 8, window
    (1, 32, 8, 64, 63, 0, 0, 0, 10.0),          # one ragged key tile
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_I8_CASES)
def test_flash_fwd_i8_matches_plain(cuda, case):
    B, Hq, Hkv, Sq, Sk, qo, ko, window, cap = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q = _randn(g, (B, Hq, Sq, 128), cuda)
    kq, ks = _quantized(g, (B, Hkv, Sk, 128), cuda)
    vq, vs = _quantized(g, (B, Hkv, Sk, 128), cuda)
    kw = dict(causal=True, q_offset=qo, kv_offset=ko, window=window,
              soft_cap=cap, k_scale=ks, v_scale=vs)
    n0 = (fa.flash_fwd_i8.launches, fa.flash_attention.launches)
    out, lse = fa.flash_attention(q, kq, vq, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_i8.launches, fa.flash_attention.launches) == (
        n0[0] + 1, n0[1])
    ref_out, ref_lse = fa.flash_attention_ref(q, kq, vq, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    if ko:
        assert torch.all(out[:, :, :ko] == 0)
        assert torch.all(lse[:, :, :ko] <= -1e29)


@pytest.mark.gpu
@pytest.mark.parametrize("step", [1, 2])
def test_flash_fwd_i8_segmented_matches_plain(cuda, step):
    """The int8 forward's segmented mode: the W ranks of one zigzag ring
    step folded into the batch (per-row start vectors), int8 K / V with
    their scales, against the plain version at the bf16 tolerances."""
    world, b, Hq, Hkv, S = 4, 1, 16, 4, 256
    g = np.random.default_rng(300 + step)
    q = _randn(g, (world * b, Hq, S, 128), cuda)
    kq, ks = _quantized(g, (world * b, Hkv, S, 128), cuda)
    vq, vs = _quantized(g, (world * b, Hkv, S, 128), cuda)
    kw = dict(causal=True, q_offset=_zig_rows(world, b, S, 0),
              kv_offset=_zig_rows(world, b, S, step), k_scale=ks,
              v_scale=vs)
    n0 = fa.flash_fwd_i8.launches
    out, lse = fa.flash_attention(q, kq, vq, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert fa.flash_fwd_i8.launches == n0 + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, kq, vq, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


@pytest.mark.gpu
def test_flash_fwd_i8_refuses_non_tma_q(cuda):
    """The int8 forward reads q by TMA: a q TMA cannot read (a row stride
    that is not a multiple of 16 bytes) raises a ValueError before any
    launch; int8 K / V views with strided rows are taken (one bulk copy a
    row)."""
    g = np.random.default_rng(31)
    kq, ks = _quantized(g, (1, 2, 200, 128), cuda)
    vq, vs = _quantized(g, (1, 2, 200, 128), cuda)
    wide = _randn(g, (1, 8, 64, 136), cuda)
    bad = wide[..., 4:132]
    n0 = fa.flash_fwd_i8.launches
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(bad, kq, vq, q_offset=136, k_scale=ks,
                           v_scale=vs)
    assert fa.flash_fwd_i8.launches == n0
    pair = torch.stack([kq, vq], dim=3)          # rows 256 bytes apart
    q = _randn(g, (1, 8, 64, 128), cuda)
    kw = dict(q_offset=136, k_scale=ks, v_scale=vs)
    out, lse = fa.flash_attention(q, pair[:, :, :, 0], pair[:, :, :, 1],
                                  return_lse=True, **kw)
    ref_out, ref_lse = fa.flash_attention_ref(q, kq, vq, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)


DECODE_ENTRIES = ["bf16", "int8", "paged", "paged_int8"]


def _decode_call(kind, g, dev, *, B=8, T=1, Hq=32, Hkv=8, S=2048, page=16,
                 lens=None, q_lens=None, window=0, cap=0.0, layout="dense"):
    """(kernel call, plain call) of one decode entry on fresh inputs:
    ``layout`` "pairs" makes K and V views of one [.., 2, ..] tensor
    (pages or rows not contiguous), "rows" interleaves K and V rows
    (row stride 2 D)."""
    paged, int8 = kind.startswith("paged"), kind.endswith("int8")
    lens = np.asarray(lens if lens is not None
                      else g.integers(T, S + 1, size=B), np.int32)
    n_pages = -(-S // page)
    if paged:
        rows = (B * n_pages + 1, Hkv, page)
        table = torch.from_numpy((1 + g.permutation(B * n_pages)).reshape(
            B, n_pages).astype(np.int32)).to(dev)
    else:
        rows = (B, Hkv, S)
    x = torch.from_numpy(g.standard_normal(
        (2,) + rows + (128,)).astype(np.float32)).to(dev)
    if int8:
        xq, xs = fd.quantize_kv(x)
    else:
        xq, xs = x.to(torch.bfloat16), None
    if layout == "pairs":    # [N, 2, Hkv, page, D] / [B, 2, Hkv, S, D]
        xq = xq.movedim(0, 1).contiguous().movedim(1, 0)
        xs = None if xs is None else xs.movedim(0, 1).contiguous().movedim(
            1, 0)
    elif layout == "rows":   # K and V rows interleaved: row stride 2 D
        xq = xq.movedim(0, -2).contiguous().movedim(-2, 0)
    k, v = xq[0], xq[1]
    assert layout == "dense" or not k.is_contiguous()
    kw = dict(q_lens=None if q_lens is None else torch.tensor(
        q_lens, dtype=torch.int32, device=dev), window=window, soft_cap=cap)
    if int8:
        kw.update(k_scale=xs[0], v_scale=xs[1])
    shape = (B, T, Hq, 128) if T > 1 else (B, Hq, 128)
    q = _randn(g, shape, dev)
    lens_t = torch.from_numpy(lens).to(dev)
    if paged:
        return (lambda: fd.gqa_decode_paged_shard(q, k, v, table, lens_t,
                                                  **kw),
                lambda: fd.decode_paged_ref(q, k, v, table, lens_t, **kw))
    return (lambda: fd.gqa_decode_shard(q, k, v, lens_t, **kw),
            lambda: fd.decode_ref(q, k, v, lens_t, **kw))


def _decode_agrees(kern, plain, q_lens=None):
    out, lse = kern()
    torch.cuda.synchronize()
    ref_out, ref_lse = plain()
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    if q_lens is not None and 0 in q_lens:
        dead = q_lens.index(0)
        assert torch.all(out[dead] == 0) and torch.all(lse[dead] <= -1e29)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", DECODE_ENTRIES)
@pytest.mark.parametrize("T", [1, 4])
def test_decode_short_lens_and_straddling_pages(cuda, kind, T):
    """Lengths shorter than a pair's split count in tiles (1, 63, 65, 64,
    129: most splits empty), an empty row, full rows; pools of page 48,
    whose 64-key tiles straddle pages; T 4 with a dead row."""
    g = np.random.default_rng(17 * T + len(kind))
    lens = [1, 63, 65, 2048, 700, 64, 129, 0] if T == 1 else \
        [4, 63, 65, 2048, 700, 64, 129, 5]
    ql = None if T == 1 else [4, 1, 0, 4, 2, 4, 3, 4]
    kern, plain = _decode_call(kind, g, cuda, T=T, lens=lens, q_lens=ql,
                               page=48)
    _decode_agrees(kern, plain, ql)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", DECODE_ENTRIES)
@pytest.mark.parametrize("layout", ["pairs", "rows"])
def test_decode_pool_views(cuda, kind, layout):
    """K and V (and int8 scales) as views of one tensor: pages or rows not
    contiguous (a page of one, its partner's between), and rows 2 D apart
    (one bulk copy a row in every case)."""
    g = np.random.default_rng(5 + len(kind) + len(layout))
    kern, plain = _decode_call(kind, g, cuda, B=4, S=600, layout=layout,
                               window=200 if layout == "rows" else 0)
    _decode_agrees(kern, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["int8", "paged_int8"])
def test_decode_i8_verify_chunk_128_rows(cuda, kind):
    """The int8 modes at T 32 (128 query rows: eight consumer warps, one
    row group each), a window and a soft cap."""
    g = np.random.default_rng(40 + len(kind))
    kern, plain = _decode_call(kind, g, cuda, B=2, T=32, Hq=16, Hkv=4,
                               S=640, window=300, cap=20.0,
                               q_lens=[32, 17])
    _decode_agrees(kern, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", DECODE_ENTRIES)
def test_decode_merge_at_the_ring_cap(cuda, kind):
    """One pair of 128 query rows (T 32, G 4) over 16,384 keys: the split
    count is capped by what the pair's merge keeps in the kernel's ring
    (``split_plan``: 134 bf16, 109 int8 splits, every one live), not by
    the grid, and the merged result holds to the plain version."""
    g = np.random.default_rng(90 + len(kind))
    S = 16384
    sms = _build.sm_count(cuda)
    assert fd.split_plan(1, S, sms, 128, kind.endswith("int8")) == (
        109 if kind.endswith("int8") else 134) < fd.BLOCKS_PER_SM * sms
    kern, plain = _decode_call(kind, g, cuda, B=1, T=32, Hq=4, Hkv=1, S=S,
                               lens=[S])
    _decode_agrees(kern, plain)


def _decode_kernels(fn):
    """Names and counts of the device kernels one ``fn()`` launches, from
    the profiler."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter({e.key: e.count for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})


@pytest.mark.gpu
@pytest.mark.parametrize("kind", DECODE_ENTRIES)
@pytest.mark.parametrize("T", [1, 4])
def test_decode_is_one_kernel_launch(cuda, kind, T):
    """Every decode entry is one kernel launch per call (its split-KV
    merge runs inside it), counted by the profiler at the main path's
    shape, where every pair has several splits.  Every device kernel is
    counted: at T 1 the call launches the decode kernel and nothing else;
    at T 4 it also packs its lens (``pack_lens_arg``: a stack on the
    device), whose kernels, counted alone, are taken off first."""
    g = np.random.default_rng(60 + T)
    kern, _ = _decode_call(kind, g, cuda, T=T,
                           q_lens=None if T == 1 else [4] * 8)
    seen = _decode_kernels(kern)
    if T > 1:
        lens = torch.ones(8, dtype=torch.int32, device=cuda)
        pack = _decode_kernels(lambda: fd.pack_lens_arg(
            lens, None, lens, n_tok=T, window=0))
        assert all(seen[k] >= n for k, n in pack.items()), (seen, pack)
        seen -= pack
    assert list(seen.values()) == [1], seen
    assert all("decode_kernel" in k for k in seen), seen


@pytest.mark.gpu
def test_decode_cuda_graph_replays_bit_equal(cuda):
    """Two decode calls (bf16 contiguous T 1, int8 paged T 4) captured in
    one CUDA graph and replayed three times, their outputs zeroed before
    each replay: bit-equal to eager calls every time, so the merge
    counters the last split resets are zero at every replay."""
    g = np.random.default_rng(71)
    a, _ = _decode_call("bf16", g, cuda)
    b, _ = _decode_call("paged_int8", g, cuda, T=4, q_lens=[4, 1, 0, 4, 2,
                                                            4, 3, 4])
    want = [a(), b()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a(), b()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = [a(), b()]
    for _ in range(3):
        for pair in got:
            for x in pair:
                x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for (go, gl), (wo, wl) in zip(got, want):
            assert torch.equal(go, wo) and torch.equal(gl, wl)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 16, 17, 37, 63, 64, 65, 250, 512,
                               2048])
def test_matmul_i8_exact(cuda, m):
    """Exact equality with the float64 plain product on both sides of the
    crossover (split-K with int32 atomics at decode widths, the persistent
    wgmma kernel from ``quant.WG_MIN_M`` rows), at k 32 / 1,024 / 14,336
    and n 16 / 4,096 / 14,336, each call counted under the kernel
    ``matmul_i8_kernel_for`` names."""
    from triton_dist_tpu_torch.kernels import quant

    g = torch.Generator(device=cuda).manual_seed(m)
    k, n = 4096, 14336
    a = torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    n0 = quant.matmul_i8.launches
    kind = quant.matmul_i8_kernel_for(m, n, k)
    modes0 = dict(quant.matmul_i8.mode_launches)
    got = quant.matmul_i8(a, b)
    torch.cuda.synchronize()
    assert quant.matmul_i8.launches == n0 + 1
    assert quant.matmul_i8.mode_launches == dict(modes0, **{
        kind: modes0[kind] + 1})
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, quant.matmul_i8_ref(a, b))
    # the down projection's shape: k 14336, n 4096, and a ragged n tail
    a2 = torch.randint(-127, 128, (m, 14336), generator=g, device=cuda,
                       dtype=torch.int8)
    b2 = torch.randint(-127, 128, (14336, 4096 + 48), generator=g,
                       device=cuda, dtype=torch.int8)
    assert torch.equal(quant.matmul_i8(a2, b2), quant.matmul_i8_ref(a2, b2))
    for kk in (32, 1024, 14336):
        for nn in (16, 4096, 14336):
            a3 = torch.randint(-127, 128, (m, kk), generator=g, device=cuda,
                               dtype=torch.int8)
            b3 = torch.randint(-127, 128, (kk, nn), generator=g,
                               device=cuda, dtype=torch.int8)
            assert torch.equal(quant.matmul_i8(a3, b3),
                               quant.matmul_i8_ref(a3, b3)), (m, kk, nn)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [16, 512])
def test_matmul_i8_ten_calls_in_a_row(cuda, m):
    """Ten calls back to back without a synchronisation (the persistent
    kernel's rings start afresh each launch; the split-K output is zeroed
    each call) all equal the plain product."""
    from triton_dist_tpu_torch.kernels import quant

    g = torch.Generator(device=cuda).manual_seed(100 + m)
    a = torch.randint(-127, 128, (m, 4096), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (4096, 3584), generator=g, device=cuda,
                      dtype=torch.int8)
    outs = [quant.matmul_i8(a, b) for _ in range(10)]
    want = quant.matmul_i8_ref(a, b)
    assert all(torch.equal(o, want) for o in outs)


@pytest.mark.gpu
def test_matmul_i8_refuses_shapes(cuda):
    from triton_dist_tpu_torch.kernels import quant

    a = torch.zeros((8, 48), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        quant.matmul_i8(a, torch.zeros((48, 128), dtype=torch.int8,
                                       device=cuda))
    a = torch.zeros((8, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        quant.matmul_i8(a, torch.zeros((64, 120), dtype=torch.int8,
                                       device=cuda))
    # operands that break TMA's rules, on both kernels (gemm_operand_ok)
    n0 = quant.matmul_i8.launches
    b = torch.zeros((1024, 4096), dtype=torch.int8, device=cuda)
    for m in (8, 512):
        a = torch.zeros((m, 1024 + 16), dtype=torch.int8, device=cuda)
        with pytest.raises(ValueError, match="TMA"):
            quant.matmul_i8(a[:, :1024], b)                # padded rows
        with pytest.raises(ValueError, match="TMA"):
            quant.matmul_i8(a.view(-1)[8:8 + m * 1024].view(m, 1024), b)
        with pytest.raises(ValueError, match="TMA"):       # B column-major
            quant.matmul_i8(a[:, :1024].contiguous(), b.t().contiguous().t())
    assert quant.matmul_i8.launches == n0


@pytest.mark.gpu
def test_quantized_generator_step(cuda):
    """Llama-3-8B widths at 2 layers, int8 cache: chunked prefill (flash
    int8), then one step (decode int8), against the same step taken by a
    chunk forward whose attention is the plain int8 version, from the
    same cache."""
    from dataclasses import replace

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import (
        Generator,
        _chunk_forward,
    )
    from triton_dist_tpu_torch.runtime.utils import (
        tree_map,
        use_full_precision_matmul,
    )

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0)
    gen = Generator(cfg, max_seq=512, kv_dtype=torch.int8)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 300))
    n0 = (fa.flash_fwd_i8.launches, fd.decode_i8.launches)
    with torch.no_grad():
        st = gen.prefill_chunked(params, prompt, chunk_size=256)
        assert fa.flash_fwd_i8.launches == n0[0] + 2 * cfg.n_layers
        before = tree_map(lambda t: t.clone(), st.caches)
        token = torch.argmax(st.last_logits, -1).to(torch.int32)
        st = gen.step(params, st, token)
        assert fd.decode_i8.launches == n0[1] + cfg.n_layers

        def plain(q, k, v, off, k_scale=None, v_scale=None):
            lens = torch.full((q.shape[0],), q.shape[1] + off,
                              dtype=torch.int32, device=q.device)
            out, _ = fd.decode_ref(q, k, v, lens, k_scale=k_scale,
                                   v_scale=v_scale)
            return out.float()

        _, want = _chunk_forward(params, token[:, None], before, 300,
                                 cfg=cfg, extent=512, attend=plain)
    got, want = st.last_logits.float(), want[:, 0].float()
    assert torch.isfinite(got).all()
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 1e-2, f"step logits relative L2 {rel}"


# ---------------------------------------------------------------------------
# The grouped GEMM (MoE)
# ---------------------------------------------------------------------------


def _gg_case(cuda, T, E, K, N, block_m, seed):
    """A sort_align plan of seeded top-2 routing of T tokens, x_sorted
    (padding rows zero), bf16 weights [E, K, N] and a dy whose padding
    rows are zero (as the backward's is)."""
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    g = np.random.default_rng(seed)
    _, experts = mu.topk_routing(torch.from_numpy(
        g.standard_normal((T, E)).astype(np.float32)).to(cuda), 2)
    plan = mu.sort_align(experts, E, block_m)
    x = _randn(g, (T, K), cuda)
    xs = mu.gather_sorted(x, plan["dest"], plan["m_pad"])
    w = (_randn(g, (E, K, N), cuda).float() / K ** 0.5).bfloat16()
    dy = _randn(g, (plan["m_pad"], N), cuda) * plan["valid_rows"][:, None]
    return plan, xs, w, dy.bfloat16()


def _tile_close(got, want, block_m, name):
    """max |err| <= 2e-2 max |plain|; relative L2 <= 1e-2 over the tensor
    and over each row tile (a tile steered to the wrong expert shows); a
    tile whose plain output is zero (padding) must be exactly zero."""
    err, want = got.float() - want.float(), want.float()
    assert err.abs().max() <= 2e-2 * want.abs().max(), name
    assert err.norm() <= 1e-2 * want.norm(), name
    for t in range(want.shape[0] // block_m):
        rows = slice(t * block_m, (t + 1) * block_m)
        wn = want[rows].norm()
        if wn == 0:
            assert torch.all(got[rows] == 0), f"{name}: padding tile {t}"
        else:
            assert err[rows].norm() <= 1e-2 * wn, f"{name}: tile {t}"


GG_CASES = [
    # (T, E, K, N, block_m)
    (100, 4, 256, 384, 128),          # mostly padding tiles
    (2048, 8, 4096, 14336, 512),      # Mixtral gate/up, the layer's block_m
    (200, 8, 256, 14336, 256),        # int8 on 256 x 128 tiles
    (64, 8, 4096, 384, 512),          # a ragged last 256-column band
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GG_CASES)
def test_group_gemm_modes_match_plain(cuda, case):
    """The three modes of csrc/group_gemm.cu against the plain version:
    bf16 forward, dx (dy @ w[e]^T on the [E, K, N] stack, no transposed
    copy) and exact int8; padding rows come out as zeros."""
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    T, E, K, N, bm = case
    plan, xs, w, dy = _gg_case(cuda, T, E, K, N, bm, zlib.crc32(
        repr(case).encode()))
    te, valid = plan["tile_expert"], plan["valid_rows"]
    n0 = (gg.group_gemm.launches, gg.group_gemm_dx.launches,
          gg.group_gemm_i8.launches)
    y = gg.group_gemm(xs, w, te, block_m=bm)
    dx = gg.group_gemm_dx(dy, w, te, block_m=bm)
    xq = torch.randint(-127, 128, xs.shape, device=cuda,
                       dtype=torch.int8) * valid[:, None].to(torch.int8)
    wq = torch.randint(-127, 128, w.shape, device=cuda, dtype=torch.int8)
    yq = gg.group_gemm_i8(xq, wq, te, block_m=bm)
    torch.cuda.synchronize()
    assert (gg.group_gemm.launches, gg.group_gemm_dx.launches,
            gg.group_gemm_i8.launches) == tuple(n + 1 for n in n0)
    assert y.dtype == dx.dtype == torch.bfloat16 and yq.dtype == torch.int32
    _tile_close(y, gg.group_gemm_ref(xs, w, te, block_m=bm), bm, "fwd")
    _tile_close(dx, gg.group_gemm_ref(dy, w.transpose(1, 2), te,
                                      block_m=bm), bm, "dx")
    assert torch.equal(yq, gg.group_gemm_ref(xq, wq, te, block_m=bm))
    for out in (y, dx, yq):
        assert torch.all(out[~valid] == 0)


def _gg_plan(cuda, T, E, K, block_m, routing, seed):
    """A sort_align plan of T tokens routed ``routing``: "top2" (seeded
    top-2 of E), "subset" (top-2 among the even experts: the odd ones get
    no row), "one" (every token to one expert); x_sorted bf16 (padding
    rows zero)."""
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    g = np.random.default_rng(seed)
    logits = torch.from_numpy(g.standard_normal((T, E)).astype(np.float32))
    if routing == "one":
        experts = torch.full((T, 1), E // 2, dtype=torch.int32)
    else:
        if routing == "subset":
            logits[:, 1::2] = -1e9
        experts = mu.topk_routing(logits, 2)[1]
    plan = mu.sort_align(experts.to(cuda), E, block_m)
    xs = mu.gather_sorted(_randn(g, (T, K), cuda),
                          plan["dest"], plan["m_pad"])
    return plan, xs, g


GG_WG_CASES = [
    # (T, E, K, N, block_m, routing)
    (300, 8, 32, 128, 128, "top2"),
    (300, 8, 96, 384, 256, "subset"),
    (40, 8, 32, 384, 512, "top2"),          # mostly padding tiles
    (64, 8, 4096, 384, 512, "one"),
    (200, 4, 96, 14336, 256, "one"),
    (500, 8, 4096, 14336, 128, "top2"),
    (1024, 8, 4096, 128, 128, "subset"),
    (700, 6, 1024, 14336, 512, "subset"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GG_WG_CASES)
def test_group_gemm_wg_modes_match_plain(cuda, case):
    """``group_gemm_wg_kernel`` in every mode against the plain version
    over block_m 128 / 256 / 512, N 128 / 384 / 14,336 (a ragged last
    256-column band), K 32 / 96 / 1,024 / 4,096 and plans with empty
    experts, one expert only and trailing padding tiles: the bf16 forward
    and, where the model's K tiles by 128, dx by the row-tile rule; int8
    (K % 32) exactly; each mode ten calls in a row (the persistent rings
    restart each launch), every call counted."""
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    T, E, K, N, bm, routing = case
    plan, xs, g = _gg_plan(cuda, T, E, K, bm, routing,
                           zlib.crc32(repr(case).encode()))
    te, valid = plan["tile_expert"], plan["valid_rows"]
    w = (_randn(g, (E, K, N), cuda).float() / K ** 0.5).bfloat16()
    n0 = (gg.group_gemm.launches, gg.group_gemm_dx.launches,
          gg.group_gemm_i8.launches)
    ys = [gg.group_gemm(xs, w, te, block_m=bm) for _ in range(10)]
    want = gg.group_gemm_ref(xs, w, te, block_m=bm)
    _tile_close(ys[0], want, bm, "fwd")
    assert all(torch.equal(y, ys[0]) for y in ys[1:])
    assert torch.all(ys[0][~valid] == 0)
    dx_calls = 0
    if K % 128 == 0:
        dy = (_randn(g, (xs.shape[0], N), cuda)
              * valid[:, None]).bfloat16()
        dxs = [gg.group_gemm_dx(dy, w, te, block_m=bm) for _ in range(10)]
        _tile_close(dxs[0], gg.group_gemm_ref(dy, w, te, block_m=bm,
                                              trans_w=True), bm, "dx")
        assert all(torch.equal(d, dxs[0]) for d in dxs[1:])
        dx_calls = 10
    xq = torch.from_numpy(g.integers(-127, 128, xs.shape, dtype=np.int8)
                          ).to(cuda) * valid[:, None].to(torch.int8)
    wq = torch.from_numpy(g.integers(-127, 128, (E, K, N), dtype=np.int8)
                          ).to(cuda)
    yqs = [gg.group_gemm_i8(xq, wq, te, block_m=bm) for _ in range(10)]
    wantq = gg.group_gemm_ref(xq, wq, te, block_m=bm)
    assert all(torch.equal(y, wantq) for y in yqs)
    torch.cuda.synchronize()
    assert (gg.group_gemm.launches, gg.group_gemm_dx.launches,
            gg.group_gemm_i8.launches) == (n0[0] + 10, n0[1] + dx_calls,
                                           n0[2] + 10)


@pytest.mark.gpu
@pytest.mark.parametrize("block_m", [64, 192])
def test_group_gemm_i8_64_row_tiles(cuda, block_m):
    """int8 takes block_m % 64: where block_m % 128 != 0 the kernel walks
    64-row tiles (each in one expert), exactly equal to the plain
    version."""
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    plan, xs, g = _gg_plan(cuda, 200, 8, 256, block_m, "top2", block_m)
    te, valid = plan["tile_expert"], plan["valid_rows"]
    xq = torch.from_numpy(g.integers(-127, 128, xs.shape, dtype=np.int8)
                          ).to(cuda) * valid[:, None].to(torch.int8)
    wq = torch.from_numpy(g.integers(-127, 128, (8, 256, 384),
                                     dtype=np.int8)).to(cuda)
    assert torch.equal(gg.group_gemm_i8(xq, wq, te, block_m=block_m),
                       gg.group_gemm_ref(xq, wq, te, block_m=block_m))


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [128, 256])
def test_group_gemm_autograd_matches_plain(cuda, bm):
    """GroupGemmFn's backward on the card — dx through the transposed
    mode, dW by cuBLAS with f32 accumulation — against autograd through a
    per-tile f32 product: dx by the row-tile rule, each expert's dW within
    1e-2 relative L2 (bf16 rounding of the kernel's side), an expert with
    no tile exactly zero."""
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    E = 6
    plan, xs, w, dy = _gg_case(cuda, 300, E, 512, 384, bm, 17)
    te = plan["tile_expert"]
    x1, w1 = xs.clone().requires_grad_(), w.clone().requires_grad_()
    n0 = gg.group_gemm_dx.launches
    gx, gw = torch.autograd.grad(gg.group_gemm(x1, w1, te, block_m=bm),
                                 (x1, w1), dy)
    assert gg.group_gemm_dx.launches == n0 + 1
    assert gx.dtype == gw.dtype == torch.bfloat16
    x2, w2 = xs.float().requires_grad_(), w.float().requires_grad_()
    y2 = torch.cat([x2[t * bm:(t + 1) * bm] @ w2[e]
                    for t, e in enumerate(te.tolist())])
    rx, rw = torch.autograd.grad(y2, (x2, w2), dy.float())
    _tile_close(gx, rx, bm, "dx")
    used = set(te.tolist())
    for e in range(E):
        if e in used:
            err = (gw[e].float() - rw[e]).norm() / rw[e].norm()
            assert err <= 1e-2, f"dW[{e}] relative L2 {err}"
        else:
            assert torch.all(gw[e] == 0)


@pytest.mark.gpu
def test_group_gemm_refuses_what_the_kernel_does_not_take(cuda):
    from triton_dist_tpu_torch.kernels import group_gemm as gg

    x = torch.zeros((128, 256), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((2, 256, 256), dtype=torch.bfloat16, device=cuda)
    te = torch.zeros((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="block_m"):
        gg.group_gemm(x, w, te, block_m=64)          # bf16 tiles are 128
    with pytest.raises(ValueError, match="block_m"):
        gg.group_gemm(x, w[:, :, :200], te[:1], block_m=128)    # N % 128
    with pytest.raises(TypeError):
        gg.group_gemm(x.float(), w.float(), te[:1], block_m=128)
    q = torch.zeros((128, 256), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="block_m"):
        gg.group_gemm_i8(q, w.to(torch.int8), torch.zeros(
            (4,), dtype=torch.int32, device=cuda), block_m=32)
    # operands that break TMA's rules (quant.gemm_operand_ok): no copy is
    # made and nothing launches
    n0 = (gg.group_gemm.launches, gg.group_gemm_dx.launches,
          gg.group_gemm_i8.launches)
    wide = torch.zeros((128, 512), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="TMA"):
        gg.group_gemm(wide[:, :256], w, te[:1], block_m=128)   # padded rows
    with pytest.raises(ValueError, match="TMA"):
        gg.group_gemm(wide.view(-1)[4:4 + 128 * 256].view(128, 256), w,
                      te[:1], block_m=128)                   # misaligned
    with pytest.raises(ValueError, match="TMA"):
        gg.group_gemm(x, w.transpose(1, 2), te[:1], block_m=128)
    with pytest.raises(ValueError, match="TMA"):
        gg.group_gemm_dx(x[:, :128].contiguous(), w[:, :, :128]
                         .contiguous().transpose(1, 2).contiguous()
                         .transpose(1, 2), te[:1], block_m=128)
    with pytest.raises(ValueError, match="TMA"):
        gg.group_gemm_i8(q, w.to(torch.int8).transpose(1, 2), te[:1],
                         block_m=128)
    assert (gg.group_gemm.launches, gg.group_gemm_dx.launches,
            gg.group_gemm_i8.launches) == n0


@pytest.mark.gpu
def test_moe_forward_and_train_step_at_mixtral_width(cuda):
    """Mixtral-8x7B widths at 2 layers, S 512: the forward with the
    kernels against the plain versions routed alike (relative L2 of the
    logits within 2e-2), then an SGD step whose loss is finite and whose
    backward ran the dx mode and the all-to-all's backward."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.models import moe
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul

    use_full_precision_matmul()
    cfg = replace(moe.MoEConfig.mixtral_8x7b(), n_layers=2)
    params = moe.init_params(cfg, seed=0)
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(512, 1)), device=cuda)
    n0 = (gg.group_gemm.launches, a2a.fast_all_to_all_shard.launches)
    routes = []
    with torch.no_grad():
        got, aux = moe.make_forward(cfg)(params, tok, routes=routes)
        want, aux_p = moe.make_forward(cfg, plain=True)(params, tok,
                                                        routes=routes)
    assert (gg.group_gemm.launches, a2a.fast_all_to_all_shard.launches) == (
        n0[0] + 3 * cfg.n_layers, n0[1] + 2 * cfg.n_layers)
    assert torch.isfinite(got).all() and got.shape == (512, 1, cfg.vocab)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2e-2, f"logits relative L2 {rel}"
    assert abs(float(aux) - float(aux_p)) <= 1e-2 * float(aux_p)
    del got, want
    n0 = (gg.group_gemm_dx.launches, a2a.fast_all_to_all_shard.launches)
    _, loss = moe.make_train_step(cfg, lr=0.1)(params, tok,
                                               torch.roll(tok, -1, 0))
    assert np.isfinite(float(loss))
    assert (gg.group_gemm_dx.launches, a2a.fast_all_to_all_shard.launches) \
        == (n0[0] + 3 * cfg.n_layers, n0[1] + 4 * cfg.n_layers)


# ---------------------------------------------------------------------------
# The all-to-all (MoE dispatch and combine)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((1, 4096, 4096), torch.bfloat16),
                                         ((1, 37, 3), torch.bfloat16),
                                         ((1, 5, 8), torch.int32)])
def test_all_to_all_matches_plain(cuda, shape, dtype):
    """csrc/all_to_all.cu at world 1 (send [1, 1, max_tokens, H]): recv
    equals send bit for bit (16-byte vectors and a byte tail), recv_splits
    equals splits, one launch; the same rows over two ranks go through
    the peer kernel; nine ranks (more than the kernel takes) raise."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    send = torch.randint(-1000, 1000, (1, *shape), device=cuda).to(dtype)
    splits = torch.tensor([[shape[1] - 2]], dtype=torch.int32, device=cuda)
    n0 = a2a.fast_all_to_all_shard.launches
    recv, recv_splits = a2a.fast_all_to_all_shard(send, splits)
    torch.cuda.synchronize()
    assert a2a.fast_all_to_all_shard.launches == n0 + 1
    assert recv.data_ptr() != send.data_ptr()
    assert torch.equal(recv, send) and torch.equal(recv_splits, splits)
    send2 = send.expand(2, 2, *shape[1:]).contiguous()
    splits2 = torch.full((2, 2), shape[1], dtype=torch.int32, device=cuda)
    recv2, rsplits2 = a2a.fast_all_to_all_shard(send2, splits2)
    torch.cuda.synchronize()
    assert torch.equal(recv2, send2) and torch.equal(rsplits2, splits2)
    with pytest.raises(ValueError, match="at most 8 ranks"):
        a2a.fast_all_to_all_shard(send.expand(9, 9, *shape[1:]),
                                  splits.expand(9, 9))


@pytest.mark.gpu
def test_all_to_all_autograd_on_the_card(cuda):
    """The backward shuffles the cotangent back through the kernel and
    zeroes the rows past the split."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    g = np.random.default_rng(3)
    send = _randn(g, (1, 1, 64, 256), cuda).requires_grad_()
    ct = _randn(g, (1, 1, 64, 256), cuda)
    splits = torch.tensor([[40]], dtype=torch.int32, device=cuda)
    n0 = a2a.fast_all_to_all_shard.launches
    recv, _ = a2a.fast_all_to_all_shard_diff(send, splits)
    (d_send,) = torch.autograd.grad(recv, (send,), ct)
    assert a2a.fast_all_to_all_shard.launches == n0 + 2
    assert torch.equal(d_send[0, 0, :40], ct[0, 0, :40])
    assert torch.all(d_send[0, 0, 40:] == 0)


def _a2a_peer_case(cuda, g, world, max_tokens, hidden, dtype=torch.bfloat16):
    """Random send [W, W, max_tokens, H] and splits [W, W] over 0 ..
    max_tokens + 3 (0 and above max_tokens forced into the first row)."""
    send = torch.from_numpy(g.standard_normal(
        (world, world, max_tokens, hidden)).astype(np.float32) * 100).to(
        device=cuda, dtype=dtype)
    splits = g.integers(0, max_tokens + 4, (world, world))
    splits[0, 0], splits[0, -1] = 0, max_tokens + 3
    return send, torch.as_tensor(splits, dtype=torch.int32, device=cuda)


def _a2a_agree(recv, recv_splits, want, want_splits):
    """Rows below each clamped split (the whole own segment) and the
    split counts bit for bit."""
    world, _, max_tokens = recv.shape[:3]
    assert torch.equal(recv_splits, want_splits)
    raw = recv.view(torch.uint8) if recv.element_size() == 1 else recv
    ref = want.view(torch.uint8) if want.element_size() == 1 else want
    for p in range(world):
        for r in range(world):
            k = max_tokens if p == r else min(int(want_splits[p, r]),
                                              max_tokens)
            assert torch.equal(raw[p, r, :k], ref[p, r, :k]), (p, r, k)


@pytest.mark.gpu
@pytest.mark.parametrize("world,max_tokens,hidden,dtype", [
    (2, 64, 256, torch.bfloat16), (4, 256, 512, torch.bfloat16),
    (8, 40, 128, torch.bfloat16), (4, 37, 3, torch.bfloat16),
    (4, 16, 64, torch.int32), (2, 33, 64, torch.float8_e4m3fn)])
def test_all_to_all_peers_match_plain(cuda, world, max_tokens, hidden,
                                      dtype):
    """The peer segments at W 2, 4 and 8 with random splits (0 and above
    max_tokens among them), a ragged row of 6 bytes, int32 and fp8
    payloads: every rank's rows below each split, its whole own segment
    and recv_splits equal to the plain version bit for bit; three calls
    back to back (a new epoch each), one launch each."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    g = np.random.default_rng(world * 100 + max_tokens)
    for _ in range(3):
        if dtype == torch.int32:
            send = torch.randint(-2 ** 30, 2 ** 30, (world, world,
                                 max_tokens, hidden), device=cuda,
                                 dtype=torch.int32)
            splits = _a2a_peer_case(cuda, g, world, max_tokens, 1)[1]
        else:
            send, splits = _a2a_peer_case(cuda, g, world, max_tokens,
                                          hidden, dtype)
        n0 = a2a.fast_all_to_all_shard.launches
        recv, recv_splits = a2a.fast_all_to_all_shard(send, splits)
        torch.cuda.synchronize()
        assert a2a.fast_all_to_all_shard.launches == n0 + 1
        want, want_splits = a2a.all_to_all_ref(send, splits)
        _a2a_agree(recv, recv_splits, want, want_splits)


@pytest.mark.gpu
def test_all_to_all_debug_poison_on_the_card(cuda):
    """debug_poison: the kernel's receive buffers equal the plain
    version's with poison bit for bit (NaN past every peer segment's
    split); dispatch with zero_undefined and combine, both poisoned, give
    a finite output equal to the unpoisoned one."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.layers import ep_a2a as ep

    g = np.random.default_rng(21)
    send, splits = _a2a_peer_case(cuda, g, 4, 96, 256)
    recv, recv_splits = a2a.fast_all_to_all_shard(send, splits,
                                                  debug_poison=True)
    torch.cuda.synchronize()
    want, want_splits = a2a.all_to_all_ref(send, splits, debug_poison=True)
    assert torch.equal(recv_splits, want_splits)
    assert torch.equal(recv.view(torch.int16), want.view(torch.int16))
    assert torch.isnan(recv.float()).any()

    T, H, E = 512, 256, 8
    x = _randn(g, (4, T // 4, H), cuda)
    experts = torch.as_tensor(g.integers(0, E, (4, T // 4, 2)),
                              dtype=torch.int32, device=cuda)
    w = torch.full((4, T // 4, 2), 0.5, device=cuda)
    outs = []
    for poison in (False, True):
        recv, _, _, plan, _ = ep.ep_dispatch_shard(
            x, experts, n_experts=E, zero_undefined=True,
            debug_poison=poison)
        assert torch.isfinite(recv.float()).all()
        outs.append(ep.ep_combine_shard(recv * 2, w, plan,
                                        debug_poison=poison))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[1].float()).all()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.gpu
def test_all_to_all_peers_autograd_on_the_card(cuda):
    """AllToAllFn over 4 ranks on the card against the same Function over
    the plain version: the forward's rows below each split and the
    cotangent (rows past the splits zero) bit for bit, two launches."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a

    g = np.random.default_rng(22)
    send, splits = _a2a_peer_case(cuda, g, 4, 128, 256)
    ct = _randn(g, tuple(send.shape), cuda)
    outs = []
    for plain in (False, True):
        s = send.clone().requires_grad_()
        n0 = a2a.fast_all_to_all_shard.launches
        recv, rs = a2a.fast_all_to_all_shard_diff(s, splits, plain=plain)
        keep = (torch.arange(128, device=cuda) < torch.clamp(
            rs, max=128)[..., None])[..., None]
        (d,) = torch.autograd.grad(recv, (s,), torch.where(keep, ct, 0))
        torch.cuda.synchronize()
        assert a2a.fast_all_to_all_shard.launches == n0 + (0 if plain else 2)
        outs.append((torch.where(keep, recv, 0), d))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.gpu
def test_moe_ep4_forward_and_train_step_at_mixtral_width(cuda):
    """Mixtral-8x7B widths at 2 layers, S 512, over 4 ranks of the virtual
    world (TP attention, expert-parallel FFN): the forward with the kernels
    against the plain versions routed alike (relative L2 of the logits
    within 2e-2), then an SGD step with a finite loss; per layer the
    forward runs 2 all-to-alls, 3 grouped GEMMs, an AG-GEMM (QKV) and a
    GEMM-RS (wo), the backward their duals."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import group_gemm as gg
    from triton_dist_tpu_torch.models import moe
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul

    use_full_precision_matmul()
    cfg = replace(moe.MoEConfig.mixtral_8x7b(), n_layers=2)
    params = moe.shard_params(moe.init_params(cfg, seed=0), cfg, 4)
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(512, 1)), device=cuda)

    def counts():
        return (a2a.fast_all_to_all_shard.launches, gg.group_gemm.launches,
                gg.group_gemm_dx.launches, agm.ag_gemm_shard.launches,
                grs.gemm_rs_shard.launches)

    n0 = counts()
    routes = []
    with torch.no_grad():
        got, aux = moe.make_forward(cfg, 4)(params, tok, routes=routes)
        want, aux_p = moe.make_forward(cfg, 4, plain=True)(params, tok,
                                                           routes=routes)
    L = cfg.n_layers
    assert tuple(x - y for x, y in zip(counts(), n0)) == (
        2 * L, 3 * L, 0, L, L)
    assert torch.isfinite(got).all() and got.shape == (512, 1, cfg.vocab)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2e-2, f"logits relative L2 {rel}"
    assert abs(float(aux) - float(aux_p)) <= 1e-2 * float(aux_p)
    del got, want
    n0 = counts()
    _, loss = moe.make_train_step(cfg, 4, lr=0.1)(params, tok,
                                                  torch.roll(tok, -1, 0))
    assert np.isfinite(float(loss))
    assert tuple(x - y for x, y in zip(counts(), n0)) == (
        4 * L, 3 * L, 3 * L, 2 * L, 2 * L)


# ---------------------------------------------------------------------------
# Tensor parallelism: the dense GEMM and the two ring kernels
# ---------------------------------------------------------------------------


def _gemm_close(got, want, name, tol=2e-2):
    """The bf16 GEMM rule: max |err| <= tol max |plain| and relative L2 <=
    tol / 2 (both sides sum in f32; they differ by the order of the sum and
    the output's one rounding)."""
    err, want = got.float() - want.float(), want.float()
    assert torch.isfinite(got).all(), name
    assert err.abs().max() <= tol * want.abs().max(), \
        f"{name}: max |err| {err.abs().max().item()}"
    assert err.norm() <= tol / 2 * want.norm(), \
        f"{name}: relative L2 {(err.norm() / want.norm()).item()}"


MATMUL_CASES = [
    # (M, K, N, the kernel): aligned, a ragged edge in every dimension (the
    # tile loop's element loads), a K tail inside one k-tile, a single row,
    # the row-7 shape
    (256, 512, 384, "wgmma"), (130, 200, 97, "tile"), (64, 40, 136, "wgmma"),
    (1, 64, 8, "wgmma"), (2048, 4096, 14336, "wgmma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MATMUL_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_matmul_matches_plain(cuda, case, out_dtype):
    """csrc/gemm.cu against its plain version: bf16 output to the bf16
    rule, f32 output to 1e-4 of the largest magnitude (only the order of
    the f32 sums differs); one launch per call, of the kernel
    ``matmul_kernel_for`` names (``mode_launches``)."""
    from triton_dist_tpu_torch.kernels import gemm

    M, K, N, kind = case
    g = np.random.default_rng(zlib.crc32(repr(case[:3]).encode()))
    a, b = _randn(g, (M, K), cuda), _randn(g, (K, N), cuda)
    n0, modes0 = gemm.matmul.launches, dict(gemm.matmul.mode_launches)
    got = gemm.matmul(a, b, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert gemm.matmul.launches == n0 + 1
    assert gemm.matmul.mode_launches == dict(modes0, **{
        kind: modes0[kind] + 1})
    assert got.dtype == out_dtype and got.shape == (M, N)
    want = gemm.matmul_ref(a, b, out_dtype=torch.float32)
    if out_dtype == torch.float32:
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err
    else:
        _gemm_close(got, want, f"matmul {case}")


@pytest.mark.gpu
def test_matmul_misaligned_base_takes_the_tile_loop(cuda):
    """An operand 2 bytes off a 16-byte boundary (a contiguous view at
    storage offset 1) is no TMA operand: the tile loop takes it, and
    agrees with the plain version by the bf16 rule."""
    from triton_dist_tpu_torch.kernels import gemm

    g = np.random.default_rng(77)
    M, K, N = 192, 256, 320
    a = torch.empty(M * K + 1, dtype=torch.bfloat16, device=cuda)[1:].view(
        M, K)
    a.copy_(_randn(g, (M, K), cuda))
    b = _randn(g, (K, N), cuda)
    assert a.is_contiguous() and a.data_ptr() % 16
    modes0 = dict(gemm.matmul.mode_launches)
    got = gemm.matmul(a, b)
    torch.cuda.synchronize()
    assert gemm.matmul.mode_launches == dict(modes0, tile=modes0["tile"] + 1)
    _gemm_close(got, gemm.matmul_ref(a, b, out_dtype=torch.float32),
                "matmul misaligned")


@pytest.mark.gpu
def test_matmul_refuses_what_the_kernel_does_not_take(cuda):
    from triton_dist_tpu_torch.kernels import gemm

    a = torch.zeros((16, 32), device=cuda)
    with pytest.raises(TypeError):
        gemm.matmul(a, a.t())                       # f32 operands
    with pytest.raises(TypeError):
        gemm.matmul(a.bfloat16(), a.t().bfloat16(), out_dtype=torch.int32)
    with pytest.raises(ValueError):
        gemm.matmul(a.bfloat16(), a.bfloat16())     # contraction mismatch


def _ring_case(cuda, g, world, m_loc, k, n, trans_b):
    """Rank-stacked operands: the AG-GEMM's a [W, m_loc, K] and b [W, K, n]
    (or [W, n, K]); the GEMM-RS's a [W, W m_loc, K] and b [W, K, n] (or
    [W, n, K])."""
    b_shape = (world, n, k) if trans_b else (world, k, n)
    b = (_randn(g, b_shape, cuda).float() / k ** 0.5).bfloat16()
    return (_randn(g, (world, m_loc, k), cuda),
            _randn(g, (world, world * m_loc, k), cuda), b)


RING_CASES = [
    # (world, m_loc, K, N): one tile, a ragged N edge and K tail, several
    # segment tiles per rank; row tails (m_loc no multiple of the 128-row
    # tile: 250 rows per rank of a 1,000-token prompt at TP 4, a segment
    # smaller than one tile, one row)
    (1, 128, 256, 384), (2, 128, 264, 200), (4, 256, 512, 256),
    (4, 128, 128, 1000), (4, 250, 512, 384), (2, 5, 264, 200),
    (4, 1, 128, 256),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("trans_b", [False, True])
def test_ring_kernels_match_plain(cuda, case, trans_b):
    """csrc/ag_gemm.cu and csrc/gemm_rs.cu over a virtual world of W ranks
    against their plain versions: the gathered A bit for bit, C and the
    reduced chunks by the bf16 GEMM rule; both B layouts; one launch
    each."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    g = np.random.default_rng(zlib.crc32(repr((case, trans_b)).encode()))
    a, a_rs, b = _ring_case(cuda, g, world, m_loc, k, n, trans_b)
    n0 = (agm.ag_gemm_shard.launches, grs.gemm_rs_shard.launches)
    a_full, c = agm.ag_gemm_shard(a, b, trans_b=trans_b)
    out = grs.gemm_rs_shard(a_rs, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert (agm.ag_gemm_shard.launches,
            grs.gemm_rs_shard.launches) == (n0[0] + 1, n0[1] + 1)
    want_full, want_c = agm.ag_gemm_ref(a, b, trans_b=trans_b)
    assert a_full.shape == (world, world * m_loc, k)
    assert torch.equal(a_full, want_full)
    _gemm_close(c, want_c, f"ag_gemm {case} trans_b={trans_b}")
    want = grs.gemm_rs_ref(a_rs, b, trans_b=trans_b)
    assert out.shape == (world, m_loc, n)
    _gemm_close(out, want, f"gemm_rs {case} trans_b={trans_b}")


@pytest.mark.gpu
def test_ring_kernels_rerandomized_back_to_back(cuda):
    """24 calls of each kernel back to back on fresh random inputs (the
    reference's test_ag_gemm_rerandomized_iterations): every result is
    checked, so a flag or a staging buffer left by an earlier call that
    let a wait pass early would show as a stale value."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    g = np.random.default_rng(5)
    results = []
    for i in range(24):
        a, a_rs, b = _ring_case(cuda, g, 4, 256, 512, 512, bool(i % 2))
        results.append((a, a_rs, b, bool(i % 2),
                        agm.ag_gemm_shard(a, b, trans_b=bool(i % 2)),
                        grs.gemm_rs_shard(a_rs, b, trans_b=bool(i % 2))))
    torch.cuda.synchronize()
    for i, (a, a_rs, b, tb, (a_full, c), out) in enumerate(results):
        want_full, want_c = agm.ag_gemm_ref(a, b, trans_b=tb)
        assert torch.equal(a_full, want_full), i
        _gemm_close(c, want_c, f"ag_gemm call {i}")
        _gemm_close(out, grs.gemm_rs_ref(a_rs, b, trans_b=tb),
                    f"gemm_rs call {i}")


@pytest.mark.gpu
def test_ring_kernels_refuse_what_they_do_not_take(cuda):
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    with pytest.raises(ValueError, match="positive"):
        agm.ag_gemm_shard(z(2, 0, 256), z(2, 256, 256))          # no rows
    with pytest.raises(ValueError, match="multiples of 32 and 16"):
        agm.ag_gemm_shard(z(2, 64, 48, dtype=torch.int8),
                    z(2, 48, 256, dtype=torch.int8))       # int8 K % 32
    with pytest.raises(ValueError, match="multiples of 32 and 16"):
        agm.ag_gemm_i8(z(2, 64, 64, dtype=torch.int8),
                       z(2, 64, 40, dtype=torch.int8))     # int8 N % 16
    with pytest.raises(ValueError, match="without trans_b"):
        agm.ag_gemm_shard(z(2, 64, 64, dtype=torch.int8),
                    z(2, 64, 64, dtype=torch.int8), trans_b=True)
    with pytest.raises(ValueError, match="multiples of 8"):
        agm.ag_gemm_shard(z(2, 128, 260), z(2, 260, 256))        # K % 8
    with pytest.raises(ValueError, match="multiples of 8"):
        grs.gemm_rs_shard(z(2, 256, 256), z(2, 256, 100))        # N % 8
    with pytest.raises(ValueError, match="chunks"):
        grs.gemm_rs_shard(z(4, 130, 256), z(4, 256, 256))        # rows % W
    with pytest.raises(TypeError):
        agm.ag_gemm_shard(z(2, 128, 256, dtype=torch.float32),
                    z(2, 256, 256, dtype=torch.float32))
    with pytest.raises(ValueError, match="at most 8"):
        agm.ag_gemm_shard(z(9, 128, 64), z(9, 64, 64))
    with pytest.raises(ValueError, match="contraction"):
        grs.gemm_rs_shard(z(2, 256, 256), z(2, 128, 256))
    graph = torch.cuda.CUDAGraph()
    a, b = z(2, 128, 256), z(2, 256, 256)
    agm.ag_gemm_shard(a, b)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            agm.ag_gemm_shard(a, b)


@pytest.mark.gpu
def test_tp_linears_autograd_match_plain(cuda):
    """The column- and row-parallel autograd Functions on the card (the
    forward and backward of each through the ring kernels) against the
    same Functions over the plain versions, at W 4: outputs and both
    gradients by the bf16 GEMM rule."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.layers import tp_linear as tl

    g = np.random.default_rng(9)
    W, m_loc, K, n = 4, 128, 512, 256
    a = _randn(g, (W, m_loc, K), cuda)
    b = (_randn(g, (W, K, n), cuda).float() / K ** 0.5).bfloat16()
    dc = _randn(g, (W, W * m_loc, n), cuda)
    a2 = _randn(g, (W, W * m_loc, n), cuda)
    b2 = (_randn(g, (W, n, K), cuda).float() / n ** 0.5).bfloat16()
    dc2 = _randn(g, (W, m_loc, K), cuda)
    for fn, x, w, ct in ((tl.column_parallel_linear, a, b, dc),
                         (tl.row_parallel_linear, a2, b2, dc2)):
        outs = []
        for plain in (False, True):
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            n0 = (agm.ag_gemm_shard.launches, grs.gemm_rs_shard.launches)
            y = fn(xg, wg, plain=plain)
            outs.append((y, *torch.autograd.grad(y, (xg, wg), ct)))
            moved = (agm.ag_gemm_shard.launches - n0[0],
                     grs.gemm_rs_shard.launches - n0[1])
            assert moved == ((0, 0) if plain else (1, 1)), moved
        for got, want, name in zip(outs[0], outs[1], ("out", "dx", "dw")):
            _gemm_close(got, want, f"{fn.__name__} {name}")


@pytest.mark.gpu
def test_tp4_llama_forward_and_train_step_at_8b_width(cuda):
    """Llama-3-8B widths at 2 layers, S 512, TP 4 on the virtual world:
    the forward with the kernels against the plain versions (relative L2
    of the logits within 2e-2), then an SGD step with a finite loss; the
    forward runs 3 AG-GEMMs and 2 GEMM-RS per layer, the backward their
    duals."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.shard_params(llama.init_params(cfg, seed=0), cfg, 4)
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(512, 1)), device=cuda)

    def counts():
        return agm.ag_gemm_shard.launches, grs.gemm_rs_shard.launches

    n0 = counts()
    with torch.no_grad():
        got = llama.make_forward(cfg, 4)(params, tok)
        want = llama.make_forward(cfg, 4, plain=True)(params, tok)
    assert tuple(x - y for x, y in zip(counts(), n0)) == (
        3 * cfg.n_layers, 2 * cfg.n_layers)
    assert torch.isfinite(got).all() and got.shape == (512, 1, cfg.vocab)
    rel = ((got - want).norm() / want.norm()).item()
    assert rel <= 2e-2, f"logits relative L2 {rel}"
    del got, want
    n0 = counts()
    _, loss = llama.make_train_step(cfg, 4, lr=0.1)(params, tok,
                                                    torch.roll(tok, -1, 0))
    assert np.isfinite(float(loss))
    assert tuple(x - y for x, y in zip(counts(), n0)) == (
        5 * cfg.n_layers, 5 * cfg.n_layers)


AG_MODES = {
    # name: (shard kwargs, the counter the call moves)
    "bidir": (dict(ring_mode="bidir"), "bidir"),
    "wire": (dict(wire_dtype="int8"), "wire"),
    "chunks2": (dict(chunks=2), "chunked"),
    "chunks4": (dict(chunks=4), "chunked"),
}
MODE_CASES = [
    # (world, m_loc, K, n): the TP-4 prefill rows cut in K and n, the
    # decode size (m_loc 16: a half of 8 rows, one masked 128-row tile),
    # several pieces per half, world 2 and 8, a ragged n edge; QKV's n
    # (1536) over halves of 200 rows (a ragged last row tile a half)
    (4, 512, 512, 256), (4, 16, 256, 256), (4, 384, 256, 384),
    (2, 32, 512, 200), (8, 16, 256, 128), (4, 400, 256, 1536),
]


def _mode_counts():
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    return {"uni": agm.ag_gemm_shard.launches,
            **agm.ag_gemm_shard.mode_launches,
            "rs_uni": grs.gemm_rs_shard.launches,
            **{f"rs_{k}": v for k, v in
               grs.gemm_rs_shard.mode_launches.items()}}


def _moved(n0):
    now = _mode_counts()
    return {k: now[k] - n0[k] for k in now if now[k] != n0[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", MODE_CASES)
@pytest.mark.parametrize("mode", sorted(AG_MODES))
def test_ag_gemm_modes_match_plain(cuda, case, mode):
    """The AG-GEMM's ring modes (``tdt_ag_gemm_bidir``, the int8 wire
    ``tdt_ag_gemm_wire``, the chunked forward of ``tdt_ag_gemm``) against
    the plain version: the gathered A bit for bit (the wire's rebuilt from
    the same payload), C by the bf16 GEMM rule; each call moves its
    schedule's counter only."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    world, m_loc, k, n = case
    kw, counter = AG_MODES[mode]
    g = np.random.default_rng(zlib.crc32(repr((case, mode)).encode()))
    a, _, b = _ring_case(cuda, g, world, m_loc, k, n, False)
    sched = agm.ag_gemm_schedule(m_loc, world, False, **kw)
    n0 = _mode_counts()
    a_full, c = agm.ag_gemm_shard(a, b, **kw)
    torch.cuda.synchronize()
    want = {"wire" if sched.wire else sched.mode: 1}
    if sched.chunks > 1:
        want["chunked"] = 1
    assert _moved(n0) == want, (sched, _moved(n0))
    want_full, want_c = agm.ag_gemm_ref(a, b, wire=sched.wire)
    assert torch.equal(a_full, want_full)
    _gemm_close(c, want_c, f"ag_gemm {mode} {case}")


@pytest.mark.gpu
def test_ag_gemm_modes_ten_calls_in_a_row(cuda):
    """Ten calls of each ring mode in a row on fresh inputs, every result
    checked afterwards: a flag or piece counter left by an earlier call
    that let a wait pass early would show as a stale value."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    g = np.random.default_rng(13)
    results = []
    for i in range(10):
        for mode in sorted(AG_MODES):
            kw = AG_MODES[mode][0]
            a, _, b = _ring_case(cuda, g, 4, 256 if i % 2 else 16, 256, 256,
                                 False)
            results.append((mode, kw, a, b, agm.ag_gemm_shard(a, b, **kw)))
    torch.cuda.synchronize()
    for mode, kw, a, b, (a_full, c) in results:
        want_full, want_c = agm.ag_gemm_ref(a, b, wire="wire_dtype" in kw)
        assert torch.equal(a_full, want_full), mode
        _gemm_close(c, want_c, f"ag_gemm {mode} in a row")


RS_MODE_CASES = [
    # (world, m_loc, k, N): bidir needs (N / 2) % 128 == 0; decode size,
    # ragged chunk rows, world 2 and 8
    (4, 512, 512, 256), (4, 16, 256, 512), (2, 37, 256, 512),
    (8, 16, 128, 256), (4, 250, 512, 768),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RS_MODE_CASES)
def test_gemm_rs_bidir_matches_plain(cuda, case):
    """``tdt_gemm_rs_bidir`` against the plain version of the bidir ring
    (the reference's hop order and bf16 adds) by the bf16 GEMM rule (the
    partials may round differently: another order over k); one launch of
    the bidir counter only."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    _, a, b = _ring_case(cuda, g, world, m_loc, k, n, False)
    n0 = _mode_counts()
    out = grs.gemm_rs_shard(a, b, ring_mode="bidir")
    torch.cuda.synchronize()
    assert _moved(n0) == {"rs_bidir": 1}
    assert out.shape == (world, m_loc, n)
    _gemm_close(out, grs.gemm_rs_ref(a, b, ring_mode="bidir"),
                f"gemm_rs bidir {case}")


@pytest.mark.gpu
def test_gemm_rs_bidir_ten_calls_in_a_row(cuda):
    """Ten bidir GEMM-RS calls in a row on fresh inputs, every result
    checked afterwards (stale landing slots or flags would show)."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    g = np.random.default_rng(17)
    results = []
    for i in range(10):
        _, a, b = _ring_case(cuda, g, 4, 128 if i % 2 else 16, 256, 512,
                             False)
        results.append((a, b, grs.gemm_rs_shard(a, b, ring_mode="bidir")))
    torch.cuda.synchronize()
    for i, (a, b, out) in enumerate(results):
        _gemm_close(out, grs.gemm_rs_ref(a, b, ring_mode="bidir"),
                    f"gemm_rs bidir call {i}")


# (world, m_loc, K, N) of the int8 GEMM-RS: m_loc 1 / 16 / 250 / 512,
# N 4,112 (a ragged column tile at 128 and 256), K % 128 != 0, worlds 2-8
I8_RS_CASES = [(4, 128, 512, 256), (4, 16, 1024, 1536), (2, 37, 256, 144),
               (1, 64, 128, 128), (4, 250, 512, 384), (2, 1, 96, 4112),
               (4, 16, 544, 4112), (8, 250, 160, 4112),
               (4, 512, 1056, 4112), (8, 512, 224, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", I8_RS_CASES)
def test_gemm_rs_i8_matches_plain(cuda, case):
    """The GEMM-RS's int8 mode (``tdt_gemm_rs_i8``, the uni kernel on the
    wgmma / TMA mainloop): int32 C exactly equal to the plain version
    (exact partials and sums), ten calls in a row at the first case; one
    launch of the int8 counter each."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr(case).encode()))
    calls = 10 if case == (4, 128, 512, 256) else 1
    results = []
    n0 = _mode_counts()
    for _ in range(calls):
        a = torch.randint(-127, 128, (world, world * m_loc, k), generator=g,
                          device=cuda, dtype=torch.int8)
        b = torch.randint(-127, 128, (world, k, n), generator=g,
                          device=cuda, dtype=torch.int8)
        results.append((a, b, grs.gemm_rs_shard(a, b)))
    torch.cuda.synchronize()
    assert _moved(n0) == {"rs_i8": calls}
    for a, b, out in results:
        assert out.dtype == torch.int32
        assert torch.equal(out, grs.gemm_rs_ref(a, b))


@pytest.mark.gpu
def test_ring_host_entries_on_the_card(cuda):
    """The host entries over a port Mesh on the card: ``ag_gemm`` /
    ``ag_gemm_gathered`` / ``gemm_rs`` with contexts (every mode) against
    the same contexts at ``impl="xla"`` (the plain versions), and the
    autotuned entries inside one ``contextual_autotune`` region against
    the plain versions."""
    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    mesh = Mesh((4,), ("tp",), cuda)
    g = np.random.default_rng(21)
    a = _randn(g, (256, 512), cuda)
    b = (_randn(g, (512, 1024), cuda).float() / 512 ** 0.5).bfloat16()
    for kw in (dict(), dict(ring_mode="bidir"), dict(chunks=2),
               dict(wire_dtype="int8")):
        full, c = agm.ag_gemm_gathered(
            a, b, agm.create_ag_gemm_context(mesh, **kw))
        want_full, want_c = agm.ag_gemm_gathered(
            a, b, agm.create_ag_gemm_context(mesh, impl="xla", **kw))
        assert torch.equal(full, want_full), kw
        _gemm_close(c, want_c, f"host ag_gemm_gathered {kw}")
        _gemm_close(agm.ag_gemm(a, b, agm.create_ag_gemm_context(mesh, **kw)),
                    want_c, f"host ag_gemm {kw}")
    a2 = _randn(g, (256, 1024), cuda)
    b2 = (_randn(g, (1024, 512), cuda).float() / 1024 ** 0.5).bfloat16()
    for kw in (dict(), dict(ring_mode="bidir")):
        c = grs.gemm_rs(a2, b2, grs.create_gemm_rs_context(mesh, **kw))
        _gemm_close(c, grs.gemm_rs(a2, b2, grs.create_gemm_rs_context(
            mesh, impl="xla", **kw)), f"host gemm_rs {kw}")

    @contextual_autotune(n_repeat=2, n_warmup=1)
    def op(x, w, x2, w2):
        return (agm.ag_gemm_autotuned(x, w, agm.create_ag_gemm_context(
            mesh)), grs.gemm_rs_autotuned(x2, w2, grs.create_gemm_rs_context(
                mesh)))

    c, c2 = op(a, b, a2, b2)
    _gemm_close(c, a.float() @ b.float(), "ag_gemm_autotuned")
    _gemm_close(c2, a2.float() @ b2.float(), "gemm_rs_autotuned")


@pytest.mark.gpu
def test_ring_modes_refuse_what_they_do_not_take(cuda):
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    with pytest.raises(ValueError, match="trans_b"):
        agm.ag_gemm_shard(z(4, 32, 256), z(4, 256, 256), trans_b=True,
                          ring_mode="bidir")
    with pytest.raises(ValueError, match="trans_b"):
        agm.ag_gemm_shard(z(4, 32, 256), z(4, 256, 256), trans_b=True,
                          wire_dtype="int8")
    with pytest.raises(ValueError, match="multiples of 16"):
        agm.ag_gemm_shard(z(4, 32, 264), z(4, 264, 256), wire_dtype="int8")
    with pytest.raises(ValueError, match="bidir"):
        agm.ag_gemm_shard(z(4, 32, 256), z(4, 256, 256), ring_mode="bidir",
                          chunks=2)
    with pytest.raises(ValueError, match="trans_b"):
        grs.gemm_rs_shard(z(4, 128, 256), z(4, 256, 256), trans_b=True,
                          ring_mode="bidir")
    # int8 operands take the int8 bidir ring (row 15bi) since it was
    # ported; an int8 a against a bf16 b it does not take
    with pytest.raises(ValueError, match="int8 b"):
        grs.gemm_rs_shard(z(4, 128, 256, dtype=torch.int8), z(4, 256, 256),
                          ring_mode="bidir")
    with pytest.raises(ValueError, match="multiples of 32 and 16"):
        grs.gemm_rs_shard(z(4, 128, 48, dtype=torch.int8),
                          z(4, 48, 256, dtype=torch.int8))


I8_RING_CASES = [
    # (world, m_loc, K, n): aligned 64-row tiles, the TP-4 QKV shape cut
    # in K, row tails (250 rows per rank of a 1,000-token prompt; fewer
    # rows than one tile), a ragged n edge, world 1
    (4, 128, 512, 256), (4, 512, 1024, 1536), (4, 250, 512, 384),
    (2, 37, 256, 144), (1, 64, 128, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", I8_RING_CASES)
def test_ag_gemm_i8_matches_plain(cuda, case):
    """The AG-GEMM's int8 mode (``tdt_ag_gemm_i8``) over a virtual world
    of W ranks against its plain version: the gathered int8 A bit for bit,
    the int32 C exactly equal (the accumulation is exact); one launch of
    the int8 mode, none of the bf16 one."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    world, m_loc, k, n = case
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr(case).encode()))
    a = torch.randint(-127, 128, (world, m_loc, k), generator=g,
                      device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (world, k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    n0 = (agm.ag_gemm_shard.launches, agm.ag_gemm_i8.launches)
    a_full, c = agm.ag_gemm_shard(a, b)
    torch.cuda.synchronize()
    assert (agm.ag_gemm_shard.launches, agm.ag_gemm_i8.launches) == (n0[0],
                                                               n0[1] + 1)
    want_full, want_c = agm.ag_gemm_ref(a, b)
    assert a_full.dtype == torch.int8 and c.dtype == torch.int32
    assert torch.equal(a_full, want_full)
    assert torch.equal(c, want_c)


# The uni kernels on sm90_gemm.cuh (128 x 256 tiles; bf16 B [K][n] or
# [n][K], int8 B [K][n]): (world, m_loc, K, n, chunks).  W 2, 4, 8; m_loc
# 512, 250 (row tails), 16 and 1; chunks 1, 2, 4 (W 8 at chunks 4: a tile
# waits on a chunk's flag, then TMA reads rows that peers stored: the
# proxy fence); K and n at their smallest legal multiples and at odd tile
# counts (3 column tiles of 256, the last ragged; bf16 a K tail of 8 past
# 3 k-tiles of 64, int8 one of 32 past 3 k-tiles of 128).
WG_BF16_CASES = [
    (2, 512, 1024, 1536, 1), (4, 512, 4096, 3584, 2), (8, 512, 256, 520, 4),
    (4, 250, 200, 760, 2), (8, 250, 512, 256, 1), (2, 16, 8, 8, 1),
    (8, 16, 200, 760, 2), (4, 1, 64, 264, 1), (8, 1, 8, 8, 1),
]
WG_I8_CASES = [
    (2, 512, 1024, 1536, 1), (4, 512, 4096, 3584, 2), (8, 512, 256, 272, 4),
    (4, 250, 416, 752, 2), (8, 250, 512, 256, 1), (2, 16, 32, 16, 1),
    (8, 16, 416, 752, 2), (4, 1, 128, 144, 1), (8, 1, 32, 16, 1),
]


def _seg_tiles_close(c, want, world, m_loc, name):
    """The bf16 GEMM rule over the whole C and each 128-row tile of each
    rank's segments (relative L2 <= 1e-2 a tile: a tile that read the
    wrong rows or a stale one shows)."""
    _gemm_close(c, want, name)
    err, w = c.float() - want.float(), want.float()
    for s in range(world):
        for r0 in range(0, m_loc, 128):
            rows = slice(s * m_loc + r0, s * m_loc + min(r0 + 128, m_loc))
            assert err[:, rows].norm() <= 1e-2 * w[:, rows].norm(), \
                f"{name}: segment {s} rows {r0}.."


@pytest.mark.gpu
@pytest.mark.parametrize("case", WG_BF16_CASES)
@pytest.mark.parametrize("trans_b", [False, True])
def test_ag_gemm_wg_bf16_matches_plain(cuda, case, trans_b):
    """``tdt_ag_gemm`` (the uni bf16 AG-GEMM on wgmma / TMA) over a virtual
    world of W ranks against ``ag_gemm_ref``: the gathered A bit for bit,
    C by the bf16 GEMM rule over the whole output and each 128-row tile of
    every segment; one uni launch a call."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    world, m_loc, k, n, chunks = case
    g = np.random.default_rng(zlib.crc32(repr((case, trans_b)).encode()))
    a, _, b = _ring_case(cuda, g, world, m_loc, k, n, trans_b)
    n0 = agm.ag_gemm_shard.launches
    a_full, c = agm.ag_gemm_shard(a, b, trans_b=trans_b, chunks=chunks)
    torch.cuda.synchronize()
    assert agm.ag_gemm_shard.launches == n0 + 1
    want_full, want_c = agm.ag_gemm_ref(a, b, trans_b=trans_b)
    assert torch.equal(a_full, want_full)
    _seg_tiles_close(c, want_c, world, m_loc,
                     f"ag_gemm {case}{' B^T' if trans_b else ''}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", WG_I8_CASES)
def test_ag_gemm_wg_i8_matches_plain(cuda, case):
    """``tdt_ag_gemm_i8`` (the int8 AG-GEMM on wgmma / TMA, B transposed
    in shared memory) against ``ag_gemm_ref``: the gathered int8 A bit for
    bit, the int32 C exactly equal; one int8 launch a call."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    world, m_loc, k, n, chunks = case
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr(("wg", case)).encode()))
    a = torch.randint(-127, 128, (world, m_loc, k), generator=g,
                      device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (world, k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    n0 = agm.ag_gemm_i8.launches
    a_full, c = agm.ag_gemm_shard(a, b, chunks=chunks)
    torch.cuda.synchronize()
    assert agm.ag_gemm_i8.launches == n0 + 1
    want_full, want_c = agm.ag_gemm_ref(a, b)
    assert torch.equal(a_full, want_full)
    assert torch.equal(c, want_c)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_ag_gemm_wg_w8_chunks4_twenty_calls(cuda, int8):
    """W 8, chunks 4, twenty calls in a row on fresh inputs, each checked:
    every tile of a peer's segment waits on its chunks' flags and then
    reads the rows the peers' stores wrote by TMA, so without the proxy
    fence between the two a tile reads stale rows (an earlier call's, in a
    buffer the allocator handed back) and its 128-row tile fails."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    world, m_loc, k, n = 8, 512, 1024, 512
    g = np.random.default_rng(8)
    for i in range(20):
        if int8:
            a = torch.from_numpy(g.integers(-127, 128, (world, m_loc, k),
                                            dtype=np.int8)).to(cuda)
            b = torch.from_numpy(g.integers(-127, 128, (world, k, n),
                                            dtype=np.int8)).to(cuda)
        else:
            a, _, b = _ring_case(cuda, g, world, m_loc, k, n, False)
        a_full, c = agm.ag_gemm_shard(a, b, chunks=4)
        torch.cuda.synchronize()
        want_full, want_c = agm.ag_gemm_ref(a, b)
        assert torch.equal(a_full, want_full), i
        if int8:
            assert torch.equal(c, want_c), i
        else:
            _seg_tiles_close(c, want_c, world, m_loc, f"call {i}")


@pytest.mark.gpu
def test_ag_gemm_wg_refuses_non_tma_operands(cuda):
    """The uni kernels read by TMA: an operand whose base is not 16-byte
    aligned raises (``ag_gemm_operand_ok``) before any launch."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    buf = torch.zeros(4 * 64 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    a = buf[1:].view(4, 64, 256)
    b = torch.zeros(4, 256, 256, dtype=torch.bfloat16, device=cuda)
    n0 = agm.ag_gemm_shard.launches
    with pytest.raises(ValueError, match="TMA"):
        agm.ag_gemm_shard(a, b)
    assert agm.ag_gemm_shard.launches == n0


# The uni GEMM-RS on sm90_gemm.cuh (128 x 256 tiles, a flag per staged
# tile, the owner's fold in its tiles' epilogue): (world, m_loc, k, N).  W
# 1, 2, 4, 8; m_loc 512, 250 (a chunk's last row tile masked: TMA loads
# the next chunk's rows there) and 1; N a multiple of 256 and N % 256 ==
# 128 (a half-empty last column tile); k with a tail of 8 past 64-deep
# k-tiles.
RS_WG_CASES = [(world, m_loc, k, n) for world in (1, 2, 4, 8)
               for m_loc, k in ((512, 1024), (250, 264), (1, 72))
               for n in (512, 384)]


def _chunk_tiles_close(out, want, name):
    """The bf16 GEMM rule over the whole output and each 128-row tile of
    every rank's chunk (relative L2 <= 1e-2 a tile: a tile that folded a
    wrong or a stale partial shows)."""
    _gemm_close(out, want, name)
    err, w = out.float() - want.float(), want.float()
    for r in range(out.shape[0]):
        for r0 in range(0, out.shape[1], 128):
            assert err[r, r0:r0 + 128].norm() <= \
                1e-2 * w[r, r0:r0 + 128].norm() + 1e-6, \
                f"{name}: rank {r} rows {r0}.."


@pytest.mark.gpu
@pytest.mark.parametrize("case", RS_WG_CASES)
@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_rs_wg_matches_plain(cuda, case, trans_b):
    """``tdt_gemm_rs`` (the uni GEMM-RS on wgmma / TMA) over a virtual
    world of W ranks against ``gemm_rs_ref`` by the bf16 GEMM rule over
    the whole output and each 128-row tile of every chunk; both B
    layouts; one uni launch a call."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    g = np.random.default_rng(zlib.crc32(repr(("wg", case, trans_b))
                                         .encode()))
    _, a, b = _ring_case(cuda, g, world, m_loc, k, n, trans_b)
    n0 = grs.gemm_rs_shard.launches
    out = grs.gemm_rs_shard(a, b, trans_b=trans_b)
    torch.cuda.synchronize()
    assert grs.gemm_rs_shard.launches == n0 + 1
    assert out.shape == (world, m_loc, n)
    _chunk_tiles_close(out, grs.gemm_rs_ref(a, b, trans_b=trans_b),
                       f"gemm_rs {case}{' B^T' if trans_b else ''}")


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["tp", "dcn"])
@pytest.mark.parametrize("m_loc", [256, 250])
@pytest.mark.parametrize("trans_b", [False, True])
def test_gemm_rs_wg_group_mode_matches_plain(cuda, axis, m_loc, trans_b):
    """The uni kernel's GROUP mode (``tdt_gemm_rs_group``, torus = 0: the
    first step of the torus composition) over one axis of a (2, 4) mesh,
    G 4 ranks one apart or G 2 four apart, against ``group_gemm_rs_ref``
    by the bf16 rule over each rank's chunk tiles; both B layouts."""
    import ctypes

    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    mesh = _mesh((2, 4), ("dcn", "tp"), cuda)
    G, k, n = mesh.axis_size(axis), 264, 640
    g = np.random.default_rng(zlib.crc32(repr((axis, m_loc, trans_b))
                                         .encode()))
    b = (_randn(g, (8, n, k) if trans_b else (8, k, n), cuda).float()
         / k ** 0.5).bfloat16()
    a = _randn(g, (8, G * m_loc, k), cuda)
    out = grs._uni(a, b, m_loc, n, trans_b, "gemm_rs_group", G,
                   group=((ctypes.c_int * 7)(*mesh.group_args((axis,))),
                          (ctypes.c_int * 6)(), 0))
    torch.cuda.synchronize()
    want = grs.group_gemm_rs_ref(a, b, mesh, (axis,), trans_b=trans_b)
    _chunk_tiles_close(out, want, f"gemm_rs group {axis} m_loc {m_loc}")


@pytest.mark.gpu
def test_gemm_rs_wg_ten_calls_in_a_row(cuda):
    """Ten uni GEMM-RS calls in a row on new inputs (W 4, m_loc 512, both
    B layouts in turn), each checked: a flag or a staged tile left by an
    earlier call that let a fold pass early would show."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    g = np.random.default_rng(15)
    for i in range(10):
        trans_b = bool(i % 2)
        _, a, b = _ring_case(cuda, g, 4, 512, 1024, 1024, trans_b)
        out = grs.gemm_rs_shard(a, b, trans_b=trans_b)
        torch.cuda.synchronize()
        _chunk_tiles_close(out, grs.gemm_rs_ref(a, b, trans_b=trans_b),
                           f"gemm_rs call {i}")


@pytest.mark.gpu
def test_gemm_rs_wg_refuses_non_tma_operands(cuda):
    """The uni GEMM-RS reads by TMA: an operand whose base is not 16-byte
    aligned raises before any launch."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    buf = torch.zeros(4 * 256 * 256 + 1, dtype=torch.bfloat16, device=cuda)
    a = buf[1:].view(4, 256, 256)
    b = torch.zeros(4, 256, 256, dtype=torch.bfloat16, device=cuda)
    n0 = grs.gemm_rs_shard.launches
    with pytest.raises(ValueError, match="TMA"):
        grs.gemm_rs_shard(a, b)
    assert grs.gemm_rs_shard.launches == n0


@pytest.mark.gpu
def test_tp4_w8a8_forward_at_8b_width(cuda):
    """Llama-3-8B widths at 2 layers, TP 4 on the virtual world, W8A8:
    ``make_w8a8_forward`` with the kernels (the int8 AG-GEMM for QKV and
    gate/up, matmul_i8 per rank for out and down, flash attention) against
    the same forward over the plain versions, at S 512 and at a ragged S
    1,000 (250 rows per rank): argmax agreement >= 0.75 (the W8A8 floor:
    each projection re-quantizes rows that bf16 rounding moved), finite
    logits, 3 int8 AG-GEMMs and 8 int8 GEMMs per layer; and against the
    float forward: cosine > 0.995."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import quant
    from triton_dist_tpu_torch.models import llama, llama_w8a8
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0)
    qp = llama_w8a8.place_w8a8_params(
        llama_w8a8.quantize_params_w8a8(params, cfg, 4), cfg, 4)
    for S in (512, 1000):
        tok = torch.as_tensor(np.random.default_rng(S).integers(
            0, cfg.vocab, size=(S, 1)), device=cuda)
        n0 = (agm.ag_gemm_i8.launches, quant.matmul_i8.launches)
        with torch.no_grad():
            got = llama_w8a8.make_w8a8_forward(cfg, 4)(qp, tok)
            moved = (agm.ag_gemm_i8.launches - n0[0],
                     quant.matmul_i8.launches - n0[1])
            want = llama_w8a8.make_w8a8_forward(cfg, 4, plain=True)(qp, tok)
            ref = llama.make_forward(cfg)(params, tok)
        assert moved == (3 * cfg.n_layers, 8 * cfg.n_layers), moved
        assert torch.isfinite(got).all() and got.shape == (S, 1, cfg.vocab)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        assert agree >= 0.75, agree
        cos = ((got * ref).sum() / (got.norm() * ref.norm())).item()
        assert cos > 0.995, cos


@pytest.mark.gpu
@pytest.mark.parametrize("w8a8", [False, True])
def test_heads_engine_on_the_card(cuda, w8a8):
    """``ServeEngine(mesh=World(4), kv_shard="heads")`` at Llama-3-8B
    widths cut to 2 layers, float and W8A8 (int8 pools with the W8A8
    run): two requests served to the end through the folded paged decode
    (decode_paged / decode_paged_i8 launched).  Token agreement with
    world 1 is chip_smoke.py's phase 16 (at 32 layers, with its near-tie
    gates)."""
    from dataclasses import replace

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.runtime.bootstrap import get_world
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul
    from triton_dist_tpu_torch.serve import (
        Request,
        SamplingParams,
        ServeEngine,
    )

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0)
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (2, 700))
    kv = torch.int8 if w8a8 else None
    gen = Generator(cfg, max_seq=1024, kv_dtype=kv)
    paged = fd.decode_paged_i8 if w8a8 else fd.gqa_decode_paged_shard

    def serve(mesh):
        eng = ServeEngine(gen, params, num_blocks=1 + 2 * 64, page_size=16,
                          max_batch=2, prefill_chunk=512, mesh=mesh,
                          kv_shard="heads", w8a8=w8a8)
        for i, n in enumerate((700, 300)):
            eng.submit(Request(f"r{i}", prompt[i, :n],
                               SamplingParams(max_new_tokens=8)))
        with torch.no_grad():
            while eng.has_work():
                eng.step()
        return {r: o.token_ids for r, o in eng._outputs.items()}

    n0 = paged.launches
    got = serve(get_world(4, cuda))
    assert paged.launches > n0
    assert sorted(got) == ["r0", "r1"]
    assert all(len(t) == 8 for t in got.values())


def _sp_partials(g, dev, world, lead, D, dead_rank=None, dead_row=None):
    """Rank-stacked decode partials: out N(0, 1) f32, lse N(0, 3); rank
    ``dead_rank`` holds nothing of any row and row ``dead_row`` (a flat
    index over ``lead``) is dead on every rank (out 0, lse NEG_INF)."""
    out = torch.from_numpy(g.standard_normal((world, *lead, D)).astype(
        np.float32)).to(dev)
    lse = torch.from_numpy(3 * g.standard_normal((world, *lead)).astype(
        np.float32)).to(dev)
    flat_out, flat_lse = out.view(world, -1, D), lse.view(world, -1)
    for rank, row in ((dead_rank, slice(None)), (slice(None), dead_row)):
        if rank is None or row is None:
            continue
        flat_out[rank, row] = 0
        flat_lse[rank, row] = fd.NEG_INF
    return out, lse


@pytest.mark.gpu
@pytest.mark.parametrize("world,lead,D", [
    (4, (8, 32), 128),      # the SP-4 decode of 8 sequences of Llama-3-8B
    (4, (512, 32), 128),    # the engine's 512-token chunk
    (2, (3, 5), 64), (8, (2, 7), 132), (4, (1, 1), 128)])
def test_sp_combine_matches_plain(cuda, world, lead, D):
    """The combine kernel against its plain version (``combine_partials``
    over the stack) within 1e-5 of the largest magnitude, with a dead rank
    and a row dead on every rank (merged to exactly 0); every rank's
    merge bit for bit the same; three calls back to back (a new epoch
    each), one launch each."""
    g = np.random.default_rng(world * 1000 + D)
    for _ in range(3):
        out, lse = _sp_partials(g, cuda, world, lead, D, dead_rank=1,
                                dead_row=0)
        n0 = fd.sp_combine_shard.launches
        # the result lives in the workspace until the next combine of
        # this shape: keep a copy to hold the next call against
        got = fd.sp_combine_shard(out, lse, all_ranks=True).clone()
        torch.cuda.synchronize()
        assert fd.sp_combine_shard.launches == n0 + 1
        assert got.shape == (world, *lead, D)
        want = fd.combine_partials(out, lse)
        err = (got[0] - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err
        for r in range(1, world):
            assert torch.equal(got[r], got[0]), r
        assert torch.all(got.reshape(world, -1, D)[:, 0] == 0)
        assert torch.isfinite(got).all()
        assert torch.equal(fd.sp_combine_shard(out, lse), got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("world,lead", [
    (2, (1, 1)), (3, (1, 2)), (5, (2, 2)), (6, (4, 32)), (7, (16, 32)),
    (8, (1, 3)), (8, (8, 32)), (8, (64, 32))])
def test_sp_combine_owner_bands_match_plain(cuda, world, lead):
    """Worlds 2..8 with bh < W (owners with an empty band), bh = W - 1
    and several chunks an owner: the merged rows against the plain
    version (1e-5 of the largest), ranks bit-equal, the dead row 0."""
    D = 128
    g = np.random.default_rng(world * 7919 + int(np.prod(lead)))
    out, lse = _sp_partials(g, cuda, world, lead, D, dead_rank=world - 1,
                            dead_row=0)
    got = fd.sp_combine_shard(out, lse, all_ranks=True).clone()
    torch.cuda.synchronize()
    want = fd.combine_partials(out, lse)
    assert (got[0] - want).abs().max().item() <= \
        1e-5 * want.abs().max().item()
    for r in range(1, world):
        assert torch.equal(got[r], got[0]), r
    assert torch.all(got.reshape(world, -1, D)[:, 0] == 0)


@pytest.mark.gpu
def test_sp_combine_interleaved_shapes_repeat(cuda):
    """Two shapes interleaved over repeated calls (each call a new epoch,
    the gather slots and counters of each shape reused): every result
    against the plain version, ranks bit-equal."""
    g = np.random.default_rng(17)
    for i in range(6):
        lead = (8, 32) if i % 2 else (512, 32)
        out, lse = _sp_partials(g, cuda, 4, lead, 128, dead_rank=i % 4,
                                dead_row=i)
        got = fd.sp_combine_shard(out, lse, all_ranks=True).clone()
        want = fd.combine_partials(out, lse)
        assert (got[0] - want).abs().max().item() <= \
            1e-5 * want.abs().max().item(), i
        for r in range(1, 4):
            assert torch.equal(got[r], got[0]), (i, r)


@pytest.mark.gpu
def test_sp_combine_refuses_what_it_does_not_take(cuda):
    z = torch.zeros
    with pytest.raises(ValueError, match="multiple of 4"):
        fd.sp_combine_shard(z((2, 3, 4, 6), device=cuda),
                            z((2, 3, 4), device=cuda))
    with pytest.raises(TypeError):
        fd.sp_combine_shard(z((2, 3, 4, 8), device=cuda,
                              dtype=torch.bfloat16),
                            z((2, 3, 4), device=cuda))
    with pytest.raises(ValueError, match="at most 8"):
        fd.sp_combine_shard(z((9, 3, 8), device=cuda), z((9, 3),
                                                         device=cuda))
    with pytest.raises(ValueError, match=r"\[W, \.\.\., D\]"):
        fd.sp_combine_shard(z((2, 3, 8), device=cuda), z((2, 4),
                                                         device=cuda))
    graph = torch.cuda.CUDAGraph()
    out, lse = z((2, 3, 8), device=cuda), z((2, 3), device=cuda)
    fd.sp_combine_shard(out, lse)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            fd.sp_combine_shard(out, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("T,window", [(1, 0), (4, 0), (1, 300)])
def test_sp_decodes_match_world1_decode(cuda, T, window):
    """SP-4 decode over contiguous spans and over a partitioned paged pool
    (one decode launch for every rank, one combine launch) against the
    world-1 decode kernel over the whole cache: within the bf16 output
    tolerance; a request shorter than one span is live on rank 0 only."""
    W, B, Hq, Hkv, S, D, page = 4, 4, 32, 8, 2048, 128, 16
    g = np.random.default_rng(7 + T + window)
    q = _randn(g, (B, T, Hq, D) if T > 1 else (B, Hq, D), cuda)
    k, v = _randn(g, (B, Hkv, S, D), cuda), _randn(g, (B, Hkv, S, D), cuda)
    lens = torch.tensor([2048, 1500, 300, 777], dtype=torch.int32,
                        device=cuda)
    want, _ = fd.gqa_decode_shard(q, k, v, lens, window=window)
    n0 = (fd.gqa_decode_shard.launches, fd.sp_combine_shard.launches)
    got = fd.sp_gqa_decode_shard(q, fd.shard_seq(k, W), fd.shard_seq(v, W),
                                 lens, window=window)
    torch.cuda.synchronize()
    assert (fd.gqa_decode_shard.launches - n0[0],
            fd.sp_combine_shard.launches - n0[1]) == (1, 1)
    _close(got, want, OUT_TOL)
    # the same cache as pages: rank r's pages in its own pool rows
    n_loc, nb_loc = S // page // W, B * S // page // W + 1
    pool_k = torch.zeros((W * nb_loc, Hkv, page, D), dtype=torch.bfloat16,
                         device=cuda)
    pool_v = torch.zeros_like(pool_k)
    tables = torch.zeros((W, B, n_loc), dtype=torch.int32, device=cuda)
    for r in range(W):
        rows = r * nb_loc + 1 + torch.randperm(
            B * n_loc, generator=torch.Generator().manual_seed(r)).to(cuda)
        tables[r] = rows.view(B, n_loc).to(torch.int32)
        span = slice(r * n_loc * page, (r + 1) * n_loc * page)
        for src, pool in ((k, pool_k), (v, pool_v)):
            pool[tables[r].long()] = src[:, :, span].reshape(
                B, Hkv, n_loc, page, D).transpose(1, 2)
    n0 = fd.gqa_decode_paged_shard.launches
    got = fd.sp_gqa_decode_paged_shard(q, pool_k, pool_v, tables, lens,
                                       window=window)
    torch.cuda.synchronize()
    assert fd.gqa_decode_paged_shard.launches == n0 + 1
    _close(got, want, OUT_TOL)


@pytest.mark.gpu
def test_sp_generator_and_engine_match_world1_at_8b_width(cuda):
    """Llama-3-8B widths at 2 layers: ``Generator(mesh=World(4))`` against
    world 1 (prefill_chunked at 256 over a 1,500-token prompt, so every
    span holds prompt rows, then 8 steps teacher-forced on world 1's
    tokens: logits within 5e-2 of each other's largest magnitude, the bf16
    floor), and the seq engine over 4 ranks serving two requests to the
    end, every partition holding pages, the combine launched."""
    from dataclasses import replace

    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.runtime.bootstrap import get_world
    from triton_dist_tpu_torch.runtime.utils import use_full_precision_matmul
    from triton_dist_tpu_torch.serve import (
        Request,
        SamplingParams,
        ServeEngine,
    )

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    params = llama.init_params(cfg, seed=0)
    world = get_world(4, cuda)
    prompt = np.random.default_rng(3).integers(0, cfg.vocab, (2, 1900))
    g1 = Generator(cfg, max_seq=2048)
    g4 = Generator(cfg, mesh=world, max_seq=2048)
    with torch.no_grad():
        s1 = g1.prefill_chunked(params, prompt[:, :1500], chunk_size=256)
        s4 = g4.prefill_chunked(params, prompt[:, :1500], chunk_size=256)
        n0 = fd.sp_combine_shard.launches
        for _ in range(8):
            scale = s1.last_logits.abs().max().item()
            err = (s4.last_logits - s1.last_logits).abs().max().item()
            assert err <= 5e-2 * scale, (err, scale)
            tok = s1.last_logits.argmax(-1)
            s1, s4 = g1.step(params, s1, tok), g4.step(params, s4, tok)
        assert fd.sp_combine_shard.launches - n0 == 8 * cfg.n_layers
        eng = ServeEngine(g1, params, num_blocks=4 * 129, page_size=16,
                          max_batch=2, prefill_chunk=512, mesh=world,
                          kv_shard="seq")
        for i, n in enumerate((1900, 700)):
            eng.submit(Request(f"r{i}", prompt[i, :n],
                               SamplingParams(max_new_tokens=8)))
        used = set()
        while eng.has_work():
            eng.step()
            for rid in list(eng.bm._tables):
                used |= {eng.bm.part_of_block(b) for b in eng.bm.table(rid)}
        outs = eng._outputs
    assert sorted(outs) == ["r0", "r1"]
    assert all(len(o.token_ids) == 8 for o in outs.values())
    assert used == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# Context parallelism: the flash kernels' segmented mode, the fused ring
# kernel, the flash ring, Ulysses, the CP model
# ---------------------------------------------------------------------------


def _zig_rows(world, b, s_loc, step):
    """The folded batch's per-row run starts at ring step ``step`` (rank
    r's q against rank r - step's zigzag block)."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    return ra._fold_starts(world, b, s_loc, True, step)


SEG_CASES = [
    # (world, b, Hq, Hkv, S_loc, step, window, cap): the W ranks of one
    # zigzag ring step folded into the batch (two runs per side)
    (4, 1, 8, 2, 512, 0, 0, 0.0),
    (4, 1, 8, 2, 512, 1, 0, 0.0),
    (4, 2, 8, 2, 256, 3, 0, 0.0),
    (2, 1, 16, 4, 384, 1, 200, 20.0),
    # 128-row tiles whose 64-row blocks fall in two runs (chunks of 192)
    (2, 1, 4, 4, 384, 1, 0, 0.0),
    (4, 1, 8, 1, 384, 2, 48, 10.0),
    (2, 2, 8, 8, 256, 0, 0, 0.0),
    # runs of 64 (S_loc 128): every 128-row tile spans both runs
    (4, 1, 8, 8, 128, 1, 0, 0.0),
    (4, 2, 16, 2, 128, 3, 0, 0.0),
    (2, 1, 16, 2, 128, 0, 0, 5.0),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SEG_CASES)
def test_flash_segmented_fwd_bwd_match_plain(cuda, case):
    """The segmented mode (per-batch-row block-start vectors) of
    flash_fwd, dq and dkv against the plain versions on the same per-row
    run starts: out 2e-2 / lse 1e-3, f32 gradients by the bf16 gradient
    rule; one launch each; rows that see no key of the block (the late
    chunk's keys against the early chunk's rows) give out 0, lse NEG_INF
    and zero gradients."""
    world, b, Hq, Hkv, S, step, window, cap = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    B = world * b
    q = _randn(g, (B, Hq, S, 128), cuda)
    k = _randn(g, (B, Hkv, S, 128), cuda)
    v = _randn(g, (B, Hkv, S, 128), cuda)
    do = _randn(g, (B, Hq, S, 128), cuda)
    kw = dict(causal=True, q_offset=_zig_rows(world, b, S, 0),
              kv_offset=_zig_rows(world, b, S, step), window=window,
              soft_cap=cap)
    n0 = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
          fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                 grad_dtype=torch.float32, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, **kw)
    _close(out, ref_out, OUT_TOL)
    _close(lse, ref_lse, LSE_TOL)
    dead = ref_lse <= fd.NEG_INF / 2
    assert torch.all(lse[dead] <= fd.NEG_INF / 2)
    assert torch.all(out[dead] == 0)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for gt, wt, name in zip(got, want, ("dq", "dk", "dv")):
        assert gt.dtype == torch.float32
        if wt.abs().max() > 0:
            _rel_close(gt, wt, name)
        else:
            assert torch.all(gt == 0), name


def _ring_close(got, want):
    """A ring's output [W, S_loc, B, H, hd] against the dense ring's:
    within OUT_TOL absolute, and by the bf16 rule of :func:`_rel_close`
    over each (rank, batch, head, 64-row block).  There is no lse to hold
    it to, and a row that sees n unit-scale keys has |out| ~ sqrt(e / n),
    near OUT_TOL itself at Llama-3-8B CP 4: a dropped key tile shows only
    in the relative rule."""
    _close(got, want, OUT_TOL)
    _rel_close(*(x.permute(0, 2, 3, 1, 4).flatten(0, 1) for x in (got, want)),
               "ring out")


def _ring_inputs(g, dev, world, s_loc, b, hq, hkv):
    return (_randn(g, (world, s_loc, b, hq, 128), dev),
            _randn(g, (world, s_loc, b, hkv, 128), dev),
            _randn(g, (world, s_loc, b, hkv, 128), dev))


RING_ATTN_CASES = [
    # (world, S_loc, B, Hq, Hkv, causal, window, cap, zigzag)
    (4, 256, 1, 8, 2, True, 0, 0.0, False),
    (4, 256, 1, 8, 2, False, 0, 0.0, False),
    (2, 256, 2, 8, 2, True, 300, 15.0, False),
    (4, 256, 1, 8, 2, True, 0, 0.0, True),
    (2, 384, 1, 16, 4, True, 0, 0.0, True),
    (4, 100, 1, 8, 2, True, 0, 0.0, False),    # a row tail that does not tile
    (4, 512, 1, 32, 8, True, 0, 0.0, True),    # Llama-3-8B's heads
    # the edges of the 128-row / 128-key tiles
    (4, 64, 1, 8, 2, True, 0, 0.0, False),     # half a tile
    (2, 129, 1, 8, 2, True, 0, 0.0, False),    # one row past a tile
    (3, 200, 2, 4, 4, True, 0, 0.0, False),    # G = 1 at 128-row tiles
    (2, 1000, 1, 16, 2, True, 0, 0.0, False),  # G = 8
    (4, 384, 1, 8, 2, True, 0, 0.0, True),     # zigzag, 192-row chunks
    (4, 256, 1, 8, 2, True, 48, 0.0, False),   # window shorter than a tile
    (2, 200, 1, 8, 2, True, 0, 20.0, False),   # soft-cap
    (3, 129, 1, 8, 2, False, 0, 0.0, False),   # non-causal
    (1, 200, 1, 8, 2, True, 0, 0.0, False),    # W 1
    (8, 128, 1, 8, 2, True, 0, 0.0, True),     # W 8
    (8, 100, 1, 8, 1, False, 0, 0.0, False),   # W 8, G 8, a tail
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", RING_ATTN_CASES)
def test_ring_attn_matches_plain(cuda, case):
    """The fused ring kernel (one cooperative launch over W ranks, the KV
    blocks through the workspace's slots) against its plain version, the
    dense ring, within 2e-2 (bf16 out; the kernel rounds P to bf16) and by
    the relative rule of :func:`_ring_close`."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    world, s_loc, b, hq, hkv, causal, window, cap, zz = case
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    q, k, v = _ring_inputs(g, cuda, world, s_loc, b, hq, hkv)
    kw = dict(causal=causal, window=window, soft_cap=cap, zigzag=zz)
    n0 = ra.ring_attn.launches
    got = ra.ring_attn(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ra.ring_attn.launches == n0 + 1
    want = ra._ring_attention_dense(q, k, v, scale=128 ** -0.5, **kw)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _ring_close(got, want)


@pytest.mark.gpu
def test_ring_attn_ten_calls_in_a_row(cuda):
    """Ten calls back to back on new inputs, each checked: every call's
    epoch passes only its own arrivals, so slot reuse across calls shows."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    g = np.random.default_rng(77)
    for i in range(10):
        q, k, v = _ring_inputs(g, cuda, 4, 256, 1, 8, 2)
        got = ra.ring_attn(q, k, v, zigzag=bool(i % 2))
        want = ra._ring_attention_dense(q, k, v, causal=True,
                                        scale=128 ** -0.5,
                                        zigzag=bool(i % 2))
        _ring_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("zigzag", [False, True])
def test_ring_attn_training_shape_repeats(cuda, zigzag):
    """Ten calls back to back at Llama-3-8B CP 4 (W 4, S_loc 2048, Hq 32,
    Hkv 8) on the same inputs agree with the first bit for bit (one block
    owns each output row and sums in a fixed order), and the first with
    the dense ring."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    g = np.random.default_rng(5 + zigzag)
    q, k, v = _ring_inputs(g, cuda, 4, 2048, 1, 32, 8)
    first = ra.ring_attn(q, k, v, zigzag=zigzag)
    for _ in range(9):
        assert torch.equal(ra.ring_attn(q, k, v, zigzag=zigzag), first)
    want = ra._ring_attention_dense(q, k, v, causal=True, scale=128 ** -0.5,
                                    zigzag=zigzag)
    _ring_close(first, want)


@pytest.mark.gpu
@pytest.mark.parametrize("segmented", [False, True])
def test_flash_bwd_training_shape_repeats(cuda, segmented):
    """Ten backward calls back to back at the training shape (B 1, Hq 32,
    Hkv 8, S 2048; and the CP-4 ring step's folded zigzag layout, S_loc
    2048) agree with the first bit for bit (no atomics: one sequential
    sum per output), and the first with the plain version."""
    if segmented:
        world, b, S = 4, 1, 2048
        kw = dict(causal=True, q_offset=_zig_rows(world, b, S, 0),
                  kv_offset=_zig_rows(world, b, S, 1))
        B = world * b
    else:
        B, S, kw = 1, 2048, dict(causal=True)
    g = np.random.default_rng(9 + segmented)
    q = _randn(g, (B, 32, S, 128), cuda)
    k = _randn(g, (B, 8, S, 128), cuda)
    v = _randn(g, (B, 8, S, 128), cuda)
    do = _randn(g, (B, 32, S, 128), cuda)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    for _ in range(9):
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        for a, f in zip(again, first):
            assert torch.equal(a, f)
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for gt, wt, name in zip(first, want, ("dq", "dk", "dv")):
        if wt.abs().max() > 0:
            _rel_close(gt, wt, name)
        else:
            assert torch.all(gt == 0), name


@pytest.mark.gpu
@pytest.mark.parametrize("impl,zigzag", [("flash", True), ("flash", False),
                                         ("fused", True)])
def test_ring_attention_grads_match_plain(cuda, impl, zigzag):
    """``ring_attention_shard`` under autograd against the dense ring's
    (plain) autograd: the flash ring (W flash launches forward, W dq and
    dkv launches backward) and the fused kernel (one launch; its backward
    is the dense VJP), outputs by :func:`_ring_close`, gradients by the
    bf16 rule."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    g = np.random.default_rng(31 + zigzag)
    world = 4
    q, k, v = (t.requires_grad_() for t in _ring_inputs(g, cuda, world, 256,
                                                        1, 8, 2))
    w = _randn(g, tuple(q.shape), cuda)
    n0 = (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
          ra.ring_attn.launches)
    out = ra.ring_attention_shard(q, k, v, impl=impl, zigzag=zigzag)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    moved = (fa.flash_attention.launches - n0[0],
             fa.flash_bwd_dq.launches - n0[1], ra.ring_attn.launches - n0[2])
    assert moved == ((world, world, 0) if impl == "flash" else (0, 0, 1))
    ref = ra.ring_attention_shard(q, k, v, zigzag=zigzag, plain=True)
    want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
    _ring_close(out.detach(), ref.detach())
    for gt, wt, name in zip(got, want, "qkv"):
        _rel_close(gt.flatten(0, 1), wt.flatten(0, 1), "d" + name,
                   seq_first=True)


@pytest.mark.gpu
def test_ring_attention_refusals(cuda):
    """An explicit impl="flash" on a shape the flash ring does not take
    raises (``auto`` takes the fused kernel there); ring_attn refuses a
    CUDA graph capture (each call takes a host epoch)."""
    from triton_dist_tpu_torch.kernels import ring_attention as ra

    g = np.random.default_rng(3)
    q, k, v = _ring_inputs(g, cuda, 4, 100, 1, 8, 2)
    with pytest.raises(ra.RingShapeError):
        ra.ring_attention_shard(q, k, v, impl="flash")
    n0 = ra.ring_attn.launches
    ra.ring_attention_shard(q, k, v)
    assert ra.ring_attn.launches == n0 + 1
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            ra.ring_attn(q, k, v)


@pytest.mark.gpu
def test_ulysses_on_the_card(cuda):
    """Ulysses over 4 ranks: two all-to-all launches forward (two more
    backward) and one flash call, against the plain versions (out by
    :func:`_ring_close`, gradients by the bf16 rule)."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import ulysses_attention as ua

    g = np.random.default_rng(41)
    q, k, v = (t.requires_grad_() for t in _ring_inputs(g, cuda, 4, 256, 1,
                                                        8, 4))
    w = _randn(g, tuple(q.shape), cuda)
    n0 = (a2a.fast_all_to_all_shard.launches, fa.flash_attention.launches)
    out = ua.ulysses_attention_shard(q, k, v)
    got = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    assert (a2a.fast_all_to_all_shard.launches - n0[0],
            fa.flash_attention.launches - n0[1]) == (4, 1)
    ref = ua.ulysses_attention_shard(q, k, v, plain=True)
    want = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
    _ring_close(out.detach(), ref.detach())
    for gt, wt, name in zip(got, want, "qkv"):
        _rel_close(gt.flatten(0, 1), wt.flatten(0, 1), "d" + name,
                   seq_first=True)


@pytest.mark.gpu
def test_cp_llama_two_layers_on_the_card(cuda):
    """A 2-layer Llama at narrow widths (dim 1024, 8 / 4 heads of 128,
    bf16), S 2048 over 4 ranks: ``make_cp_forward`` three ways (the
    zigzag flash ring, the fused kernel, Ulysses) against the world-1
    forward (logits relative L2 within 2e-2), then one SGD step of each
    scheme with a finite loss, the gradients against the plain versions'
    within 2e-2 relative L2 per leaf."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import ring_attention as ra
    from triton_dist_tpu_torch.models import cp, llama
    from triton_dist_tpu_torch.runtime.utils import (
        tree_leaves,
        use_full_precision_matmul,
        value_and_grad,
    )

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.tiny(torch.bfloat16), vocab=4096,
                  max_seq=2048)
    params = llama.init_params(cfg, seed=0)
    tok = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2048, 1)), device=cuda)
    with torch.no_grad():
        ref = llama.make_forward(cfg)(params, tok)
        for attn, impl in (("ring", "auto"), ("ring", "fused"),
                           ("ulysses", "auto")):
            n0 = (fa.flash_attention.launches, ra.ring_attn.launches)
            got = cp.make_cp_forward(cfg, 4, attn=attn, impl=impl)(params,
                                                                   tok)
            moved = (fa.flash_attention.launches - n0[0],
                     ra.ring_attn.launches - n0[1])
            expect = {("ring", "auto"): (8, 0), ("ring", "fused"): (0, 2),
                      ("ulysses", "auto"): (2, 0)}[attn, impl]
            assert moved == expect, (attn, impl, moved)
            rel = ((got - ref).norm() / ref.norm()).item()
            assert rel <= 2e-2, (attn, impl, rel)
    tgt = torch.roll(tok, -1, 0)
    for attn, impl in (("ring", "auto"), ("ring", "fused"),
                       ("ulysses", "auto")):
        step = cp.make_cp_train_step(cfg, 4, attn=attn, impl=impl, lr=0.0)

        def loss(p, t, y, plain=False):
            zz = cp._pick_zigzag(None, attn, 2048, 4, impl, 128)
            if zz:
                t, y = ra.to_zigzag(t, 4), ra.to_zigzag(y, 4)
            lg = cp.cp_forward_shard(p, t.reshape(4, 512, 1), cfg,
                                     attn=attn, impl=impl, plain=plain,
                                     zigzag=zz)
            return torch.nn.functional.cross_entropy(
                lg.reshape(-1, cfg.vocab), y.reshape(-1))

        _, l_k = step(params, tok, tgt)
        assert np.isfinite(float(l_k))
        _, g_k = value_and_grad(loss, params, tok, tgt)
        _, g_p = value_and_grad(loss, params, tok, tgt, plain=True)
        for a, b in zip(tree_leaves(g_k), tree_leaves(g_p)):
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            assert rel <= 2e-2, (attn, impl, rel)


# ---------------------------------------------------------------------------
# Collectives over a mesh of the virtual world: barrier, all-gather,
# reduce-scatter (bit for bit against their plain versions), the PP step
# ---------------------------------------------------------------------------

COLLECTIVE_MESHES = [
    # (mesh shape, axis names, the axis collected over): T 2 over grouped
    # ranks, T 4 over a (2, 4) mesh, T 8 flat
    ((2, 2, 2), ("dcn", "pp", "tp"), "tp"),
    ((2, 2, 2), ("dcn", "pp", "tp"), "dcn"),
    ((2, 4), ("dcn", "tp"), "tp"),
    ((8,), ("tp",), "tp"),
]


def _mesh(shape, names, dev):
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    return Mesh(shape, names, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", COLLECTIVE_MESHES)
def test_barrier_on_the_card(cuda, mesh_case):
    """One launch of the barrier over every group of the axis returns each
    rank's word; ten in a row."""
    from triton_dist_tpu_torch.kernels import common_ops as co

    mesh = _mesh(*mesh_case[:2], cuda)
    x = torch.arange(mesh.size, dtype=torch.int32, device=cuda).reshape(
        mesh.shape)
    n0 = co.barrier_shard.launches
    for _ in range(10):
        assert torch.equal(co.barrier_shard(x, mesh, mesh_case[2]), x)
    assert co.barrier_shard.launches == n0 + 10
    got = co.barrier_all_on_mesh(mesh, mesh_case[2])
    assert got.tolist() == [0] * mesh.axis_size(mesh_case[2])


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", COLLECTIVE_MESHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["RING_1D", "RING_BIDIR",
                                    "FULL_MESH_PUSH"])
def test_all_gather_matches_plain(cuda, mesh_case, dtype, method):
    """Every mode of the all-gather kernel equals its plain version bit for
    bit, at even (1024) and odd (37: bidir takes the ring) rows per rank,
    one launch per call."""
    from triton_dist_tpu_torch.kernels import allgather as ag

    mesh = _mesh(*mesh_case[:2], cuda)
    axis = mesh_case[2]
    g = torch.Generator(device=cuda).manual_seed(1)
    for rows in (1024, 37):
        x = torch.randn((*mesh.shape, rows, 128), generator=g,
                        device=cuda).to(dtype)
        n0 = ag.all_gather_shard.launches
        got = ag.all_gather_shard(x, mesh, axis,
                                  getattr(ag.AllGatherMethod, method))
        torch.cuda.synchronize()
        assert ag.all_gather_shard.launches == n0 + 1
        assert torch.equal(got, ag.all_gather_ref(x, mesh, axis))


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", COLLECTIVE_MESHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("method", ["RING_1D", "RING_BIDIR"])
def test_reduce_scatter_matches_plain(cuda, mesh_case, dtype, method):
    """Every mode of the reduce-scatter kernel equals its plain version
    (the reference's ring order, ``ring_fold_order``) bit for bit, in f32
    and bf16, at rows per chunk 2048, 8, 5 (unequal bidir halves) and 1
    (the ring), and at a row of 3 elements (the scalar path); one launch
    of the method's mode a call."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    mesh = _mesh(*mesh_case[:2], cuda)
    axis = mesh_case[2]
    T = mesh.axis_size(axis)
    g = torch.Generator(device=cuda).manual_seed(2)
    meth = getattr(rs.ReduceScatterMethod, method)
    for rows, row in ((2048, 128), (8, 128), (5, 128), (1, 128), (5, 3)):
        x = torch.randn((*mesh.shape, T * rows, row), generator=g,
                        device=cuda).to(dtype)
        mode = "bidir" if method == "RING_BIDIR" and rows >= 2 else "ring"
        n0 = rs.reduce_scatter_shard.mode_launches[mode]
        got = rs.reduce_scatter_shard(x, mesh, axis, meth)
        torch.cuda.synchronize()
        assert rs.reduce_scatter_shard.mode_launches[mode] == n0 + 1
        assert torch.equal(got, rs.reduce_scatter_ref(x, mesh, axis, meth))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["RING_1D", "RING_BIDIR"])
def test_reduce_scatter_allocates_only_its_output(cuda, method):
    """A reduce-scatter call pulls the peers' partials in place: around
    one call (after a first that set up the workspace's barrier slots)
    ``torch.cuda.memory_allocated`` grows by no more than its output, and
    nothing is left allocated but the output."""
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    mesh = _mesh((2, 4), ("dcn", "tp"), cuda)
    meth = getattr(rs.ReduceScatterMethod, method)
    x = torch.randn((2, 4, 4 * 4096, 128), device=cuda)
    rs.reduce_scatter_shard(x, mesh, "tp", meth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = rs.reduce_scatter_shard(x, mesh, "tp", meth)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    out_bytes = out.numel() * out.element_size()
    assert grew <= out_bytes, (grew, out_bytes)
    assert torch.cuda.memory_allocated() - before == out_bytes


@pytest.mark.gpu
def test_collectives_ten_calls_in_a_row_and_refuse_capture(cuda):
    """Ten bidir all-gathers and ten bidir reduce-scatters in a row on new
    inputs, each checked; a CUDA graph capture of either is refused (each
    call takes a host epoch); an unsupported dtype is refused."""
    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    mesh = _mesh((2, 2, 2), ("dcn", "pp", "tp"), cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(10):
        x = torch.randn((2, 2, 2, 4096, 128), generator=g, device=cuda)
        a = ag.all_gather_shard(x, mesh, "tp", ag.AllGatherMethod.RING_BIDIR)
        r = rs.reduce_scatter_shard(x, mesh, "tp")
        torch.cuda.synchronize()
        assert torch.equal(a, ag.all_gather_ref(x, mesh, "tp"))
        assert torch.equal(r, rs.reduce_scatter_ref(x, mesh, "tp"))
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            ag.all_gather_shard(x, mesh, "tp")
    with pytest.raises(TypeError, match="f32 or bf16"):
        rs.reduce_scatter_shard(x.double(), mesh, "tp")


@pytest.mark.gpu
def test_hier_all_to_all_on_the_card(cuda):
    """The two-stage all-to-all over a (2, 4) mesh on the kernel (one
    launch per group of each axis: 4 + 2) equals its plain version on
    every row below a split, padding rows zero."""
    from triton_dist_tpu_torch.kernels import all_to_all as a2a
    from triton_dist_tpu_torch.kernels import hierarchical as hi

    mesh = _mesh((2, 4), ("dp", "tp"), cuda)
    gen = np.random.default_rng(4)
    send = torch.from_numpy(gen.standard_normal((2, 4, 8, 64, 256)).astype(
        np.float32)).to(device=cuda, dtype=torch.bfloat16)
    splits = torch.from_numpy(gen.integers(0, 65, size=(2, 4, 8)).astype(
        np.int32)).to(cuda)
    n0 = a2a.fast_all_to_all_shard.launches
    got, gs = hi.hier_all_to_all_shard(send, splits, mesh, slow_axis="dp",
                                       fast_axis="tp")
    torch.cuda.synchronize()
    assert a2a.fast_all_to_all_shard.launches == n0 + 6
    want, ws = hi.hier_all_to_all_shard(send, splits, mesh, slow_axis="dp",
                                        fast_axis="tp", plain=True)
    assert torch.equal(gs, ws)
    row = torch.arange(64, device=cuda)
    keep = (row < ws[..., None])[..., None]
    assert torch.equal(torch.where(keep, got, 0), want)


@pytest.mark.gpu
def test_pp_hier_step_on_the_card(cuda):
    """A 2-layer narrow Llama (dim 1024, 8 / 4 heads, bf16) on (dcn 2, pp
    2, tp 2), S 512, B 4: the hierarchical step launches one
    reduce-scatter (bidir) and one all-gather (full mesh) per step, and
    its losses and updated leaves equal the psum step's (bf16 rounding:
    losses 1e-3 relative, leaves 2e-2 relative L2)."""
    from dataclasses import replace

    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs
    from triton_dist_tpu_torch.models import llama, pp
    from triton_dist_tpu_torch.runtime.utils import (
        tree_leaves,
        use_full_precision_matmul,
    )

    use_full_precision_matmul()
    cfg = replace(llama.LlamaConfig.tiny(torch.bfloat16), vocab=4096,
                  max_seq=512)
    mesh = _mesh((2, 2, 2), ("dcn", "pp", "tp"), cuda)
    tok = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(512, 4)), device=cuda)
    tgt = torch.roll(tok, -1, 0)
    runs = {}
    for hier in ("tp", None):
        params = pp.place_pp_params(pp.init_pp_params(cfg, seed=0), cfg,
                                    mesh)
        step, _ = pp.make_pp_train_step(cfg, mesh, dp_axis="dcn", n_micro=2,
                                        lr=0.2, remat=True,
                                        hier_dp_fast_axis=hier)
        n0 = (dict(rs.reduce_scatter_shard.mode_launches),
              dict(ag.all_gather_shard.mode_launches))
        losses = [float(step(params, tok, tgt)[1]) for _ in range(2)]
        moved = (rs.reduce_scatter_shard.mode_launches["bidir"]
                 - n0[0]["bidir"],
                 ag.all_gather_shard.mode_launches["full_mesh"]
                 - n0[1]["full_mesh"])
        assert moved == ((2, 2) if hier else (0, 0)), moved
        assert all(np.isfinite(losses)) and losses[1] < losses[0]
        runs[hier] = (losses, tree_leaves(params))
    np.testing.assert_allclose(runs["tp"][0], runs[None][0], rtol=1e-3)
    for a, b in zip(runs["tp"][1], runs[None][1]):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        assert rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# The MoE overlap kernels: AG-GroupGEMM (csrc/ag_group_gemm.cu) and
# GroupGEMM-RS (csrc/moe_rs.cu) over a virtual world of W ranks
# ---------------------------------------------------------------------------

MOE_TP_CASES = [(W, bm, routing) for W in (2, 4) for bm in (128, 256)
                for routing in ("balanced", "skewed", "empty")] + [
    # (W, block_m, routing, D[, F_loc]): D 384 leaves a ragged 128-column
    # band of moe_rs's 256-column tiles to mask, F_loc 384 one of
    # ag_group_gemm's; and the largest world
    (4, 128, "balanced", 384), (8, 128, "balanced"),
    (4, 128, "balanced", 256, 384)]


def _moe_tp_args(case):
    """(W, block_m, routing, keyword arguments of _moe_tp_case) of a
    MOE_TP_CASES entry."""
    W, bm, routing, *dims = case
    return W, bm, routing, dict(zip(("D", "f_loc"), dims))


def _moe_tp_case(dev, g, W, block_m, routing, t_loc=64, E=8, D=256,
                 f_loc=256):
    """Seeded top-2 routing (N(0, 1) logits; ``skewed``: most assignments
    on experts 0 and 1; ``empty``: expert E - 1 gets none), the plans,
    the sorted segments xs [W, m_pad, D], gate slabs [W, E, D, F_loc], h
    [W, W m_pad, F_loc] in the sorted layout (padding rows zero) and down
    slabs [W, E, F_loc, D]."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_utils as mu

    logits = g.standard_normal((W * t_loc, E)).astype(np.float32)
    if routing == "skewed":
        logits[:, :2] += 4.0
    elif routing == "empty":
        logits[:, -1] = -1e9
    weights, experts = mu.topk_routing(torch.from_numpy(logits).to(dev), 2)
    weights, experts = weights.view(W, t_loc, 2), experts.view(W, t_loc, 2)
    dest, te, m_pad = agg._segment_plans(experts, E, block_m)
    x = _randn(g, (W, t_loc, D), dev)
    xs = torch.stack([mu.gather_sorted(x[r], dest[r], m_pad)
                      for r in range(W)])
    act = _randn(g, (W, t_loc, W * f_loc), dev)
    h = torch.stack([torch.cat([
        mu.gather_sorted(act[s, :, q * f_loc:(q + 1) * f_loc], dest[s],
                         m_pad) for s in range(W)]) for q in range(W)])
    w_up = (_randn(g, (W, E, D, f_loc), dev).float() / D ** 0.5).bfloat16()
    w_dn = (_randn(g, (W, E, f_loc, D), dev).float() / f_loc ** 0.5
            ).bfloat16()
    return weights, experts, te, x, xs, w_up, h, w_dn


def _segment_tiles_close(got, want, name):
    """Each rank's grouped output by the row-tile rule (padding tiles
    exactly zero)."""
    for r in range(got.shape[0]):
        _tile_close(got[r], want[r], 128, f"{name} rank {r}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_TP_CASES)
def test_ag_group_gemm_matches_plain(cuda, case):
    """``tdt_ag_group_gemm`` against its plain version: the gathered
    sorted segments bit for bit, every rank's grouped products by the
    row-tile rule (padding tiles exactly zero), one launch counted; the
    rank-stacked shard function (plans, sort, combine) by the bf16 GEMM
    rule."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg

    W, bm, routing, kw = _moe_tp_args(case)
    g = np.random.default_rng(zlib.crc32(repr(case).encode()))
    weights, experts, te, x, xs, w_up, _, _ = _moe_tp_case(cuda, g, W, bm,
                                                           routing, **kw)
    n0 = agg.ag_group_gemm_shard.launches
    gathered, y = agg.ag_group_gemm_sorted(xs, w_up, te, block_m=bm)
    torch.cuda.synchronize()
    assert agg.ag_group_gemm_shard.launches == n0 + 1
    want_g, want_y = agg.ag_group_gemm_ref(xs, w_up, te, block_m=bm)
    assert torch.equal(gathered, want_g)
    _segment_tiles_close(y, want_y, f"ag_group_gemm {case}")
    kw = dict(n_experts=8, topk=2, block_m=bm)
    _gemm_close(agg.ag_group_gemm_shard(x, weights, experts, w_up, **kw),
                agg.ag_group_gemm_shard(x, weights, experts, w_up, plain=True,
                                        **kw), f"ag_group_gemm_shard {case}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", MOE_TP_CASES)
def test_moe_rs_matches_plain(cuda, case):
    """``tdt_moe_rs`` against its plain version (the same hop order and
    bf16 adds; the partials may round differently): every owner's reduced
    segment by the row-tile rule (padding tiles exactly zero), one launch
    counted; the shard function by the bf16 GEMM rule."""
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    W, bm, routing, kw = _moe_tp_args(case)
    g = np.random.default_rng(zlib.crc32(repr(case).encode()) + 1)
    weights, experts, te, _, _, _, h, w_dn = _moe_tp_case(cuda, g, W, bm,
                                                          routing, **kw)
    n0 = mrs.moe_reduce_rs_shard.launches
    ys = mrs.moe_rs_sorted(h, w_dn, te, block_m=bm)
    torch.cuda.synchronize()
    assert mrs.moe_reduce_rs_shard.launches == n0 + 1
    _segment_tiles_close(ys, mrs.moe_rs_ref(h, w_dn, te, block_m=bm),
                         f"moe_rs {case}")
    kw = dict(n_experts=8, topk=2, block_m=bm)
    _gemm_close(mrs.moe_reduce_rs_shard(h, w_dn, weights, experts, **kw),
                mrs.moe_reduce_rs_shard(h, w_dn, weights, experts,
                                        plain=True, **kw),
                f"moe_reduce_rs_shard {case}")


@pytest.mark.gpu
def test_moe_tp_kernels_ten_calls_in_a_row(cuda):
    """Ten calls of each kernel in a row, alternating two shapes (a flag,
    piece counter or landing slot left by an earlier call that let a wait
    pass early would show): each result equal to the first call's on the
    same inputs and to the plain version by the tile rule."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    g = np.random.default_rng(31)
    cases = [_moe_tp_case(cuda, g, 4, bm, "balanced") for bm in (128, 256)]
    results = []
    for i in range(10):
        bm = (128, 256)[i % 2]
        _, _, te, _, xs, w_up, h, w_dn = cases[i % 2]
        results.append((i % 2, agg.ag_group_gemm_sorted(xs, w_up, te,
                                                        block_m=bm),
                        mrs.moe_rs_sorted(h, w_dn, te, block_m=bm)))
    torch.cuda.synchronize()
    first = {}
    for c, (gathered, y), ys in results:
        ref = first.setdefault(c, (gathered, y, ys))
        assert torch.equal(gathered, ref[0]) and torch.equal(y, ref[1])
        assert torch.equal(ys, ref[2])
    for c, (gathered, y, ys) in first.items():
        bm = (128, 256)[c]
        _, _, te, _, xs, w_up, h, w_dn = cases[c]
        assert torch.equal(gathered, agg.ag_group_gemm_ref(
            xs, w_up, te, block_m=bm)[0])
        _segment_tiles_close(y, agg.ag_group_gemm_ref(xs, w_up, te,
                                                      block_m=bm)[1],
                             "ag_group_gemm in a row")
        _segment_tiles_close(ys, mrs.moe_rs_ref(h, w_dn, te, block_m=bm),
                             "moe_rs in a row")


@pytest.mark.gpu
def test_moe_rs_after_a_call_of_another_shape(cuda):
    """Calls at one shape, another and the first again (D 384 at block_m
    256, then D 256 at block_m 128): the landing slots and flags of the
    other shape sit in the workspace between them; every call against the
    plain version by the row-tile rule, the repeat equal to the first."""
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    g = np.random.default_rng(37)
    shapes = [(_moe_tp_case(cuda, g, 4, 256, "skewed", D=384), 256),
              (_moe_tp_case(cuda, g, 4, 128, "balanced"), 128)]
    outs = []
    for case, bm in shapes + shapes[:1]:
        te, h, w_dn = case[2], case[6], case[7]
        ys = mrs.moe_rs_sorted(h, w_dn, te, block_m=bm)
        torch.cuda.synchronize()
        _segment_tiles_close(ys, mrs.moe_rs_ref(h, w_dn, te, block_m=bm),
                             f"moe_rs block_m {bm} D {w_dn.shape[-1]}")
        outs.append(ys)
    assert torch.equal(outs[0], outs[2])


@pytest.mark.gpu
def test_moe_rs_refuses_non_tma_operands(cuda):
    """Slabs whose rank stride is 0 (one stack expanded over the ranks)
    pass the grouped kernels' row rule but break TMA's
    (``grouped_operand_ok``): a ValueError before any launch."""
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    g = np.random.default_rng(39)
    _, _, te, _, _, _, h, w_dn = _moe_tp_case(cuda, g, 2, 128, "balanced")
    n0 = mrs.moe_reduce_rs_shard.launches
    with pytest.raises(ValueError, match="TMA"):
        mrs.moe_rs_sorted(h, w_dn[:1].expand_as(w_dn), te, block_m=128)
    assert mrs.moe_reduce_rs_shard.launches == n0


@pytest.mark.gpu
def test_moe_tp_kernels_refuse_what_they_do_not_take(cuda):
    """f32 operands, block_m 64, D or F_loc off the 128 tile: raises on
    the card (no fallback to the plain version)."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=cuda)

    te = z(2, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="bf16"):
        agg.ag_group_gemm_sorted(z(2, 256, 256, dtype=torch.float32),
                                 z(2, 4, 256, 256, dtype=torch.float32), te,
                                 block_m=128)
    with pytest.raises(TypeError, match="bf16"):
        mrs.moe_rs_sorted(z(2, 512, 256, dtype=torch.float32),
                          z(2, 4, 256, 256, dtype=torch.float32), te,
                          block_m=128)
    te64 = z(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 128"):
        agg.ag_group_gemm_sorted(z(2, 128, 256), z(2, 4, 256, 256), te64,
                                 block_m=64)
    with pytest.raises(ValueError, match="multiples of 128"):
        mrs.moe_rs_sorted(z(2, 256, 256), z(2, 4, 256, 256), te64,
                          block_m=64)
    with pytest.raises(ValueError, match="multiples of 128"):
        agg.ag_group_gemm_sorted(z(2, 256, 200), z(2, 4, 200, 256), te,
                                 block_m=128)
    with pytest.raises(ValueError, match="multiples of 128"):
        mrs.moe_rs_sorted(z(2, 512, 256), z(2, 4, 256, 200), te,
                          block_m=128)


@pytest.mark.gpu
def test_moe_tp_host_entries_on_the_card(cuda):
    """The host entries over a port Mesh on the card, the expert stacks
    [E, D, F] / [E, F, D] read in place as each rank's F block: against
    the same contexts at ``impl="xla"``; then the autotuned entries in one
    ``contextual_autotune`` region against the plain host entries; the
    native host planner equal to numpy on the same routing."""
    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.runtime import host_ops
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    W, T, D, F, E = 4, 512, 256, 1024, 8
    mesh = Mesh((W,), ("tp",), cuda)
    g = np.random.default_rng(33)
    x = _randn(g, (T, D), cuda)
    weights, experts = mu.topk_routing(torch.from_numpy(
        g.standard_normal((T, E)).astype(np.float32)).to(cuda), 2)
    w_up = (_randn(g, (E, D, F), cuda).float() / D ** 0.5).bfloat16()
    w_dn = (_randn(g, (E, F, D), cuda).float() / F ** 0.5).bfloat16()
    ctx = agg.create_ag_group_gemm_context(mesh, n_experts=E, topk=2)
    out = agg.ag_group_gemm(x, weights, experts, w_up, ctx)
    want = agg.ag_group_gemm(x, weights, experts, w_up,
                             agg.create_ag_group_gemm_context(
                                 mesh, n_experts=E, topk=2, impl="xla"))
    _gemm_close(out, want, "host ag_group_gemm")
    bm = agg.resolve_block_m(ctx, T)
    dest, _, m_pad = agg._segment_plans(experts.view(W, -1, 2), E, bm)
    act = _randn(g, (T, F), cuda).view(W, T // W, F)
    h = torch.cat([mu.gather_sorted(act[s], dest[s], m_pad)
                   for s in range(W)])
    rctx = mrs.create_moe_rs_context(mesh, n_experts=E, topk=2)
    got = mrs.moe_reduce_rs(h, w_dn, weights, experts, rctx)
    _gemm_close(got, mrs.moe_reduce_rs(h, w_dn, weights, experts,
                                       mrs.create_moe_rs_context(
                                           mesh, n_experts=E, topk=2,
                                           impl="xla")), "host moe_rs")

    @contextual_autotune(n_repeat=2, n_warmup=1)
    def op():
        return (agg.ag_group_gemm_autotuned(x, weights, experts, w_up, ctx),
                mrs.moe_reduce_rs_autotuned(h, w_dn, weights, experts,
                                            rctx))

    out_t, got_t = op()
    _gemm_close(out_t, want, "ag_group_gemm_autotuned")
    _gemm_close(got_t, got, "moe_reduce_rs_autotuned")
    assert agg._ag_group_gemm_tunable.best_config is not None
    ids = experts.cpu().numpy()
    nat = host_ops.moe_ag_scatter_align_block_size(ids, W, E, bm,
                                                   impl="native")
    ref = host_ops.moe_ag_scatter_align_block_size(ids, W, E, bm,
                                                   impl="numpy")
    assert all(np.array_equal(nat[k], ref[k]) for k in ref)


# ---------------------------------------------------------------------------
# The torus (multi-axis) collectives and ring GEMMs over a joint group
# ---------------------------------------------------------------------------

TORUS_MESHES = [
    # (mesh shape, axis names, the joint axes): the reference's oracle
    # meshes, a reordered tuple (joint index not the world rank), a subset
    # tuple (two groups of four)
    ((2, 4), ("x", "y"), ("x", "y")),
    ((4, 2), ("x", "y"), ("x", "y")),
    ((2, 2, 2), ("x", "y", "z"), ("x", "y", "z")),
    ((2, 4), ("x", "y"), ("y", "x")),
    ((2, 2, 2), ("x", "y", "z"), ("y", "z")),
]


def _torus_counts():
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import torus

    return (torus.torus_all_gather_shard.launches,
            torus.torus_reduce_scatter_shard.launches,
            agm.torus_ag_gemm.launches, agm.torus_ag_gemm_i8.launches,
            grs.torus_gemm_rs.launches, grs.torus_gemm_rs_i8.launches)


def _torus_moved(n0):
    return tuple(x - y for x, y in zip(_torus_counts(), n0))


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", TORUS_MESHES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_torus_collectives_match_plain(cuda, mesh_case, dtype):
    """The torus all-gather bit for bit against its plain version (rows
    256, 7 and 1 a rank), the torus reduce-scatter bit for bit against its
    plain version (the reference's torus order and rounding: rows 256, 5
    and 1 a band, rows of 128 and of 3 elements: the vector and the
    element path), one launch of each per call."""
    from triton_dist_tpu_torch.kernels import torus

    mesh = _mesh(*mesh_case[:2], cuda)
    axes = mesh_case[2]
    G = mesh.joint_size(axes)
    g = torch.Generator(device=cuda).manual_seed(5)
    for rows, row in ((256, 128), (7, 128), (1, 128), (5, 3)):
        x = torch.randn((*mesh.shape, rows, row), generator=g,
                        device=cuda).to(dtype)
        n0 = _torus_counts()
        got = torus.torus_all_gather_shard(x, mesh, axes)
        parts = torch.randn((*mesh.shape, G * rows, row), generator=g,
                            device=cuda).to(dtype)
        red = torus.torus_reduce_scatter_shard(parts, mesh, axes)
        torch.cuda.synchronize()
        assert _torus_moved(n0) == (1, 1, 0, 0, 0, 0)
        assert torch.equal(got, torus.torus_all_gather_ref(x, mesh, axes))
        assert torch.equal(red, torus.torus_reduce_scatter_ref(parts, mesh,
                                                               axes))


def _torus_gemm_close(got, want, name):
    """The bf16 GEMM rule over each rank's output and per 128-row tile."""
    _gemm_close(got, want, name)
    for r in range(got.shape[0]):
        _tile_close(got[r], want[r], 128, f"{name} rank {r}")


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", TORUS_MESHES)
@pytest.mark.parametrize("int8", [False, True])
def test_torus_ag_gemm_matches_plain(cuda, mesh_case, int8):
    """The torus AG-GEMM (``tdt_ag_gemm_torus``, and its int8 mode)
    through ``ag_gemm_shard(mesh=, axis=tuple)``: the gathered A bit for
    bit (flat axes-major), C by the bf16 rule over the whole output and
    per 128-row tile (int8: exactly equal), at m_loc 256 and 37 (a masked
    tile), and in bf16 with B^T read in place (``trans_b``: the B^T
    instance over a group) at m_loc 100 and n 272 (a ragged column tile);
    one launch of the mode's counter."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm

    mesh = _mesh(*mesh_case[:2], cuda)
    axes = mesh_case[2]
    W = mesh.size
    g = torch.Generator(device=cuda).manual_seed(6)
    shapes = [(256, 512, 256, False), (37, 256, 144, False)]
    if not int8:
        shapes.append((100, 384, 272, True))
    for m_loc, k, n, trans in shapes:
        if int8:
            a = torch.randint(-127, 128, (W, m_loc, k), generator=g,
                              device=cuda, dtype=torch.int8)
            b = torch.randint(-127, 128, (W, k, n), generator=g,
                              device=cuda, dtype=torch.int8)
        else:
            a = torch.randn((W, m_loc, k), generator=g,
                            device=cuda).bfloat16()
            b = (torch.randn((W, n, k) if trans else (W, k, n), generator=g,
                             device=cuda) / k ** 0.5).bfloat16()
        n0 = _torus_counts()
        a_full, c = agm.ag_gemm_shard(a, b, trans_b=trans, mesh=mesh,
                                      axis=axes)
        torch.cuda.synchronize()
        assert _torus_moved(n0) == ((0, 0, 0, 1, 0, 0) if int8
                                    else (0, 0, 1, 0, 0, 0))
        want_full, want_c = agm.torus_ag_gemm_ref(a, b, mesh, axes,
                                                  trans_b=trans)
        assert torch.equal(a_full, want_full)
        if int8:
            assert torch.equal(c, want_c)
        else:
            _torus_gemm_close(c, want_c, f"torus ag_gemm {mesh_case}")


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_case", TORUS_MESHES)
@pytest.mark.parametrize("int8", [False, True])
def test_torus_gemm_rs_matches_plain(cuda, mesh_case, int8):
    """The torus GEMM-RS (``tdt_gemm_rs_group`` in its torus order, and
    the int8 mode) through ``gemm_rs_shard(mesh=, axis=tuple)`` at m_loc
    256 and 16 (int8 also 1, 250 and 512): bf16 by the rule (whole and per 128-row tile) and bit for
    bit on integer-valued operands (exact partials, so only the order and
    rounding of the bf16 adds can differ); int8 exactly equal; at an
    untileable k (264) the composition (the uni kernel over the first
    axis, then the ring reduce-scatter) against its plain version."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    mesh = _mesh(*mesh_case[:2], cuda)
    axes = mesh_case[2]
    W, G = mesh.size, mesh.joint_size(axes)
    g = torch.Generator(device=cuda).manual_seed(7)
    # int8 also at m_loc 1 / 250 / 512, K % 128 != 0 and N 4,112
    shapes = ((256, 512, 512), (16, 256, 768)) + (
        ((1, 96, 4112), (250, 160, 4112), (512, 544, 1040)) if int8 else ())
    for m_loc, k, n in shapes:
        if int8:
            a = torch.randint(-127, 128, (W, G * m_loc, k), generator=g,
                              device=cuda, dtype=torch.int8)
            b = torch.randint(-127, 128, (W, k, n), generator=g,
                              device=cuda, dtype=torch.int8)
            n0 = _torus_counts()
            out = grs.gemm_rs_shard(a, b, mesh=mesh, axis=axes)
            torch.cuda.synchronize()
            assert _torus_moved(n0) == (0, 0, 0, 0, 0, 1)
            assert torch.equal(out, grs.torus_gemm_rs_ref(a, b, mesh, axes))
            continue
        a = torch.randn((W, G * m_loc, k), generator=g,
                        device=cuda).bfloat16()
        b = (torch.randn((W, k, n), generator=g, device=cuda)
             / k ** 0.5).bfloat16()
        n0 = _torus_counts()
        out = grs.gemm_rs_shard(a, b, mesh=mesh, axis=axes)
        torch.cuda.synchronize()
        assert _torus_moved(n0) == (0, 0, 0, 0, 1, 0)
        _torus_gemm_close(out, grs.torus_gemm_rs_ref(a, b, mesh, axes),
                          f"torus gemm_rs {mesh_case} m_loc {m_loc}")
        ai = torch.randint(-1, 2, a.shape, generator=g,
                           device=cuda).bfloat16()
        bi = torch.randint(-2, 3, b.shape, generator=g,
                           device=cuda).bfloat16()
        assert torch.equal(grs.gemm_rs_shard(ai, bi, mesh=mesh, axis=axes),
                           grs.torus_gemm_rs_ref(ai, bi, mesh, axes))
    if not int8:
        a = torch.randn((W, G * 128, 264), generator=g,
                        device=cuda).bfloat16()
        b = (torch.randn((W, 264, 256), generator=g, device=cuda)
             / 264 ** 0.5).bfloat16()
        n0 = _torus_counts()
        out = grs.gemm_rs_shard(a, b, mesh=mesh, axis=axes)
        torch.cuda.synchronize()
        assert _torus_moved(n0)[4] == 0
        _gemm_close(out, grs._compose(a, b, mesh, axes, False, True),
                    f"torus gemm_rs composition {mesh_case}")


@pytest.mark.gpu
def test_torus_kernels_ten_calls_in_a_row(cuda):
    """Ten calls of each torus kernel in a row on fresh inputs over the
    (2, 4) mesh, every result checked afterwards (a flag or counter left
    by an earlier call that let a wait pass early would show)."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import torus

    mesh, axes = _mesh((2, 4), ("x", "y"), cuda), ("x", "y")
    g = torch.Generator(device=cuda).manual_seed(8)
    results = []
    for i in range(10):
        x = torch.randn((2, 4, 64 if i % 2 else 5, 256), generator=g,
                        device=cuda).bfloat16()
        p = torch.randn((2, 4, 8 * 32, 256), generator=g, device=cuda)
        a = torch.randn((8, 128, 256), generator=g, device=cuda).bfloat16()
        b = (torch.randn((8, 256, 256), generator=g, device=cuda)
             / 16).bfloat16()
        a2 = torch.randn((8, 8 * 128, 256), generator=g,
                         device=cuda).bfloat16()
        results.append((x, p, a, b, a2,
                        torus.torus_all_gather_shard(x, mesh, axes),
                        torus.torus_reduce_scatter_shard(p, mesh, axes),
                        agm.ag_gemm_shard(a, b, mesh=mesh, axis=axes),
                        grs.gemm_rs_shard(a2, b, mesh=mesh, axis=axes)))
    torch.cuda.synchronize()
    for x, p, a, b, a2, ag, rs, (a_full, c), out in results:
        assert torch.equal(ag, torus.torus_all_gather_ref(x, mesh, axes))
        assert torch.equal(rs, torus.torus_reduce_scatter_ref(p, mesh, axes))
        want_full, want_c = agm.torus_ag_gemm_ref(a, b, mesh, axes)
        assert torch.equal(a_full, want_full)
        _gemm_close(c, want_c, "torus ag_gemm in a row")
        _gemm_close(out, grs.torus_gemm_rs_ref(a2, b, mesh, axes),
                    "torus gemm_rs in a row")


@pytest.mark.gpu
def test_torus_host_entries_on_the_card(cuda):
    """The host entries with a tuple axis on the card against the same
    contexts' plain versions (``plain`` / ``impl="xla"``): ``all_gather``
    (above 64 KiB a rank: the torus kernel), ``reduce_scatter``,
    ``ag_gemm_gathered``, ``gemm_rs``, and the autotuned entries (one
    torus timing each) in one ``contextual_autotune`` region."""
    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import allgather as ag
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import reduce_scatter as rs

    mesh, axes = _mesh((4, 2), ("x", "y"), cuda), ("x", "y")
    g = np.random.default_rng(9)
    x = _randn(g, (8 * 512, 128), cuda)     # 128 KiB a rank
    n0 = _torus_counts()
    got = ag.all_gather(x, ag.create_allgather_context(mesh, axis=axes))
    assert _torus_moved(n0)[0] == 1 and torch.equal(got, x)
    parts = _randn(g, (8, 8 * 64, 128), cuda)
    red = rs.reduce_scatter(parts, rs.create_reduce_scatter_context(
        mesh, axis=axes))
    _gemm_close(red, parts.float().sum(0), "host reduce_scatter", 2e-2)
    a = _randn(g, (512, 512), cuda)
    b = (_randn(g, (512, 1024), cuda).float() / 512 ** 0.5).bfloat16()
    full, c = agm.ag_gemm_gathered(a, b, agm.create_ag_gemm_context(
        mesh, axis=axes))
    assert torch.equal(full, a)
    _gemm_close(c, a.float() @ b.float(), "host torus ag_gemm")
    a2 = _randn(g, (512, 1024), cuda)
    b2 = (_randn(g, (1024, 512), cuda).float() / 1024 ** 0.5).bfloat16()
    c2 = grs.gemm_rs(a2, b2, grs.create_gemm_rs_context(mesh, axis=axes))
    _gemm_close(c2, grs.gemm_rs(a2, b2, grs.create_gemm_rs_context(
        mesh, axis=axes, impl="xla")), "host torus gemm_rs")

    @contextual_autotune(n_repeat=2, n_warmup=1)
    def op():
        return (agm.ag_gemm_autotuned(a, b, agm.create_ag_gemm_context(
            mesh, axis=axes)), grs.gemm_rs_autotuned(
                a2, b2, grs.create_gemm_rs_context(mesh, axis=axes)))

    ct, c2t = op()
    _gemm_close(ct, c, "ag_gemm_autotuned (torus)")
    _gemm_close(c2t, c2, "gemm_rs_autotuned (torus)")
    assert len(next(reversed(agm._ag_gemm_tunable.sweeps.values()))) == 1


# ---------------------------------------------------------------------------
# the serving engine's decode horizon: threefry streams and CUDA graphs
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_prng_cuda_equals_cpu(cuda):
    """The reference's threefry streams on the card: bits, uniform floats
    and categorical draws equal the CPU's; Gumbel noise too (each log in
    float64, rounded once)."""
    from triton_dist_tpu_torch.models import prng

    for seed in (0, 2**31 + 11, 2**40):
        kc, kg = prng.key(seed), prng.key(seed, cuda)
        assert torch.equal(prng.random_bits(kg, (7, 4099)).cpu(),
                           prng.random_bits(kc, (7, 4099)))
        assert torch.equal(prng.uniform(kg, (65536,)).cpu(),
                           prng.uniform(kc, (65536,)))
        idx = [0, 5, 2**31 + 1]
        rows_c = prng.fold_in(prng.keys([seed, seed + 1, 3]),
                              torch.tensor(idx))
        rows_g = prng.fold_in(prng.keys([seed, seed + 1, 3], cuda),
                              torch.tensor(idx, device=cuda))
        assert torch.equal(rows_g.cpu(), rows_c)
        gc, gg = prng.gumbel(kc, (65536,)), prng.gumbel(kg, (65536,)).cpu()
        assert torch.equal(gc, gg)
        logits = torch.randn(8, 128256, generator=torch.Generator()
                             .manual_seed(seed % 1000)) * 3
        assert torch.equal(prng.categorical(rows_g[:1].expand(8, 2),
                                            logits.to(cuda)).cpu(),
                           prng.categorical(rows_c[:1].expand(8, 2), logits))


def _tiny_serving(cuda, n_layers=2):
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import Generator

    cfg = llama.LlamaConfig(vocab=512, dim=256, n_layers=n_layers,
                            n_heads=2, n_kv_heads=1, ffn_dim=512,
                            max_seq=256, dtype=torch.bfloat16)
    params = llama.init_params(cfg, seed=4, device=cuda)
    return cfg, params, Generator(cfg, max_seq=256, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("all_greedy", [True, False])
def test_horizon_graph_replay_equals_eager(cuda, all_greedy):
    """A captured horizon rung's replay is bit-equal to the same loop run
    eagerly from the same pools and carries (tokens, masks, carries and
    every pool page), and each replay adds the decode launches its
    capture recorded to the wrapper's counter."""
    import functools

    from triton_dist_tpu_torch.models import prng
    from triton_dist_tpu_torch.runtime.jit_cache import CountingJit
    from triton_dist_tpu_torch.serve import engine as eng_mod

    cfg, params, _ = _tiny_serving(cuda)
    B, H, page, NB = 4, 8, 16, 24
    g = torch.Generator(device=cuda).manual_seed(7)
    shape = (NB, cfg.n_kv_heads, page, cfg.head_dim)
    pools0 = [tuple(torch.randn(shape, generator=g, device=cuda)
                    .to(torch.bfloat16) for _ in range(2))
              for _ in range(cfg.n_layers)]
    tables = torch.zeros((B, 16), dtype=torch.int32, device=cuda)
    tables[0, :3] = torch.tensor([1, 2, 3])
    tables[1, :4] = torch.tensor([4, 5, 6, 7])
    tables[2, :2] = torch.tensor([8, 9])
    dev = functools.partial(torch.tensor, device=cuda)
    args = (tables, dev([20, 50, 5, 0], dtype=torch.int32),
            dev([3, 17, 200, 0]), dev([True, True, True, False]),
            torch.zeros(B, dtype=torch.bool, device=cuda),
            dev([8, 6, 8, 0], dtype=torch.int32),
            dev([4, 0, 11, 0], dtype=torch.int32),
            prng.keys([0, 2**31 + 11, 2**40, 0], cuda),
            dev([1.0, 0.9, 0.7, 1.0]), dev([0, 16, 0, 0], dtype=torch.int32),
            dev([1.0, 1.0, 0.9, 1.0]),
            dev([all_greedy, False, False, True]), dev([-1, -1, -1, -1]))
    step = functools.partial(eng_mod._paged_decode_forward, cfg=cfg,
                             page=page)
    fn = CountingJit(functools.partial(eng_mod._paged_decode_horizon,
                                       decode_fwd=step), "decode_horizon",
                     graph=True, counted=(fd.gqa_decode_paged_shard,))
    pools = [tuple(x.clone() for x in layer) for layer in pools0]
    with torch.no_grad():
        eager = fn(params, pools, *args, H=H, all_greedy=all_greedy)
        eager = [x.clone() for x in eager[1:]]
        eager_pools = [tuple(x.clone() for x in layer) for layer in pools]
        for layer, layer0 in zip(pools, pools0):
            for x, x0 in zip(layer, layer0):
                x.copy_(x0)
        n0 = fd.gqa_decode_paged_shard.launches
        got = fn(params, pools, *args, H=H, all_greedy=all_greedy)
        torch.cuda.synchronize()
    assert (fn.misses, fn.hits, fn.graphs) == (1, 1, 1)
    assert fd.gqa_decode_paged_shard.launches - n0 == H * cfg.n_layers
    for w, x in zip(eager, got[1:]):
        assert torch.equal(w, x)
    for layer, layer_e in zip(pools, eager_pools):
        for x, w in zip(layer, layer_e):
            assert torch.equal(x, w)


@pytest.mark.gpu
def test_engine_horizon_and_prefix_equal_h1_on_card(cuda):
    """The engine on the card: after warmup (graphs captured, a miss
    counter that serving leaves flat), H=8 streams with the prefix cache
    on (a second wave warm) equal the H=1 engine's without it, greedy and
    sampled rows alike (the same kernels on the same shapes: bit-equal
    logits)."""
    from triton_dist_tpu_torch.serve import Request, SamplingParams
    from triton_dist_tpu_torch.serve import ServeEngine

    cfg, params, gen = _tiny_serving(cuda)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab, size=70)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, size=n)])
               for n in (9, 30, 17, 44)]

    def serve(**kw):
        eng = ServeEngine(gen, params, num_blocks=1 + 4 * 16, page_size=16,
                          max_batch=4, prefill_chunk=32, **kw)
        w = eng.warmup() if kw.get("horizon", 1) > 1 else None
        flat = eng.metrics.compile_misses
        outs = {}
        for wave in (0, 1):
            for i in (2 * wave, 2 * wave + 1):
                eng.submit(Request(f"r{i}", prompts[i], SamplingParams(
                    max_new_tokens=40, **(dict(temperature=0.9, top_k=50,
                                               seed=2**40 + i)
                                          if i % 2 else {}))))
            outs.update(eng.run())
        return eng, w, flat, {r: o.token_ids for r, o in outs.items()}

    with torch.no_grad():
        _, _, _, want = serve(horizon=1, prefix_cache=False)
        eng, w, flat, got = serve(horizon=8, pipeline=2)
    assert w["graphs"] > 0
    assert eng.metrics.compile_misses == flat
    assert eng.metrics.prefix_hits >= 2
    assert got == want


@pytest.mark.gpu
def test_counting_jit_refuses_mixed_devices(cuda):
    """``graph=True`` captures only where every tensor lies on the card: a
    call that mixes card and CPU tensors raises (naming the leaf) instead
    of running uncaptured; an all-CPU call runs eagerly; an all-card call
    captures at its miss and replays at its hit."""
    from triton_dist_tpu_torch.runtime.jit_cache import CountingJit

    fn = CountingJit(lambda a, b: a + b, "add", graph=True)
    with pytest.raises(ValueError, match="leaf 1"):
        fn(torch.ones(4, device=cuda), torch.ones(4))
    assert torch.equal(fn(torch.ones(4), torch.ones(4)), torch.full((4,), 2.))
    assert (fn.misses, fn.graphs) == (1, 0)
    two = torch.full((4,), 2.)
    out = fn(torch.ones(4, device=cuda), torch.ones(4, device=cuda))
    assert (fn.misses, fn.graphs) == (2, 1) and torch.equal(out.cpu(), two)
    out = fn(torch.ones(4, device=cuda), torch.full((4,), 2., device=cuda))
    assert (fn.hits, fn.graphs) == (1, 1)
    assert torch.equal(out.cpu(), torch.full((4,), 3.))


@pytest.mark.gpu
def test_generate_onchip_keeps_states_apart_on_card(cuda):
    """Two prefilled states of one shape through one generate_onchip
    program on the card: each gives generate's tokens, and the second
    call leaves the first state as its own call left it."""
    cfg, params, gen = _tiny_serving(cuda)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, size=(2, 20)) for _ in range(2)]

    def flat(st):
        return [x.clone() for layer in st.caches for x in layer] + [
            st.kv_lens.clone(), st.last_logits.clone()]

    with torch.no_grad():
        want = [gen.generate(params, gen.prefill(params, p), 12)[0]
                for p in prompts]
        toks_a, st_a = gen.generate_onchip(params,
                                           gen.prefill(params, prompts[0]),
                                           12)
        kept = flat(st_a)
        toks_b, _ = gen.generate_onchip(params,
                                        gen.prefill(params, prompts[1]), 12)
    assert torch.equal(toks_a, want[0]) and torch.equal(toks_b, want[1])
    assert all(torch.equal(x, y) for x, y in zip(flat(st_a), kept))


@pytest.mark.gpu
@pytest.mark.parametrize("horizon", [1, 8])
def test_cow_split_on_shared_tail_on_card(cuda, horizon):
    """Copy-on-write on the card: a running request cloned mid-page with
    its block table shared whole (the overlapping tables a beam fork or a
    restored snapshot gives; no engine entry point shares such a page
    yet) splits the tail page before either row writes it, and both
    streams continue as the uninterrupted one."""
    import dataclasses

    from triton_dist_tpu_torch.serve import Request, SamplingParams
    from triton_dist_tpu_torch.serve import ServeEngine
    from triton_dist_tpu_torch.serve.scheduler import Status

    cfg, params, gen = _tiny_serving(cuda)
    prompt = np.random.default_rng(9).integers(0, cfg.vocab, size=37)

    def engine():
        return ServeEngine(gen, params, num_blocks=1 + 2 * 16, page_size=16,
                           max_batch=2, prefill_chunk=32, horizon=horizon)

    with torch.no_grad():
        ref = engine()
        ref.submit(Request("r1", prompt, SamplingParams(max_new_tokens=24)))
        want = ref.run()["r1"].token_ids
        eng = engine()
        eng.submit(Request("r1", prompt, SamplingParams(max_new_tokens=24)))
        rs = eng._states["r1"]
        while rs.status is not Status.RUNNING or rs.kv_len % 16 == 0:
            eng.step()
        slot = eng.slots.index(None)
        clone = dataclasses.replace(
            rs, req=dataclasses.replace(rs.req, request_id="r2"), slot=slot,
            generated=list(rs.generated), seq=rs.seq + 1000,
            metrics=dataclasses.replace(
                rs.metrics, token_times=list(rs.metrics.token_times)))
        eng.bm.share("r2", eng.bm.table("r1"))
        eng.slots[slot] = clone
        eng._states["r2"] = clone
        outs = eng.run()
    assert outs["r1"].token_ids == want and outs["r2"].token_ids == want
    assert eng.bm.cow_copies >= 1
    assert eng.bm.num_free == eng.bm.num_allocatable


# ---------------------------------------------------------------------------
# the int8 bidir GEMM-RS (row 15bi) and speculative serving
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(4, 128, 512, 256), (2, 37, 256, 512),
                                  (4, 16, 1024, 1024), (4, 250, 512, 768),
                                  (2, 1, 96, 4096), (4, 512, 544, 4096),
                                  (8, 250, 160, 4096), (8, 16, 1056, 2048)])
def test_gemm_rs_i8_bidir_matches_plain(cuda, case):
    """The int8 mode of the bidir ring (``tdt_gemm_rs_bidir_i8``): int32
    C exactly equal to the plain version at worlds 2, 4 and 8 (m_loc 1 /
    16 / 250 / 512, K % 128 != 0, several tiles a half), ten calls in a
    row at the first case (stale landing slots or flags would show); one
    launch of its counter each."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    assert grs.gemm_rs_schedule(world, n, "bidir") == "bidir"
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr(case).encode()))
    calls = 10 if case == (4, 128, 512, 256) else 1
    results = []
    n0 = _mode_counts()
    for _ in range(calls):
        a = torch.randint(-127, 128, (world, world * m_loc, k), generator=g,
                          device=cuda, dtype=torch.int8)
        b = torch.randint(-127, 128, (world, k, n), generator=g,
                          device=cuda, dtype=torch.int8)
        results.append((a, b, grs.gemm_rs_shard(a, b, ring_mode="bidir")))
    torch.cuda.synchronize()
    assert _moved(n0) == {"rs_i8_bidir": calls}
    for a, b, out in results:
        assert out.dtype == torch.int32
        assert torch.equal(out, grs.gemm_rs_ref(a, b, ring_mode="bidir"))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 250, 96, 4128), (4, 1, 160, 4128),
                                  (8, 512, 544, 4160)])
def test_gemm_rs_i8_bidir_kernel_at_ragged_halves(cuda, case):
    """The int8 bidir kernel at an N whose halves are no multiple of 128
    (N % 32 == 0, which the host entries give to the uni schedule), called
    directly: int32 C exactly equal to the plain version."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    world, m_loc, k, n = case
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr(case).encode()))
    a = torch.randint(-127, 128, (world, world * m_loc, k), generator=g,
                      device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (world, k, n), generator=g, device=cuda,
                      dtype=torch.int8)
    out = grs._bidir_i8(a, b, m_loc, n)
    torch.cuda.synchronize()
    assert torch.equal(out, grs.gemm_rs_ref(a, b))


@pytest.mark.gpu
def test_gemm_rs_i8_ten_calls_in_a_row(cuda):
    """Ten int8 GEMM-RS calls in a row on new inputs, the uni kernel, the
    bidir ring and the group kernel over the torus of (2, 4) in turn, each
    checked after all were queued: a flag, a staged tile or a landing slot
    left by an earlier call (its epoch reused) would show."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    mesh = _mesh((2, 4), ("dcn", "tp"), cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    results = []
    for i in range(10):
        kind = ("uni", "bidir", "torus")[i % 3]
        world = 8 if kind == "torus" else 4
        a = torch.randint(-127, 128, (world, world * 256, 544), generator=g,
                          device=cuda, dtype=torch.int8)
        b = torch.randint(-127, 128, (world, 544, 2048), generator=g,
                          device=cuda, dtype=torch.int8)
        if kind == "torus":
            out = grs.torus_gemm_rs_i8(a, b, mesh, ("dcn", "tp"))
        else:
            out = grs.gemm_rs_shard(a, b, ring_mode=kind)
        results.append((kind, a, b, out))
    torch.cuda.synchronize()
    for kind, a, b, out in results:
        want = (grs.torus_gemm_rs_ref(a, b, mesh, ("dcn", "tp"))
                if kind == "torus" else grs.gemm_rs_ref(a, b))
        assert torch.equal(out, want), kind


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["tp", "dcn"])
@pytest.mark.parametrize("m_loc", [256, 250, 16])
def test_gemm_rs_i8_group_over_one_axis(cuda, axis, m_loc):
    """The int8 group kernel (``tdt_gemm_rs_group_i8``) over one axis of a
    (2, 4) mesh, G 4 ranks one apart or G 2 four apart, at N 4,112 and K
    544: int32 C exactly equal to the plain version."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    mesh = _mesh((2, 4), ("dcn", "tp"), cuda)
    G = mesh.axis_size(axis)
    g = torch.Generator(device=cuda).manual_seed(zlib.crc32(
        repr((axis, m_loc)).encode()))
    a = torch.randint(-127, 128, (8, G * m_loc, 544), generator=g,
                      device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (8, 544, 4112), generator=g, device=cuda,
                      dtype=torch.int8)
    n0 = grs.torus_gemm_rs_i8.launches
    out = grs.torus_gemm_rs_i8(a, b, mesh, (axis,))
    torch.cuda.synchronize()
    assert grs.torus_gemm_rs_i8.launches == n0 + 1
    assert torch.equal(out, grs.torus_gemm_rs_ref(a, b, mesh, (axis,)))


@pytest.mark.gpu
def test_gemm_rs_i8_refuses_non_tma_operands(cuda):
    """The int8 kernels read by TMA: an operand whose base is not 16-byte
    aligned raises before any launch, in the uni, bidir and group
    modes."""
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs

    buf = torch.zeros(4 * 512 * 256 + 1, dtype=torch.int8, device=cuda)
    a = buf[1:].view(4, 512, 256)
    b = torch.zeros(4, 256, 256, dtype=torch.int8, device=cuda)
    mesh = _mesh((4,), ("tp",), cuda)
    n0 = (_mode_counts(), grs.torus_gemm_rs_i8.launches)
    for call in (lambda: grs.gemm_rs_shard(a, b),
                 lambda: grs.gemm_rs_shard(a, b, ring_mode="bidir"),
                 lambda: grs.torus_gemm_rs_i8(a, b, mesh, ("tp",))):
        with pytest.raises(ValueError, match="TMA"):
            call()
    assert (_mode_counts(), grs.torus_gemm_rs_i8.launches) == n0


@pytest.mark.gpu
def test_gemm_rs_autotuned_int8_times_bidir(cuda):
    """``gemm_rs_autotuned`` on int8 operands times the bidir config
    (the card no longer refuses it) beside the uni one, and its result
    equals the plain version exactly."""
    from triton_dist_tpu_torch.autotuner import contextual_autotune
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.runtime.bootstrap import Mesh

    mesh = Mesh((4,), ("tp",), cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-127, 128, (512, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (1024, 512), generator=g, device=cuda,
                      dtype=torch.int8)

    @contextual_autotune()
    def op(x, w):
        return grs.gemm_rs_autotuned(x, w, grs.create_gemm_rs_context(mesh))

    out = op(a, b)
    torch.cuda.synchronize()
    key = next(k for k in reversed(grs._gemm_rs_tunable.sweeps)
               if any("torch.int8" in str(x) for x in k))
    modes = {c.get("ring_mode") for c, _ in grs._gemm_rs_tunable.sweeps[key]}
    assert modes == {"uni", "bidir"}
    assert torch.equal(out, grs.gemm_rs(a, b, grs.create_gemm_rs_context(
        mesh, impl="xla")))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [5, 32])
def test_paged_verify_forward_matches_plain(cuda, T, monkeypatch):
    """``engine._paged_verify_forward`` at T queries a row (three live
    rows at lengths 20, 47 and 100, one dead row): every attention call
    of the path (one paged decode launch each) against the plain paged
    decode on the same inputs within the kernels' bf16 tolerance on the
    live rows, the rows it writes landing in the rows' pages, and the
    logits against the same forward with the plain attention (relative
    max error <= 2e-2)."""
    from triton_dist_tpu_torch.serve import engine as eng_mod

    cfg, params, _ = _tiny_serving(cuda)
    B, page, NB = 4, 16, 40
    g = torch.Generator(device=cuda).manual_seed(T)
    shape = (NB, cfg.n_kv_heads, page, cfg.head_dim)
    pools0 = [tuple(torch.randn(shape, generator=g, device=cuda)
                    .to(torch.bfloat16) for _ in range(2))
              for _ in range(cfg.n_layers)]
    tables = torch.zeros((B, 16), dtype=torch.int32, device=cuda)
    tables[0, :4] = torch.tensor([1, 2, 3, 4])
    tables[1, :6] = torch.tensor([5, 6, 7, 8, 9, 10])
    tables[2, :9] = torch.arange(11, 20)
    lens = torch.tensor([20, 47, 100, 0], dtype=torch.int32, device=cuda)
    active = torch.tensor([True, True, True, False], device=cuda)
    chunk = torch.randint(0, cfg.vocab, (B, T), generator=g, device=cuda)
    live = active.cpu().numpy()
    errs = []
    real = eng_mod.gqa_decode_paged_shard

    def spy(q, kp, vp, table, local_lens, **kw):
        out = real(q, kp, vp, table, local_lens, **kw)
        ref, _ = fd.decode_paged_ref(q, kp, vp, table, local_lens, **kw)
        errs.append((out[0][live].float() - ref[live]).abs().max().item())
        return out

    def plain(q, kp, vp, table, local_lens, **kw):
        out, lse = fd.decode_paged_ref(q, kp, vp, table, local_lens, **kw)
        return out.to(q.dtype), lse

    def run(attn):
        monkeypatch.setattr(eng_mod, "gqa_decode_paged_shard", attn)
        pools = [tuple(x.clone() for x in layer) for layer in pools0]
        with torch.no_grad():
            pools, logits = eng_mod._paged_verify_forward(
                params, pools, tables, lens, chunk, active, cfg=cfg,
                page=page)
        torch.cuda.synchronize()
        return pools, logits

    n0 = fd.gqa_decode_paged_shard.launches
    pools, got = run(spy)
    assert fd.gqa_decode_paged_shard.launches - n0 == cfg.n_layers
    assert len(errs) == cfg.n_layers and max(errs) <= OUT_TOL, errs
    pools_p, want = run(plain)
    # layer 0's K/V rows do not depend on attention: equal bit for bit,
    # past the null block 0 (the dead row's T writes all land on its row
    # 0, in no defined order)
    for x, y in zip(pools[0], pools_p[0]):
        assert torch.equal(x[1:], y[1:])
    k0 = pools[0][0]
    for b in range(3):
        for t in range(T):
            p = int(lens[b]) + t
            row = int(tables[b, p // page])
            assert not torch.equal(k0[row, :, p % page],
                                   pools0[0][0][row, :, p % page])
    err = (got[:3] - want[:3]).abs().max().item()
    assert err <= 2e-2 * want[:3].abs().max().item(), err


@pytest.mark.gpu
def test_spec_fused_round_equals_unfused_on_card(cuda):
    """Speculative serving on the card: the fused round (k ladder
    captured by warmup, one CUDA graph a rung and sampler, serving adding
    no miss) and the unfused round give the same greedy streams (the
    same kernels on the same shapes), for a self-draft (acceptance 1)
    and a small independent draft."""
    from triton_dist_tpu_torch.models import llama
    from triton_dist_tpu_torch.models.generate import Generator
    from triton_dist_tpu_torch.serve import Request, SamplingParams
    from triton_dist_tpu_torch.serve import ServeEngine

    cfg, params, gen = _tiny_serving(cuda)
    dcfg = llama.LlamaConfig(vocab=512, dim=128, n_layers=1, n_heads=1,
                             n_kv_heads=1, ffn_dim=256, max_seq=256,
                             dtype=torch.bfloat16)
    dparams = llama.init_params(dcfg, seed=5, device=cuda)
    draft = Generator(dcfg, max_seq=256, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (9, 40, 77)]

    def serve(draft, dparams, fused):
        eng = ServeEngine(gen, params, num_blocks=1 + 3 * 16, page_size=16,
                          max_batch=3, prefill_chunk=32, draft=draft,
                          draft_params=dparams, spec_k=4, spec_fused=fused)
        w = eng.warmup()
        flat = eng.metrics.compile_misses
        for i, p in enumerate(prompts):
            eng.submit(Request(f"r{i}", p, SamplingParams(
                max_new_tokens=30)))
        outs = eng.run()
        return eng, w, flat, {r: o.token_ids for r, o in outs.items()}

    with torch.no_grad():
        for d, dp in ((gen, params), (draft, dparams)):
            eng, w, flat, got = serve(d, dp, True)
            _, _, _, want = serve(d, dp, False)
            assert got == want
            assert w["programs"] > 0 and eng._spec_fused_fn.graphs > 0
            assert eng.metrics.compile_misses == flat
            assert eng.metrics.spec_rounds > 0
            if d is gen:
                assert eng.metrics.spec_stats()["accept_rate"] > 0.9
