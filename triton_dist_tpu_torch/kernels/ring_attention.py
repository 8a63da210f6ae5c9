"""Ring attention: training-side context parallelism.

Counterpart of ``triton_dist_tpu/kernels/ring_attention.py``.  Q/K/V stay
sequence-sharded over the ranks of a virtual world (``runtime/
bootstrap.World``), KV blocks rotate round the ring, and every rank folds
each block into a running online-softmax accumulator.  Tensors carry the
leading rank dimension: q [W, S_loc, B, Hq, hd], k/v [W, S_loc, B, Hkv,
hd]; rank r's shard is ``x[r]``, at the global positions
:func:`_shard_starts` gives (one contiguous run, or the zigzag pair of
chunks r and 2W - 1 - r).

The algorithms keep the reference's choice under the port's names:

- ``impl="flash"`` (the reference's ``"flash"``): the flash ring.  Each
  ring step is one call of the flash kernels (``kernels/
  flash_attention.py``) with the W ranks folded into the batch, each rank
  at its own offsets (their segmented mode under zigzag), and the steps'
  partials merged by log-sum-exp; the backward is the reverse ring over
  the flash backward kernels against the global lse, in f32, the dk/dv
  accumulators rotating with their blocks and taking one final hop home.
- ``impl="fused"`` (the reference's ``"pallas"``): the hand-written
  fused kernel ``csrc/ring_attn.cu`` (:func:`ring_attn`, the port of the
  TPU ``_ring_attn_kernel``): one cooperative launch over the W ranks,
  the KV blocks travelling a ring of slots in the symmetric workspace.
  Its backward is the reference's: the VJP of the dense ring, recomputed
  inside the backward (torch ops; the reference leaves it to XLA).
- ``impl="auto"``: ``"flash"`` where :func:`flash_attention.
  flash_shapes_ok` holds for the shard's runs, else ``"fused"``
  (reference :637-646); an explicit ``"flash"`` on an illegal shape
  raises.
- ``plain=True`` (the reference's ``"xla"``): the dense ring
  :func:`_ring_attention_dense`, differentiated by autograd op by op: the
  plain version of both kernels' algorithms.

On CPU tensors the flash ring's kernels and :func:`ring_attn` run their
plain versions (``flash_attention_ref`` and the dense ring).  The ring's
rotation is XLA's ``ppermute`` in the reference, not a Pallas kernel; here
it is ``torch.roll`` of the rank-stacked tensor, and no kernel is owed.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.flash_attention import (
    apply_soft_cap,
    bwd_delta,
    flash_attention,
    flash_attention_bwd,
    flash_shapes_ok,
)
from triton_dist_tpu_torch.runtime.bootstrap import (
    MAX_RANKS,
    World,
    get_world,
)
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

_NEG = -1e30
IMPLS = ("auto", "flash", "fused")
RING_CHUNK_BYTES = 1 << 16   # K rows a copy item moves before it signals

RING_BM = 128   # folded q rows per compute item (csrc/ring_attn.cu BM)
RING_BN = 128   # keys per K / V tile (csrc/ring_attn.cu BN)

_SIG = {"tdt_ring_attn": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
        + [ctypes.c_float] * 2 + [ctypes.c_uint, ctypes.c_void_p]}


class RingShapeError(ValueError):
    """An explicit ``impl="flash"`` on a shape the flash ring does not
    take (the reference's ``PallasShapeError``)."""


@dataclass
class RingAttentionContext:
    """Counterpart of the reference's context: the world the sequence is
    sharded over and the attention's options (``plain`` for the
    reference's ``impl="xla"``)."""

    world: World
    axis: str = "sp"
    causal: bool = True
    impl: str = "auto"
    plain: bool = False
    window: int = 0
    soft_cap: float = 0.0
    zigzag: bool = False

    @property
    def size(self) -> int:
        """The number of ranks (the reference's ``ctx.world``)."""
        return self.world.size


def create_ring_attention_context(world, axis="sp", causal=True,
                                  impl="auto", window=0, soft_cap=0.0,
                                  zigzag=False, *, device=None,
                                  plain=False) -> RingAttentionContext:
    """The context over ``world``: a :class:`World`, or a rank count (the
    world of that size on ``device``, made on first use)."""
    if not isinstance(world, World):
        world = get_world(int(world), device)
    return RingAttentionContext(world=world, axis=axis, causal=causal,
                                impl=impl, plain=plain, window=window,
                                soft_cap=soft_cap, zigzag=zigzag)


# ---------------------------------------------------------------------------
# Positions, permutations, the dense ring
# ---------------------------------------------------------------------------


def _seg_positions(starts, idx, total):
    """Global positions for row indices ``idx`` of an axis made of
    len(starts) equal runs (starts: ints, or tensors that broadcast
    against ``idx``, such as one [W, 1] column per run)."""
    starts = starts if isinstance(starts, (tuple, list)) else (starts,)
    run = total // len(starts)
    pos = starts[0] + idx
    for t in range(1, len(starts)):
        pos = torch.where(idx >= t * run, starts[t] + (idx - t * run), pos)
    return pos


def _ring_perm(world):
    """The one ring direction: rank i -> i + 1 (``torch.roll(x, 1, 0)`` of
    a rank-stacked tensor)."""
    return [(i, (i + 1) % world) for i in range(world)]


def _shard_starts(rank, s_loc, world, zigzag):
    """Run starts of ``rank``'s sequence shard: one contiguous run, or the
    zigzag pair, chunks ``rank`` and ``2w - 1 - rank`` of length s_loc/2.
    ``rank`` may be a tensor (the entries then are)."""
    if not zigzag:
        return (rank * s_loc,)
    c = s_loc // 2
    return (rank * c, (2 * world - 1 - rank) * c)


def zigzag_indices(S, world):
    """Global row permutation of the zigzag layout: position p of the
    returned int32 array names the natural-order row that lands at p when
    the shards are laid out [shard0 | shard1 | ...], shard i = [chunk i |
    chunk 2w-1-i]."""
    c = S // (2 * world)
    if 2 * world * c != S:
        raise ValueError(f"zigzag needs S % (2*world) == 0, got S={S}, "
                         f"world={world}")
    idx = []
    for i in range(world):
        idx.extend(range(i * c, (i + 1) * c))
        j = 2 * world - 1 - i
        idx.extend(range(j * c, (j + 1) * c))
    return np.asarray(idx, np.int32)


def to_zigzag(x, world, axis=0):
    """Re-order a natural-order global tensor for zigzag sharding."""
    idx = torch.as_tensor(zigzag_indices(x.shape[axis], world),
                          dtype=torch.long, device=x.device)
    return torch.index_select(x, axis, idx)


def from_zigzag(x, world, axis=0):
    """Inverse of :func:`to_zigzag`."""
    inv = np.argsort(zigzag_indices(x.shape[axis], world))
    idx = torch.as_tensor(inv, dtype=torch.long, device=x.device)
    return torch.index_select(x, axis, idx)


def _src_rank(me, s, world):
    """Owner of the block rank ``me`` consumes at ring step ``s``."""
    return (me - s + world) % world


def _block_update(q, k_blk, v_blk, m, l, acc, q_off, k_off, *, causal,
                  scale, group, window=0, soft_cap=0.0):
    """One online-softmax fold of a KV block into the running stats, for
    every rank at once.  Grouped layout, rank leading: q [W, G, Sq, hd]
    with G = B * Hq; k/v [W, Gk, Sk, hd] (G = group * Gk); m/l [W, G, Sq]
    and acc [W, G, Sq, hd] f32; q_off/k_off: each rank's run starts (a
    tuple of [W, 1] tensors).  Returns the updated (m, l, acc): the
    reference's ``_block_update``, P rounded to q's dtype before P V."""
    kr = k_blk.repeat_interleave(group, dim=1).float()
    vr = v_blk.repeat_interleave(group, dim=1)
    logits = torch.einsum("wgsd,wgtd->wgst", q.float(), kr) * scale
    logits = apply_soft_cap(logits, soft_cap)
    mask = None
    if causal or window:
        sq, sk = q.shape[2], k_blk.shape[2]
        dev = q.device
        qpos = _seg_positions(q_off, torch.arange(sq, device=dev), sq)
        kpos = _seg_positions(k_off, torch.arange(sk, device=dev), sk)
        rows, cols = qpos[:, :, None], kpos[:, None, :]
        if causal and window:
            mask = (rows >= cols) & (rows - cols < window)
        elif causal:
            mask = rows >= cols
        else:
            mask = rows - cols < window
        mask = mask[:, None]
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    rescale = torch.exp(torch.clamp(m - m_new, max=0.0))
    l_new = l * rescale + p.sum(dim=-1)
    acc_new = acc * rescale[..., None] + torch.einsum(
        "wgst,wgtd->wgsd", p.to(q.dtype).float(), vr.float())
    return m_new, l_new, acc_new


def _grouped(x):
    """[W, S, B, H, hd] -> [W, B * H, S, hd]."""
    w, s, b, h, hd = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(w, b * h, s, hd)


def _ring_attention_dense(q, k, v, *, causal, scale, window=0, soft_cap=0.0,
                          zigzag=False):
    """The plain version (the reference's ``_ring_attention_xla``): a
    dense block update per ring step ([W, B Hq, S_loc, S_loc] logits),
    the blocks rolled one rank round the ring between steps.  Returns
    [W, S_loc, B, Hq, hd] in q's dtype; differentiable op by op."""
    world, s_loc, b, hq, hd = q.shape
    group = hq // k.shape[3]
    ranks = torch.arange(world, device=q.device)[:, None]
    q_off = _shard_starts(ranks, s_loc, world, zigzag)
    kw = dict(causal=causal, scale=scale, group=group, window=window,
              soft_cap=soft_cap)
    qg, k_blk, v_blk = _grouped(q), _grouped(k), _grouped(v)
    m = torch.full(qg.shape[:3], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    m, l, acc = _block_update(qg, k_blk, v_blk, m, l, acc, q_off, q_off,
                              **kw)
    for s in range(1, world):
        k_blk = torch.roll(k_blk, 1, 0)
        v_blk = torch.roll(v_blk, 1, 0)
        src = _src_rank(ranks, s, world)
        m, l, acc = _block_update(qg, k_blk, v_blk, m, l, acc, q_off,
                                  _shard_starts(src, s_loc, world, zigzag),
                                  **kw)
    out = acc / l.clamp_min(1e-30)[..., None]
    return (out.reshape(world, b, hq, s_loc, hd).permute(0, 3, 1, 2, 4)
            .to(q.dtype))


def _merge_partial(acc, denom, m_run, o_j, l_j):
    """Fold one normalized partial (o_j, lse_j) into the running (acc,
    denom, m_run): out = acc / denom, lse = m_run + log(denom).  Dead
    partials (lse NEG) are exact no-ops."""
    m = torch.maximum(m_run, l_j)
    r1 = torch.exp(m_run - m)
    r2 = torch.exp(l_j - m)
    acc = acc * r1[..., None] + o_j.float() * r2[..., None]
    return acc, denom * r1 + r2, m


# ---------------------------------------------------------------------------
# The flash ring: the flash kernels per step, the ranks folded into the
# batch (one launch per step for every rank)
# ---------------------------------------------------------------------------


def _fold(x):
    """[W, S, B, H, hd] -> [W * B, H, S, hd] (a view when B is 1)."""
    w, s, b, h, hd = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(w * b, h, s, hd)


def _unfold(x, world):
    """[W * B, H, S, hd] -> [W, S, B, H, hd] (a view)."""
    wb, h, s, hd = x.shape
    return x.reshape(world, wb // world, h, s, hd).permute(0, 3, 1, 2, 4)


def _fold_starts(world, b, s_loc, zigzag, step):
    """The per-batch-row run starts of the folded batch at ring step
    ``step``: row r * B + j holds the block of rank r - step."""
    return tuple(_shard_starts(_src_rank(r, step, world), s_loc, world,
                               zigzag)
                 for r in range(world) for _ in range(b))


def _ring_attention_flash_fwd(q, k, v, *, causal, scale, window=0,
                              soft_cap=0.0, zigzag=False):
    """(out [W, S_loc, B, Hq, hd] in q's dtype, lse [W * B, Hq, S_loc]
    f32): one flash call per ring step over every rank (each at its own
    q and kv offsets), the partials merged by log-sum-exp."""
    world, s_loc, b = q.shape[:3]
    q4, k_blk, v_blk = _fold(q), _fold(k), _fold(v)
    q_rows = _fold_starts(world, b, s_loc, zigzag, 0)
    kw = dict(causal=causal, scale=scale, window=window, soft_cap=soft_cap,
              return_lse=True)
    o0, l0 = flash_attention(q4, k_blk, v_blk, q_offset=q_rows,
                             kv_offset=q_rows, **kw)
    acc, denom, m_run = o0.float(), torch.ones_like(l0), l0
    for s in range(1, world):
        k_blk = torch.roll(k_blk, b, 0)
        v_blk = torch.roll(v_blk, b, 0)
        o_j, l_j = flash_attention(
            q4, k_blk, v_blk, q_offset=q_rows,
            kv_offset=_fold_starts(world, b, s_loc, zigzag, s), **kw)
        acc, denom, m_run = _merge_partial(acc, denom, m_run, o_j, l_j)
    out4 = (acc / denom[..., None]).to(q.dtype)
    return _unfold(out4, world), m_run + torch.log(denom)


def _ring_attention_flash_bwd(q, k, v, out, lse, do, *, causal, scale,
                              window=0, soft_cap=0.0, zigzag=False):
    """The reverse ring: per visiting block the flash backward kernels
    against the GLOBAL lse, f32 per-block gradients; dk/dv accumulators
    rotate with their blocks and take one final hop home."""
    world, s_loc, b = q.shape[:3]
    q4, k_blk, v_blk = _fold(q), _fold(k), _fold(v)
    out4, do4 = _fold(out), _fold(do)
    q_rows = _fold_starts(world, b, s_loc, zigzag, 0)
    kw = dict(causal=causal, scale=scale, window=window, soft_cap=soft_cap,
              grad_dtype=torch.float32,
              delta=bwd_delta(out4, do4) if q.is_cuda else None)
    dq, dk_blk, dv_blk = flash_attention_bwd(
        q4, k_blk, v_blk, out4, lse, do4, q_offset=q_rows, kv_offset=q_rows,
        **kw)
    for s in range(1, world):
        k_blk = torch.roll(k_blk, b, 0)
        v_blk = torch.roll(v_blk, b, 0)
        dk_blk = torch.roll(dk_blk, b, 0)
        dv_blk = torch.roll(dv_blk, b, 0)
        dq_c, dk_c, dv_c = flash_attention_bwd(
            q4, k_blk, v_blk, out4, lse, do4, q_offset=q_rows,
            kv_offset=_fold_starts(world, b, s_loc, zigzag, s), **kw)
        dq += dq_c
        dk_blk += dk_c
        dv_blk += dv_c
    if world > 1:
        # after W - 1 rotations rank r holds rank r + 1's block gradients
        dk_blk = torch.roll(dk_blk, b, 0)
        dv_blk = torch.roll(dv_blk, b, 0)
    return (_unfold(dq, world).to(q.dtype),
            _unfold(dk_blk, world).to(k.dtype),
            _unfold(dv_blk, world).to(v.dtype))


class RingFlashFn(torch.autograd.Function):
    """The flash ring under autograd (the reference's custom VJP with
    ``impl="flash"``): saves (q, k, v, out, lse); the backward is the
    reverse ring over the flash backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _ring_attention_flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_attention_flash_bwd(q, k, v, out, lse, dout,
                                           **ctx.kw), None)


class RingFusedFn(torch.autograd.Function):
    """The fused kernel under autograd (the reference's custom VJP with
    ``impl="pallas"``): the forward is :func:`ring_attn`; the backward is
    the VJP of the dense ring on the saved (q, k, v), recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        ctx.save_for_backward(q, k, v)
        ctx.kw = kw
        return ring_attn(q, k, v, **kw)

    @staticmethod
    def backward(ctx, dout):
        prim = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _ring_attention_dense(*prim, **ctx.kw)
        return (*torch.autograd.grad(out, prim, dout), None)


# ---------------------------------------------------------------------------
# The fused kernel (csrc/ring_attn.cu)
# ---------------------------------------------------------------------------


def _check_ring_operand(name, x, shape):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ring_attn kernel: {name} must be bf16, got "
                        f"{x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"ring_attn: {name} {tuple(x.shape)} != "
                         f"{tuple(shape)}")
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            st % 8 for st in x.stride()[:-1]):
        raise ValueError(f"ring_attn kernel: {name} needs a unit last "
                         f"stride and 16-byte aligned rows (strides "
                         f"{tuple(x.stride())})")


def _ring_item_costs(world, s_loc, group, *, causal, window, zigzag):
    """[world, n_qt] int64: each q tile's count of live K / V tiles over
    the W ring steps, in the kernel's tiling (``RING_BM`` folded rows, so
    ``RING_BM // group`` positions, against ``RING_BN`` keys), by the
    reference's ``_block_live`` rule on each tile's first and last
    positions (the rule the kernel's walk applies)."""
    bq = RING_BM // group

    def ends(rank, size):
        # first / last global positions of each tile of `size` rows
        first = torch.arange(0, s_loc, size)
        last = torch.clamp(first + size, max=s_loc) - 1
        starts = _shard_starts(rank, s_loc, world, zigzag)
        return (_seg_positions(starts, first, s_loc),
                _seg_positions(starts, last, s_loc))

    cost = []
    for me in range(world):
        qf, ql = (x[:, None] for x in ends(me, bq))
        n = 0
        for s in range(world):
            kf, kl = (x[None, :] for x in ends(_src_rank(me, s, world),
                                               RING_BN))
            live = torch.ones(qf.shape[0], kf.shape[1], dtype=torch.bool)
            if causal:
                live &= kf <= ql
            if window:
                live &= kl > qf - window
            n = n + live.sum(1)
        cost.append(n)
    return torch.stack(cost).numpy()


def _ring_items(world, s_loc, bh, group, n_rc, *, causal, window, zigzag):
    """The kernel's one item list over every folded rank: (items [n, 4]
    int32, n_copy, costs [n] int64).  Copy items (s, rank, pair, chunk)
    come first, step by step and rank by rank, so every copy waits only on
    a lower index (the left rank's copy of the step before); then the
    compute items (0, rank, pair, q tile), heaviest first by their live
    tile count (``_ring_item_costs``; ties in (rank, pair, tile) order).
    Copy items cost 0."""
    steps = np.arange(1, world)
    ranks, pairs, chunks = np.arange(world), np.arange(bh), np.arange(n_rc)
    copy = np.stack([g.ravel() for g in np.meshgrid(
        steps, ranks, pairs, chunks, indexing="ij")], 1)
    cost = _ring_item_costs(world, s_loc, group, causal=causal,
                            window=window, zigzag=zigzag)
    n_qt = cost.shape[1]
    r, p, t = (g.ravel() for g in np.meshgrid(
        ranks, pairs, np.arange(n_qt), indexing="ij"))
    comp = np.stack([np.zeros_like(r), r, p, t], 1)
    comp_cost = cost[r, t]
    order = np.argsort(-comp_cost, kind="stable")
    items = np.concatenate([copy.reshape(-1, 4), comp[order]]).astype(
        np.int32)
    costs = np.concatenate([np.zeros(len(copy), np.int64),
                            comp_cost[order]])
    return items, len(copy), costs


def _ring_plan(ws, bh, s_loc, hd, *, group, causal, window, zigzag):
    """What a call at this shape keeps from call to call, made once and
    held in the workspace: (chunk_rows, n_rc, the pointer tables of the K
    and V slots, the arrival flags and the barrier slots, the item list
    [n, 4] int32 on the workspace's device, n_copy)."""
    key = ("ring_attn", bh, s_loc, hd, group, bool(causal), int(window),
           bool(zigzag))
    plan = ws.plans.get(key)
    if plan is None:
        world = ws.world.size
        chunk_rows = max(1, RING_CHUNK_BYTES // (hd * 2))
        n_rc = -(-s_loc // chunk_rows)
        if n_rc > 128:
            chunk_rows = -(-s_loc // 128)
            n_rc = -(-s_loc // chunk_rows)
        steps = max(world - 1, 1)
        bufs = (ws.get("ring_attn_k", (steps, bh, s_loc, hd)),
                ws.get("ring_attn_v", (steps, bh, s_loc, hd)),
                ws.flags("ring_attn", steps * bh * n_rc),
                ws.flags("barrier", world))
        table = ctypes.c_longlong * world
        items, n_copy, _ = _ring_items(world, s_loc, bh, group, n_rc,
                                       causal=causal, window=window,
                                       zigzag=zigzag)
        items = torch.from_numpy(items).to(bufs[0].device)
        plan = ws.plans[key] = (chunk_rows, n_rc,
                                *[table(*peer_table(t)) for t in bufs],
                                items, n_copy)
    return plan


def ring_attn(q, k, v, *, causal=True, scale=None, window=0, soft_cap=0.0,
              zigzag=False):
    """The fused ring attention of every rank: q [W, S_loc, B, Hq, hd],
    k/v [W, S_loc, B, Hkv, hd] -> [W, S_loc, B, Hq, hd] in q's dtype.  On
    CUDA tensors one launch of ``csrc/ring_attn.cu`` (raising on what it
    does not take: bf16, hd 128, Hq / Hkv dividing 64, at most
    ``MAX_RANKS`` ranks, zigzag runs tiling by 64; each call takes a new
    workspace epoch, so no CUDA graph can capture it), counted in
    ``ring_attn.launches``; on CPU tensors the dense ring
    :func:`_ring_attention_dense`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, scale=scale, window=window, soft_cap=soft_cap,
              zigzag=zigzag)
    if q.device.type == "cpu":
        return _ring_attention_dense(q, k, v, **kw)
    if not q.is_cuda:
        raise ValueError(f"ring_attn: unsupported device {q.device}")
    world, s_loc, b, hq, hd = q.shape
    hkv = k.shape[3]
    if hd != 128:
        raise ValueError(f"ring_attn kernel: head_dim must be 128, got {hd}")
    if hq % hkv or 64 % (hq // hkv):
        raise ValueError(f"ring_attn kernel: the group size Hq/Hkv must "
                         f"divide 64 (Hq={hq}, Hkv={hkv})")
    if world > MAX_RANKS:
        raise ValueError(f"ring_attn kernel: at most {MAX_RANKS} ranks, got "
                         f"{world}")
    if zigzag and (s_loc % 2 or (s_loc // 2) % 64):
        raise ValueError(f"ring_attn kernel: zigzag needs S_loc/2 to tile "
                         f"by 64, got S_loc={s_loc}")
    _check_ring_operand("q", q, (world, s_loc, b, hq, hd))
    for name, x in (("k", k), ("v", v)):
        _check_ring_operand(name, x, (world, s_loc, b, hkv, hd))
        if x.device != q.device:
            raise ValueError(f"ring_attn: {name} on {x.device}, q on "
                             f"{q.device}")
    ws = get_world(world, q.device).workspace
    chunk_rows, n_rc, kslot, vslot, flags, bar, items, n_copy = _ring_plan(
        ws, b * hkv, s_loc, hd, group=hq // hkv, causal=causal,
        window=window, zigzag=zigzag)
    out = torch.empty((world, s_loc, b, hq, hd), dtype=q.dtype,
                      device=q.device)
    epoch = ws.next_epoch()
    lib = _build.load("ring_attn", _SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_ring_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:4], *k.stride()[:4], *v.stride()[:4], kslot, vslot,
            flags, bar, items.data_ptr(), items.shape[0], n_copy, world,
            s_loc, b, hq, hkv, chunk_rows, n_rc,
            int(bool(zigzag)), int(bool(causal)), int(window), float(scale),
            float(soft_cap or 0.0), epoch,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ring_attn")
    ring_attn.launches += 1
    return out


ring_attn.launches = 0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def resolve_ring_impl(impl, s_loc, hd, zigzag):
    """The algorithm ``impl`` names at this shape: ``"auto"`` is the flash
    ring where the flash kernels take the shard's runs, else the fused
    kernel (reference :637-646); an explicit ``"flash"`` on an illegal
    shape raises."""
    if impl not in IMPLS:
        raise ValueError(f"ring_attention: impl {impl!r} is not one of "
                         f"{IMPLS} (plain=True is the reference's 'xla')")
    n_runs = 2 if zigzag else 1
    legal = flash_shapes_ok(s_loc, s_loc, hd, n_runs, n_runs)
    if impl == "flash" and not legal:
        raise RingShapeError(
            f"ring_attention impl='flash': (S_loc={s_loc}, hd={hd}, "
            f"zigzag={zigzag}) needs (S_loc/runs) % 128 == hd % 128 == 0")
    if impl == "auto":
        return "flash" if legal else "fused"
    return impl


def ring_attention_shard(q, k, v, *, causal=True, scale=None, impl="auto",
                         window=0, soft_cap=0.0, zigzag=False, plain=False):
    """Every rank's ring attention: q [W, S_loc, B, Hq, hd], k/v [W,
    S_loc, B, Hkv, hd] (rank r's shard at [r]) -> [W, S_loc, B, Hq, hd].
    Differentiable under every ``impl`` (module docstring).  ``zigzag``:
    rank r holds chunks r and 2W-1-r of a 2W-chunk split (``to_zigzag`` on
    the global sequence first); it needs ``causal`` and an even S_loc."""
    if q.dim() != 5 or k.shape != v.shape or k.shape[:3] != q.shape[:3]:
        raise ValueError(f"ring_attention: q {tuple(q.shape)} must be [W, "
                         f"S_loc, B, Hq, hd] and k/v {tuple(k.shape)} [W, "
                         f"S_loc, B, Hkv, hd]")
    s_loc, hd = q.shape[1], q.shape[4]
    if q.shape[3] % k.shape[3]:
        raise ValueError(f"Hq={q.shape[3]} must be a multiple of "
                         f"Hkv={k.shape[3]}")
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if zigzag:
        if not causal:
            raise ValueError("zigzag layout only balances CAUSAL ring "
                             "attention; use the contiguous layout")
        if s_loc % 2:
            raise ValueError(f"zigzag needs an even S_loc, got {s_loc}")
    impl = resolve_ring_impl(impl, s_loc, hd, zigzag)
    kw = dict(causal=causal, scale=float(scale), window=int(window),
              soft_cap=float(soft_cap), zigzag=bool(zigzag))
    if plain:
        return _ring_attention_dense(q, k, v, **kw)
    fn = RingFlashFn if impl == "flash" else RingFusedFn
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fn.apply(q, k, v, kw)
    if impl == "flash":
        return _ring_attention_flash_fwd(q, k, v, **kw)[0]
    return ring_attn(q, k, v, **kw)


def ring_attention(q, k, v, ctx: RingAttentionContext):
    """Host entry: q/k/v [S, B, H, hd], the global sequence (in zigzag
    order when ``ctx.zigzag``) sharded evenly over ``ctx``'s ranks.
    Returns [S, B, Hq, hd]."""
    w = ctx.size
    S = q.shape[0]
    if S % w:
        raise ValueError(f"{S} positions do not split over {w} ranks")

    def shard(x):
        return x.reshape(w, S // w, *x.shape[1:])

    out = ring_attention_shard(
        shard(q), shard(k), shard(v), causal=ctx.causal, impl=ctx.impl,
        window=ctx.window, soft_cap=ctx.soft_cap, zigzag=ctx.zigzag,
        plain=ctx.plain)
    return out.reshape(S, *out.shape[2:])
