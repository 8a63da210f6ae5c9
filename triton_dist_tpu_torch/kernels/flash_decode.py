"""GQA decode attention over a contiguous or a paged KV cache, at world 1
and sequence-parallel over the ranks of a virtual world.

Counterpart of ``triton_dist_tpu/kernels/flash_decode.py``'s shard-level
entries :func:`gqa_decode_shard` and :func:`gqa_decode_paged_shard`:
single-token ``[B, Hq, D]`` or multi-token ``[B, T, Hq, D]`` queries (with
per-request ``q_lens``), ``window``/``window_lens`` and ``soft_cap``, f32
partials (out, lse) with the reference's dead-row contract (out 0, lse
``NEG_INF``) and masking rule (``_chunk_valid``).

int8 caches (``k_scale``/``v_scale``: f32 per-position scales, from
:func:`quantize_kv`) dequantize inside attention exactly as the
reference's ``_local_decode_xla`` does: K's scale multiplies the logit
columns, V's folds into P before the PV product.

On CUDA tensors both launch the hand-written Hopper kernel
``csrc/decode.cu`` (one kernel: a producer warp streams K / V tiles into a
ring by cp.async, consumer warps keep the softmax state in registers;
the paged entry reads page ids from the block table; an int8
instantiation for int8 caches) or raise on what it does not take.  A call
is one launch: each split of a (batch, kv-head) pair takes its share of
the pair's live tiles (:func:`live_tiles`, :func:`split_tiles`) and the
last split to finish merges the pair's partials in the same launch,
counting on a per-device workspace (:func:`_merge_counters`).  Each kernel
mode counts its own launches:
``gqa_decode_shard.launches`` and ``gqa_decode_paged_shard.launches``
(bf16), ``decode_i8.launches`` and ``decode_paged_i8.launches`` (int8).
On CPU tensors they run the plain PyTorch versions :func:`decode_ref` and
:func:`decode_paged_ref` (the counterparts of ``_local_decode_xla`` and of
``_paged_gather`` + ``_paged_gather_scale`` followed by it).

Sequence parallelism (SP) over the W ranks of a virtual world
(``runtime/bootstrap.World``): rank r holds positions
``[r * S_loc, (r + 1) * S_loc)`` of every sequence, and what differs per
rank carries a leading rank dimension (cache spans ``[W, B, Hkv, S_loc,
D]``, rank tables ``[W, B, n_local]``, partials ``[W, ...]``), while the
query and the result are held once.

- :func:`sp_gqa_decode_shard` / :func:`sp_gqa_decode_paged_shard`: every
  rank's local decode in ONE kernel launch (the ranks folded into the
  batch, with the reference's ``ends = kv_lens - r * S_loc`` rule), then
  :func:`_combine_across_ranks`.
- :func:`sp_combine_shard`: the inter-rank log-sum-exp merge. On CUDA
  tensors it launches ``csrc/sp_combine.cu`` (the port of the TPU
  ``_sp_combine_kernel`` as an owner merge: barrier, every rank's packed
  (out, lse) rows scattered to the rows' owners, each owner's merge in
  rank order broadcast to every rank, one cooperative launch; the plan is
  :func:`combine_schedule`) and counts ``sp_combine_shard.launches``, or
  raises on what the kernel does not take; on CPU tensors the plain
  version :func:`sp_combine_ref` (the gather is the rank stack itself:
  :func:`combine_partials`).
- :class:`SpDecodeContext`, :func:`create_sp_decode_context` and the host
  entry :func:`sp_gqa_decode`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.flash_attention import (
    NEG_INF,
    _check_cuda_operand,
    _check_scale,
    apply_soft_cap,
)
from triton_dist_tpu_torch.kernels.quant import symmetric_quantize
from triton_dist_tpu_torch.runtime.bootstrap import MAX_RANKS, World, get_world
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

MAX_ROWS = 128  # T * G query rows one decode block holds
TILE = 64       # key positions per kernel tile (csrc/decode.cu BN)
# the split count keeps the grid within one wave of the kernel's 2
# resident blocks an SM (PERF.md has the trials: examples/decode_trials.py)
BLOCKS_PER_SM = 2
# bytes of the kernel's K / V ring (csrc/decode.cu RING_BYTES: 2 stages of
# 64 bf16 K and V rows of 136, or 3 of 64 int8 rows of 144 and their
# scales), by int8-ness; a pair's merge keeps (n_split + 2) * T * G f32
# there, which bounds the split count
RING_BYTES = {False: 2 * (2 * TILE * 136 * 2),
              True: 3 * (2 * TILE * 144 + 2 * TILE * 4)}

_TAIL = [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_DECODE_SIG = {
    "tdt_decode": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 6 + _TAIL,
    "tdt_decode_paged": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 6 + _TAIL,
    "tdt_decode_i8": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12 + _TAIL,
    "tdt_decode_paged_i8": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
    + [ctypes.c_longlong] * 12 + _TAIL,
}
_SP_SIG = {"tdt_sp_combine": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
           + [ctypes.c_uint, ctypes.c_void_p]}
SP_PLANE_PAD = 4          # csrc/sp_combine.cu PAD: lse + 3 zeros per row
SP_CHUNK_BYTES = 1 << 16  # plane rows a block pushes before it signals
SP_CHUNKS_PER_OWNER = 4   # chunks an owner gets where the rows allow
SP_COMBINE_THREADS = 256  # csrc/sp_combine.cu NT
SP_COMBINE_VEC = 4        # csrc/sp_combine.cu V: float4s a thread merges


def split_plan(n_pairs: int, S_total: int, sms: int, rows: int = 1,
               int8: bool = False) -> int:
    """The split count of the decode grid: as many splits as keep the
    grid within about BLOCKS_PER_SM blocks an SM (one wave at the
    kernel's two resident blocks an SM: a block's start and its merge are
    latencies a second wave would pay again), at least one, at most one
    a tile of the cache, and at most what lets a pair's merge of ``rows``
    (T * G) query rows keep its (n_split + 2) * rows f32 in the ring
    (:data:`RING_BYTES`; the kernel refuses more); computed from shapes
    alone, so no host sync (each block finds its own tiles on the device:
    :func:`split_tiles`)."""
    n_tiles = max(1, -(-S_total // TILE))
    fit = RING_BYTES[int8] // (4 * rows) - 2
    return max(1, min(BLOCKS_PER_SM * sms // max(n_pairs, 1), n_tiles, fit))


def live_tiles(llen, wlen, qlen, *, use_qlens, window, S_total):
    """The kernel's live tiles [t_lo, t_hi) of one (batch, kv-head) pair:
    the TILE-key tiles that hold a position some live query sees (the
    visibility rule of :func:`decode_ref`), from the pair's lens alone
    (``csrc/decode.cu`` `pair_of` mirrors it).  A dead pair (``q_lens``
    0) or an empty one has none."""
    hi = max(0, min(llen, S_total))
    lo = 0
    if use_qlens:
        hi = min(hi, wlen) if qlen > 0 else 0
        if window:
            lo = wlen - (qlen - 1) - window
    elif window:
        lo = wlen - window
    lo = max(lo, 0)
    t_lo = lo // TILE
    return t_lo, (-(-hi // TILE) if hi > lo else t_lo)


def split_tiles(t_lo, t_hi, n_split, s):
    """Split s's share [a, b) of the live tiles [t_lo, t_hi): the tiles
    spread evenly, the first ``n % n_split`` splits one more
    (``csrc/decode.cu`` `split_share`)."""
    n = max(0, t_hi - t_lo)
    q, r = divmod(n, n_split)
    a = t_lo + s * q + min(s, r)
    return a, a + q + (1 if s < r else 0)


_COUNTS: dict = {}
_COUNTS_KEPT: list = []


def _merge_counters(device, n_pairs):
    """The decode kernel's merge counters on ``device``: int32, one a
    (batch, kv-head) pair, zero between calls (the split that merges a
    pair resets its counter in the launch).  Made zeroed on first use and
    grown as calls need more, never inside a CUDA-graph capture; a grown
    buffer's predecessor is kept, so a graph captured on it stays valid.
    Calls on one device are stream-ordered (one stream, or a graph of one
    stream's calls): two decodes running at once would share counters."""
    buf = _COUNTS.get(device)
    if buf is None or buf.numel() < n_pairs:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode: call the kernel once outside the CUDA-graph "
                "capture first (its merge counters are made zeroed there)")
        if buf is not None:
            _COUNTS_KEPT.append(buf)
        buf = _COUNTS[device] = torch.zeros(max(n_pairs, 4096),
                                            dtype=torch.int32,
                                            device=device)
    return buf


def quantize_kv(x):
    """[..., S, D] float → ([..., S, D] int8, [..., S] f32 scales):
    symmetric per-position row quant (the reference's int8-KV layout; the
    one recipe of ``kernels/quant.py``)."""
    return symmetric_quantize(x, -1)


def pack_lens_arg(local_lens, window_lens, q_lens, *, n_tok, window):
    """The lens operand in the reference's ``_pack_lens_arg`` layouts:
    ``[B]`` (valid rows), ``[2, B]`` (+ window end) when windowed, ``[3, B]``
    (+ live query count) for multi-token or ``q_lens`` calls.  Returns
    (int32 tensor, use_qlens)."""
    local_lens = local_lens.to(torch.int32)
    wl = local_lens if window_lens is None else window_lens.to(torch.int32)
    use_qlens = n_tok > 1 or q_lens is not None
    if use_qlens:
        ql = (torch.full_like(local_lens, n_tok) if q_lens is None
              else q_lens.to(device=local_lens.device, dtype=torch.int32))
        return torch.stack([local_lens, wl, ql]).contiguous(), True
    if window:
        return torch.stack([local_lens, wl]).contiguous(), False
    return local_lens.contiguous(), False


def decode_ref(q, k, v, local_lens, *, scale=None, k_scale=None,
               v_scale=None, soft_cap=0.0, window=0, window_lens=None,
               q_lens=None, positions=None):
    """Plain PyTorch decode (f32 math, dense over the cache) — the
    ``_local_decode_xla`` contract: q [B, Hq, D] or [B, T, Hq, D]; k/v
    [B, Hkv, S, D] (int8 with ``k_scale``/``v_scale`` [B, Hkv, S]);
    returns f32 (out, lse).  ``positions`` = (lo, hi), each [B], keeps
    only the keys at positions [lo, hi) of each row: one split's share
    (:func:`split_tiles`), whose partials :func:`combine_partials`
    merges."""
    multi = q.dim() == 4
    if not multi:
        q = q[:, None]
    B, T, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.float().reshape(B, T, Hkv, g, D)
    logits = torch.einsum("bthgd,bhsd->bhtgs", qf, k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, None, :]
    logits = apply_soft_cap(logits, soft_cap)
    ll = local_lens.to(device=dev, dtype=torch.int64)
    wl = ll if window_lens is None else window_lens.to(dev, torch.int64)
    ql = (torch.full((B,), T, dtype=torch.int64, device=dev)
          if q_lens is None else q_lens.to(dev, torch.int64))
    pos = torch.arange(S, device=dev)[None, None, :]                # [1,1,S]
    d = ql[:, None] - 1 - torch.arange(T, device=dev)[None, :]      # [B, T]
    valid = ((pos < ll[:, None, None]) & (d[..., None] >= 0)
             & (pos < (wl[:, None] - d)[..., None]))                # [B,T,S]
    if window:
        valid = valid & (pos >= (wl[:, None] - d)[..., None] - window)
    if positions is not None:
        lo, hi = (torch.as_tensor(x, device=dev).to(torch.int64)[:, None, None]
                  for x in positions)
        valid = valid & (pos >= lo) & (pos < hi)
    vmask = valid[:, None, :, None, :]
    logits = torch.where(vmask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)                                         # [B,Hkv,T,g]
    nonempty = m > NEG_INF / 2
    p = torch.where(vmask, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = torch.einsum("bhtgs,bhsd->bthgd", p, v.float())
    l_safe = torch.where(nonempty, l, torch.ones_like(l))
    ne_t = nonempty.permute(0, 2, 1, 3)[..., None]
    out = torch.where(ne_t, out / l_safe.permute(0, 2, 1, 3)[..., None],
                      torch.zeros_like(out))
    lse = torch.where(nonempty, m + torch.log(l_safe),
                      torch.full_like(m, NEG_INF)).permute(0, 2, 1, 3)
    out = out.reshape(B, T, Hq, D)
    lse = lse.reshape(B, T, Hq)
    if not multi:
        return out[:, 0], lse[:, 0]
    return out, lse


def paged_gather(pool, table):
    """[N, Hkv, P, D] pool + [B, n] table → [B, Hkv, n*P, D] contiguous
    view (the plain path materializes it; the kernel never does)."""
    g = pool[table.long()]                               # [B, n, Hkv, P, D]
    B, n, Hkv, Pg, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n * Pg, D)


def paged_gather_scale(scale_pool, table):
    """[N, Hkv, P] per-position scale pool + [B, n] table → [B, Hkv, n*P]
    (the twin of :func:`paged_gather` for an int8 pool's scale plane)."""
    g = scale_pool[table.long()]                         # [B, n, Hkv, P]
    B, n, Hkv, Pg = g.shape
    return g.permute(0, 2, 1, 3).reshape(B, Hkv, n * Pg)


def decode_paged_ref(q, k_pool, v_pool, block_table, local_lens, *,
                     k_scale=None, v_scale=None, **kw):
    """Plain paged decode: gather the pages (and, for int8 pools, their
    scales), then :func:`decode_ref`."""
    if k_scale is not None:
        kw.update(k_scale=paged_gather_scale(k_scale, block_table),
                  v_scale=paged_gather_scale(v_scale, block_table))
    return decode_ref(q, paged_gather(k_pool, block_table),
                      paged_gather(v_pool, block_table), local_lens, **kw)


def _decode_setup(q, k, v, local_lens, window_lens, q_lens, window,
                  S_total, kv_dtype=torch.bfloat16):
    """Shape and operand checks shared by the CUDA entries, plus the
    outputs, the split-KV scratch (partial o and lse per split) and the
    merge counters."""
    multi = q.dim() == 4
    n_tok = q.shape[1] if multi else 1
    B, Hq, D = q.shape[0], q.shape[-2], q.shape[-1]
    Hkv = k.shape[1]
    if D != 128:
        raise ValueError(f"decode kernel: head_dim must be 128, got {D}")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if n_tok * (Hq // Hkv) > MAX_ROWS:
        raise ValueError(f"decode kernel: T*G = {n_tok * (Hq // Hkv)} query "
                         f"rows exceed {MAX_ROWS}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if local_lens.shape != (B,):
        raise ValueError(f"local_lens shape {tuple(local_lens.shape)} != "
                         f"({B},)")
    qc = q.contiguous()
    _check_cuda_operand("q", qc, torch.bfloat16)
    for name, x in (("k", k), ("v", v)):
        _check_cuda_operand(name, x, kv_dtype)
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if window_lens is not None:
        window_lens = window_lens.to(q.device)
    lens, use_qlens = pack_lens_arg(local_lens.to(q.device), window_lens,
                                    q_lens, n_tok=n_tok, window=window)
    shape = (B, n_tok, Hq) if multi else (B, Hq)
    out = torch.empty(shape + (D,), dtype=torch.float32, device=q.device)
    lse = torch.empty(shape, dtype=torch.float32, device=q.device)
    R = n_tok * (Hq // Hkv)
    n_split = split_plan(B * Hkv, S_total, _build.sm_count(q.device), R,
                         kv_dtype == torch.int8)
    part = (B * Hkv, n_split, R) if n_split > 1 else (0,)
    o_part = torch.empty(part + ((D,) if n_split > 1 else ()),
                         dtype=torch.float32, device=q.device)
    lse_part = torch.empty(part, dtype=torch.float32, device=q.device)
    counts = _merge_counters(q.device, B * Hkv)
    return dict(qc=qc, lens=lens, use_qlens=use_qlens, out=out, lse=lse,
                o_part=o_part, lse_part=lse_part, counts=counts,
                n_split=n_split, B=B, T=n_tok, Hq=Hq, Hkv=Hkv)


def _scratch(a):
    """The pointers of a call's partials and merge counters."""
    return (a["o_part"].data_ptr(), a["lse_part"].data_ptr(),
            a["counts"].data_ptr())


def gqa_decode_shard(q, k, v, local_lens, *, block_s=None, k_scale=None,
                     v_scale=None, soft_cap=0.0, window=0, window_lens=None,
                     q_lens=None):
    """GQA decode on a contiguous cache: q [B, Hq, D] or [B, T, Hq, D],
    k/v [B, Hkv, S, D], local_lens [B] valid rows.  Returns f32 (out
    [B, (T,) Hq, D], lse [B, (T,) Hq]).  ``block_s`` is accepted for the
    reference's signature; the kernel's tile is fixed."""
    del block_s
    kw = dict(soft_cap=soft_cap, window=window, window_lens=window_lens,
              q_lens=q_lens)
    if q.device.type == "cpu":
        return decode_ref(q, k, v, local_lens, k_scale=k_scale,
                          v_scale=v_scale, **kw)
    if not q.is_cuda:
        raise ValueError(f"gqa_decode_shard: unsupported device {q.device}")
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {q.shape[0]}")
    if k_scale is not None or v_scale is not None:
        return decode_i8(q, k, v, k_scale, v_scale, local_lens, **kw)
    a = _decode_setup(q, k, v, local_lens, window_lens, q_lens, window,
                      k.shape[2])
    lens = a["lens"]
    lib = _build.load("decode", _DECODE_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_decode(
            a["qc"].data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            a["out"].data_ptr(), a["lse"].data_ptr(), *_scratch(a), a["B"],
            a["T"], a["Hq"], a["Hkv"], k.shape[2], a["n_split"],
            *k.stride()[:3], *v.stride()[:3],
            lens.shape[0] if lens.dim() == 2 else 1, int(a["use_qlens"]),
            int(window), 1.0 / math.sqrt(q.shape[-1]),
            float(soft_cap or 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode")
    gqa_decode_shard.launches += 1
    return a["out"], a["lse"]


gqa_decode_shard.launches = 0


def decode_i8(q, k, v, k_scale, v_scale, local_lens, *, soft_cap=0.0,
              window=0, window_lens=None, q_lens=None):
    """The int8 instantiation of the decode kernel on CUDA tensors (the
    port of ``_decode_kernel_i8``): k/v [B, Hkv, S, D] int8 with f32
    ``k_scale``/``v_scale`` [B, Hkv, S]; the returns of
    :func:`gqa_decode_shard`."""
    a = _decode_setup(q, k, v, local_lens, window_lens, q_lens, window,
                      k.shape[2], kv_dtype=torch.int8)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_scale(name, sc, k.shape[:3], q.device)
    lens = a["lens"]
    lib = _build.load("decode", _DECODE_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_decode_i8(
            a["qc"].data_ptr(), k.data_ptr(), v.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), lens.data_ptr(),
            a["out"].data_ptr(), a["lse"].data_ptr(), *_scratch(a), a["B"],
            a["T"], a["Hq"], a["Hkv"], k.shape[2], a["n_split"],
            *k.stride()[:3], *v.stride()[:3],
            *k_scale.stride(), *v_scale.stride(),
            lens.shape[0] if lens.dim() == 2 else 1, int(a["use_qlens"]),
            int(window), 1.0 / math.sqrt(q.shape[-1]),
            float(soft_cap or 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_i8")
    decode_i8.launches += 1
    return a["out"], a["lse"]


decode_i8.launches = 0


def gqa_decode_paged_shard(q, k_pool, v_pool, block_table, local_lens, *,
                           soft_cap=0.0, window=0, window_lens=None,
                           q_lens=None, k_scale=None, v_scale=None):
    """GQA decode over a PAGED cache: k/v_pool [N, Hkv, page, D],
    block_table [B, n_pages] int32 (logical page i of batch b at pool row
    ``block_table[b, i]``; entries past a sequence's length may point
    anywhere in the pool, e.g. the null block 0, but every entry must be
    a pool row — the kernel does not check, as that would cost a device
    sync per call).  Same returns as
    :func:`gqa_decode_shard`.  int8 pools carry f32 scale pools
    ``k_scale``/``v_scale`` [N, Hkv, page], addressed through the same
    page ids.  The kernel takes pages that are multiples of 16 up to
    256."""
    kw = dict(soft_cap=soft_cap, window=window, window_lens=window_lens,
              q_lens=q_lens)
    if q.device.type == "cpu":
        return decode_paged_ref(q, k_pool, v_pool, block_table, local_lens,
                                k_scale=k_scale, v_scale=v_scale, **kw)
    if not q.is_cuda:
        raise ValueError(
            f"gqa_decode_paged_shard: unsupported device {q.device}")
    page = k_pool.shape[2]
    if page % 16 or page > 256:
        raise ValueError(f"decode_paged kernel: page size {page} must be a "
                         f"multiple of 16 and at most 256")
    table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
    if table.shape[0] != q.shape[0]:
        raise ValueError(f"block_table rows {table.shape[0]} != batch "
                         f"{q.shape[0]}")
    if k_scale is not None or v_scale is not None:
        return decode_paged_i8(q, k_pool, v_pool, k_scale, v_scale, table,
                               local_lens, **kw)
    a = _decode_setup(q, k_pool, v_pool, local_lens, window_lens, q_lens,
                      window, page * table.shape[1])
    lens = a["lens"]
    lib = _build.load("decode", _DECODE_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_decode_paged(
            a["qc"].data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lens.data_ptr(), a["out"].data_ptr(),
            a["lse"].data_ptr(), *_scratch(a), a["B"], a["T"], a["Hq"],
            a["Hkv"], page, table.shape[1], a["n_split"],
            *k_pool.stride()[:3], *v_pool.stride()[:3],
            lens.shape[0] if lens.dim() == 2 else 1, int(a["use_qlens"]),
            int(window), 1.0 / math.sqrt(q.shape[-1]),
            float(soft_cap or 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_paged")
    gqa_decode_paged_shard.launches += 1
    return a["out"], a["lse"]


gqa_decode_paged_shard.launches = 0


def decode_paged_i8(q, k_pool, v_pool, k_scale, v_scale, table, local_lens,
                    *, soft_cap=0.0, window=0, window_lens=None,
                    q_lens=None):
    """The int8 instantiation of the paged decode kernel on CUDA tensors
    (called by :func:`gqa_decode_paged_shard` with an int32 ``table`` on
    q's device): int8 pools [N, Hkv, page, D] with f32 scale pools
    [N, Hkv, page], both read through ``table``.  The reference has no
    Pallas kernel here: it computes the int8 paged attend as XLA math."""
    a = _decode_setup(q, k_pool, v_pool, local_lens, window_lens, q_lens,
                      window, k_pool.shape[2] * table.shape[1],
                      kv_dtype=torch.int8)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_scale(name, sc, k_pool.shape[:3], q.device)
    lens = a["lens"]
    lib = _build.load("decode", _DECODE_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_decode_paged_i8(
            a["qc"].data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), table.data_ptr(),
            lens.data_ptr(), a["out"].data_ptr(), a["lse"].data_ptr(),
            *_scratch(a), a["B"], a["T"], a["Hq"], a["Hkv"],
            k_pool.shape[2], table.shape[1], a["n_split"],
            *k_pool.stride()[:3], *v_pool.stride()[:3], *k_scale.stride(),
            *v_scale.stride(),
            lens.shape[0] if lens.dim() == 2 else 1, int(a["use_qlens"]),
            int(window), 1.0 / math.sqrt(q.shape[-1]),
            float(soft_cap or 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "decode_paged_i8")
    decode_paged_i8.launches += 1
    return a["out"], a["lse"]


decode_paged_i8.launches = 0


# ---------------------------------------------------------------------------
# Inter-rank combine
# ---------------------------------------------------------------------------


def combine_partials(outs, lses):
    """Log-sum-exp merge of per-rank partials: outs [W, ..., D], lses
    [W, ...] -> [..., D] f32 (the reference's ``combine_partials``).  A
    row with lse NEG_INF on every rank merges to 0: every weight is 1 and
    every partial 0."""
    lses = lses.float()
    m = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - m)
    denom = w.sum(dim=0)
    out = (outs.float() * w[..., None]).sum(dim=0)
    return out / denom[..., None]


def sp_combine_ref(out, lse):
    """Plain version of the combine: rank-stacked partials out
    [W, B, H, D] and lse [W, B, H] -> every rank's merged result
    [W, B, H, D] f32 (the same on every rank).  In the virtual world the
    rank stack is the gathered buffer every rank reads (the reference's
    packed gather), so this is :func:`combine_partials` over it."""
    final = combine_partials(out, lse)
    return final[None].expand(out.shape[0], *final.shape)


def _check_combine(out, lse):
    if out.dim() < 2 or tuple(lse.shape) != tuple(out.shape[:-1]):
        raise ValueError(f"sp_combine: out {tuple(out.shape)} must be "
                         f"[W, ..., D] and lse {tuple(lse.shape)} [W, ...]")
    if out.shape[0] > MAX_RANKS:
        raise ValueError(f"sp_combine: at most {MAX_RANKS} ranks, got "
                         f"{out.shape[0]}")


class CombineSchedule(NamedTuple):
    """The owner merge's cut of ``bh`` rows over ``world`` ranks
    (``csrc/sp_combine.cu``): chunks of ``chunk_rows`` rows (the last may
    be short), ``n_chunk`` of them, chunk c owned by rank ``c // cpo``
    (owners past the last chunk have an empty band), merged in items of
    ``merge_rows`` rows."""

    world: int
    bh: int
    chunk_rows: int
    n_chunk: int
    cpo: int
    merge_rows: int

    def chunk(self, c):
        """Rows [r0, r1) of chunk c."""
        r0 = c * self.chunk_rows
        return r0, min(r0 + self.chunk_rows, self.bh)

    def owned(self, o):
        """The chunks rank o owns, as a range."""
        return range(min(o * self.cpo, self.n_chunk),
                     min((o + 1) * self.cpo, self.n_chunk))

    def pieces(self, c):
        """Merge items of chunk c (what its final flag counts)."""
        r0, r1 = self.chunk(c)
        return -(-(r1 - r0) // self.merge_rows)

    def scatter_waits(self, o):
        """Flags owner o waits on before merging: one per (source, owned
        chunk)."""
        return self.world * len(self.owned(o))

    def final_waits(self):
        """Final flags every rank waits on before its launch ends."""
        return self.n_chunk


def combine_schedule(world: int, bh: int, D: int) -> CombineSchedule:
    """The owner merge's plan for ``bh`` rows of ``D`` over ``world``
    ranks: chunks of at most SP_CHUNK_BYTES of plane rows, and at least
    SP_CHUNKS_PER_OWNER chunks an owner where the rows allow (more blocks
    push and merge at small shapes), at least one row; merge items of
    ``SP_COMBINE_VEC`` float4s a thread (``SP_COMBINE_THREADS`` of
    them)."""
    plane = (D + SP_PLANE_PAD) * 4
    chunk_rows = max(1, min(SP_CHUNK_BYTES // plane,
                            -(-bh // (world * SP_CHUNKS_PER_OWNER))))
    n_chunk = -(-bh // chunk_rows)
    return CombineSchedule(world, bh, chunk_rows, n_chunk,
                           -(-n_chunk // world),
                           max(1, SP_COMBINE_VEC * SP_COMBINE_THREADS
                               // (D // 4)))


def _combine_plan(ws, bh, D):
    """What a combine of ``bh`` rows of ``D`` over a workspace's world
    keeps from call to call, made once per shape and held in the
    workspace: (its :func:`combine_schedule`, the final buffer [W, bh, D]
    f32, and the pointer tables of out, lse (filled in place by each
    call), the owners' gather buffers [W, cpo * chunk_rows, D + 4], the
    finals, the flags ([W, n_chunk] scatter and [n_chunk] final a rank),
    the merge-item counters and the barrier slots)."""
    key = ("sp_combine", bh, D)
    plan = ws.plans.get(key)
    if plan is None:
        world = ws.world.size
        sch = combine_schedule(world, bh, D)
        final = ws.get("sp_combine_final", (bh, D), torch.float32)
        bufs = (ws.get("sp_combine", (world, sch.cpo * sch.chunk_rows,
                                      D + SP_PLANE_PAD), torch.float32),
                final, ws.flags("sp_combine", (world + 1) * sch.n_chunk),
                ws.flags("sp_combine_count", sch.n_chunk),
                ws.flags("barrier", world))
        table = ctypes.c_longlong * world
        plan = ws.plans[key] = (sch, final, table(), table(),
                                *[table(*peer_table(t)) for t in bufs])
    return plan


def sp_combine_shard(out, lse, *, all_ranks: bool = False):
    """The inter-rank combine of SP decode partials: out [W, B, H, D] f32,
    lse [W, B, H] f32 (rank r's partial over its span at [r]; B and H may
    be any leading shape) -> [B, H, D] f32, the merged result every rank
    holds (rank 0's); ``all_ranks`` returns the rank-stacked [W, B, H, D]
    instead (each rank's final, bit for bit the same on the card: one
    owner merges each row and writes it to every rank).  World 1 passes
    the partial through.  On CUDA tensors one launch of
    ``csrc/sp_combine.cu`` (raising on what it does not take): each rank
    scatters its rows to their owners (:func:`combine_schedule`), each
    owner merges its band in rank order and broadcasts it into every
    rank's slice of the workspace's final buffer of this shape.  The
    result stays valid until the next combine of the same shape, as the
    reference's gather buffer does.  On CPU tensors :func:`sp_combine_ref`,
    a new tensor."""
    _check_combine(out, lse)
    world = out.shape[0]
    if world == 1:
        return out if all_ranks else out[0]
    if out.device.type == "cpu":
        final = sp_combine_ref(out, lse)
        return final if all_ranks else final[0]
    if not out.is_cuda:
        raise ValueError(f"sp_combine: unsupported device {out.device}")
    if out.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError(f"sp_combine kernel: f32 partials, got out "
                        f"{out.dtype}, lse {lse.dtype}")
    if lse.device != out.device:
        raise ValueError(f"sp_combine: lse on {lse.device}, out on "
                         f"{out.device}")
    D = out.shape[-1]
    if D % 4:
        raise ValueError(f"sp_combine kernel: head_dim {D} must be a "
                         f"multiple of 4 (16-byte plane rows)")
    lead = out.shape[1:-1]
    bh = math.prod(lead)
    if bh == 0:
        raise ValueError("sp_combine kernel: no rows to merge")
    out, lse = out.contiguous(), lse.contiguous()
    ws = get_world(world, out.device).workspace
    sch, final, t_out, t_lse, gath, t_fin, flags, count, bar = \
        _combine_plan(ws, bh, D)
    for t, x, row in ((t_out, out, bh * D * 4), (t_lse, lse, bh * 4)):
        base = x.data_ptr()
        for r in range(world):
            t[r] = base + r * row
    epoch = ws.next_epoch()
    lib = _build.load("sp_combine", _SP_SIG)
    with torch.cuda.device(out.device):
        err = lib.tdt_sp_combine(t_out, t_lse, gath, t_fin, flags, count,
                                 bar, world, bh, D, sch.chunk_rows,
                                 sch.n_chunk, sch.cpo, sch.merge_rows,
                                 epoch,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sp_combine")
    sp_combine_shard.launches += 1
    final = final.view(world, *lead, D)
    return final if all_ranks else final[0]


sp_combine_shard.launches = 0


def _combine_across_ranks(out, lse, out_dtype):
    """The one inter-rank combine dispatch of the SP paths (the decodes
    and ``flash_attention.sp_flash_attention_shard``): rank-stacked
    partials [W, B, H, D] / [W, B, H] -> [B, H, D] in ``out_dtype``.
    World 1 passes through; otherwise :func:`sp_combine_shard` (the kernel
    on CUDA tensors, the plain version on CPU tensors; partials in another
    dtype than f32 widen first).  The reference's other branch
    (``impl="xla"`` or head_dim % 128: a packed gather, then XLA's merge)
    is the plain version here."""
    return sp_combine_shard(out.float(), lse.float()).to(out_dtype)


# ---------------------------------------------------------------------------
# Sequence-parallel decode (shard + host entries)
# ---------------------------------------------------------------------------


def sp_local_lens(kv_lens, world: int, s_loc: int):
    """(local_lens, ends) [W, B] int32 of global lengths ``kv_lens`` [B]:
    rank r's unclipped local end ``kv_lens - r * s_loc`` and its clip to
    [0, s_loc] (the reference's rule; the unclipped ends place windowed
    and multi-token queries globally)."""
    r = torch.arange(world, device=kv_lens.device, dtype=torch.int32)
    ends = kv_lens.to(torch.int32)[None, :] - (r * s_loc)[:, None]
    return ends.clamp(0, s_loc), ends


def _fold_ranks(q, world):
    """q [B, ...] held once -> [W * B, ...]: every rank's copy, so the
    ranks fold into the decode kernel's batch."""
    return q.expand(world, *q.shape).reshape(world * q.shape[0],
                                             *q.shape[1:])


def _combine_folded(out, lse, world, B, out_dtype):
    """Partials of a folded decode ([W * B, (T,) H, D]) -> the combined
    [B, (T,) H, D]: multi-token partials merge like a B * T batch."""
    rest = out.shape[1:-1]
    c = _combine_across_ranks(out.reshape(world, -1, rest[-1], out.shape[-1]),
                              lse.reshape(world, -1, rest[-1]), out_dtype)
    return c.reshape(B, *rest, out.shape[-1])


def sp_gqa_decode_shard(q, k_shard, v_shard, kv_lens, *, k_scale=None,
                        v_scale=None, soft_cap=0.0, window=0, q_lens=None):
    """SP decode over contiguous cache spans: q [B, Hq, D] or
    [B, T, Hq, D] (held once); k/v_shard [W, B, Hkv, S_loc, D] (rank r's
    span of every sequence at [r], int8 with ``k_scale``/``v_scale``
    [W, B, Hkv, S_loc]); kv_lens [B] GLOBAL lengths.  Every rank's local
    partial in one decode launch (the ranks folded into the batch), then
    the combine.  Returns [B, (T,) Hq, D] in q's dtype."""
    world, B, Hkv, s_loc, D = k_shard.shape
    multi = q.dim() == 4
    local, ends = sp_local_lens(kv_lens.to(q.device), world, s_loc)

    def fold(x):
        return None if x is None else x.reshape(world * B, *x.shape[2:])

    out, lse = gqa_decode_shard(
        _fold_ranks(q, world), fold(k_shard), fold(v_shard),
        local.reshape(-1), k_scale=fold(k_scale), v_scale=fold(v_scale),
        soft_cap=soft_cap, window=window,
        window_lens=ends.reshape(-1) if (window or multi) else None,
        q_lens=None if q_lens is None else q_lens.to(q.device).repeat(world))
    return _combine_folded(out, lse, world, B, q.dtype)


def sp_gqa_decode_paged_shard(q, k_pool, v_pool, block_table, kv_lens, *,
                              soft_cap=0.0, window=0, q_lens=None,
                              k_scale=None, v_scale=None):
    """SP decode over a paged pool: k/v_pool [N, Hkv, page, D] (int8 with
    ``k_scale``/``v_scale`` [N, Hkv, page]) hold every rank's pages, and
    ``block_table`` [W, B, n_local] gives rank r's logical pages of each
    sequence as pool rows (its own pages; entries past a length may point
    at any pool row, e.g. its null).  Rank r owns global positions
    ``[r * s_loc, (r + 1) * s_loc)``, ``s_loc = n_local * page`` (the
    contiguous rule); kv_lens [B] are GLOBAL lengths.  Under the
    partitioned allocator the pool IS the rank-stacked pool (rank r's
    rows ``[r * nb_loc, (r + 1) * nb_loc)``), so one paged launch over
    W * B rows computes every rank's partial without copying it.  Returns
    [B, (T,) Hq, D] in q's dtype."""
    world, B, n_local = block_table.shape
    s_loc = n_local * k_pool.shape[2]
    multi = q.dim() == 4
    local, ends = sp_local_lens(kv_lens.to(q.device), world, s_loc)
    out, lse = gqa_decode_paged_shard(
        _fold_ranks(q, world), k_pool, v_pool,
        block_table.reshape(world * B, n_local), local.reshape(-1),
        soft_cap=soft_cap, window=window,
        window_lens=ends.reshape(-1) if (window or multi) else None,
        q_lens=None if q_lens is None else q_lens.to(q.device).repeat(world),
        k_scale=k_scale, v_scale=v_scale)
    return _combine_folded(out, lse, world, B, q.dtype)


def shard_seq(x, world: int):
    """[B, Hkv, S, ...] -> [W, B, Hkv, S / W, ...] (a new contiguous
    tensor): rank r's span of the sequence axis at [r]."""
    B, H, S = x.shape[:3]
    if S % world:
        raise ValueError(f"sequence length {S} must divide by the world "
                         f"size {world}")
    return x.reshape(B, H, world, S // world, *x.shape[3:]).movedim(
        2, 0).contiguous()


@dataclass
class SpDecodeContext:
    """The world and the knobs of an SP decode (the reference's
    ``SpDecodeContext``; its ``mesh``/``axis`` pair is the world here)."""

    world: World
    soft_cap: float = 0.0
    window: int = 0


def create_sp_decode_context(world, soft_cap=0.0, window=0, *,
                             device=None) -> SpDecodeContext:
    """The context over ``world``: a :class:`World`, or a rank count (the
    world of that size on ``device``, made on first use).  The
    reference's ``block_s`` has no counterpart: the kernel's tile is
    fixed."""
    if not isinstance(world, World):
        world = get_world(int(world), device)
    return SpDecodeContext(world=world, soft_cap=soft_cap, window=window)


def sp_gqa_decode(q, k_cache, v_cache, kv_lens, ctx: SpDecodeContext):
    """Host entry: q [B, Hq, D]; k/v_cache [W, B, Hkv, S_loc, D], the
    sequence axis sharded over the context's W ranks (:func:`shard_seq`);
    kv_lens [B] global lengths.  Returns [B, Hq, D]."""
    if k_cache.shape[0] != ctx.world.size:
        raise ValueError(f"cache of {k_cache.shape[0]} rank spans, world "
                         f"of {ctx.world.size}")
    return sp_gqa_decode_shard(q, k_cache, v_cache, kv_lens,
                               soft_cap=ctx.soft_cap, window=ctx.window)
