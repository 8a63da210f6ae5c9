"""Sharded serving over the ranks of a virtual world: the ``seq`` and
``heads`` layouts of ``triton_dist_tpu/serve/mesh.py``.

**kv_shard="seq"** (sequence-sharded).  Over the W ranks of a virtual
world (``runtime.bootstrap.World``) the engine keeps its weights,
activations, logits and sampled tokens once and shards only the paged KV:
the partitioned :class:`~triton_dist_tpu_torch.serve.block_manager.BlockManager`
gives rank r the pool rows ``[r * nb_loc, (r + 1) * nb_loc)`` (``nb_loc =
num_blocks / W``, its first row its own null) and places logical page
``i`` of every request in partition ``i // (n_pages_max / W)``, so rank r
holds the pages of its contiguous sequence span.  The engine's global
pools ``[num_blocks, Hkv, page, D]`` therefore ARE the rank-stacked pools,
and the engine's programs are plain functions over them:

- :func:`sp_paged_decode_shard`: the decode step, attention through
  ``sp_gqa_decode_paged_shard`` over every rank's rebased table slice
  (one decode launch for all ranks, then the SP combine kernel);
- :func:`sp_chunk_forward_shard`: chunked prefill whose attention read
  shards over the ranks' spans of the replicated prefill scratch, the
  partials merged by the same combine.

The page scatter is world 1's (``engine._fill_pool_pages``): in the
shared pool a global block id already is its owner's row, so the
reference's rebase to local rows and back is the identity on owned ids
and nothing moves between ranks.

**kv_shard="heads"** (Megatron tensor parallelism, reference :200-300 and
the engine programs at :555-580).  Weights are rank-stacked by
``llama.shard_params`` (QKV and gate/up by output columns, out and down
by input rows), the pools by KV head ``[W, num_blocks, Hkv/W, page, D]``
(int8 pools' scale planes with them), and the engine's own programs run
under the local-head view (:func:`_local_cfg`) with the two row-parallel
seams supplied here (:func:`_tp_out_proj`, :func:`_tp_ffn`: each rank's
partial product, then the reference's ``psum`` as a sum over the rank
axis in rank order).  Attention is head-independent, so nothing is
combined across ranks: :func:`tp_paged_decode_shard` folds the W ranks'
heads into one paged decode launch of W B rows
(``engine._paged_decode_forward``), and :func:`tp_chunk_forward_shard`
one prefill attention call (``generate._chunk_forward``).  Block tables
and page ownership are world 1's: the reference replicates them.

:func:`validate_mesh_geometry` holds both layouts' divisibility rules.
The reference's ``collective_seams`` declares seams for its jaxpr auditor
and names programs this engine does not have yet; the port has no such
auditor (the kernels' launch counts are what ``chip_smoke.py`` reads), so
it has no counterpart either.  The reference's ``ShardedProgram`` and
``MeshChunkJit`` canonicalize argument shardings for jax's jit cache;
PyTorch runs eagerly and has no such cache, so they have no counterpart.
``kv_shard="heads+seq"`` (the 2-D composition) is not ported yet: ROADMAP
Queue 1's ninth entry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.flash_decode import (
    sp_gqa_decode_paged_shard,
)
from triton_dist_tpu_torch.layers.tp_linear import rank_sum
from triton_dist_tpu_torch.models.generate import (
    _attend_prefix,
    _chunk_forward,
    _token_forward,
)
from triton_dist_tpu_torch.models.llama import _silu_mul

KV_SHARDS = ("heads", "seq", "heads+seq")


def check_kv_shard(kv_shard: str) -> None:
    """Reject an unknown layout (ValueError) and the layout not ported yet
    (NotImplementedError)."""
    if kv_shard not in KV_SHARDS:
        raise ValueError(
            f"kv_shard must be one of {KV_SHARDS}, got {kv_shard!r}")
    if kv_shard == "heads+seq":
        raise NotImplementedError(
            "kv_shard='heads+seq' (heads over a tp axis composed with the "
            "seq layout's blocks over an sp axis) is not ported yet: "
            "ROADMAP Queue 1's ninth entry (item 12's rest, sharded serving "
            "without a kernel)")


def _check_heads_geometry(cfg, world, kv_shard, label):
    """The heads-TP divisibility rules (the reference's, message for
    message)."""
    if cfg.n_kv_heads % world:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs n_kv_heads ({cfg.n_kv_heads}) "
            f"divisible by the {label} ({world}) — each rank "
            f"must own whole KV heads of the paged pools")
    if cfg.n_heads % world:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs n_heads ({cfg.n_heads}) "
            f"divisible by the {label} ({world}) — the "
            f"column-parallel QKV split assigns whole query heads "
            f"per rank")
    if cfg.ffn_dim % world:
        raise ValueError(
            f"TP weights need ffn_dim ({cfg.ffn_dim}) divisible by "
            f"the {label} ({world}) — wgate/wup shard by "
            f"columns, wdown by rows")


def _check_seq_geometry(max_seq, num_blocks, page_size, world, kv_shard,
                        label):
    """The seq-SP divisibility rules (the reference's, message for
    message)."""
    n_pages = max_seq // page_size
    if n_pages % world:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs max_seq/page_size ({n_pages} "
            f"logical pages) divisible by the {label} ({world}) "
            f"— each rank owns a contiguous span of "
            f"{n_pages}//{world} logical pages")
    if num_blocks % world:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs num_blocks ({num_blocks}) "
            f"divisible by the {label} ({world}) — the pool "
            f"splits into equal per-rank partitions")
    if num_blocks // world < 2:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs num_blocks//world >= 2 "
            f"({num_blocks}//{world} = {num_blocks // world}): "
            f"every partition reserves its own null block and "
            f"still needs at least one allocatable page")
    if page_size % world:
        raise ValueError(
            f"kv_shard={kv_shard!r} needs page_size ({page_size}) "
            f"divisible by the {label} ({world}) — the sharded "
            f"chunked-prefill attend splits every scratch-extent rung "
            f"(a page multiple) into equal per-rank row spans")


def validate_mesh_geometry(*, mesh, kv_shard, cfg, max_seq, num_blocks,
                           page_size) -> int:
    """Reject impossible (world, engine geometry) combinations loudly at
    construction; returns the world size.  ``mesh`` is a :class:`World`
    (the reference's mesh axis)."""
    check_kv_shard(kv_shard)
    world = int(mesh.size)
    if kv_shard == "heads":
        _check_heads_geometry(cfg, world, kv_shard, "mesh world")
    else:
        _check_seq_geometry(max_seq, num_blocks, page_size, world, kv_shard,
                            "mesh world")
    return world


# ---------------------------------------------------------------------------
# kv_shard="heads": the local-head view and the two TP reduction seams
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _ShardCfg:
    """The per-rank config view the shared forwards see under TP: LOCAL
    head counts with the GLOBAL ``head_dim``/``dim`` (``LlamaConfig.
    head_dim`` is ``dim // n_heads``, so a replaced ``n_heads`` would
    corrupt it: the fields the forwards read are pinned here)."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    dim: int
    norm_eps: float
    rope_theta: float
    dtype: object
    attn_window: int
    attn_soft_cap: float


def _local_cfg(cfg, world: int) -> _ShardCfg:
    """The per-rank view of a TP-sharded model: local head counts (each
    rank's column shards hold 1/world of the heads); dim, head_dim,
    norms and RoPE stay global."""
    return _ShardCfg(n_heads=cfg.n_heads // world,
                     n_kv_heads=cfg.n_kv_heads // world,
                     head_dim=cfg.head_dim, dim=cfg.dim,
                     norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta,
                     dtype=cfg.dtype, attn_window=cfg.attn_window,
                     attn_soft_cap=cfg.attn_soft_cap)


def _tp_out_proj(o2, layer, *, axis=0):
    """Row-parallel attention output projection: each rank contracts its
    local head columns o2 [W, rows, Hq/W hd] against its ``wo`` row shard
    [W, Hq/W hd, D]; the sum over the rank axis (``axis``, dim 0) in rank
    order completes it (the reference's ``psum``)."""
    del axis
    return rank_sum(o2 @ layer["wo"], o2.dtype)


def _tp_ffn(h2, layer, *, axis=0):
    """Megatron MLP: column-parallel gate/up of the replicated rows h2
    [rows, D] against each rank's [W, D, F/W] shards, row-parallel down,
    the ranks' partials summed in rank order — the SwiGLU math of
    ``generate._dense_prompt_ffn`` over each rank's feature shard."""
    del axis
    act = _silu_mul(h2 @ layer["wgate"], h2 @ layer["wup"])
    return rank_sum(act @ layer["wdown"], h2.dtype)


def tp_paged_decode_shard(params, pools, tables, kv_lens, token, active, *,
                          cfg, page, world, ffn=None, out_proj=None):
    """Head-sharded twin of ``engine._paged_decode_forward``: QKV project
    onto every rank's head columns, the K/V scatter lands in each rank's
    pool shard and attention reads each rank's heads (one folded paged
    decode launch for every rank; no combine: heads are independent), the
    out and FFN seams sum the ranks' partials.  ``tables``/``kv_lens`` are
    world 1's; the logits come back whole, so sampling and commit are
    world 1's.  The engine's own forward does the addressing; this only
    supplies the TP seams (local-head cfg, rank-sum hooks).  ``ffn`` /
    ``out_proj`` override the default seams (the W8A8 hooks at
    ``axis=0``)."""
    from triton_dist_tpu_torch.serve.engine import _paged_decode_forward

    return _paged_decode_forward(
        params, pools, tables, kv_lens, token, active, cfg=cfg, page=page,
        fwd_cfg=_local_cfg(cfg, world), ffn=ffn or _tp_ffn,
        out_proj=out_proj or _tp_out_proj)


def tp_chunk_forward_shard(params, chunk, caches, prefix_len, n_valid, *,
                           cfg, extent, world, ffn=None, out_proj=None):
    """Head-sharded chunked prefill: ``generate._chunk_forward`` under the
    local-head view with the TP seams — each rank's head columns of the
    chunk's K/V go into its shard of the rank-stacked prefill scratch
    [W, 1, Hkv/W, S, D] (int8 rows quantize per (head, position), as world
    1's), and attention over every rank's heads is one call of the
    Generator's chunk attention (``generate._attend_prefix``) with the
    ranks folded into the batch."""

    def fold(x):
        return None if x is None else x.flatten(0, 1)

    def attend(q, k_view, v_view, plen, *, k_scale=None, v_scale=None):
        o = _attend_prefix(fold(q), fold(k_view), fold(v_view), plen,
                           k_scale=fold(k_scale), v_scale=fold(v_scale),
                           window=cfg.attn_window,
                           soft_cap=cfg.attn_soft_cap)
        return o.unflatten(0, (world, -1))

    return _chunk_forward(params, chunk, caches, prefix_len,
                          cfg=_local_cfg(cfg, world), ffn=ffn or _tp_ffn,
                          out_proj=out_proj or _tp_out_proj, extent=extent,
                          n_valid=n_valid, attend=attend)


# ---------------------------------------------------------------------------
# kv_shard="seq": rank tables over the partitioned pool, the SP programs
# ---------------------------------------------------------------------------


def _rebase_local(ids, *, world, num_blocks):
    """THE global -> local block-id rebase of the seq layout, for every
    rank at once: rank r owns global blocks ``[r * nb_loc, (r + 1) *
    nb_loc)``; returns ``(mine, local)``, each ``[W, *ids.shape]``, where
    foreign and padded ids (another rank's blocks, the global null) map to
    local row 0, the rank's own null."""
    nb_loc = num_blocks // world
    lo = (torch.arange(world, device=ids.device, dtype=ids.dtype)
          * nb_loc).reshape(-1, *([1] * ids.dim()))
    mine = (ids >= lo) & (ids < lo + nb_loc)
    return mine, torch.where(mine, ids - lo, torch.zeros_like(ids))


def _rank_tables(tables, *, world, num_blocks, n_pages_max):
    """Every rank's slice of the global block tables [B, n_pages_max] as
    rows of the shared pool: rank r's logical pages ``[r * n_loc, (r + 1)
    * n_loc)``, rebased (:func:`_rebase_local`) and moved back to r's
    rows, so foreign and padded entries read r's own null.  Returns
    [W, B, n_loc] int32."""
    n_loc = n_pages_max // world
    spans = tables.reshape(tables.shape[0], world, n_loc).transpose(0, 1)
    nb_loc = num_blocks // world
    r = torch.arange(world, device=tables.device, dtype=tables.dtype)
    _, local = _rebase_local(spans, world=world, num_blocks=num_blocks)
    own = local[r, r]                     # rank r's rebase of its own span
    return (own + (r * nb_loc)[:, None, None]).to(torch.int32)


def sp_paged_decode_shard(params, pools, tables, kv_lens, token, active, *,
                          cfg, page, world, num_blocks, n_pages_max,
                          ffn=None, out_proj=None):
    """Sequence-sharded twin of ``engine._paged_decode_forward``: the
    token's K/V land on the owner rank's page (its global id: the
    partitioned allocator placed the page in its owner's rows), and
    attention reads every rank's rebased table slice through
    ``sp_gqa_decode_paged_shard`` (one paged decode launch over W * B
    rows, then the combine kernel).  Logits [B, V] f32, held once."""
    from triton_dist_tpu_torch.serve.engine import (
        _page_slots,
        _pool_views,
        _scatter_kv,
    )

    inc = active.to(kv_lens.dtype)
    pool_row, in_page = _page_slots(tables, kv_lens, active, page=page)
    lt = _rank_tables(tables, world=world, num_blocks=num_blocks,
                      n_pages_max=n_pages_max)

    def write_kv(li, pool, k, v):
        return _scatter_kv(pool, k, v, pool_row, in_page)

    def attend(li, q, pool):
        kq, vq, ks, vs = _pool_views(pool)
        return sp_gqa_decode_paged_shard(
            q, kq, vq, lt, kv_lens + inc, soft_cap=cfg.attn_soft_cap,
            window=cfg.attn_window, k_scale=ks, v_scale=vs)

    return _token_forward(params, pools, token, kv_lens, cfg=cfg,
                          write_kv=write_kv, attend=attend, ffn=ffn,
                          out_proj=out_proj)


def _spans(x, world):
    """A replicated scratch view [B, Hkv, ext, ...] as rank spans
    [W, B, Hkv, ext / W, ...] (a strided view, no copy)."""
    if x is None:
        return None
    B, H, ext = x.shape[:3]
    return x.unflatten(2, (world, ext // world)).movedim(2, 0)


def sp_chunk_forward_shard(params, chunk, caches, prefix_len, n_valid, *,
                           cfg, extent, world, ffn=None, out_proj=None):
    """Sequence-sharded chunked prefill: the chunk's projections and its
    scratch K/V write stay replicated (the page scatter needs the whole
    scratch), and the attention read shards: rank r attends over rows
    ``[r * extent / W, (r + 1) * extent / W)`` of the extent-bounded
    scratch views (page_size % W and page-multiple extents make the split
    exact) through the Generator's own chunk attention over rank spans
    (``generate._attend_prefix(spans=True)``: the multi-token decode for
    chunks of 32 or fewer, the reference's route, and above that one
    flash call per rank, as the decode kernel holds at most 128 query
    rows), whose partials merge through the combine kernel."""

    def attend(q, k_view, v_view, plen, *, k_scale=None, v_scale=None):
        return _attend_prefix(
            q, _spans(k_view, world), _spans(v_view, world), plen,
            k_scale=_spans(k_scale, world), v_scale=_spans(v_scale, world),
            window=cfg.attn_window, soft_cap=cfg.attn_soft_cap, spans=True)

    return _chunk_forward(params, chunk, caches, prefix_len, cfg=cfg,
                          ffn=ffn, out_proj=out_proj, extent=extent,
                          n_valid=n_valid, attend=attend)
