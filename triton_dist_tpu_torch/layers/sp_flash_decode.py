"""Sequence-parallel GQA flash-decode attention layer.

Counterpart of ``triton_dist_tpu/layers/sp_flash_decode.py``'s
``SpGQAFlashDecodeAttention``: ``init_cache``, ``append_kv`` and
``__call__`` (contiguous caches, or paged pools with a block table) and
``init_paged_cache``, over float caches or int8 caches
(``kv_dtype=torch.int8``: each cache is a ``{"q": int8, "s": f32}`` pair
of rows and per-position scales, rows quantized by ``quantize_kv`` as they
land).

At world 1 a cache is ``[B, Hkv, S, D]`` (scales ``[B, Hkv, S]``).  Over
the W ranks of a virtual world (``mesh=``, a ``runtime.bootstrap.World``:
the reference's mesh axis) the sequence axis is sharded: a cache is
rank-stacked ``[W, B, Hkv, S / W, D]``, rank r holding positions
``[r * S / W, (r + 1) * S / W)`` of every sequence; an append lands on the
owner rank ``pos // (S / W)`` alone, and attention runs every rank's
local decode in one launch, then the inter-rank combine
(``kernels/flash_decode.py``).  Paged pools are shared by the ranks: rank r
owns pool rows ``[r * N / W, (r + 1) * N / W)`` and the logical pages
``[r * n / W, (r + 1) * n / W)`` of each sequence.

Cache updates are in place (the reference's arrays are immutable; here
the write lands in the cache tensor itself).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_decode import (
    create_sp_decode_context,
    gqa_decode_shard,
    quantize_kv,
    shard_seq,
    sp_gqa_decode_paged_shard,
    sp_gqa_decode_shard,
)
from triton_dist_tpu_torch.runtime.bootstrap import World


class SpGQAFlashDecodeAttention:
    """Decode-side attention over a KV cache pair, sequence-sharded over
    ``mesh`` (a :class:`World`; None: world 1 on ``device``).

    Usage::

        layer = SpGQAFlashDecodeAttention(mesh=world)     # or world 1
        k_cache, v_cache = layer.init_cache(B, Hkv, S, D, torch.bfloat16)
        k_cache, v_cache = layer.append_kv(k_cache, v_cache, k_t, v_t, lens)
        out = layer(q, k_cache, v_cache, lens + 1)
    """

    def __init__(self, mesh: World | None = None, *, device="cuda",
                 check_bounds: bool = True, kv_dtype=None,
                 soft_cap: float = 0.0, window: int = 0):
        if kv_dtype not in (None, torch.int8):
            raise ValueError(f"kv_dtype must be None (float caches) or "
                             f"torch.int8, got {kv_dtype}")
        self.ctx = create_sp_decode_context(
            mesh if mesh is not None else 1, soft_cap=soft_cap,
            window=window, device=device)
        self.device = self.ctx.world.device
        self.check_bounds = check_bounds
        self.soft_cap = soft_cap
        self.window = window
        self.kv_dtype = kv_dtype

    @property
    def mesh(self) -> World:
        return self.ctx.world

    @property
    def world(self) -> int:
        return self.ctx.world.size

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == torch.int8

    def _place(self, x):
        """A world-1 tensor [B, Hkv, S, ...] in this layer's layout."""
        return x if self.world == 1 else shard_seq(x, self.world)

    def init_cache(self, batch: int, n_kv_heads: int, max_seq: int,
                   head_dim: int, dtype=torch.bfloat16, k_init=None,
                   v_init=None):
        """Zeroed K/V caches in this layer's layout; ``k_init``/``v_init``
        [B, Hkv, S0, D] (the prefill K/V, held once) land at positions
        [0, S0) — cut into the ranks' spans, and quantized on the way in
        for an int8 cache (whose unwritten scales are 1, as in the
        reference)."""
        if max_seq % self.world:
            raise ValueError(f"max_seq {max_seq} must divide by the world "
                             f"size {self.world}")
        shape = (batch, n_kv_heads, max_seq, head_dim)
        if self.quantized:
            caches = []
            for init in (k_init, v_init):
                c = {"q": torch.zeros(shape, dtype=torch.int8,
                                      device=self.device),
                     "s": torch.ones(shape[:3], dtype=torch.float32,
                                     device=self.device)}
                if init is not None:
                    q8, sc = quantize_kv(init)
                    c["q"][:, :, :init.shape[2]] = q8
                    c["s"][:, :, :init.shape[2]] = sc
                caches.append({n: self._place(t) for n, t in c.items()})
            return caches[0], caches[1]
        k = torch.zeros(shape, dtype=dtype, device=self.device)
        v = torch.zeros(shape, dtype=dtype, device=self.device)
        if k_init is not None:
            k[:, :, :k_init.shape[2]] = k_init.to(dtype)
            v[:, :, :v_init.shape[2]] = v_init.to(dtype)
        return self._place(k), self._place(v)

    def append_kv(self, k_cache, v_cache, new_k, new_v, kv_lens):
        """Write one token's K/V [B, Hkv, D] at global position
        ``kv_lens[b]`` of each row, in place: at world W on the owner rank
        ``pos // S_loc`` only, row ``pos % S_loc`` (quantized per (row,
        head) for an int8 cache, the reference's ``append_kv_shard_q``).
        Raises on overflow when ``check_bounds``: a dropped append would
        leave the next decode reading stale rows."""
        quantized = isinstance(k_cache, dict)
        if quantized != self.quantized:
            raise ValueError(f"cache/layer mismatch: layer kv_dtype="
                             f"{self.kv_dtype} but the cache is "
                             f"{'int8' if quantized else 'float'}")
        data = k_cache["q"] if quantized else k_cache
        s_loc = data.shape[-2]
        max_seq = s_loc * self.world
        if self.check_bounds and int(kv_lens.max()) >= max_seq:
            raise ValueError(
                f"KV cache overflow: append at position "
                f"{int(kv_lens.max())} but max_seq={max_seq}")
        dev = new_k.device
        rows = torch.arange(new_k.shape[0], device=dev)
        pos = kv_lens.to(device=dev, dtype=torch.long)
        # A row past the end (an unchecked caller) rewrites the last
        # position with its own value, as the reference's owner-rank write
        # does: a mask instead of a boolean selection, so no host sync
        keep = pos < max_seq
        pos = pos.clamp(max=max_seq - 1)
        # [owner rank,] batch row, all heads, local position
        at = ((rows, slice(None), pos) if self.world == 1 else
              (pos // s_loc, rows, slice(None), pos % s_loc))

        def put(cache, new):
            mask = keep.view(-1, *([1] * (new.dim() - 1)))
            cache[at] = torch.where(mask, new.to(cache.dtype), cache[at])

        if quantized:
            for cache, new in ((k_cache, new_k), (v_cache, new_v)):
                q8, sc = quantize_kv(new)
                put(cache["q"], q8)
                put(cache["s"], sc)
            return k_cache, v_cache
        put(k_cache, new_k)
        put(v_cache, new_v)
        return k_cache, v_cache

    def __call__(self, q, k_cache, v_cache, kv_lens, block_table=None):
        """q [B, Hq, D] -> attention output [B, Hq, D] in q's dtype.

        With ``block_table`` [B, W * n_local] the caches are PAGED pools
        [W * N_loc, Hkv, page, D] (int8: ``{"q", "s"}`` pools): logical
        page i of batch b lives at pool row ``block_table[b, i]``, and
        rank r owns logical pages [r * n_local, (r + 1) * n_local), whose
        entries must point into its rows [r * N_loc, (r + 1) * N_loc)."""
        if isinstance(k_cache, dict) != self.quantized:
            raise ValueError("cache/layer mismatch (see append_kv)")
        scales = {}
        if isinstance(k_cache, dict):
            scales = dict(k_scale=k_cache["s"], v_scale=v_cache["s"])
            k_cache, v_cache = k_cache["q"], v_cache["q"]
        kw = dict(soft_cap=self.soft_cap, window=self.window, **scales)
        if block_table is not None:
            W = self.world
            if block_table.shape[1] % W or k_cache.shape[0] % W:
                raise ValueError(
                    f"block_table columns {block_table.shape[1]} and pool "
                    f"rows {k_cache.shape[0]} must divide by the world "
                    f"size {W}")
            n_local = block_table.shape[1] // W
            tables = block_table.reshape(-1, W, n_local).transpose(0, 1)
            return sp_gqa_decode_paged_shard(q, k_cache, v_cache,
                                             tables.contiguous(), kv_lens,
                                             **kw)
        if self.world == 1:
            out, _ = gqa_decode_shard(q, k_cache, v_cache, kv_lens, **kw)
            return out.to(q.dtype)
        return sp_gqa_decode_shard(q, k_cache, v_cache, kv_lens, **kw)

    # -- paged cache (block_table) ---------------------------------------

    def init_paged_cache(self, batch: int, n_kv_heads: int, page: int,
                         pages_per_seq: int, head_dim: int,
                         dtype=torch.bfloat16):
        """Zeroed page pools and a block table: ``pages_per_seq`` logical
        pages per sequence (a multiple of the world size); every rank's
        share of the pool holds ``batch * pages_per_seq / W`` pages, so
        each (sequence, logical page) pair has its own pool row.  Returns
        (k_pool, v_pool [W * N_loc, Hkv, page, D], table [batch,
        pages_per_seq] int32), rank r owning logical pages
        [r * n / W, (r + 1) * n / W) in its own rows."""
        W = self.world
        if pages_per_seq % W:
            raise ValueError(f"pages_per_seq {pages_per_seq} must divide by "
                             f"the world size {W}")
        n_seq_loc = pages_per_seq // W
        n_loc = batch * n_seq_loc
        shape = (W * n_loc, n_kv_heads, page, head_dim)
        pool_k = torch.zeros(shape, dtype=dtype, device=self.device)
        pool_v = torch.zeros(shape, dtype=dtype, device=self.device)
        i = torch.arange(pages_per_seq, dtype=torch.int32,
                         device=self.device)
        r, j = i // n_seq_loc, i % n_seq_loc
        b = torch.arange(batch, dtype=torch.int32, device=self.device)[:, None]
        table = r[None] * n_loc + b * n_seq_loc + j[None]
        return pool_k, pool_v, table
