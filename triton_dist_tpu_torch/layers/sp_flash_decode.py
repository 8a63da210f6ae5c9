"""GQA flash-decode attention layer over a contiguous KV cache (world 1).

Counterpart of ``triton_dist_tpu/layers/sp_flash_decode.py``'s
``SpGQAFlashDecodeAttention``: ``init_cache``, ``append_kv`` and
``__call__`` at world 1, over float caches or int8 caches
(``kv_dtype=torch.int8``: each cache is a ``{"q": int8 [B, Hkv, S, D],
"s": f32 [B, Hkv, S]}`` pair, rows quantized by ``quantize_kv`` as they
land).  The sequence-parallel (world > 1) layout and paged calls through
the layer are not ported yet: ROADMAP Queue 1 item 12.  The cache update is
in place (the reference's arrays are immutable; here the write lands in
the cache tensor itself).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_decode import (
    gqa_decode_shard,
    quantize_kv,
)


class SpGQAFlashDecodeAttention:
    """Decode-side attention over a ``[B, Hkv, S, D]`` cache pair.

    Usage::

        layer = SpGQAFlashDecodeAttention(device="cuda")
        k_cache, v_cache = layer.init_cache(B, Hkv, S, D, torch.bfloat16)
        k_cache, v_cache = layer.append_kv(k_cache, v_cache, k_t, v_t, lens)
        out = layer(q, k_cache, v_cache, lens + 1)
    """

    def __init__(self, *, world: int = 1, device="cuda",
                 check_bounds: bool = True, kv_dtype=None,
                 soft_cap: float = 0.0, window: int = 0):
        if world != 1:
            raise NotImplementedError(
                "sequence-parallel decode (world > 1) is not ported yet: "
                "ROADMAP Queue 1 item 12")
        if kv_dtype not in (None, torch.int8):
            raise ValueError(f"kv_dtype must be None (float caches) or "
                             f"torch.int8, got {kv_dtype}")
        self.world = 1
        self.device = torch.device(device)
        self.check_bounds = check_bounds
        self.soft_cap = soft_cap
        self.window = window
        self.kv_dtype = kv_dtype

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == torch.int8

    def init_cache(self, batch: int, n_kv_heads: int, max_seq: int,
                   head_dim: int, dtype=torch.bfloat16, k_init=None,
                   v_init=None):
        """Zeroed K/V caches [B, Hkv, S, D]; ``k_init``/``v_init``
        [B, Hkv, S0, D] (the prefill K/V) land at positions [0, S0),
        quantized on the way in for an int8 cache (whose unwritten scales
        are 1, as in the reference)."""
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
                caches.append(c)
            return caches[0], caches[1]
        k = torch.zeros(shape, dtype=dtype, device=self.device)
        v = torch.zeros(shape, dtype=dtype, device=self.device)
        if k_init is not None:
            k[:, :, :k_init.shape[2]] = k_init.to(dtype)
            v[:, :, :v_init.shape[2]] = v_init.to(dtype)
        return k, v

    def append_kv(self, k_cache, v_cache, new_k, new_v, kv_lens):
        """Write one token's K/V [B, Hkv, D] at position ``kv_lens[b]`` of
        each row (in place; quantized per (row, head) for an int8 cache,
        ``append_kv_shard_q``).  Raises on overflow when ``check_bounds``:
        a dropped append would leave the next decode reading stale rows."""
        quantized = isinstance(k_cache, dict)
        if quantized != self.quantized:
            raise ValueError(f"cache/layer mismatch: layer kv_dtype="
                             f"{self.kv_dtype} but the cache is "
                             f"{'int8' if quantized else 'float'}")
        max_seq = (k_cache["q"] if quantized else k_cache).shape[2]
        if self.check_bounds and int(kv_lens.max()) >= max_seq:
            raise ValueError(
                f"KV cache overflow: append at position "
                f"{int(kv_lens.max())} but max_seq={max_seq}")
        B = new_k.shape[0]
        dev = new_k.device
        rows = torch.arange(B, device=dev)
        pos = kv_lens.to(device=dev, dtype=torch.long)
        # Rows past the end (unchecked callers) leave the cache untouched,
        # as the reference's owner-rank write does.
        keep = pos < max_seq
        rows, pos = rows[keep], pos[keep]
        if quantized:
            for cache, new in ((k_cache, new_k), (v_cache, new_v)):
                q8, sc = quantize_kv(new[keep])
                cache["q"][rows, :, pos] = q8
                cache["s"][rows, :, pos] = sc
            return k_cache, v_cache
        k_cache[rows, :, pos] = new_k[keep].to(k_cache.dtype)
        v_cache[rows, :, pos] = new_v[keep].to(v_cache.dtype)
        return k_cache, v_cache

    def __call__(self, q, k_cache, v_cache, kv_lens):
        """q [B, Hq, D] → attention output [B, Hq, D] in q's dtype."""
        if isinstance(k_cache, dict):
            out, _ = gqa_decode_shard(q, k_cache["q"], v_cache["q"], kv_lens,
                                      k_scale=k_cache["s"],
                                      v_scale=v_cache["s"],
                                      soft_cap=self.soft_cap,
                                      window=self.window)
        else:
            out, _ = gqa_decode_shard(q, k_cache, v_cache, kv_lens,
                                      soft_cap=self.soft_cap,
                                      window=self.window)
        return out.to(q.dtype)
