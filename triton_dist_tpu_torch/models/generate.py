"""Autoregressive generation over a contiguous KV cache, at world 1 or
sequence-parallel over the ranks of a virtual world.

Counterpart of ``triton_dist_tpu/models/generate.py``: the
:class:`Generator` (``prefill``, ``prefill_chunked``, ``step``,
``generate``; ``mesh=`` a ``runtime.bootstrap.World`` shards every
layer's cache over its ranks' sequence spans, weights and activations
held once) and the shared layer math the serving engine reuses —
``_token_forward`` (one decode token, parameterized by the cache
addressing), ``_chunk_forward`` (one prompt chunk against the cached
prefix) and ``_prompt_forward`` (the full-prompt forward).  Attention runs
through the port's kernels: the flash prefill kernel for prompts and
chunks, the decode kernel for decode steps and chunks of 32 or fewer —
over float caches or int8 ones (``Generator(kv_dtype=torch.int8)``: each
layer's cache is a ``{"q", "s"}`` pair of int8 rows and f32 per-position
scales, and attention dequantizes inside the kernels).

PyTorch runs eagerly, so the reference's ``jax.jit`` programs are plain
calls, and cache writes land in place.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from triton_dist_tpu_torch.kernels.flash_attention import (
    flash_attention,
    flash_gqa_attention,
    sp_flash_attention_shard,
)
from triton_dist_tpu_torch.kernels.flash_decode import (
    gqa_decode_shard,
    quantize_kv,
    sp_gqa_decode_shard,
)
from triton_dist_tpu_torch.layers.sp_flash_decode import (
    SpGQAFlashDecodeAttention,
)
from triton_dist_tpu_torch.models.llama import (
    LlamaConfig,
    _rms_norm,
    _rope,
    _rope_table,
    _rotate,
    _silu_mul,
)
from triton_dist_tpu_torch.runtime.bootstrap import World
from triton_dist_tpu_torch.runtime.utils import resolve_device


@dataclass
class GenerationState:
    """Per-layer K/V caches + lengths."""

    caches: list  # [(k_cache, v_cache)] per layer, [B, Hkv, S, D] (or
    #               {"q": int8 [B, Hkv, S, D], "s": f32 [B, Hkv, S]});
    #               over W ranks rank-stacked [W, B, Hkv, S / W, ...]
    kv_lens: torch.Tensor  # [B] int32 — tokens currently in the cache
    last_logits: torch.Tensor  # [B, vocab] f32 — logits for the next token


def _rope_at(x, pos, theta, table=None):
    """RoPE for single-position vectors.  x [B, H, hd]; pos [B] int
    (``table``: their precomputed ``_rope_table``)."""
    cos, sin = table or _rope_table(pos, x.shape[-1], theta)
    return _rotate(x, cos[:, None, :], sin[:, None, :])


def _logits(x, lm_head):
    """The vocab projection with f32 logits (the reference's
    ``preferred_element_type=f32``): bf16 operands multiply with f32
    accumulation and an f32 result."""
    if x.dtype == torch.float32:
        return x @ lm_head
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda:
        out = torch.mm(x2, lm_head, out_dtype=torch.float32)
    else:
        out = x2.float() @ lm_head.float()
    return out.reshape(*x.shape[:-1], lm_head.shape[1])


def _default_out_proj(o2, layer):
    """Attention output projection ``[rows, Hq*hd] @ wo``."""
    return o2 @ layer["wo"]


def _dense_prompt_ffn(h2, layer):
    """The dense family's SwiGLU MLP over flattened tokens."""
    return _silu_mul(h2 @ layer["wgate"], h2 @ layer["wup"]) @ layer["wdown"]


def _token_forward(params, caches, token, pos, *, cfg: LlamaConfig,
                   write_kv, attend, ffn=None, out_proj=None):
    """ONE copy of the single-token decode layer math, parameterized by
    the cache addressing:

    - ``write_kv(li, cache, k, v) -> cache'`` stores the token's K/V
      ([B, Hkv, hd] each) in layer ``li``'s cache;
    - ``attend(li, q, cache) -> [B, Hq, hd]`` scores the query against
      the updated cache.

    ``Generator._step_impl`` (contiguous append + decode kernel) and
    ``serve.engine._paged_decode_forward`` (pool-page scatter + the paged
    kernel) are both this function with different pairs.  ``pos`` [B]
    carries each row's RoPE position (its cache length).

    Under the head-sharded layout (``serve/mesh.py``, ``kv_shard="heads"``)
    ``cfg`` is the local-head view and the QKV weights are rank-stacked
    [W, D, H/W hd]: q/k/v then carry a leading rank dimension ([W, B, H/W,
    hd]) through RoPE, ``write_kv`` and ``attend``, and the ``out_proj`` /
    ``ffn`` seams sum the ranks' partials back to the replicated [B, D]
    residual."""
    ffn = ffn or _dense_prompt_ffn
    out_proj = out_proj or _default_out_proj
    new_caches = []
    x = params["embed"][token.long()]                               # [B, D]
    table = _rope_table(pos, cfg.head_dim, cfg.rope_theta)
    for li, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = (h @ layer["wq"]).unflatten(-1, (cfg.n_heads, cfg.head_dim))
        k = (h @ layer["wk"]).unflatten(-1, (cfg.n_kv_heads, cfg.head_dim))
        v = (h @ layer["wv"]).unflatten(-1, (cfg.n_kv_heads, cfg.head_dim))
        q = _rope_at(q, pos, cfg.rope_theta, table)
        k = _rope_at(k, pos, cfg.rope_theta, table)
        cache = write_kv(li, caches[li], k, v)
        o = attend(li, q, cache)                                    # [B,Hq,hd]
        x = x + out_proj(o.flatten(-2).to(cfg.dtype), layer)
        h = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        x = x + ffn(h, layer)
        new_caches.append(cache)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return new_caches, _logits(x, params["lm_head"])


def _attend_prefix(q, k_all, v_all, prefix_len, *, k_scale=None,
                   v_scale=None, window=0, soft_cap=0.0, spans=False):
    """Chunk attention against the cache prefix + itself: q [B, c, Hq, hd];
    k/v_all [B, Hkv, S, hd] with the chunk's rows already written at
    [prefix, prefix + c); position j is visible to chunk row i iff
    j <= prefix + i.  Chunks of 32 or fewer ride the multi-token decode
    kernel (c * G query rows, one pass over the cache); larger ones the
    flash prefill kernel at ``q_offset = prefix_len``.  ``k_scale``/
    ``v_scale`` [B, Hkv, S] dequantize an int8 cache on either route.
    With ``spans`` the caches are rank-stacked sequence spans
    [W, B, Hkv, S_loc, hd] (scales [W, B, Hkv, S_loc]) and the routes are
    their sequence-parallel forms, the reference's world > 1 branches:
    ``sp_gqa_decode_shard`` (one decode launch for every rank) and
    ``sp_flash_attention_shard`` (a flash call per rank), the partials
    merged by the combine kernel on either.  The Generator and the seq
    engine (``serve/mesh.py``) both attend here.  Returns f32
    [B, c, Hq, hd]."""
    B, c = q.shape[0], q.shape[1]
    if c <= 32:
        lens = torch.full((B,), c + int(prefix_len), dtype=torch.int32,
                          device=q.device)
        kw = dict(k_scale=k_scale, v_scale=v_scale, soft_cap=soft_cap,
                  window=window)
        if spans:
            out = sp_gqa_decode_shard(q, k_all, v_all, lens, **kw)
        else:
            out, _ = gqa_decode_shard(q, k_all, v_all, lens, **kw)
        return out.float()
    flash = sp_flash_attention_shard if spans else flash_attention
    out = flash(q.permute(0, 2, 1, 3), k_all, v_all, causal=True,
                q_offset=prefix_len, k_scale=k_scale, v_scale=v_scale,
                window=window, soft_cap=soft_cap)
    return out.permute(0, 2, 1, 3).float()


def _write_chunk(cache, new, prefix_len):
    """Write chunk K or V rows [..., B, Hkv, c, hd] at ``prefix_len`` (in
    place; leading dims: a rank-stacked cache's); for a quantized cache
    dict the rows quantize and the scale plane updates too."""
    span = slice(prefix_len, prefix_len + new.shape[-2])
    if isinstance(cache, dict):
        q8, sc = quantize_kv(new)
        cache["q"][..., span, :] = q8
        cache["s"][..., span] = sc
        return cache
    cache[..., span, :] = new.to(cache.dtype)
    return cache


def _write_span_rows(cache, new, prefix_len):
    """Write rows [B, Hkv, c, ...] at global ``prefix_len`` into a
    rank-stacked cache [W, B, Hkv, S_loc, ...], in place: each rank's
    share lands in its own span (a chunk may cross span boundaries; rows
    past the last span are dropped)."""
    W, s_loc, c = cache.shape[0], cache.shape[3], new.shape[2]
    for r in range(prefix_len // s_loc,
                   min(W, -(-(prefix_len + c) // s_loc))):
        lo = max(prefix_len, r * s_loc)
        hi = min(prefix_len + c, (r + 1) * s_loc)
        cache[r, :, :, lo - r * s_loc:hi - r * s_loc] = \
            new[:, :, lo - prefix_len:hi - prefix_len]


def _write_chunk_spans(cache, new, prefix_len):
    """:func:`_write_chunk` for rank-stacked sequence spans: rows quantize
    whole (per position, as world 1's do), then land on their owners."""
    if isinstance(cache, dict):
        q8, sc = quantize_kv(new)
        _write_span_rows(cache["q"], q8, prefix_len)
        _write_span_rows(cache["s"], sc, prefix_len)
        return cache
    _write_span_rows(cache, new.to(cache.dtype), prefix_len)
    return cache


def _cache_views(k_c, v_c, extent):
    """(k, v, k_scale, v_scale): the attention reads of one layer's cache
    pair [..., S, hd] (scales [..., S], None for float caches), the
    position axis cut to ``extent`` when given."""
    if isinstance(k_c, dict):
        views = (k_c["q"], v_c["q"], k_c["s"], v_c["s"])
    else:
        views = (k_c, v_c, None, None)
    if extent is None:
        return views
    k, v, ks, vs = views
    return (k[..., :extent, :], v[..., :extent, :],
            None if ks is None else ks[..., :extent],
            None if vs is None else vs[..., :extent])


def _chunk_forward(params, chunk, caches, prefix_len, *, cfg: LlamaConfig,
                   extent: int | None = None, n_valid: int | None = None,
                   ffn=None, out_proj=None, attend=None, write=None):
    """One prompt chunk [B, c] against the cached prefix; returns
    (new_caches, logits [B, c, V] f32 — position i predicts the token
    after chunk[:, i]).  The chunk's own K/V are written to the cache
    first (quantized for int8 ``{"q", "s"}`` caches: the reference's static
    ``quantized`` flag is the cache type here), then attention reads the
    cache back, so later chunks and this one see the same K/V.  ``extent``
    bounds the cache rows attention reads.  ``n_valid`` marks rows >=
    n_valid as padding: their K/V are written as exact zeros, so a padded
    final chunk leaves the cache identical to an unpadded run (causality
    already hides those rows from every valid query).  ``attend(q, k_view,
    v_view, prefix_len, k_scale=, v_scale=)`` overrides the prefix
    attention (scale views are None for float caches); ``write(cache,
    rows, prefix_len)`` the cache write (rank-stacked spans:
    :func:`_write_chunk_spans`).  Rank-stacked QKV weights (the
    head-sharded layout, ``cfg`` its local-head view) give q/k/v a leading
    rank dimension, as in :func:`_token_forward`; the caches are then
    rank-stacked [W, B, Hkv/W, S, hd] and ``attend`` takes them so."""
    ffn = ffn or _dense_prompt_ffn
    write = write or _write_chunk
    out_proj = out_proj or _default_out_proj
    if attend is None:
        def attend(q, k, v, off, k_scale=None, v_scale=None):
            return _attend_prefix(q, k, v, off, k_scale=k_scale,
                                  v_scale=v_scale, window=cfg.attn_window,
                                  soft_cap=cfg.attn_soft_cap)
    prefix_len = int(prefix_len)
    B, c = chunk.shape
    hd = cfg.head_dim
    dev = params["embed"].device
    x = params["embed"][chunk.long()]                               # [B,c,D]
    positions = prefix_len + torch.arange(c, device=dev)
    cos, sin = _rope_table(positions, hd, cfg.rope_theta)
    keep = (None if n_valid is None else
            (torch.arange(c, device=dev) < int(n_valid))[None, :, None,
                                                         None])
    new_caches = []
    for li, layer in enumerate(params["layers"]):
        k_c, v_c = caches[li]
        h2 = _rms_norm(x, layer["attn_norm"], cfg.norm_eps).reshape(
            B * c, cfg.dim)
        q = (h2 @ layer["wq"]).unflatten(-1, (cfg.n_heads, hd))
        k = (h2 @ layer["wk"]).unflatten(-1, (cfg.n_kv_heads, hd))
        v = (h2 @ layer["wv"]).unflatten(-1, (cfg.n_kv_heads, hd))
        # [..., B, c, H, hd]; RoPE by chunk position
        q, k, v = (t.unflatten(-3, (B, c)) for t in (q, k, v))
        q = _rotate(q, cos[:, None, :], sin[:, None, :])
        k = _rotate(k, cos[:, None, :], sin[:, None, :])
        if keep is not None:
            k = torch.where(keep, k, torch.zeros_like(k))
            v = torch.where(keep, v, torch.zeros_like(v))
        k_c = write(k_c, k.transpose(-3, -2), prefix_len)
        v_c = write(v_c, v.transpose(-3, -2), prefix_len)
        new_caches.append((k_c, v_c))
        kq, vq, ks, vs = _cache_views(k_c, v_c, extent)
        o = attend(q, kq, vq, prefix_len, k_scale=ks, v_scale=vs)
        o = o.flatten(-2).flatten(-3, -2).to(cfg.dtype)     # [..., B c, .]
        x = x + out_proj(o, layer).reshape(B, c, cfg.dim)
        h2 = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(
            B * c, cfg.dim)
        x = x + ffn(h2, layer).reshape(B, c, cfg.dim)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return new_caches, _logits(x, params["lm_head"])


def _prompt_forward(params, tokens, *, cfg: LlamaConfig, ffn=None,
                    plain: bool = False):
    """Full-sequence forward that also returns the per-layer K/V
    (post-RoPE, cache layout [B, Hkv, S, hd]) and f32 logits [B, S, V].
    ``plain`` computes attention with the plain PyTorch version instead of
    the kernel (a reference forward on any device)."""
    ffn = ffn or _dense_prompt_ffn
    tokens = tokens.long()
    B, S = tokens.shape
    hd = cfg.head_dim
    x = params["embed"][tokens]                                     # [B,S,D]
    positions = torch.arange(S, device=x.device)
    table = _rope_table(positions, hd, cfg.rope_theta)
    kvs = []
    for layer in params["layers"]:
        h2 = _rms_norm(x, layer["attn_norm"], cfg.norm_eps).reshape(
            B * S, cfg.dim)
        q = (h2 @ layer["wq"]).reshape(B, S, cfg.n_heads, hd)
        k = (h2 @ layer["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
        v = (h2 @ layer["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
        # _rope expects [S, B, H, hd] (seq-major).
        q = _rope(q.transpose(0, 1), positions, cfg.rope_theta, table)
        k = _rope(k.transpose(0, 1), positions, cfg.rope_theta, table)
        v = v.transpose(0, 1)
        kvs.append((k.permute(1, 2, 0, 3), v.permute(1, 2, 0, 3)))
        o = flash_gqa_attention(q, k, v, causal=True, scale=hd ** -0.5,
                                window=cfg.attn_window,
                                soft_cap=cfg.attn_soft_cap, plain=plain)
        o = o.transpose(0, 1).reshape(B * S, cfg.n_heads * hd)
        x = x + (o @ layer["wo"]).reshape(B, S, cfg.dim)
        h2 = _rms_norm(x, layer["mlp_norm"], cfg.norm_eps).reshape(
            B * S, cfg.dim)
        x = x + ffn(h2, layer).reshape(B, S, cfg.dim)
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return kvs, _logits(x, params["lm_head"])


def _as_tokens(tokens, device):
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                           device=device)


class Generator:
    """Greedy (or sampled) autoregressive decoder for the Llama family.

    Usage::

        gen = Generator(cfg, max_seq=4096)              # device="cuda"
        state = gen.prefill(params, prompt_tokens)      # [B, S0]
        tokens, state = gen.generate(params, state, n_new=64)

    ``mesh=World(W)`` (``runtime.bootstrap.get_world``) serves the same
    model sequence-parallel: every layer's cache is cut into the W ranks'
    spans of ``max_seq / W`` positions, the prompt and decode forwards run
    once (weights and activations are held once), and attention runs
    every rank's partial over its span, then the inter-rank combine
    (``layers/sp_flash_decode.py``).

    ``kv_dtype=torch.int8`` keeps every cache quantized (int8 rows + f32
    per-position scales): prefill quantizes the prompt's K/V once,
    chunked prefill and each decode step quantize the rows they write,
    and the int8 kernels read them back.
    """

    def __init__(self, cfg: LlamaConfig, *, mesh: World | None = None,
                 max_seq: int | None = None, device="cuda", kv_dtype=None):
        self.cfg = cfg
        self.device = resolve_device(device if mesh is None else
                                     mesh.device)
        self.max_seq = max_seq or cfg.max_seq
        self.attn = SpGQAFlashDecodeAttention(
            mesh, device=self.device,
            check_bounds=False,  # the Generator guards lengths itself
            kv_dtype=kv_dtype, soft_cap=cfg.attn_soft_cap,
            window=cfg.attn_window)
        self.world = self.attn.world
        if self.max_seq % self.world:
            raise ValueError(f"max_seq {self.max_seq} must divide by the "
                             f"world size {self.world}")

    # -- prefill ----------------------------------------------------------

    def prefill(self, params, tokens) -> GenerationState:
        """Run the prompt [B, S0], fill the caches, return the state."""
        cfg = self.cfg
        tokens = _as_tokens(tokens, self.device)
        B, S0 = tokens.shape
        if S0 > self.max_seq:
            raise ValueError(f"prompt length {S0} > max_seq {self.max_seq}")
        kvs, logits = _prompt_forward(params, tokens, cfg=cfg,
                                      ffn=self._ffn_prompt)
        caches = [self.attn.init_cache(B, cfg.n_kv_heads, self.max_seq,
                                       cfg.head_dim, dtype=cfg.dtype,
                                       k_init=k, v_init=v)
                  for k, v in kvs]
        lens = torch.full((B,), S0, dtype=torch.int32, device=self.device)
        return GenerationState(caches=caches, kv_lens=lens,
                               last_logits=logits[:, -1])

    def prefill_chunked(self, params, tokens,
                        chunk_size: int = 512) -> GenerationState:
        """Prefill in fixed-size chunks against the growing KV cache (the
        scores are [chunk, extent] instead of [S0, S0]); same final state
        as :meth:`prefill` up to the quantization of earlier chunks' K/V
        in an int8 cache."""
        cfg = self.cfg
        tokens = _as_tokens(tokens, self.device)
        B, S0 = tokens.shape
        if S0 > self.max_seq:
            raise ValueError(f"prompt length {S0} > max_seq {self.max_seq}")
        caches = [self.attn.init_cache(B, cfg.n_kv_heads, self.max_seq,
                                       cfg.head_dim, dtype=cfg.dtype)
                  for _ in range(cfg.n_layers)]
        logits = None
        extent = min(self.max_seq, -(-S0 // chunk_size) * chunk_size)
        kw = dict(extent=extent)
        if self.world > 1:
            # every rank attends over its whole span (masks bound the
            # read), and writes land on the rows' owners
            kw = dict(write=_write_chunk_spans,
                      attend=functools.partial(
                          _attend_prefix, window=cfg.attn_window,
                          soft_cap=cfg.attn_soft_cap, spans=True))
        for off in range(0, S0, chunk_size):
            caches, logits = _chunk_forward(
                params, tokens[:, off:off + chunk_size], caches, off,
                cfg=cfg, ffn=self._ffn_prompt, **kw)
        lens = torch.full((B,), S0, dtype=torch.int32, device=self.device)
        return GenerationState(caches=caches, kv_lens=lens,
                               last_logits=logits[:, -1])

    # -- decode -----------------------------------------------------------

    def step(self, params, state: GenerationState, token,
             active=None) -> GenerationState:
        """One decode step: token [B] → next state.  Rows with
        ``active[b] == False`` are frozen (their length does not advance).
        Raises on cache overflow."""
        lens = state.kv_lens
        if active is not None:
            lens = torch.where(active.to(lens.device), lens,
                               torch.full_like(lens, -1))
        top = int(lens.max())
        if top >= self.max_seq:
            raise ValueError(f"KV cache overflow: decode at position {top} "
                             f"but max_seq={self.max_seq}")
        caches, kv_lens, logits = self._step_impl(
            params, state.caches, state.kv_lens,
            _as_tokens(token, self.device), active)
        return GenerationState(caches=caches, kv_lens=kv_lens,
                               last_logits=logits)

    def _ffn_prompt(self, h2, layer):
        """FFN hook of the prompt and chunk forwards (a family's
        subclass routes its own FFN through it)."""
        return _dense_prompt_ffn(h2, layer)

    def _ffn_decode(self, h, layer):
        """FFN hook of a decode step."""
        return _dense_prompt_ffn(h, layer)

    def _step_impl(self, params, caches, kv_lens, token, active=None):
        inc = (torch.ones_like(kv_lens) if active is None
               else active.to(device=kv_lens.device, dtype=kv_lens.dtype))

        def write_kv(li, cache, k, v):
            return self.attn.append_kv(cache[0], cache[1], k, v, kv_lens)

        def attend(li, q, cache):
            return self.attn(q, cache[0], cache[1], kv_lens + inc)

        new_caches, logits = _token_forward(
            params, caches, token, kv_lens, cfg=self.cfg,
            write_kv=write_kv, attend=attend, ffn=self._ffn_decode)
        return new_caches, kv_lens + inc, logits

    def generate(self, params, state: GenerationState, n_new: int,
                 sample=None, generator: torch.Generator | None = None,
                 eos_id: int | None = None):
        """Generate up to ``n_new`` tokens; returns (tokens [B, n_new]
        int32, state).  Token choice: greedy argmax by default;
        ``sample(logits, generator)`` draws when ``generator`` is given
        (``sample`` defaults to ``sampling.sample_logits``); ``sample``
        alone is called as ``sample(logits)``.  Rows that emit ``eos_id``
        keep emitting it; the loop exits once every row has."""
        top = int(state.kv_lens.max())
        if top + n_new > self.max_seq:
            raise ValueError(f"generate({n_new}) from position {top} would "
                             f"overflow max_seq={self.max_seq}")
        if generator is not None and sample is None:
            from triton_dist_tpu_torch.models.sampling import sample_logits
            sample = sample_logits
        outs = []
        done = None
        for _ in range(n_new):
            if generator is not None:
                token = sample(state.last_logits, generator)
            elif sample is not None:
                token = sample(state.last_logits)
            else:
                token = torch.argmax(state.last_logits, dim=-1).to(
                    torch.int32)
            if eos_id is not None:
                if done is None:
                    done = torch.zeros(token.shape, dtype=torch.bool,
                                       device=token.device)
                token = torch.where(done, torch.full_like(token, eos_id),
                                    token)
                done = done | (token == eos_id)
            state = self.step(params, state, token)
            outs.append(token)
            if eos_id is not None and bool(done.all()):
                break
        tokens = torch.stack(outs, dim=1)
        if eos_id is not None and tokens.shape[1] < n_new:
            pad = torch.full((tokens.shape[0], n_new - tokens.shape[1]),
                             eos_id, dtype=tokens.dtype,
                             device=tokens.device)
            tokens = torch.cat([tokens, pad], dim=1)
        return tokens, state
