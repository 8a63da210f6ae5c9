"""The continuous-batching step loop over a paged KV cache (world 1).

Counterpart of the world-1 core of ``triton_dist_tpu/serve/engine.py``.
Each :meth:`ServeEngine.step` is one scheduler iteration:

1. **Admit** waiting requests into free batch slots while the block
   manager can cover their prompt (+1 decode block of headroom).
2. **Prefill** admitted prompts in fixed-size chunks against a
   per-request contiguous scratch cache (``generate._chunk_forward``:
   the flash prefill kernel), metered by the scheduler's token budget; a
   completed prompt's K/V scatter into the request's pool pages and its
   first token is chosen.
3. **Decode** all running rows in one batched forward
   (``_paged_decode_forward``: the paged decode kernel over per-row block
   tables); inactive slots write to the reserved null block 0.

Requests retire individually; when a running request cannot extend its
allocation the scheduler preempts the latest-admitted request
(recompute: its emitted tokens are kept and it re-prefills
``prompt + generated``).

Quantized serving (the reference's "Quantized serving"): a
``Generator(kv_dtype=torch.int8)`` makes every pool layer a
``{"q": int8 [NB, Hkv, page, D], "s": f32 [NB, Hkv, page]}`` pair —
``_scatter_kv`` quantizes rows as they land, the page fill moves int8
bytes and scales verbatim (never a dequant/requant round trip), and the
paged decode kernel dequantizes inside attention; ``w8a8=True`` swaps the
weight tree once for ``llama_w8a8.quantize_serve_params`` and binds the
W8A8 ``ffn``/``out_proj`` hooks on the prefill and decode forwards.  The
two compose.

Sharded serving over the W ranks of a ``runtime.bootstrap.World``
(``mesh=``), the decode and chunked-prefill programs ``serve/mesh.py``'s:

- ``kv_shard="seq"``: weights stay whole, the pools shard by block over
  the ranks' sequence spans (the partitioned ``BlockManager``), attention
  is every rank's partial, then the SP combine kernel;
- ``kv_shard="heads"`` (the default, as the reference's; ``None`` means
  it too): tensor-parallel weights (``llama.shard_params``:
  QKV and gate/up by columns, out and down by rows, rank-stacked), pools
  rank-stacked by KV head ``[W, num_blocks, Hkv/W, page, D]`` (int8
  pools' scale planes with them), one folded paged decode launch over
  every rank's heads, and the row-parallel seams summed over the ranks;
  ``w8a8=True`` composes (the hooks' ``axis=0``).  Page ownership and
  block tables are world 1's (the reference replicates them).

The page fill is world 1's under both.  ``mesh=None`` is the world-1
engine.

PyTorch runs eagerly, so the reference's counted jit programs are plain
calls and pools update in place.  Options of the reference engine that
are not ported yet raise ``NotImplementedError`` naming their ROADMAP
item: decode horizon, speculative decoding, prefix cache, failure
containment and crash recovery, overload control, the ``heads+seq``
mesh layout.
"""

from __future__ import annotations

import functools
import sys
import time
from typing import Optional

import numpy as np
import torch

from triton_dist_tpu_torch.kernels.flash_decode import (
    gqa_decode_paged_shard,
    quantize_kv,
)
from triton_dist_tpu_torch.models import llama_w8a8
from triton_dist_tpu_torch.models.llama import shard_params
from triton_dist_tpu_torch.models.generate import (
    Generator,
    _chunk_forward,
    _token_forward,
)
from triton_dist_tpu_torch.models.sampling import sample_logits
from triton_dist_tpu_torch.runtime.bootstrap import World, canonical_device
from triton_dist_tpu_torch.runtime.utils import tree_leaves
from triton_dist_tpu_torch.serve import mesh as serve_mesh
from triton_dist_tpu_torch.serve.block_manager import (
    BlockExhausted,
    BlockManager,
)
from triton_dist_tpu_torch.serve.metrics import RequestMetrics, ServeMetrics
from triton_dist_tpu_torch.serve.request import (
    FinishReason,
    Request,
    RequestOutput,
)
from triton_dist_tpu_torch.serve.scheduler import (
    FCFSScheduler,
    ReqState,
    Status,
)


# ---------------------------------------------------------------------------
# Paged model forwards (dense Llama family)
# ---------------------------------------------------------------------------


def _page_slots(tables, kv_lens, active, *, page):
    """Physical (pool row, in-page row) for each batch row's next write.
    Inactive rows redirect to the null block (pool row 0, row 0): their
    table entries may be stale — a freed page can already belong to
    another request."""
    n_pages = tables.shape[1]
    logical = torch.clamp(kv_lens // page, max=n_pages - 1)[:, None]
    pool_row = torch.gather(tables, 1, logical.long())[:, 0]
    in_page = kv_lens % page
    zero = torch.zeros_like(pool_row)
    return (torch.where(active, pool_row, zero),
            torch.where(active, in_page, torch.zeros_like(in_page)))


def _scatter_kv(pool, k, v, pool_row, in_page):
    """The one paged K/V write: new rows [B, Hkv, D] land at
    (pool_row, in_page) of each pool, in place.  Quantized pools
    (``{"q", "s"}`` dicts) quantize each new row here — ``quantize_kv``'s
    per-(head, position) absmax over D, the contiguous cache's recipe —
    so a row's int8 bytes and its scale land together."""
    k_pool, v_pool = pool
    r, p = pool_row.long(), in_page.long()
    if isinstance(k_pool, dict):
        for dst, new in ((k_pool, k), (v_pool, v)):
            q8, sc = quantize_kv(new)
            dst["q"][r, :, p, :] = q8
            dst["s"][r, :, p] = sc
        return k_pool, v_pool
    k_pool[r, :, p, :] = k.to(k_pool.dtype)
    v_pool[r, :, p, :] = v.to(v_pool.dtype)
    return k_pool, v_pool


def _pool_views(pool):
    """``(k, v, k_scale, v_scale)`` kernel views of one pool layer: float
    pools give ``(k, v, None, None)``; int8 dict pools their quant and
    scale planes."""
    k_pool, v_pool = pool
    if isinstance(k_pool, dict):
        return k_pool["q"], v_pool["q"], k_pool["s"], v_pool["s"]
    return k_pool, v_pool, None, None


def _fold(x):
    """A rank-stacked tensor [W, N, ...] viewed as [W N, ...] (a view: an
    in-place write lands in the stack); None stays None."""
    return None if x is None else x.flatten(0, 1)


def _fold_pool(pool):
    """A rank-stacked pool layer (K, V), each [W, NB, Hkv/W, page, D] or
    an int8 ``{"q", "s"}`` pair of such planes, as one pool of W NB
    blocks (views)."""
    return tuple({n: _fold(t) for n, t in x.items()} if isinstance(x, dict)
                 else _fold(x) for x in pool)


def _rank_rows(ids, world, num_blocks):
    """Block ids [B, ...] of every rank's pool as rows of the folded pool:
    rank r's at ``id + r * num_blocks``, [W B, ...] (the null block 0
    becomes each rank's own row 0)."""
    off = torch.arange(world, device=ids.device, dtype=ids.dtype)
    return (ids[None] + (off * num_blocks).reshape(
        -1, *([1] * ids.dim()))).flatten(0, 1)


def _paged_decode_forward(params, pools, tables, kv_lens, token, active, *,
                          cfg, page, fwd_cfg=None, ffn=None, out_proj=None):
    """One decode token for every batch row over the paged pools:
    ``generate._token_forward`` with the contiguous append swapped for a
    pool-page scatter and attention through the paged decode kernel.

    ``fwd_cfg``/``ffn``/``out_proj`` are the tensor-parallel seams
    (``serve/mesh.py``; or the W8A8 hooks): the layer math runs under
    ``fwd_cfg`` (the local-head view) while the page addressing and the
    kernel's soft-cap/window stay on ``cfg``.  Under the head-sharded
    layout the pools are rank-stacked by KV head [W, NB, Hkv/W, page, D]
    and q/k/v carry a leading rank dimension: the W ranks' scatters and
    decodes fold into one batch of W B rows (each rank's table rebased
    onto its own pool rows), one launch for every rank — ONE copy of the
    block-table addressing for world 1 and every rank."""
    pool_row, in_page = _page_slots(tables, kv_lens, active, page=page)
    lens = kv_lens + active.to(kv_lens.dtype)
    k0 = _pool_views(pools[0])[0]
    world = k0.shape[0] if k0.dim() == 5 else None
    if world is not None:
        pool_row, tables = (_rank_rows(t, world, k0.shape[1])
                            for t in (pool_row, tables))
        in_page, lens = in_page.repeat(world), lens.repeat(world)
    fold = (lambda x: x) if world is None else _fold

    def write_kv(li, pool, k, v):
        _scatter_kv(pool if world is None else _fold_pool(pool), fold(k),
                    fold(v), pool_row, in_page)
        return pool

    def attend(li, q, pool):
        kq, vq, ks, vs = _pool_views(pool)
        o, _ = gqa_decode_paged_shard(
            fold(q), fold(kq), fold(vq), tables, lens,
            soft_cap=cfg.attn_soft_cap, window=cfg.attn_window,
            k_scale=fold(ks), v_scale=fold(vs))
        return o if world is None else o.unflatten(0, (world, -1))

    return _token_forward(params, pools, token, kv_lens, cfg=fwd_cfg or cfg,
                          write_kv=write_kv, attend=attend, ffn=ffn,
                          out_proj=out_proj)


def _fill_pool_pages(pools, scratch, block_ids, *, page):
    """Scatter a completed prefill's K/V (contiguous scratch caches
    [1, Hkv, n*page, D] per layer; rank-stacked [W, 1, Hkv/W, n*page, D]
    into pools [W, NB, Hkv/W, page, D] under the head-sharded layout)
    into the request's pool pages, in place.  ``block_ids`` covers every
    scratch page; entries past the prompt's allocation hold the null
    block, so duplicate null ids only ever carry the scratch's zero
    padding.  A quantized scratch's int8 bytes and scales move as they
    are: quantization is not idempotent, so the pool rows stay
    bit-identical to the scratch rows."""
    n = block_ids.shape[0]
    ids = block_ids.long()

    def as_pages(c):    # [..., 1, Hkv, n page, D] -> [..., n, Hkv, page, D]
        return c.select(-4, 0).unflatten(-2, (n, page)).transpose(-4, -3)

    def as_pages_s(sc):     # [..., 1, Hkv, n page] -> [..., n, Hkv, page]
        return sc.select(-3, 0).unflatten(-1, (n, page)).transpose(-3, -2)

    for (k_pool, v_pool), (kc, vc) in zip(pools, scratch):
        for dst, src in ((k_pool, kc), (v_pool, vc)):
            if isinstance(dst, dict):
                dst["q"][..., ids, :, :, :] = as_pages(src["q"])
                dst["s"][..., ids, :, :] = as_pages_s(src["s"])
            else:
                dst[..., ids, :, :, :] = as_pages(src).to(dst.dtype)
    return pools


def build_bucket_ladder(base: int, cap: int, page: int) -> list[int]:
    """The powers-of-two scratch-extent ladder: rungs double from
    ``base`` (rounded up to a page multiple) until ``cap``, which always
    closes the ladder.  Every rung is a multiple of ``page``."""
    if base < 1 or cap < 1:
        raise ValueError(f"ladder needs base, cap >= 1; got {base}, {cap}")
    cap = -(-cap // page) * page
    rungs = []
    r = -(-base // page) * page
    while r < cap:
        rungs.append(r)
        r *= 2
    rungs.append(cap)
    return rungs


def _not_ported(option: str, item: str):
    raise NotImplementedError(
        f"ServeEngine option {option} is not ported yet: ROADMAP {item}")


def _stream_seed(seed: int, index: int) -> int:
    """Per-(request seed, emission index) generator seed: a preempted and
    recomputed request draws the same stream where it left off.  A
    splitmix64 finalizer mixes both into every bit (the CPU generator
    keeps only the low 32 bits of its seed)."""
    mask = (1 << 64) - 1
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(index)) & mask
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
    return x ^ (x >> 31)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous-batching serving over one :class:`Generator` (float or
    int8 pools; float or W8A8 weights; world 1, or ``mesh=World(W)`` with
    ``kv_shard="seq"`` or ``"heads"``, W8A8 under ``"heads"`` only).

    Usage::

        engine = ServeEngine(gen, params, num_blocks=64, page_size=16,
                             max_batch=8)
        engine.submit(Request("r0", prompt_tokens,
                              SamplingParams(max_new_tokens=32)))
        outputs = engine.run()          # step() until drained

    Prefill always runs the one fixed ``prefill_chunk`` shape (the final
    residual pads, its K/V zero-masked by ``n_valid``) and each prompt's
    scratch extent rounds up the bucket ladder, as in the reference.
    ``gen`` built with ``kv_dtype=torch.int8`` gives int8 pools;
    ``w8a8=True`` serves W8A8 projections (``self.params`` becomes the
    quantized tree).
    """

    def __init__(self, gen: Generator, params, *, num_blocks: int,
                 page_size: int, max_batch: int = 8,
                 prefill_chunk: int = 64,
                 prefill_budget: Optional[int] = None,
                 clock=time.monotonic,
                 horizon: int = 1, mesh=None,
                 kv_shard: Optional[str] = "heads",
                 w8a8: bool = False,
                 draft: Optional[Generator] = None, draft_params=None,
                 spec_k: int = 0, prefix_cache: bool = False,
                 max_queue: Optional[int] = None, class_aware: bool = False,
                 brownout: Optional[dict] = None,
                 step_timeout_s: Optional[float] = None,
                 heartbeat: Optional[str] = None, faults=None,
                 snapshot_dir: Optional[str] = None):
        if horizon != 1:
            _not_ported("horizon > 1 (fused decode horizon)",
                        "Queue 1 item 6")
        if prefix_cache:
            _not_ported("prefix_cache=True", "Queue 1 item 6")
        if draft is not None or draft_params is not None or spec_k:
            _not_ported("draft/spec_k (speculative decoding)",
                        "Queue 1 item 8")
        kv_shard = kv_shard or "heads"
        if kv_shard not in serve_mesh.KV_SHARDS:
            # validated off-mesh too: a typo must not ride silently until
            # a mesh is added
            raise ValueError(f"kv_shard must be one of "
                             f"{serve_mesh.KV_SHARDS}, got {kv_shard!r}")
        self.sp_world = 1       # block partitions (kv_shard="seq")
        self.tp_world = 1       # head shards (kv_shard="heads")
        self.kv_shard = None
        if mesh is not None and not isinstance(mesh, World):
            _not_ported(f"mesh={type(mesh).__name__} (a mesh over several "
                        f"cards or processes; the port serves over a "
                        f"runtime.bootstrap.World on one device)",
                        "Queue 1 item 11 (the multi-process backend)")
        if mesh is not None:
            self.kv_shard = kv_shard
            world = serve_mesh.validate_mesh_geometry(
                mesh=mesh, kv_shard=self.kv_shard, cfg=gen.cfg,
                max_seq=gen.max_seq, num_blocks=num_blocks,
                page_size=page_size)
            if self.kv_shard == "seq":
                self.sp_world = world
            else:
                self.tp_world = world
            if w8a8 and self.kv_shard != "heads":
                raise ValueError(
                    "w8a8 is a tensor-parallel weight layout: supported at "
                    "world 1 and kv_shard='heads' (the seq layout keeps "
                    "float weights, as in the reference)")
            if mesh.device != canonical_device(gen.device):
                raise ValueError(f"the mesh's ranks live on {mesh.device}, "
                                 f"the generator on {gen.device}")
        if faults is not None or step_timeout_s is not None \
                or heartbeat is not None or snapshot_dir is not None:
            _not_ported("faults/step_timeout_s/heartbeat/snapshot_dir "
                        "(containment and recovery)", "Queue 1 item 7")
        if max_queue is not None or class_aware or brownout is not None:
            _not_ported("max_queue/class_aware/brownout (overload control)",
                        "Queue 1 item 10")
        if gen.max_seq % page_size:
            raise ValueError(
                f"max_seq {gen.max_seq} must divide by page_size "
                f"{page_size} (the block table is fixed-width)")
        cfg = gen.cfg
        self.gen = gen
        self.cfg = cfg
        self.device = gen.device
        self.kv_quant = bool(gen.attn.quantized)
        self.w8a8 = bool(w8a8)
        # w8a8 swaps the weight tree once, before any forward runs; the
        # hooks ride the ffn=/out_proj= seams of both forwards, so a
        # re-prefill after preemption runs the same hooked math.  Under
        # kv_shard="heads" the tree is laid out rank by rank
        # (llama.shard_params: a copy; the caller's tree is not kept) and
        # the hooks sum the ranks' partials (axis=0).
        self._hooks = {}
        if self.w8a8:
            params = llama_w8a8.quantize_serve_params(params, cfg,
                                                      world=self.tp_world)
            axis = 0 if self.tp_world > 1 else None
            self._hooks = {
                "ffn": functools.partial(llama_w8a8.w8a8_serve_ffn,
                                         axis=axis),
                "out_proj": functools.partial(
                    llama_w8a8.w8a8_serve_out_proj, axis=axis)}
        if self.tp_world > 1:
            params = shard_params(params, cfg, self.tp_world)
        self.params = params
        self.page = page_size
        self.max_batch = max_batch
        self.n_pages_max = gen.max_seq // page_size
        # kv_shard="seq" partitions the block-id space per rank (rank r
        # owns pool rows [r*NB/W, (r+1)*NB/W), the pages of its sequence
        # span; one null block per partition)
        self.bm = BlockManager(num_blocks, page_size, prefix_cache=False,
                               shards=self.sp_world,
                               pages_per_shard=self.n_pages_max
                               // self.sp_world)
        # the device programs: world 1's, or their sharded twins
        self._decode_fwd = _paged_decode_forward
        self._chunk_fwd = _chunk_forward
        if self.kv_shard == "seq":
            geo = dict(world=self.sp_world, num_blocks=num_blocks)
            self._decode_fwd = functools.partial(
                serve_mesh.sp_paged_decode_shard,
                n_pages_max=self.n_pages_max, **geo)
            self._chunk_fwd = functools.partial(
                serve_mesh.sp_chunk_forward_shard, world=self.sp_world)
        elif self.kv_shard == "heads":
            self._decode_fwd = functools.partial(
                serve_mesh.tp_paged_decode_shard, world=self.tp_world)
            self._chunk_fwd = functools.partial(
                serve_mesh.tp_chunk_forward_shard, world=self.tp_world)
        self.scheduler = FCFSScheduler(
            self.bm, prefill_budget=prefill_budget or 4 * prefill_chunk,
            prefill_chunk=prefill_chunk)
        self.metrics = ServeMetrics()
        self._clock = clock

        # The scratch-extent ladder of the reference (which bounds its
        # compiled programs); here it sets each prompt's scratch extent,
        # so the page fill and the chunk attention see the reference's
        # shapes.
        self.ladder = build_bucket_ladder(
            max(page_size, prefill_chunk),
            self._scratch_need(gen.max_seq - 1), page_size)

        # kv_shard="heads": rank-stacked by KV head [W, NB, Hkv/W, ...]
        shape = (*self._kv_lead(), num_blocks, cfg.n_kv_heads //
                 self.tp_world, page_size, cfg.head_dim)
        self._pools = [(self._zeros_kv(shape), self._zeros_kv(shape))
                       for _ in range(cfg.n_layers)]
        # KV capacity: the real allocated footprint (int8 pages and their
        # scales both count) and the token slots it buys
        self.metrics.set_kv_capacity(
            pool_bytes=sum(t.numel() * t.element_size()
                           for t in tree_leaves(self._pools)),
            token_slots=num_blocks * page_size, quantized=self.kv_quant)
        self.slots: list[Optional[ReqState]] = [None] * max_batch
        self._states: dict[str, ReqState] = {}
        self._outputs: dict[str, RequestOutput] = {}

    def _kv_lead(self) -> tuple:
        """The rank dimension of the head-sharded layout's pools and
        scratch ((W,) under kv_shard="heads", else ())."""
        return (self.tp_world,) if self.tp_world > 1 else ()

    def _zeros_kv(self, shape):
        """One zeroed K or V store of ``shape`` [.., S, D]: a float tensor,
        or for int8 pools an int8 plane with its f32 [.., S] scale plane
        (in the pool layout for pools and scratch alike)."""
        if self.kv_quant:
            return {"q": torch.zeros(shape, dtype=torch.int8,
                                     device=self.device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=self.device)}
        return torch.zeros(shape, dtype=self.cfg.dtype, device=self.device)

    # -- submission -------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request."""
        if req.request_id in self._states:
            raise ValueError(f"duplicate request id {req.request_id!r}")
        if req.params.deadline_s is not None:
            _not_ported("SamplingParams.deadline_s (deadline sweeps)",
                        "Queue 1 item 7")
        total = int(req.prompt.shape[0]) + req.params.max_new_tokens
        if total > self.gen.max_seq:
            raise ValueError(
                f"{req.request_id}: prompt + max_new_tokens = {total} "
                f"exceeds max_seq {self.gen.max_seq}")
        fit = self.bm.fit_error(total)
        if fit is not None:
            raise ValueError(f"{req.request_id}: {fit}")
        if req.arrival_time is None:
            req.arrival_time = self._clock()
        rs = ReqState(req=req,
                      metrics=RequestMetrics(arrival_time=req.arrival_time))
        self._states[req.request_id] = rs
        self.scheduler.add(rs)

    def has_work(self) -> bool:
        return bool(self.scheduler.waiting) or any(
            s is not None for s in self.slots)

    # -- the iteration ----------------------------------------------------

    def step(self) -> list[RequestOutput]:
        """One scheduler iteration; returns requests that finished."""
        t0 = time.perf_counter()
        now = self._clock()
        finished: list[RequestOutput] = []
        free = [i for i, s in enumerate(self.slots) if s is None]
        for rs in self.scheduler.admit(free, now):
            self.slots[rs.slot] = rs
            qt = rs.metrics.queue_time
            if qt is not None and not rs.metrics.queue_observed:
                rs.metrics.queue_observed = True
                self.metrics.hist_queue.observe(qt)
            self._start_prefill(rs)

        prefilling = [s for s in self.slots
                      if s is not None and s.status is Status.PREFILL]
        for rs, n in self.scheduler.prefill_plan(prefilling):
            if rs.status is not Status.PREFILL:
                continue
            out = self._run_prefill(rs, n, now)
            if out is not None:
                finished.append(out)

        running = [s for s in self.slots
                   if s is not None and s.status is Status.RUNNING]
        if running:
            finished.extend(self._decode_once(running))

        self.metrics.observe_step(
            queue_depth=self.scheduler.queue_depth,
            running=len([s for s in self.slots if s is not None]),
            kv_utilization=self.bm.utilization)
        self.metrics.hist_step.observe(time.perf_counter() - t0)
        return finished

    def run(self, max_steps: int = 100_000) -> dict[str, RequestOutput]:
        """Step until drained; returns {request_id: output}."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"engine not drained after {max_steps} "
                                   "steps")
        return dict(self._outputs)

    # -- prefill ----------------------------------------------------------

    def _scratch_need(self, n_prompt: int) -> int:
        """Unbucketed scratch extent an ``n_prompt``-token prefill needs:
        its pool pages, or the padded final chunk's write rounded up to
        ``prefill_chunk``, whichever is larger."""
        chunk = self.scheduler.prefill_chunk
        return max(self.bm.blocks_for(n_prompt) * self.page,
                   -(-n_prompt // chunk) * chunk)

    def _bucket_s_ext(self, n_prompt: int) -> int:
        need = self._scratch_need(n_prompt)
        for r in self.ladder:
            if r >= need:
                return r
        raise AssertionError(
            f"bucket ladder {self.ladder} cannot cover scratch extent "
            f"{need} (prompt {n_prompt})")

    def _start_prefill(self, rs: ReqState) -> None:
        cfg = self.cfg
        s_ext = self._bucket_s_ext(int(rs.prompt_tokens.shape[0]))
        rs.s_ext = s_ext
        shape = (*self._kv_lead(), 1, cfg.n_kv_heads // self.tp_world,
                 s_ext, cfg.head_dim)
        # a quantized scratch: chunked prefill quantizes each chunk's rows
        # as it writes them, so the page fill moves finished bytes
        rs.scratch = [(self._zeros_kv(shape), self._zeros_kv(shape))
                      for _ in range(cfg.n_layers)]

    def _run_prefill(self, rs: ReqState, n_tokens: int,
                     now: float) -> Optional[RequestOutput]:
        prompt = rs.prompt_tokens
        S0 = int(prompt.shape[0])
        end = min(rs.prefill_pos + n_tokens, S0)
        chunk_sz = self.scheduler.prefill_chunk
        logits = None
        n_last = 0
        while rs.prefill_pos < end:
            c = min(chunk_sz, end - rs.prefill_pos)
            # Every call is the one fixed chunk shape: the final residual
            # pads with zeros and n_valid zero-masks its K/V writes.
            buf = np.zeros((1, chunk_sz), np.int64)
            buf[0, :c] = prompt[rs.prefill_pos:rs.prefill_pos + c]
            rs.scratch, logits = self._chunk_fwd(
                self.params, torch.from_numpy(buf).to(self.device),
                rs.scratch, rs.prefill_pos, cfg=self.cfg, extent=rs.s_ext,
                n_valid=c, **self._hooks)
            rs.prefill_pos += c
            n_last = c
            self.metrics.prefill_tokens += c
        if rs.prefill_pos < S0:
            return None
        return self._finish_prefill(rs, logits, n_last, now)

    def _finish_prefill(self, rs: ReqState, logits, n_last: int,
                        now: float) -> Optional[RequestOutput]:
        rid = rs.req.request_id
        S0 = int(rs.prompt_tokens.shape[0])
        n_prompt_pages = self.bm.blocks_for(S0)
        ids = np.zeros((rs.s_ext // self.page,), np.int64)
        ids[:n_prompt_pages] = self.bm.table(rid)[:n_prompt_pages]
        self._pools = _fill_pool_pages(
            self._pools, rs.scratch, torch.from_numpy(ids).to(self.device),
            page=self.page)
        rs.scratch = None
        rs.kv_len = S0
        rs.status = Status.RUNNING
        last = logits[0, n_last - 1]                                 # [V]
        token = self._choose_token(rs, last)
        return self._commit_token(rs, token)

    # -- token choice / emission -----------------------------------------

    def _choose_token(self, rs: ReqState, logits_row,
                      greedy_token: Optional[int] = None) -> int:
        """Host-side token choice: greedy argmax (``greedy_token`` when
        the caller already took the batch's argmax), or one seeded draw
        keyed by (request seed, emission index)."""
        p = rs.req.params
        if p.greedy:
            if greedy_token is not None:
                return int(greedy_token)
            return int(torch.argmax(logits_row))
        gen = torch.Generator(device=logits_row.device)
        gen.manual_seed(_stream_seed(p.seed, len(rs.generated)))
        tok = sample_logits(logits_row[None], gen,
                            temperature=p.temperature, top_k=p.top_k,
                            top_p=p.top_p)
        return int(tok[0])

    def _commit_token(self, rs: ReqState, token: int,
                      now: Optional[float] = None
                      ) -> Optional[RequestOutput]:
        """Emit one token; retire the request when it finishes.  The token
        stays ``pending`` until the next decode step consumes it.  A
        raising ``on_token`` callback is logged once and disabled."""
        if rs.status is Status.FINISHED:
            return self._outputs.get(rs.req.request_id)
        if now is None:
            now = self._clock()
        rs.generated.append(token)
        rs.pending_token = token
        first = rs.metrics.first_token_time is None
        itl = rs.metrics.on_token(now)
        if first:
            if rs.metrics.ttft is not None:
                self.metrics.hist_ttft.observe(rs.metrics.ttft)
        elif itl is not None:
            self.metrics.hist_itl.observe(itl)
        if rs.req.on_token is not None and not rs.callback_disabled:
            try:
                rs.req.on_token(rs.req.request_id, token)
            except Exception as e:
                rs.callback_disabled = True
                self.metrics.callback_errors += 1
                print(f"[serve] {rs.req.request_id}: on_token callback "
                      f"raised ({e!r}); callback disabled, request "
                      f"keeps serving", file=sys.stderr)
        p = rs.req.params
        if p.eos_id is not None and token == p.eos_id:
            return self._retire(rs, FinishReason.EOS)
        if len(rs.generated) >= rs.effective_max_new:
            return self._retire(rs, FinishReason.LENGTH)
        return None

    def _retire(self, rs: ReqState, reason: FinishReason, *,
                free: bool = True, error: Optional[str] = None
                ) -> RequestOutput:
        now = self._clock()
        if free:
            self.bm.free(rs.req.request_id)
            self.slots[rs.slot] = None
        rs.status = Status.FINISHED
        rs.slot = None
        rs.scratch = None
        rs.pending_token = None
        rs.metrics.finish_time = now
        out = RequestOutput(request_id=rs.req.request_id,
                            prompt=rs.req.prompt,
                            token_ids=list(rs.generated),
                            finish_reason=reason, metrics=rs.metrics,
                            error=error)
        self._outputs[rs.req.request_id] = out
        self.metrics.observe_finish(rs.req.request_id, rs.metrics, reason)
        if rs.req.on_finish is not None:
            try:
                rs.req.on_finish(out)
            except Exception as e:
                self.metrics.callback_errors += 1
                print(f"[serve] {rs.req.request_id}: on_finish callback "
                      f"raised ({e!r}); ignored", file=sys.stderr)
        return out

    # -- capacity / preemption -------------------------------------------

    def _ensure_capacity(self, rs: ReqState, n_tokens: int) -> None:
        """Grow ``rs``'s allocation to ``n_tokens`` rows, preempting
        later-admitted slot holders (running or mid-prefill) until it
        fits; raises when no victim remains."""
        while True:
            try:
                self.bm.ensure(rs.req.request_id, n_tokens)
                return
            except BlockExhausted:
                victim = self.scheduler.pick_victim(
                    [s for s in self.slots if s is not None
                     and s.status in (Status.RUNNING, Status.PREFILL)],
                    rs)
                if victim is None:
                    raise RuntimeError(
                        f"{rs.req.request_id}: cannot extend to "
                        f"{n_tokens} tokens and no preemption victim "
                        f"remains — the block pool ({self.bm.num_blocks}"
                        " blocks) is too small for this request")
                self._preempt(victim)

    def _preempt(self, victim: ReqState) -> None:
        self.slots[victim.slot] = None
        victim.scratch = None
        self.scheduler.preempt(victim)
        self.metrics.preemptions += 1

    # -- decode -----------------------------------------------------------

    def _decode_once(self, running: list[ReqState]) -> list[RequestOutput]:
        """Reserve one more row for every running request (preempting
        where the pool is short; a request that cannot grow at all
        retires with ``FinishReason.ERROR``), then one batched decode."""
        finished: list[RequestOutput] = []
        for rs in sorted(running, key=lambda r: r.seq):
            if rs.status is Status.RUNNING:  # may get preempted below
                want = min(rs.kv_len + min(1, rs.remaining_new),
                           rs.total_tokens)
                try:
                    self._ensure_capacity(rs, want)
                except RuntimeError as e:
                    finished.append(self._retire(
                        rs, FinishReason.ERROR,
                        error=f"kv grow to {want} rows: {e!r}"))
        live = [r for r in running if r.status is Status.RUNNING]
        if live:
            self._decode_rows(live, finished)
        return finished

    def _decode_rows(self, rows: list[ReqState], finished: list) -> None:
        """ONE batched decode for ``rows`` (other slots inactive — their
        writes redirect to the null block) + per-row commits."""
        B = self.max_batch
        tokens = np.zeros((B,), np.int64)
        lens = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        tables = np.zeros((B, self.n_pages_max), np.int32)
        for rs in rows:
            b = rs.slot
            tokens[b] = rs.pending_token
            lens[b] = rs.kv_len
            active[b] = True
            tables[b] = self.bm.padded_table(rs.req.request_id,
                                             self.n_pages_max)
        dev = self.device
        self.metrics.dispatches += 1
        self._pools, logits = self._decode_fwd(
            self.params, self._pools, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lens).to(dev), torch.from_numpy(tokens).to(dev),
            torch.from_numpy(active).to(dev), cfg=self.cfg, page=self.page,
            **self._hooks)
        greedy = torch.argmax(logits, dim=-1).tolist()  # the step's sync
        self.metrics.decode_steps += 1
        self.metrics.host_syncs += 1
        for rs in rows:
            if rs.status is not Status.RUNNING:
                continue  # aborted mid-loop by a slot-mate's callback
            rs.kv_len += 1
            rs.pending_token = None
            token = self._choose_token(rs, logits[rs.slot],
                                       greedy[rs.slot])
            out = self._commit_token(rs, token)
            self.metrics.decode_tokens += 1
            if out is not None:
                finished.append(out)
