"""Overlapped AllGather-GroupGEMM: the MoE feed-forward of a tensor-parallel
group whose experts are sharded over their F dimension (the AG side).

Counterpart of ``triton_dist_tpu/kernels/allgather_group_gemm.py``.  The
port runs a world of W ranks on one device (``runtime/bootstrap.py``).

The layout is the reference's (:11-26): every rank sorts its OWN tokens by
expert into a padded segment of ``m_pad`` rows (``moe_utils.sort_align``,
:func:`_segment_plans`), the segments are gathered, and a grouped GEMM
runs each gathered segment against the rank's F shard of the expert
slabs: row tile i of segment s on slab ``tile_expert[s, i]``.  A token's
top-k rows never leave its segment, so a GEMM tile depends on exactly one
source rank.  The routing metadata needs no kernel: every rank of the
virtual world sees the whole ``[T, topk]`` (the reference's small
``all_gather`` at :198).

- :func:`ag_group_gemm_sorted` is the kernel's wrapper: given the sorted
  segments ``xs`` [W, m_pad, D], the rank-stacked slabs ``w`` [W, E, D,
  F_loc] and the plans' ``tile_expert`` [W, n_tiles], it returns the
  gathered segments [W, W m_pad, D] (the same on every rank) and the
  grouped products [W, W m_pad, F_loc].  On CUDA tensors it launches
  ``csrc/ag_group_gemm.cu`` (``tdt_ag_group_gemm``, the port of the TPU
  ``_ag_group_gemm_kernel`` :103) over the world's symmetric workspace and
  counts the launch in ``ag_group_gemm_shard.launches``, or raises on
  what the kernel does not take: bf16 operands, ``block_m`` a multiple of
  128, D and F_loc multiples of 128, at most 256 experts, and operands its
  tensor maps can read (:func:`grouped_operand_ok`: ``w`` may be a
  strided view, the host entry hands each rank its column block of the
  [E, D, F] stack in place).  On CPU tensors, or with ``plain``, it runs
  :func:`ag_group_gemm_ref`: the gather as a concatenation and each rank's
  grouped GEMM through ``group_gemm_ref``.
- :func:`ag_group_gemm_shard` (reference :181) is rank-stacked: x [W,
  t_loc, D], weights / experts [W, t_loc, topk], w [W, E, D, F_loc] ->
  out [W, T, F_loc], every rank's combined outputs for every token
  (``combine_topk`` per segment, :243-248).
- The host entry :func:`ag_group_gemm` (reference :251) with
  :class:`AGGroupGEMMContext` / :func:`create_ag_group_gemm_context` on a
  port ``Mesh``: x [T, D] sharded over ``ctx.axis`` by rows, weights /
  experts [T, topk] by rows, w_stack [E, D, F] by columns -> out [T, F]
  sharded by columns.  ``block_m`` defaults to the reference's
  ``load_aware_block_m(T topk, E)`` (:258).  ``impl`` "auto" and "pallas"
  run the kernel on CUDA tensors, "xla" the plain versions on any device;
  ``config`` (the reference's MXU blocks) and ``interpret`` are kept and
  have no effect; a mesh whose other axes have more than one rank raises
  (``allgather_gemm.flat_axis``).
- :func:`ag_group_gemm_autotuned` (reference :312) sweeps
  :data:`AG_GROUP_GEMM_TUNE_SPACE` through ``triton_dist_tpu_torch.
  autotuner``: ``block_m`` 128, 256 and 512 (it changes the plan and the
  padding); the reference's ``bn`` / ``bk`` drop out (the Hopper tile is
  fixed, 128 x 128 x 32, ``csrc/bf16_tile.cuh``).  The prune keeps the
  first config of each distinct launch, keyed by (block_m, m_pad): no two
  row-tile heights give one padding, so all three survive.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Any

import torch

from triton_dist_tpu_torch.autotuner import Config, autotune
from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    _check_impl,
    _check_tma,
    dedupe_configs,
    flat_axis,
    ring_tables,
    tma_layout_ok,
)
from triton_dist_tpu_torch.kernels.group_gemm import (
    TILE_M,
    group_gemm_ref,
    load_aware_block_m,
)
from triton_dist_tpu_torch.kernels.moe_utils import (
    gather_sorted,
    padded_rows,
    sort_align,
)
from triton_dist_tpu_torch.runtime.bootstrap import MAX_RANKS, Mesh, get_world

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
# pointer tables (xs, w, gathered, out, flags, piece counters, barrier),
# the tile map, world, m_pad, n, k, block_m, n_experts, ldb, e_stride,
# epoch, stream
_SIG = {"tdt_ag_group_gemm": [_P] * 8 + [_I] * 7 + [_L, _U, _P]}
MAX_EXPERTS = 256   # what the kernel's expert-major walk holds
WG_TILE, TILE_GROUP = (128, 256), 8   # the kernel's tile and row group


def _segment_plans(experts_all, n_experts: int, block_m: int):
    """Every segment's sort plan (reference :164): experts_all [W, t_loc,
    topk] -> (dest [W, t_loc topk] int64, tile_expert [W, n_tiles] int32,
    m_pad), each row ``moe_utils.sort_align`` of that rank's tokens; no
    value is read back to the host."""
    plans = [sort_align(e, n_experts, block_m) for e in experts_all]
    _, t_loc, topk = experts_all.shape
    m_pad = padded_rows(t_loc * topk, n_experts, block_m)
    return (torch.stack([p["dest"] for p in plans]),
            torch.stack([p["tile_expert"] for p in plans]), m_pad)


def check_sorted(name, a, w, tile_expert, block_m, *, gathered: bool):
    """The rank-stacked grouped operands: a [W, rows, K] against w [W, E,
    K, N], rows one segment of m_pad (or, ``gathered``, all W segments)
    cut into ``block_m``-row tiles by tile_expert [W, m_pad / block_m];
    returns (W, m_pad, K, N)."""
    if a.dim() != 3 or w.dim() != 4 or w.shape[0] != a.shape[0] or \
            w.shape[2] != a.shape[2]:
        raise ValueError(f"{name}: a {tuple(a.shape)} must be [W, rows, K] "
                         f"and w {tuple(w.shape)} [W, E, K, N]")
    world, m_pad = a.shape[0], tile_expert.shape[-1] * block_m
    if tuple(tile_expert.shape) != (world, m_pad // block_m) or \
            a.shape[1] != (world * m_pad if gathered else m_pad):
        raise ValueError(f"{name}: tile_expert {tuple(tile_expert.shape)} "
                         f"at block_m {block_m} does not tile a "
                         f"{tuple(a.shape)}")
    return world, m_pad, a.shape[2], w.shape[3]


def check_grouped_kernel(name, a, w, tile_expert, block_m, k, n):
    """What the grouped ring kernels take, else a raise: bf16 operands and
    an int32 tile map on one device, at most MAX_RANKS ranks, block_m, K
    and N multiples of the 128-row tile, 16-byte aligned rows (strided
    views are taken: the last dimension contiguous)."""
    if w.device != a.device or tile_expert.device != a.device:
        raise ValueError(f"{name}: w on {w.device}, tile_expert on "
                         f"{tile_expert.device}, a on {a.device}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 operands, got {a.dtype} "
                        f"and {w.dtype}")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"{name}: tile_expert must be int32, got "
                        f"{tile_expert.dtype}")
    if a.shape[0] > MAX_RANKS:
        raise ValueError(f"{name} kernel: at most {MAX_RANKS} ranks, got "
                         f"{a.shape[0]}")
    if block_m % TILE_M or k % TILE_M or n % TILE_M:
        raise ValueError(f"{name} kernel: block_m={block_m}, K={k} and "
                         f"N={n} must be multiples of {TILE_M}")
    for t in (a, w):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or \
                t.data_ptr() % 16 or t.stride(-2) >= 2 ** 31:
            raise ValueError(f"{name} kernel: operand strides {t.stride()} "
                             f"must give 16-byte aligned contiguous rows "
                             f"(a row stride below 2**31)")


def tile_order(tile_expert, me: int, n: int, block_m: int):
    """Rank ``me``'s GEMM tiles in ``tdt_ag_group_gemm``'s order (the
    kernel's expert-major walk, held by a CPU test): for each expert its
    128-row tiles of every segment, segment me first, then me - 1, me - 2,
    ..., in ``tdt_gemm90::tile_rc``'s groups of TILE_GROUP row tiles walked
    column band by column band.  ``tile_expert`` [W, m_pad / block_m] on
    the host, each row nondecreasing with ids below ``MAX_EXPERTS`` (the
    plans'); yields (segment, row tile, column tile, expert)."""
    te = [list(map(int, row)) for row in tile_expert]
    world, (tm, tn) = len(te), WG_TILE
    tiles_n, per = -(-n // tn), block_m // tm
    segs = [(me - q) % world for q in range(world)]
    for e in range(max(max(row) for row in te) + 1):
        rows = [(s, i * per + j) for s in segs
                for i, x in enumerate(te[s]) if x == e for j in range(per)]
        for t in range(len(rows) * tiles_n):
            g0 = t // (TILE_GROUP * tiles_n) * TILE_GROUP
            in_group = min(TILE_GROUP, len(rows) - g0)
            r = t - g0 * tiles_n
            yield (*rows[g0 + r % in_group], r // in_group, e)


def grouped_operand_ok(shape, strides, dtype, offset=0) -> bool:
    """Whether the MoE overlap kernels (``tdt_ag_group_gemm``,
    ``tdt_moe_rs``) read an operand of ``shape`` and element ``strides``
    by TMA (``offset``: its storage offset in elements, on a 16-byte
    aligned allocation): bf16 segments [W, rows, K] or slabs [W, E, K, N],
    strided views under ``allgather_gemm.tma_layout_ok`` (one map spans
    every rank, and a slab map every expert).  A pure function of the
    layout."""
    return dtype == torch.bfloat16 and len(shape) in (3, 4) and \
        tma_layout_ok(shape, strides, 2, offset)


def ag_group_gemm_ref(xs, w, tile_expert, *, block_m: int):
    """Plain (gathered [W, W m_pad, D], y [W, W m_pad, F_loc]): the
    segments concatenated in rank order (the same on every rank: an
    expanded view), y[r] row tile i of segment s = that tile @
    w[r][tile_expert[s, i]] in f32, cast to xs's dtype."""
    world, m_pad, d, _ = check_sorted("ag_group_gemm", xs, w, tile_expert,
                                      block_m, gathered=False)
    gathered = xs.reshape(world * m_pad, d)
    te = tile_expert.reshape(-1)
    y = torch.stack([group_gemm_ref(gathered, w[r], te, block_m=block_m)
                     for r in range(world)])
    return gathered.expand(world, -1, -1), y


def ag_group_gemm_sorted(xs, w, tile_expert, *, block_m: int,
                         plain: bool = False):
    """(gathered [W, W m_pad, D], y [W, W m_pad, F_loc]) of the sorted
    segments xs [W, m_pad, D] against w [W, E, D, F_loc]: the kernel's
    wrapper (module docstring)."""
    world, m_pad, d, n = check_sorted("ag_group_gemm", xs, w, tile_expert,
                                      block_m, gathered=False)
    if plain or xs.device.type == "cpu":
        return ag_group_gemm_ref(xs, w, tile_expert, block_m=block_m)
    if not xs.is_cuda:
        raise ValueError(f"ag_group_gemm: unsupported device {xs.device}")
    xs = xs.contiguous()
    check_grouped_kernel("ag_group_gemm", xs, w, tile_expert, block_m, d, n)
    n_experts = w.shape[1]
    if n_experts > MAX_EXPERTS:
        raise ValueError(f"ag_group_gemm kernel: at most {MAX_EXPERTS} "
                         f"experts, got {n_experts}")
    te = tile_expert.contiguous()
    gathered = torch.empty((world, world * m_pad, d), dtype=xs.dtype,
                           device=xs.device)
    _check_tma("ag_group_gemm", xs, w, gathered,
               rule=grouped_operand_ok)
    y = torch.empty((world, world * m_pad, n), dtype=xs.dtype,
                    device=xs.device)
    ws = get_world(world, xs.device).workspace
    tables = ring_tables(xs, w, gathered, y, ws.flags("ag_group_gemm", world),
                         ws.flags("ag_group_gemm_cnt", world),
                         ws.flags("barrier", world))
    # one expert: its stride is never stepped, but TMA wants a valid one
    e_stride = w.stride(1) if n_experts > 1 else d * w.stride(2)
    epoch = ws.next_epoch()
    lib = _build.load("ag_group_gemm", _SIG)
    with torch.cuda.device(xs.device):
        err = lib.tdt_ag_group_gemm(
            *tables, te.data_ptr(), world, m_pad, n, d, block_m, n_experts,
            w.stride(2), e_stride, epoch,
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ag_group_gemm")
    ag_group_gemm_shard.launches += 1
    return gathered, y


def combine_segments(y, dest, weights):
    """out [W, T, N]: for every rank r and token t of segment s, sum_k
    weights[s, t, k] * y[r][s m_pad + dest[s, t k]] in f32, cast to y's
    dtype (``moe_utils.combine_topk`` of each segment of y [W, W m_pad,
    N])."""
    world, rows, n = y.shape
    m_pad, topk = rows // dest.shape[0], weights.shape[-1]
    base = torch.arange(dest.shape[0], device=y.device)[:, None] * m_pad
    picked = y[:, (dest + base).reshape(-1)].view(world, -1, topk, n)
    out = torch.einsum("tk,rtkf->rtf", weights.reshape(-1, topk).float(),
                       picked.float())
    return out.to(y.dtype)


def ag_group_gemm_shard(x, weights, experts, w, *, n_experts: int,
                        topk: int, block_m: int, plain: bool = False):
    """out [W, T, F_loc]: rank-stacked x [W, t_loc, D], weights / experts
    [W, t_loc, topk] and expert slabs w [W, E, D, F_loc]; every rank
    computes every token against its F shard of its experts (reference
    :181)."""
    if x.dim() != 3 or tuple(experts.shape) != (*x.shape[:2], topk) or \
            weights.shape != experts.shape:
        raise ValueError(f"ag_group_gemm: x {tuple(x.shape)}, weights "
                         f"{tuple(weights.shape)} and experts "
                         f"{tuple(experts.shape)} must be rank-stacked "
                         f"[W, t_loc, .] with top-{topk}")
    dest, te, m_pad = _segment_plans(experts, n_experts, block_m)
    xs = torch.stack([gather_sorted(x[r], dest[r], m_pad)
                      for r in range(x.shape[0])])
    _, y = ag_group_gemm_sorted(xs, w, te, block_m=block_m, plain=plain)
    return combine_segments(y, dest, weights)


ag_group_gemm_shard.launches = 0


# ---------------------------------------------------------------------------
# Host entries (reference :70-100, :251-290)
# ---------------------------------------------------------------------------


@dataclass
class AGGroupGEMMContext:
    """Counterpart of the reference's context (:70): the mesh and axis,
    the experts and top-k, ``block_m`` (None: load-aware at the entry),
    ``impl``, ``config`` and ``interpret`` as ``AllGatherGEMMContext``
    takes them."""

    mesh: Mesh
    n_experts: int
    topk: int
    axis: Any = "tp"
    block_m: int | None = None
    impl: str = "auto"
    config: Any = None
    interpret: bool = False

    @property
    def world(self) -> int:
        return self.mesh.axis_size(self.axis)


def create_ag_group_gemm_context(mesh, n_experts, topk, axis="tp",
                                 block_m=None, impl="auto", config=None,
                                 interpret=False) -> AGGroupGEMMContext:
    return AGGroupGEMMContext(mesh=mesh, n_experts=n_experts, topk=topk,
                              axis=axis, block_m=block_m, impl=impl,
                              config=config, interpret=interpret)


def resolve_block_m(ctx, n_tokens: int) -> int:
    """``ctx.block_m``, or the reference's load-aware default for
    ``n_tokens`` tokens (:258)."""
    return ctx.block_m or load_aware_block_m(n_tokens * ctx.topk,
                                             ctx.n_experts)


def ag_group_gemm(x, weights, experts, w_stack, ctx: AGGroupGEMMContext):
    """out [T, F] = MoE-FFN(allgather(x)) against the F-sharded expert
    slabs, the gather overlapped with the grouped GEMM (reference :251)."""
    plain = _check_impl(ctx.impl)
    flat_axis(ctx.mesh, ctx.axis, "ag_group_gemm")
    world = ctx.mesh.size
    (T, d), (E, _, F) = x.shape, w_stack.shape
    if T % world or F % world:
        raise ValueError(f"ag_group_gemm: {T} tokens and {F} columns must "
                         f"shard over {world} ranks")
    out = ag_group_gemm_shard(
        x.reshape(world, T // world, d),
        weights.reshape(world, T // world, ctx.topk),
        experts.reshape(world, T // world, ctx.topk),
        w_stack.view(E, d, world, F // world).permute(2, 0, 1, 3),
        n_experts=ctx.n_experts, topk=ctx.topk,
        block_m=resolve_block_m(ctx, T), plain=plain)
    return out.permute(1, 0, 2).reshape(T, F)


# ---------------------------------------------------------------------------
# The autotuned entry (reference :293-325)
# ---------------------------------------------------------------------------

AG_GROUP_GEMM_TUNE_SPACE = [Config(block_m=128), Config(block_m=256),
                            Config(block_m=512)]


def launch_keys(configs, n_tokens: int, ctx):
    """What each config launches for ``n_tokens`` tokens under ``ctx``:
    (block_m, m_pad), a config's own ``block_m`` before the context's."""
    t_loc = n_tokens // ctx.mesh.size
    keys = []
    for cfg in configs:
        bm = cfg.get("block_m") or resolve_block_m(ctx, n_tokens)
        keys.append((bm, padded_rows(t_loc * ctx.topk, ctx.n_experts, bm)))
    return keys


def _prune(configs, args, kwargs):
    return dedupe_configs(configs, launch_keys(configs, args[0].shape[0],
                                               kwargs["ctx"]))


@autotune(configs=AG_GROUP_GEMM_TUNE_SPACE, key=(), prune=_prune)
def _ag_group_gemm_tunable(x, weights, experts, w_stack, *, ctx,
                           block_m=None):
    return ag_group_gemm(x, weights, experts, w_stack,
                         replace(ctx, block_m=block_m))


def ag_group_gemm_autotuned(x, weights, experts, w_stack,
                            ctx: AGGroupGEMMContext):
    """:func:`ag_group_gemm` with ``block_m`` picked by the autotuner:
    each config times the whole call, plans and padding included (a tile
    height's real cost); winners are cached per (shapes, dtypes, ctx), and
    inside a ``contextual_autotune`` region the sweep advances in lockstep
    with the region's other tuners."""
    return _ag_group_gemm_tunable(x, weights, experts, w_stack, ctx=ctx)
