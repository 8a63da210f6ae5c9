"""Overlapped GroupGEMM-ReduceScatter: the MoE down projection of a
tensor-parallel group whose experts are sharded over their F dimension
(the RS side).

Counterpart of ``triton_dist_tpu/kernels/moe_reduce_rs.py`` on the port's
virtual world.  The input h is in the per-segment sorted layout that
``allgather_group_gemm`` gathers ([W m_pad, F] rows: segment c holds rank
c's tokens sorted by expert), sharded over F.  For each segment c every
rank forms its grouped partial (row tile i on its F_loc rows of the
down-projection slab ``w[tile_expert[c, i]]``); the partials are
reduce-scattered to their owner c, which combines its own reduced segment
back to token order (``combine_topk``, :252-254).

Summation order (a decision, the reference's): segment c's partial starts
at rank c + 1 and travels right round the ring; each hop adds its own
partial, rounded to h's dtype, to the running sum it received, ``acc =
local + recv`` in h's dtype (one rounding, ``_add_body`` :97-100); rank c
adds its own partial last.  The kernel and the plain version add in
exactly this order, so given the same partials their sums are bit for bit
the same (the partials may round differently: another order over F_loc
in f32).

- :func:`moe_rs_sorted` is the kernel's wrapper: h [W, W m_pad, F_loc]
  (rank q's F shard of every segment), the rank-stacked slabs w [W, E,
  F_loc, D] and ``tile_expert`` [W, n_tiles] -> [W, m_pad, D], rank c's
  reduced segment.  On CUDA tensors it launches ``csrc/moe_rs.cu``
  (``tdt_moe_rs``, the port of the TPU ``_moe_rs_kernel`` :106, on the
  wgmma / TMA mainloop of ``csrc/sm90_gemm.cuh``) over the world's
  symmetric workspace (W - 1 landing slots per rank of 128 x 256 tiles
  in the accumulator's fragment order, :func:`moe_rs_workspace`) and
  counts the launch in ``moe_reduce_rs_shard.launches``, or raises on
  what the kernel does not take (as ``allgather_group_gemm.
  check_grouped_kernel``: bf16, block_m, F_loc and D multiples of 128;
  and TMA's rule, ``allgather_group_gemm.grouped_operand_ok``: h and w
  may be strided views, read in place by tensor maps).  On CPU tensors, or with
  ``plain``, :func:`moe_rs_ref`.
- :func:`moe_reduce_rs_shard` (reference :196): rank-stacked h, w,
  weights / experts [W, t_loc, topk] -> out [W, t_loc, D].
- The host entry :func:`moe_reduce_rs` (reference :257) with
  :class:`MoEReduceRSContext` / :func:`create_moe_rs_context`: h [W m_pad,
  F] sharded over ``ctx.axis`` by columns, w_stack [E, F, D] by F, weights
  / experts [T, topk] by rows -> out [T, D] by rows; ``block_m`` defaults
  to the load-aware rule (:263) and must be the one h was sorted with (a
  ValueError when h's rows are not W m_pad, the reference's assert at
  :213).  ``impl``, ``config`` and ``interpret`` as
  ``AGGroupGEMMContext`` takes them.  The package re-exports this
  module's names but not the entry, whose name stays the module's (as
  with ``reduce_scatter``): reach it as ``moe_reduce_rs.moe_reduce_rs``.
- :func:`moe_reduce_rs_autotuned` (reference :317) sweeps
  :data:`MOE_RS_TUNE_SPACE`, the reference's three (bn, bk) MXU blocks.
  The Hopper tile is fixed, so all three resolve to one launch (h's
  sorted layout fixes block_m): the prune keeps the first, and the sweep
  times that one config.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
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
)
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    _segment_plans,
    check_grouped_kernel,
    check_sorted,
    grouped_operand_ok,
    launch_keys,
    resolve_block_m,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import WG_TILE
from triton_dist_tpu_torch.kernels.group_gemm import group_gemm_ref
from triton_dist_tpu_torch.kernels.moe_utils import combine_topk
from triton_dist_tpu_torch.runtime.bootstrap import Mesh, get_world

_P, _I, _L, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_uint
# pointer tables (h, w, landing slots, out, flags, barrier), the tile map,
# world, m_pad, n, k, block_m, n_experts, lda, ldb, e_stride, epoch, stream
_SIG = {"tdt_moe_rs": [_P] * 7 + [_I] * 8 + [_L, _U, _P]}


def moe_rs_workspace(world: int, m_pad: int, n: int):
    """(landing-slot shape, flags) a rank of ``tdt_moe_rs``: W - 1 slots,
    each every 128 x 256 tile of [m_pad, n] (the last column band ragged
    where n % 256 == 128) as bf16 in the accumulator's fragment order, and
    a flag per (slot, tile)."""
    tm, tn = WG_TILE
    tiles = m_pad // tm * -(-n // tn)
    return (world - 1, tiles, tm * tn), (world - 1) * tiles


def moe_rs_ref(h, w, tile_expert, *, block_m: int):
    """Plain [W, m_pad, D]: rank q's partial of every segment (row tile i
    of segment s @ w[q][tile_expert[s, i]] in f32, cast to h's dtype),
    summed for each segment c in the reference's hop order (module
    docstring) in h's dtype."""
    world, m_pad, _, _ = check_sorted("moe_reduce_rs", h, w, tile_expert,
                                      block_m, gathered=True)
    te = tile_expert.reshape(-1)
    parts = [group_gemm_ref(h[q], w[q], te, block_m=block_m).view(
        world, m_pad, -1) for q in range(world)]
    out = []
    for c in range(world):
        acc = parts[(c + 1) % world][c]
        for j in range(2, world + 1):
            acc = parts[(c + j) % world][c] + acc
        out.append(acc)
    return torch.stack(out)


def moe_rs_sorted(h, w, tile_expert, *, block_m: int, plain: bool = False):
    """[W, m_pad, D]: every segment's grouped partials over the ranks'
    F shards, reduce-scattered to the segment's owner (the kernel's
    wrapper, module docstring)."""
    world, m_pad, k, n = check_sorted("moe_reduce_rs", h, w, tile_expert,
                                      block_m, gathered=True)
    if plain or h.device.type == "cpu":
        return moe_rs_ref(h, w, tile_expert, block_m=block_m)
    if not h.is_cuda:
        raise ValueError(f"moe_reduce_rs: unsupported device {h.device}")
    check_grouped_kernel("moe_reduce_rs", h, w, tile_expert, block_m, k, n)
    _check_tma("moe_reduce_rs", h, w, rule=grouped_operand_ok)
    te = tile_expert.contiguous()
    ws = get_world(world, h.device).workspace
    slots, n_flags = moe_rs_workspace(world, m_pad, n)
    land = ws.get("moe_rs_land", slots, h.dtype)
    out = torch.empty((world, m_pad, n), dtype=h.dtype, device=h.device)
    tables = ring_tables(h, w, land, out, ws.flags("moe_rs", n_flags),
                         ws.flags("barrier", world))
    n_experts = w.shape[1]
    # one expert: its stride is never stepped, but TMA wants a valid one
    e_stride = w.stride(1) if n_experts > 1 else k * w.stride(2)
    epoch = ws.next_epoch()
    lib = _build.load("moe_rs", _SIG)
    with torch.cuda.device(h.device):
        err = lib.tdt_moe_rs(*tables, te.data_ptr(), world, m_pad, n, k,
                             block_m, n_experts, h.stride(1), w.stride(2),
                             e_stride, epoch,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "moe_rs")
    moe_reduce_rs_shard.launches += 1
    return out


def moe_reduce_rs_shard(h, w, weights, experts, *, n_experts: int,
                        topk: int, block_m: int, plain: bool = False):
    """out [W, t_loc, D]: rank-stacked h [W, W m_pad, F_loc] (sorted by
    the plans of ``experts`` at ``block_m``), slabs w [W, E, F_loc, D] and
    weights / experts [W, t_loc, topk] (reference :196)."""
    world = h.shape[0]
    if tuple(experts.shape[:1]) != (world,) or experts.shape[-1] != topk \
            or weights.shape != experts.shape:
        raise ValueError(f"moe_reduce_rs: weights {tuple(weights.shape)} "
                         f"and experts {tuple(experts.shape)} must be "
                         f"[W, t_loc, {topk}]")
    dest, te, m_pad = _segment_plans(experts, n_experts, block_m)
    if h.dim() != 3 or h.shape[1] != world * m_pad:
        raise ValueError(f"moe_reduce_rs: h {tuple(h.shape)} is not [W, W "
                         f"m_pad = {world * m_pad}, F_loc] at block_m "
                         f"{block_m}")
    ys = moe_rs_sorted(h, w, te, block_m=block_m, plain=plain)
    return torch.stack([combine_topk(ys[r], dest[r], weights[r])
                        for r in range(world)])


moe_reduce_rs_shard.launches = 0


# ---------------------------------------------------------------------------
# Host entries (reference :67-96, :257-296)
# ---------------------------------------------------------------------------


@dataclass
class MoEReduceRSContext:
    """Counterpart of the reference's context (:67), with the fields of
    ``AGGroupGEMMContext``; ``block_m`` must be the one h was sorted
    with."""

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


def create_moe_rs_context(mesh, n_experts, topk, axis="tp", block_m=None,
                          impl="auto", config=None,
                          interpret=False) -> MoEReduceRSContext:
    return MoEReduceRSContext(mesh=mesh, n_experts=n_experts, topk=topk,
                              axis=axis, block_m=block_m, impl=impl,
                              config=config, interpret=interpret)


def moe_reduce_rs(h, w_stack, weights, experts, ctx: MoEReduceRSContext):
    """out [T, D] = reduce_scatter(GroupGEMM(h)) combined over the top-k,
    overlapped (reference :257)."""
    plain = _check_impl(ctx.impl)
    flat_axis(ctx.mesh, ctx.axis, "moe_reduce_rs")
    world = ctx.mesh.size
    (rows, F), (E, _, D), T = h.shape, w_stack.shape, weights.shape[0]
    if T % world or F % world:
        raise ValueError(f"moe_reduce_rs: {T} tokens and F = {F} must shard "
                         f"over {world} ranks")
    out = moe_reduce_rs_shard(
        h.view(rows, world, F // world).permute(1, 0, 2),
        w_stack.view(E, world, F // world, D).permute(1, 0, 2, 3),
        weights.reshape(world, T // world, ctx.topk),
        experts.reshape(world, T // world, ctx.topk),
        n_experts=ctx.n_experts, topk=ctx.topk,
        block_m=resolve_block_m(ctx, T), plain=plain)
    return out.reshape(T, D)


# ---------------------------------------------------------------------------
# The autotuned entry (reference :299-325)
# ---------------------------------------------------------------------------

# The reference's (bn, bk) MXU blocks; kept for the sweep's shape, and all
# one launch on the fixed Hopper tile (module docstring).
MOE_RS_TUNE_SPACE = [Config(bn=512, bk=512), Config(bn=512, bk=1024),
                     Config(bn=1024, bk=1024)]


def _prune(configs, args, kwargs):
    return dedupe_configs(configs, launch_keys(configs, args[2].shape[0],
                                               kwargs["ctx"]))


@autotune(configs=MOE_RS_TUNE_SPACE, key=(), prune=_prune)
def _moe_reduce_rs_tunable(h, w_stack, weights, experts, *, ctx, bn=None,
                           bk=None):
    del bn, bk      # the fixed Hopper tile takes no MXU blocks
    return moe_reduce_rs(h, w_stack, weights, experts, ctx)


def moe_reduce_rs_autotuned(h, w_stack, weights, experts,
                            ctx: MoEReduceRSContext):
    """:func:`moe_reduce_rs` under the autotuner (module docstring: one
    config survives the prune); see ``ag_group_gemm_autotuned``."""
    return _moe_reduce_rs_tunable(h, w_stack, weights, experts, ctx=ctx)
