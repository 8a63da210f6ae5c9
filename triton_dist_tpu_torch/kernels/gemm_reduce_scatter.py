"""Overlapped GEMM-ReduceScatter: the row-parallel projection of tensor
parallelism (and the column-parallel one's backward), with the reference's
bidirectional ring, int8 mode, contexts and host entries.

Counterpart of ``triton_dist_tpu/kernels/gemm_reduce_scatter.py`` on the
port's virtual world.  **The shard function** :func:`gemm_rs_shard`
(reference ``gemm_rs_shard`` :657) takes rank-stacked operands (every
per-rank operand carries a leading rank dimension; one call serves every
rank).  Rank q holds A_q [W m_loc, k] (every row, its shard of the
contraction) and B_q [k, N]; rank r gets C_r = sum over q of A_q[rows of
chunk r] @ B_q, [m_loc, N].  ``trans_b`` takes B_q^T from a weight stored
[N, k] (the column-parallel backward's ``b_shard.T``), read in place.

Schedules (:func:`gemm_rs_schedule`, the reference's rules):

- uni (``_gemm_rs_kernel`` :103): every rank's partial tiles pushed into
  the owner's staging slots, each owner summing its chunk;
- ``ring_mode="bidir"`` (``_gemm_rs_bidir_kernel`` :205), taken only at
  world > 1 when ``N % 2 == 0`` and ``(N // 2) % 128 == 0`` (:723-724),
  else the uni schedule: the N columns split in half, half 0's partials
  reduce round the ring rightward (chunk ``me - 1 - s`` at step s), half
  1's leftward (``me + 1 + s``), each rank's own chunk last;
- int8 A and B (the ``quantized`` path, :700-702): exact int32 partials
  and sums, the uni schedule's staging in int32, or the bidir ring's with
  int32 landing slots.

Rounding.  uni: each rank's partial is staged in A's dtype, as the
reference stages in its ``out_dtype`` (:764-772); the W partials are then
summed in f32 in the fixed order q = 0 .. W-1 and rounded once.  The
reference's ring adds in the staging dtype at every hop (``_add_body``,
:100), W - 1 roundings in a rank-dependent order: with bf16 operands the
two differ by bf16 rounding; in f32 they agree to f32 rounding.  bidir
adds as the reference does: the partial rounded to A's dtype, then at each
hop ``acc = local + recv`` in A's dtype, in the reference's hop order, so
given the same partials its sums are bit for bit the reference's (the
partials themselves may round differently: another order over k in f32).
int8: exact in any order.

On CUDA tensors each schedule launches ``csrc/gemm_rs.cu`` (``tdt_gemm_rs``
bf16; ``tdt_gemm_rs_bidir`` bf16, b [W, k, N] only, its W - 1 landing
slots per direction from the world's workspace; ``tdt_gemm_rs_i8``;
``tdt_gemm_rs_bidir_i8``, the bidir ring with int32 landing slots, each
hop's ``acc = local + recv`` added in registers) and counts it
(``gemm_rs_shard.launches`` the uni bf16 kernel,
``.mode_launches["bidir"]`` / ``["i8"]`` / ``["i8_bidir"]``), or raises on
what the kernel does not take; on CPU tensors (or with ``plain``) the
plain version.  Any ``m_loc >= 1`` is taken: the last row tile of each
chunk is masked.  The uni kernel (bf16 and int8, with its group and
torus modes) and the int8 bidir ring run on the wgmma / TMA mainloop of
``csrc/sm90_gemm.cuh`` (128 x 256 tiles, int8 :func:`i8_tile`'s; tensor
maps over the rank-stacked operands, which must meet
``allgather_gemm.ag_gemm_operand_ok`` or the wrapper raises); their
staging and landing slots hold each partial tile
in the accumulator's fragment order, a flag per (slot, tile)
(:func:`wg_workspace`), and the uni kernel's owner folds its chunk's G
staged partials in items of its own after its GEMM tiles.

**The torus schedule** (``_torus_gemm_rs_kernel`` :326, taken for a tuple
``axis`` with two or more axes of more than one rank, :679-689, whatever
``ring_mode`` says): :func:`torus_gemm_rs` over the joint group's G
ranks, a's rows the G chunks in joint order (flat axes-major), on the uni
kernel in its torus mode: each rank stages its bf16 partial of every
chunk in the owner's slot (:func:`wg_workspace`) and the owner folds its
G partials in the reference's torus order and rounding: the N columns in
2n parts of 128-column units (``_split_parts(N // 128, 2n)``, :591-597),
part q on path flavor q, every hop ``acc = local + recv`` in bf16
(``torus.torus_fold``), so given the same partials the sums are bit for
bit the reference's.  At shapes the reference's fused kernel cannot
tile (N % 128, m_loc % 8 or k % 128, and under ``plain``: the reference's
``impl="xla"``) it composes, and so does the port: the uni GEMM-RS over
``axes[0]``'s groups, then a reduce-scatter over each other axis
(:603-622), on the card the uni kernel over a one-axis group
(``tdt_gemm_rs_group``) and ``reduce_scatter_shard``'s kernels.  int8
(exact int32 in any order) always takes the joint group's int8 kernel
(:func:`torus_gemm_rs_i8`).

**The host entries** (reference :70-95, :794): :class:`GEMMReduceScatter
Context`, :func:`create_gemm_rs_context` and :func:`gemm_rs` (a [M, K]
sharded over ``ctx.axis`` by columns, b [K, N] by rows -> C [M, N], rank
r's chunk at rows r m_loc ..; a tuple axis: sharded by joint index, flat
axes-major), on a port ``Mesh``, with ``impl``, ``config`` and
``interpret`` as ``allgather_gemm``'s context takes them.
**The autotuned entry** :func:`gemm_rs_autotuned` (reference :863) sweeps
:data:`GEMM_RS_TUNE_SPACE`: the uni and the bidir ring, without the TPU
block triples; a bidir that gives way is pruned (it would launch the uni
kernel again).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from triton_dist_tpu_torch.autotuner import Config, autotune
from triton_dist_tpu_torch.kernels import _build, torus
from triton_dist_tpu_torch.kernels.allgather import joint_axes, shard_over
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    _check_impl,
    _check_tma,
    check_kernel_operands,
    check_pallas_shape,
    check_operands,
    dedupe_configs,
    flat_axis,
    ring_tables,
)
from triton_dist_tpu_torch.kernels.quant import matmul_i8_ref
from triton_dist_tpu_torch.runtime.bootstrap import Mesh, get_world

TILE_M = 128     # csrc/bf16_tile.cuh BM: the bidir ring's tile rows
TORUS_UNIT = 128   # columns of the torus order's unit (its parts' grain)
WG_TILE = (128, 256)   # csrc/sm90_gemm.cuh BM x BN: the uni kernel's tiles
# pointer tables (a, b, stage, out, flags, barrier), then world, m_loc, n,
# k [, b_nk], the epoch and the stream
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIG = {"tdt_gemm_rs": [_P] * 6 + [_I] * 5 + [_U, _P],
        "tdt_gemm_rs_bidir": [_P] * 6 + [_I] * 4 + [_U, _P],
        "tdt_gemm_rs_i8": [_P] * 6 + [_I] * 4 + [_U, _P],
        "tdt_gemm_rs_bidir_i8": [_P] * 6 + [_I] * 4 + [_U, _P],
        "tdt_gemm_rs_group": [_P] * 8 + [_I] * 6 + [_U, _P],
        "tdt_gemm_rs_group_i8": [_P] * 7 + [_I] * 4 + [_U, _P]}


def _m_loc(a, G=None):
    """The rows of one of a's G chunks (G: the ranks that reduce, the
    whole world by default)."""
    G = G or a.shape[0]
    if a.shape[1] % G:
        raise ValueError(f"gemm_rs: {a.shape[1]} rows do not split into {G} "
                         f"chunks")
    return a.shape[1] // G


def i8_tile(m_loc: int) -> tuple[int, int]:
    """The int8 kernels' tile for chunks of m_loc rows (``csrc/gemm_rs.cu``
    ``i8_tall``): 256 x 128, unless one 128 x 256 tile holds the rows."""
    return WG_TILE if m_loc <= WG_TILE[0] else (256, 128)


def uni_tiles(m_loc: int, n: int, int8: bool = False) -> int:
    """The uni kernel's tiles of one chunk [m_loc, n] (128 x 256; int8
    :func:`i8_tile`): its flags and staged tiles per slot (the last row
    tile masked to m_loc, the last column tile to n)."""
    tm, tn = i8_tile(m_loc) if int8 else WG_TILE
    return -(-m_loc // tm) * -(-n // tn)


def wg_workspace(G: int, m_loc: int, n: int, int8: bool = False,
                 bidir: bool = False):
    """(staging shape, flags) a rank of the wgmma kernels: the uni
    kernel's G slots of ``uni_tiles`` tiles, each 128 x 256 values (bf16,
    int32 in int8) in the accumulator's fragment order, a flag per (slot,
    tile); ``bidir`` (int8, G the world): the ring's 2 (G - 1) landing
    slots, each the int32 tiles of one half [m_loc, n / 2]."""
    size = WG_TILE[0] * WG_TILE[1]
    if bidir:
        tiles = uni_tiles(m_loc, n // 2, True)
        return (2, G - 1, tiles, size), 2 * (G - 1) * tiles
    tiles = uni_tiles(m_loc, n, int8)
    return (G, tiles, size), G * tiles


def _uni(a, b, m_loc, n, trans_b, name, G, group=()):
    """One launch of the uni kernel over G reducing ranks (``group``: the
    group entry's arguments, the flat world without), bf16 or int8 (int32
    staging and C), its :func:`wg_workspace`."""
    a, b = a.contiguous(), b.contiguous()
    _check_tma("gemm_rs", a, b)
    int8 = a.dtype == torch.int8
    stage, n_flags = wg_workspace(G, m_loc, n, int8)
    entry = ("tdt_gemm_rs_group" if group else "tdt_gemm_rs") + (
        "_i8" if int8 else "")
    return _launch(entry, a, b, m_loc, n, torch.int32 if int8 else a.dtype,
                   name, stage, n_flags, *(() if int8 else (int(trans_b),)),
                   group=group)


def gemm_rs_schedule(world: int, n: int, ring_mode: str = "uni",
                     torus: bool = False) -> str:
    """"torus" for a joint group of two or more real axes (``torus``),
    else "bidir" where the reference's ``gemm_rs_shard`` takes its bidir
    ring (world > 1, N % 2 == 0, (N // 2) % 128 == 0), else "uni"."""
    if torus:
        return "torus"
    if ring_mode == "bidir" and world > 1 and n % 2 == 0 and \
            (n // 2) % 128 == 0:
        return "bidir"
    return "uni"


def _partials(a, b, trans_b, G=None):
    """Each rank's partial [W, G, m_loc, N] of every chunk (G as
    :func:`_m_loc`), staged in a's dtype (int32 for int8)."""
    world, _, n = check_operands("gemm_rs", a, b, trans_b)
    G = G or world
    m_loc = _m_loc(a, G)
    bt = b.transpose(1, 2) if trans_b else b
    if a.dtype == torch.int8:
        parts = [matmul_i8_ref(a[q], bt[q]) for q in range(world)]
    else:
        parts = [(a[q].float() @ bt[q].float()).to(a.dtype)
                 for q in range(world)]
    return torch.stack(parts).view(world, G, m_loc, n)


def gemm_rs_ref(a, b, *, trans_b: bool = False, ring_mode: str = "uni"):
    """Plain C [W, m_loc, N]: each rank's partial a[q] @ b[q] (``b[q]^T``
    with ``trans_b``) in f32, staged in a's dtype; uni: chunk r of the W
    partials summed in f32 in rank order, cast to a's dtype; bidir (where
    :func:`gemm_rs_schedule` takes it): the reference's hop order and
    rounding; int8 a and b: exact int32 sums."""
    world, _, n = check_operands("gemm_rs", a, b, trans_b)
    parts = _partials(a, b, trans_b)
    if a.dtype == torch.int8:
        return parts.sum(dim=0, dtype=torch.int32)
    if gemm_rs_schedule(world, n, ring_mode) == "bidir":
        return _bidir_sums(parts)
    total = parts[0].float()
    for q in range(1, world):
        total = total + parts[q].float()
    return total.to(a.dtype)


def _bidir_sums(parts):
    """The bidir ring's sums: columns [0, N/2) of chunk c folded by ranks
    c + 1, c + 2, ..., c (rightward), [N/2, N) by c - 1, c - 2, ..., c,
    each hop ``acc = local + recv`` in the partials' dtype."""
    world, n = parts.shape[0], parts.shape[-1]
    nh = n // 2
    out = []
    for c in range(world):
        halves = []
        for d, sign in ((0, 1), (1, -1)):
            cols = slice(d * nh, (d + 1) * nh)
            acc = parts[(c + sign) % world, c, :, cols]
            for j in range(2, world + 1):
                acc = parts[(c + sign * j) % world, c, :, cols] + acc
            halves.append(acc)
        out.append(torch.cat(halves, dim=-1))
    return torch.stack(out)


def gemm_rs_shard(a, b, *, trans_b: bool = False, plain: bool = False,
                  ring_mode: str = "uni", mesh: Mesh | None = None,
                  axis=None):
    """C [W, m_loc, N] of rank-stacked a [W, W m_loc, k] and b [W, k, N]
    (``trans_b``: b [W, N, k], the product taking b[q]^T), through the
    schedule :func:`gemm_rs_schedule` picks; int8 a and b give the exact
    int32 C.  ``mesh`` and ``axis`` (the reference's ``axis``): a tuple of
    two or more axes of more than one rank takes the torus schedule over
    that joint group (:func:`torus_gemm_rs`: a [W, G m_loc, k]);
    otherwise ``axis`` must be the mesh's one real axis."""
    world, k, n = check_operands("gemm_rs", a, b, trans_b)
    if mesh is not None:
        if world != mesh.size:
            raise ValueError(f"gemm_rs: {world} ranks stacked, the mesh "
                             f"{mesh.shape} has {mesh.size}")
        joint = joint_axes(axis, mesh)
        if joint is not None:
            return torus_gemm_rs(a, b, mesh, joint, trans_b=trans_b,
                                 plain=plain)
        flat_axis(mesh, axis, "gemm_rs")
    m_loc = _m_loc(a)
    int8 = a.dtype == torch.int8
    if int8 and (b.dtype != torch.int8 or trans_b):
        raise ValueError(f"gemm_rs: int8 a takes an int8 b [W, k, N] "
                         f"without trans_b, got {b.dtype}"
                         f"{' with trans_b' if trans_b else ''}")
    mode = gemm_rs_schedule(world, n, ring_mode)
    if mode == "bidir" and trans_b:
        raise ValueError("gemm_rs: the bidir mode takes b [W, k, N], not "
                         "trans_b")
    if plain or a.device.type == "cpu":
        return gemm_rs_ref(a, b, trans_b=trans_b, ring_mode=ring_mode)
    if not a.is_cuda:
        raise ValueError(f"gemm_rs: unsupported device {a.device}")
    if int8:
        check_kernel_operands("gemm_rs (int8)", a, b, m_loc, k, n,
                              dtype=torch.int8, k_mult=32, n_mult=16)
        if mode == "bidir":
            out = _bidir_i8(a, b, m_loc, n)
            gemm_rs_shard.mode_launches["i8_bidir"] += 1
            return out
        out = _uni(a, b, m_loc, n, False, "gemm_rs_i8", world)
        gemm_rs_shard.mode_launches["i8"] += 1
        return out
    check_kernel_operands("gemm_rs", a, b, m_loc, k, n)
    if mode == "bidir":
        tiles = -(-m_loc // TILE_M) * -(-(n // 2) // TILE_M)
        out = _launch("tdt_gemm_rs_bidir", a, b, m_loc, n, a.dtype,
                      "gemm_rs_bidir", (2, world - 1, m_loc, n // 2),
                      2 * (world - 1) * tiles)
        gemm_rs_shard.mode_launches["bidir"] += 1
        return out
    out = _uni(a, b, m_loc, n, trans_b, "gemm_rs", world)
    gemm_rs_shard.launches += 1
    return out


def _bidir_i8(a, b, m_loc, n):
    """One launch of the int8 bidir ring (any N % 32: the host entries
    take it at (N / 2) % 128 == 0), its :func:`wg_workspace`."""
    a, b = a.contiguous(), b.contiguous()
    _check_tma("gemm_rs", a, b)
    return _launch("tdt_gemm_rs_bidir_i8", a, b, m_loc, n, torch.int32,
                   "gemm_rs_bidir_i8",
                   *wg_workspace(a.shape[0], m_loc, n, bidir=True))


def _launch(entry, a, b, m_loc, n, dtype, name, stage_shape, n_flags,
            *extra, group=()):
    """One cooperative launch of ``entry`` for every rank: its staging
    (or landing) buffers ``stage_shape`` per rank and ``n_flags`` flags
    per rank from the world's workspace, C [W, m_loc, n] allocated, this
    call's epoch; ``group``: the group entries' arguments after the
    tables (the joint group, the torus parts, the torus flag); ``extra``:
    the entry's arguments after k."""
    world, _, k = a.shape
    a, b = a.contiguous(), b.contiguous()
    ws = get_world(world, a.device).workspace
    stage = ws.get(name + "_stage", stage_shape, dtype)
    flags = ws.flags(name, n_flags)
    bar = ws.flags("barrier", world)
    out = torch.empty((world, m_loc, n), dtype=dtype, device=a.device)
    epoch = ws.next_epoch()
    lib = _build.load("gemm_rs", _SIG)
    with torch.cuda.device(a.device):
        err = getattr(lib, entry)(
            *ring_tables(a, b, stage, out, flags, bar), *group, world, m_loc,
            n, k, *extra, epoch, torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry[4:])
    return out


gemm_rs_shard.launches = 0
gemm_rs_shard.mode_launches = {"bidir": 0, "i8": 0, "i8_bidir": 0}


# ---------------------------------------------------------------------------
# The torus schedule (reference ``_torus_gemm_rs_kernel`` :326)
# ---------------------------------------------------------------------------


def torus_gemm_rs_ref(a, b, mesh: Mesh, axes, *, trans_b: bool = False):
    """Plain C [W, m_loc, N] over the joint group ``axes``: rank r of joint
    index t gets chunk t summed over its group, in the reference's torus
    order and rounding (module docstring); int8: the exact int32 sum."""
    G = mesh.joint_size(axes)
    parts = _partials(a, b, trans_b, G)
    world, _, m_loc, n = parts.shape
    groups = mesh.joint_groups(axes)
    if a.dtype == torch.int8:
        out = torch.empty((world, m_loc, n), dtype=torch.int32,
                          device=a.device)
        for group in groups:
            for t, r in enumerate(group):
                out[r] = parts[group, t].sum(dim=0, dtype=torch.int32)
        return out
    if n % TORUS_UNIT:
        raise ValueError(f"gemm_rs: the torus order takes N % 128 == 0, "
                         f"got {n}")
    sizes = [mesh.axis_size(x) for x in axes]
    paths = torus._paths_for(n // TORUS_UNIT, len(axes))
    out = torch.empty((world, m_loc, n), dtype=a.dtype, device=a.device)
    for group in groups:
        for t, r in enumerate(group):
            for off, ln, order, d in paths:
                if ln:
                    c0, c1 = off * TORUS_UNIT, (off + ln) * TORUS_UNIT
                    out[r, :, c0:c1] = torus.torus_fold(
                        lambda j: parts[group[j], t, :, c0:c1], sizes, t,
                        order, d)
    return out


def group_gemm_rs_ref(a, b, mesh: Mesh, axes, *, trans_b: bool = False):
    """Plain C [W, m_loc, N] of the uni schedule over the groups of
    ``axes``: chunk t of the group's partials summed in f32 in joint
    order, cast to a's dtype (the composition's first step)."""
    G = mesh.joint_size(axes)
    parts = _partials(a, b, trans_b, G)
    out = torch.empty_like(parts[:, 0])
    for group in mesh.joint_groups(axes):
        for t, r in enumerate(group):
            total = parts[group[0], t].float()
            for q in group[1:]:
                total = total + parts[q, t].float()
            out[r] = total.to(a.dtype)
    return out


def torus_tileable(m_loc: int, n: int, k: int) -> bool:
    """The shapes the reference's fused torus kernel tiles (:591-597): N %
    128, m_loc % 8 and k % 128; at others it composes."""
    return n % 128 == 0 and m_loc % 8 == 0 and k % 128 == 0


def torus_gemm_rs(a, b, mesh: Mesh, axes, *, trans_b: bool = False,
                  plain: bool = False):
    """The torus GEMM-RS over the joint group ``axes`` (module docstring):
    C [W, m_loc, N] of a [W, G m_loc, k] and b [W, k, N].  bf16 CUDA
    operands at tileable shapes launch ``tdt_gemm_rs_group`` in its torus
    order (the uni kernel's TORUS mode, its :func:`wg_workspace`; the
    operands must meet TMA's rules or it raises), counted in
    ``.launches``; int8 takes :func:`torus_gemm_rs_i8`; untileable shapes
    or ``plain`` compose; CPU operands run the plain versions."""
    world, k, n = check_operands("torus_gemm_rs", a, b, trans_b)
    G = mesh.joint_size(axes)
    m_loc = _m_loc(a, G)
    if a.dtype == torch.int8:
        return torus_gemm_rs_i8(a, b, mesh, axes, trans_b=trans_b,
                                plain=plain)
    if plain or not torus_tileable(m_loc, n, k):
        return _compose(a, b, mesh, axes, trans_b, plain)
    if a.device.type == "cpu":
        return torus_gemm_rs_ref(a, b, mesh, axes, trans_b=trans_b)
    if not a.is_cuda:
        raise ValueError(f"torus_gemm_rs: unsupported device {a.device}")
    check_kernel_operands("torus_gemm_rs", a, b, m_loc, k, n)
    ends = torus.part_ends(n // TORUS_UNIT, len(axes))
    out = _uni(a, b, m_loc, n, trans_b, "gemm_rs_torus", G,
               group=((ctypes.c_int * 7)(*mesh.group_args(axes)),
                      (ctypes.c_int * 6)(*ends), 1))
    torus_gemm_rs.launches += 1
    return out


def _compose(a, b, mesh, axes, trans_b, plain):
    """The reference's composition (:603-622): the uni GEMM-RS over the
    groups of ``axes[0]``, then a reduce-scatter over each other axis;
    the bands stay flat axes-major."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        reduce_scatter_shard,
    )

    world, k, n = check_operands("gemm_rs", a, b, trans_b)
    first = axes[:1]
    if plain or a.device.type == "cpu":
        part = group_gemm_rs_ref(a, b, mesh, first, trans_b=trans_b)
    else:
        if not a.is_cuda:
            raise ValueError(f"gemm_rs: unsupported device {a.device}")
        w0 = mesh.joint_size(first)
        m0 = _m_loc(a, w0)
        check_kernel_operands("gemm_rs", a, b, m0, k, n)
        part = _uni(a, b, m0, n, trans_b, "gemm_rs_group", w0,
                    group=((ctypes.c_int * 7)(*mesh.group_args(first)),
                           (ctypes.c_int * 6)(), 0))
        gemm_rs_shard.launches += 1
    part = part.view(*mesh.shape, *part.shape[1:])
    for ax in axes[1:]:
        part = reduce_scatter_shard(part, mesh, ax, plain=plain)
    return part.reshape(world, *part.shape[len(mesh.shape):])


def torus_gemm_rs_i8(a, b, mesh: Mesh, axes, *, trans_b: bool = False,
                     plain: bool = False):
    """The torus GEMM-RS's int8 mode: exact int32 partials and sums, so
    the torus order's sums at every shape.  CUDA operands launch
    ``tdt_gemm_rs_group_i8`` over the joint group (K % 32, N % 16),
    counted in ``.launches``; CPU operands (or ``plain``) run
    :func:`torus_gemm_rs_ref`."""
    world, k, n = check_operands("torus_gemm_rs_i8", a, b, trans_b)
    if b.dtype != torch.int8 or trans_b:
        raise ValueError(f"gemm_rs: int8 a takes an int8 b [W, k, N] "
                         f"without trans_b, got {b.dtype}"
                         f"{' with trans_b' if trans_b else ''}")
    G = mesh.joint_size(axes)
    m_loc = _m_loc(a, G)
    if plain or a.device.type == "cpu":
        return torus_gemm_rs_ref(a, b, mesh, axes)
    if not a.is_cuda:
        raise ValueError(f"torus_gemm_rs_i8: unsupported device {a.device}")
    check_kernel_operands("torus_gemm_rs_i8", a, b, m_loc, k, n,
                          dtype=torch.int8, k_mult=32, n_mult=16)
    out = _uni(a, b, m_loc, n, False, "gemm_rs_torus_i8", G,
               group=((ctypes.c_int * 7)(*mesh.group_args(axes)),))
    torus_gemm_rs_i8.launches += 1
    return out


torus_gemm_rs.launches = 0
torus_gemm_rs_i8.launches = 0


# ---------------------------------------------------------------------------
# Host entries (reference :70-95, :794-840)
# ---------------------------------------------------------------------------


@dataclass
class GEMMReduceScatterContext:
    """Counterpart of the reference's context (:70): the mesh and axis,
    ``impl``, ``config`` and ``interpret`` as ``AllGatherGEMMContext``
    takes them, and ``ring_mode``."""

    mesh: Mesh
    axis: Any = "tp"
    impl: str = "auto"
    config: Any = None
    ring_mode: str = "uni"
    interpret: bool = False

    @property
    def world(self) -> int:
        return self.mesh.joint_size(self.axis)


def create_gemm_rs_context(mesh, axis="tp", impl="auto", config=None,
                           ring_mode="uni",
                           interpret=False) -> GEMMReduceScatterContext:
    return GEMMReduceScatterContext(mesh=mesh, axis=axis, impl=impl,
                                    config=config, ring_mode=ring_mode,
                                    interpret=interpret)


def gemm_rs(a, b, ctx: GEMMReduceScatterContext):
    """C = reduce_scatter(A_loc @ B_loc, axis), overlapped (reference
    :794): a [M, K] sharded over ``ctx.axis`` by columns, b [K, N] by
    rows -> C [M, N]."""
    plain = _check_impl(ctx.impl)
    mesh = ctx.mesh
    joint = joint_axes(ctx.axis, mesh)
    if joint is not None:
        G, (M, K) = mesh.joint_size(joint), a.shape
        if K % G or M % G:
            raise ValueError(f"gemm_rs: a {tuple(a.shape)} does not shard "
                             f"over {G} ranks")
        if not torus_tileable(M // G, b.shape[1], K // G):
            # the reference composes; its first step's kernel raises
            check_pallas_shape(ctx.impl, "gemm_rs (torus)",
                               M // mesh.axis_size(joint[0]), b.shape[1],
                               K // G)
        a_r = a.reshape(M, G, -1).permute(1, 0, 2)[
            torch.tensor(mesh.joint_index(joint), device=a.device)]
        b_r = shard_over(b, mesh, ctx.axis).reshape(mesh.size, -1,
                                                    b.shape[1])
        out = gemm_rs_shard(a_r, b_r, plain=plain, ring_mode=ctx.ring_mode,
                            mesh=mesh, axis=ctx.axis)
        return out[mesh.joint_groups(joint)[0]].reshape(M, -1)
    axis = flat_axis(mesh, ctx.axis, "gemm_rs")
    world = mesh.size
    if a.shape[1] % world or a.shape[0] % world:
        raise ValueError(f"gemm_rs: a {tuple(a.shape)} does not shard over "
                         f"{world} ranks")
    a_r = a.reshape(a.shape[0], world, -1).permute(1, 0, 2)
    b_r = shard_over(b, mesh, axis) if axis else b.unsqueeze(0)
    b_r = b_r.reshape(world, -1, b.shape[1])
    out = gemm_rs_shard(a_r, b_r, plain=plain, ring_mode=ctx.ring_mode)
    return out.reshape(a.shape[0], -1)


# ---------------------------------------------------------------------------
# The autotuned entry (reference :842-870)
# ---------------------------------------------------------------------------

# The reference's mode axis (the uni and the bidir ring) without its TPU
# block triples.
GEMM_RS_TUNE_SPACE = [Config(ring_mode="uni"), Config(ring_mode="bidir")]


def _prune(configs, args, kwargs):
    ctx = kwargs["ctx"]
    torus_axes = joint_axes(ctx.axis, ctx.mesh) is not None
    return dedupe_configs(configs, [
        gemm_rs_schedule(ctx.mesh.size, args[1].shape[1],
                         c.get("ring_mode", "uni"), torus=torus_axes)
        for c in configs])


@autotune(configs=GEMM_RS_TUNE_SPACE, key=(), prune=_prune)
def _gemm_rs_tunable(a, b, *, ctx, ring_mode="uni"):
    tuned = GEMMReduceScatterContext(
        mesh=ctx.mesh, axis=ctx.axis, impl=ctx.impl, config=ctx.config,
        ring_mode=ring_mode, interpret=ctx.interpret)
    return gemm_rs(a, b, tuned)


def gemm_rs_autotuned(a, b, ctx: GEMMReduceScatterContext):
    """:func:`gemm_rs` with its ring mode picked by the autotuner (each
    config times the whole call); see ``ag_gemm_autotuned``."""
    return _gemm_rs_tunable(a, b, ctx=ctx)
