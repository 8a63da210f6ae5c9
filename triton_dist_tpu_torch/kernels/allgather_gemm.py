"""Overlapped AllGather-GEMM: the column-parallel projection of tensor
parallelism (and the row-parallel one's backward), in bf16 and in int8,
with the reference's ring modes, contexts and host entries.

Counterpart of ``triton_dist_tpu/kernels/allgather_gemm.py``.  The port
runs a world of W ranks on one device (``runtime/bootstrap.py``).

**The shard function** :func:`ag_gemm_shard` (reference ``ag_gemm_shard``
:642, run inside ``shard_map`` there) takes rank-stacked operands: every
per-rank operand carries a leading rank dimension, and one call serves
every rank.  For each rank r, given its rows A_r [m_loc, K] and its weight
shard B_r [K, n], the result is the gathered A_full [W m_loc, K] (rank s's
rows at segment s) and C_r = A_full @ B_r [W m_loc, n].  ``trans_b`` takes
B_r^T from a weight stored [n, K] (the row-parallel backward's
``b_shard.T``), read in place.  As in the reference (:700-705), A's dtype
picks the mode: int8 A and B give the exact int32 C of the W8A8
column-parallel linear (the gather moves int8).

The ring modes follow the reference's rules for when each is taken, so the
same call takes the same schedule in both packages (:func:`ag_gemm_
schedule`):

- ``ring_mode="bidir"`` (``_ag_gemm_bidir_kernel`` :108): each segment's
  top half rings rightward and its bottom half leftward.  It refuses
  ``wire_dtype`` and ``chunks > 1`` with a ValueError before any shape
  check (:670-676), and gives way to the uni schedule when m_loc is odd or
  ``(m_loc // 2) % 8``, for int8 A, and at world 1 (:750-752);
- ``chunks`` (the chunked forward, :370-373): each segment's push moves in
  ``chunks`` row chunks, each with its own flag, clamped as the reference
  clamps it (:787-788: down to a count that divides m_loc into chunks of a
  multiple of 8 rows, else 1).  ``chunks=1`` (the default) is one flag per
  segment: a GEMM tile waits for its segment's whole push;
- ``wire_dtype="int8"`` (:295-311): each rank's rows quantized per row
  (:func:`quant.quantize_rowwise`: int8 and an f32 scale per row), the
  gather moves int8 and the scales, and the GEMM dequantizes at its feed,
  ``bf16(float(q) * scale)`` then the bf16 product (``kernels/gemm.py``
  :163-165).  The reference's [m_loc, 128] scale plane is a TPU lane unit;
  the port ships [m_loc] f32 scales.  The gathered A comes back rebuilt
  from the gathered int8 and scales, outside the kernel (:822-826).  Any
  other ``wire_dtype`` raises; int8 A ignores the wire (it is the wire).

Giving way to another schedule is the reference's semantics, not a
fallback to the plain version: each schedule launches its own kernel and
has its own count (``ag_gemm_shard.launches`` the uni bf16 kernel, of which
``.mode_launches["chunked"]`` the calls with chunks > 1 (int8 ones too);
``.mode_launches["bidir"]`` and ``["wire"]``; :func:`ag_gemm_i8`'s the int8
kernel).  On CUDA tensors each launches ``csrc/ag_gemm.cu``
(``tdt_ag_gemm``: full-mesh pushes of each chunk in pieces of 128 rows,
counted at the receiver, the last piece raising the chunk's flag;
``tdt_ag_gemm_bidir``: the ring; ``tdt_ag_gemm_wire``; ``tdt_ag_gemm_i8``)
over the world's symmetric workspace and counts the launch, or raises on
what the kernel does not take (the bidir and wire kernels take no
``trans_b``); on CPU tensors (or with ``plain``) the plain version.  The
uni bf16 and int8 kernels and the bidir ring run their GEMM tiles on the
wgmma / TMA mainloop of ``csrc/sm90_gemm.cuh`` (tensor maps over the
rank-stacked operands): their operands meet :func:`ag_gemm_operand_ok` or
the wrapper raises.  Any
``m_loc >= 1`` is taken: the last tile of each segment (of each half, in
bidir) is masked to its rows.  World 1 goes through the kernel as well;
the tensor-parallel linears take ``torch.matmul`` there, as the
reference's auto dispatch takes XLA's dot.

**The host entries** (reference :859-890): :class:`AllGatherGEMMContext`,
:func:`create_ag_gemm_context`, :func:`ag_gemm` (a [M, K] sharded over
``ctx.axis`` by rows, b [K, N] by columns -> C [M, N]) and
:func:`ag_gemm_gathered` (-> (A_full [M, K], C)), on a port
``runtime/bootstrap.Mesh`` as ``allgather.all_gather`` takes one.
``impl`` and ``interpret`` are taken for source compatibility:
``impl="xla"`` runs the plain versions on any device, "auto" and "pallas"
the kernels on CUDA tensors; ``interpret`` changes nothing (CPU tensors
run the plain versions).  ``config`` (the reference's MXU block triple)
is kept and has no effect: the Hopper tiles are fixed (the uni kernels',
the torus order's and the bidir ring's 128 x 256 x 64 bf16 and 128 x 256
x 128 int8 (the torus int8 256 x 128 x 128) of ``csrc/sm90_gemm.cuh``; the
wire's 128 x 128 x 32 of ``csrc/bf16_tile.cuh``).  A tuple
``axis`` with two or more axes of more than one rank takes the torus
schedule over that joint group (reference :679-696,
``_torus_ag_gemm_kernel`` :428): a's rows and b's
columns are sharded by joint index, flat axes-major (``P(axes)``), not by
world rank.  ``wire_dtype`` then raises NotImplementedError (:687-692),
``ring_mode="bidir"`` with ``chunks > 1`` still raises ValueError first,
and ``chunks`` and ``ring_mode`` are otherwise ignored (:663-666).  The
torus kernel (:func:`torus_ag_gemm`, :func:`torus_ag_gemm_i8`) is the uni
kernel run over the joint group (``csrc/ag_gemm.cu`` ``tdt_ag_gemm_torus``:
``ag_gemm_wg_kernel`` off the flat world), its operands held to
:func:`ag_gemm_operand_ok` as the uni paths' are.  Any other axis must be
the mesh's one real axis: a single axis of a mesh whose other axes have
more than one rank raises NotImplementedError (ROADMAP Queue 1's
seventeenth entry: the ring GEMMs over one axis of a larger mesh).

**The autotuned entry** :func:`ag_gemm_autotuned` (reference :937) sweeps
:data:`AG_GEMM_TUNE_SPACE` through ``triton_dist_tpu_torch.autotuner``:
the reference's mode axis (chunks 1, 2, 4 and the bidir ring) without its
TPU block triples, which the fixed Hopper tile does not take.  The prune
drops every config whose resolved schedule another config already
launches (chunks that clamp alike, a bidir that gives way), so no two
configs of a sweep launch the same kernel with the same arguments.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any

import torch

from triton_dist_tpu_torch.autotuner import Config, autotune
from triton_dist_tpu_torch.kernels import _build, torus
from triton_dist_tpu_torch.kernels.allgather import joint_axes, shard_over
from triton_dist_tpu_torch.kernels.quant import matmul_i8_ref, quantize_rowwise
from triton_dist_tpu_torch.runtime.bootstrap import (
    MAX_RANKS,
    Mesh,
    as_axes,
    get_world,
)
from triton_dist_tpu_torch.runtime.symm_mem import peer_table

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIG = {"tdt_ag_gemm": [_P] * 7 + [_I] * 6 + [_U, _P],
        "tdt_ag_gemm_i8": [_P] * 7 + [_I] * 5 + [_U, _P],
        "tdt_ag_gemm_wire": [_P] * 9 + [_I] * 5 + [_U, _P],
        "tdt_ag_gemm_bidir": [_P] * 7 + [_I] * 4 + [_U, _P],
        "tdt_ag_gemm_torus": [_P] * 8 + [_I] * 5 + [_U, _P],
        "tdt_ag_gemm_torus_i8": [_P] * 8 + [_I] * 4 + [_U, _P]}


def check_operands(name, a, b, trans_b):
    """The rank-stacked operands' shapes: a [W, rows, K] against b
    [W, K, n] (or [W, n, K] with ``trans_b``); returns (W, K, n)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be rank-stacked [W, ., .]")
    world, k = a.shape[0], a.shape[2]
    kb, n = (b.shape[2], b.shape[1]) if trans_b else (b.shape[1],
                                                      b.shape[2])
    if kb != k:
        raise ValueError(f"{name}: contraction {k} of a against {kb} of b"
                         f"{' (transposed)' if trans_b else ''}")
    return world, k, n


def check_kernel_operands(name, a, b, m_loc, k, n, *, dtype=torch.bfloat16,
                          k_mult=8, n_mult=8):
    """What the ring kernels take, else a raise: ``dtype`` operands on one
    device, at most MAX_RANKS ranks, any m_loc >= 1 (each segment's row
    tail is masked), k % ``k_mult`` == 0 and n % ``n_mult`` == 0 (whole
    16-byte rows; the int8 mode asks 32 and 16, its tile's)."""
    if b.device != a.device:
        raise ValueError(f"{name}: b on {b.device}, a on {a.device}")
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"{name} kernel takes {dtype} operands, got "
                        f"{a.dtype} and {b.dtype}")
    if a.shape[0] > MAX_RANKS:
        raise ValueError(f"{name} kernel: at most {MAX_RANKS} ranks, got "
                         f"{a.shape[0]}")
    if m_loc < 1 or k % k_mult or n % n_mult or k == 0 or n == 0:
        mults = (f"{k_mult}" if k_mult == n_mult
                 else f"{k_mult} and {n_mult}")
        raise ValueError(f"{name} kernel: rows per rank {m_loc} must be "
                         f"positive, K={k} and N={n} positive multiples of "
                         f"{mults}")


_TMA_STRIDE_LIMIT = 1 << 40   # bytes: TMA's bound on a global stride


def ag_gemm_operand_ok(shape, strides, dtype, offset=0) -> bool:
    """Whether the uni kernels (``tdt_ag_gemm`` / ``tdt_ag_gemm_i8``)
    read a rank-stacked operand [W, rows, cols] of ``shape`` and element
    ``strides`` by TMA (``offset``: its storage offset in elements, on a
    16-byte aligned allocation): bf16 or int8, unit last stride, a 16-byte
    aligned base, and the stride of every dim of more than one row a
    nonzero multiple of 16 bytes below 2**40 (the rank stride included:
    one map spans every rank).  A pure function of the layout: the CPU
    tests hold every model path's operands to it."""
    if dtype not in (torch.bfloat16, torch.int8) or len(shape) != 3:
        return False
    return tma_layout_ok(shape, strides, 2 if dtype == torch.bfloat16 else 1,
                         offset)


def tma_layout_ok(shape, strides, size, offset=0) -> bool:
    """TMA's rule for one tensor map over a strided view of elements of
    ``size`` bytes: unit last stride, a 16-byte aligned base (``offset``
    elements into a 16-byte aligned allocation), and the stride of every
    dim of more than one row a nonzero multiple of 16 bytes below
    2**40."""
    if strides[-1] != 1 or (offset * size) % 16:
        return False
    return all(n == 1 or (0 < st * size < _TMA_STRIDE_LIMIT
                          and st * size % 16 == 0)
               for n, st in zip(shape[:-1], strides[:-1]))


def _check_tma(name, *tensors, rule=ag_gemm_operand_ok):
    """Raise unless every operand meets ``rule`` (by default
    :func:`ag_gemm_operand_ok`) at its address."""
    for t in tensors:
        if not rule(tuple(t.shape), t.stride(), t.dtype) or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: an operand {tuple(t.shape)} "
                             f"of strides {t.stride()} at offset "
                             f"{t.storage_offset()} breaks TMA's rules "
                             f"({rule.__name__})")


def ring_tables(*tensors):
    """One ctypes pointer table per rank-stacked tensor."""
    return [(ctypes.c_longlong * t.shape[0])(*peer_table(t))
            for t in tensors]


def _check_mode(a, b, trans_b):
    """int8 A takes int8 B and no ``trans_b`` (the W8A8 path has no
    backward); returns whether the int8 mode is asked for."""
    int8 = a.dtype == torch.int8
    if int8 and (b.dtype != torch.int8 or trans_b):
        raise ValueError(f"ag_gemm: int8 a takes an int8 b [W, K, n] "
                         f"without trans_b, got {b.dtype}"
                         f"{' with trans_b' if trans_b else ''}")
    return int8


def clamp_chunks(m_loc: int, chunks: int) -> int:
    """The reference's clamp (:787-788): the largest count <= ``chunks``
    that cuts m_loc into chunks of a multiple of 8 rows, else 1."""
    chunks = int(chunks)
    while chunks > 1 and (m_loc % chunks or (m_loc // chunks) % 8):
        chunks -= 1
    return max(chunks, 1)


@dataclass(frozen=True)
class Schedule:
    """What one AG-GEMM call runs: ``mode`` "uni", "bidir" or "torus", the
    clamped ``chunks`` (uni), and whether the int8 wire ships A."""

    mode: str
    chunks: int
    wire: bool


def _reject_bidir(chunks, wire_dtype, ring_mode):
    """bidir composes with neither the wire nor chunks > 1: raised before
    any shape check, as the reference does (:670-676)."""
    if ring_mode == "bidir" and (wire_dtype is not None or chunks > 1):
        raise ValueError(
            "ring_mode='bidir' composes with neither wire_dtype nor "
            "chunks > 1 (the half split is the sub-chunking)")


def ag_gemm_schedule(m_loc: int, world: int, int8: bool, *, chunks=1,
                     wire_dtype=None, ring_mode="uni",
                     torus: bool = False) -> Schedule:
    """The schedule the reference's ``ag_gemm_shard`` takes for these
    arguments (module docstring), or its ValueError; as there, any
    ``ring_mode`` but "bidir" is the uni ring.  ``torus`` (a joint group
    of two or more real axes): the torus schedule, whatever ``chunks`` and
    ``ring_mode`` say, and ``wire_dtype`` raises NotImplementedError
    (:687-692)."""
    _reject_bidir(chunks, wire_dtype, ring_mode)
    if torus:
        if wire_dtype is not None:
            raise NotImplementedError(
                "wire_dtype is implemented for the 1-D ring schedule; the "
                "torus schedule ships A as it is")
        return Schedule("torus", 1, False)
    wire = wire_dtype is not None
    if wire and wire_dtype != "int8":
        raise ValueError(f"wire_dtype must be 'int8' or None, got "
                         f"{wire_dtype!r}")
    wire = wire and not int8            # int8 A is the wire format already
    if ring_mode == "bidir" and not (m_loc % 2 or (m_loc // 2) % 8 or int8
                                     or world == 1):
        return Schedule("bidir", 1, False)
    return Schedule("uni", clamp_chunks(m_loc, chunks), wire)


def _wire_rows(a):
    """The wire's payload: every rank's rows quantized per row, (q [W,
    m_loc, K] int8, scale [W, m_loc] f32)."""
    world, m_loc, k = a.shape
    q, scale = quantize_rowwise(a.reshape(world * m_loc, k))
    return q.view(world, m_loc, k), scale.view(world, m_loc)


def _dequant(q, scale, dtype):
    """bf16(float(q) * scale) per row, the wire's reconstruction."""
    return (q.float() * scale.unsqueeze(-1)).to(dtype)


def ag_gemm_ref(a, b, *, trans_b: bool = False, wire: bool = False):
    """Plain (A_full [W, W m_loc, K], C [W, W m_loc, n]): A_full is the
    ranks' rows concatenated (the same on every rank: an expanded view),
    C[r] = A_full @ b[r] (``@ b[r]^T`` with ``trans_b``) in f32, cast to
    a's dtype; int8 a and b give the exact int32 C.  ``wire``: the rows
    quantized per row and dequantized in a's dtype first (the reference's
    XLA path, :719-725), A_full that reconstruction."""
    world, k, _ = check_operands("ag_gemm", a, b, trans_b)
    int8 = _check_mode(a, b, trans_b)
    if wire and not int8:
        a = _dequant(*_wire_rows(a), a.dtype)
    a_full = a.reshape(world * a.shape[1], k)
    bt = b.transpose(1, 2) if trans_b else b
    if int8:
        c = torch.stack([matmul_i8_ref(a_full, bt[r]) for r in range(world)])
    else:
        c = torch.stack([(a_full.float() @ bt[r].float()).to(a.dtype)
                         for r in range(world)])
    return a_full.expand(world, -1, -1), c


def ag_gemm_wire_ref(a, b):
    """The wire mode's plain version with its payload: (gathered int8 [W,
    W m_loc, K], gathered scales [W, W m_loc], C [W, W m_loc, n])."""
    world, m_loc, k = a.shape
    q, scale = _wire_rows(a)
    _, c = ag_gemm_ref(a, b, wire=True)
    return (q.reshape(1, world * m_loc, k).expand(world, -1, -1),
            scale.reshape(1, world * m_loc).expand(world, -1), c)


def _launch(entry, a, buffers, ints, name, n_flags, group=None):
    """One cooperative launch of ``entry`` for every rank: the pointer
    tables of ``buffers``, then of the flags and piece counters of
    ``name`` (``n_flags`` a rank) and the barrier slots from the world's
    workspace; then the joint ``group`` ([n, sizes, strides], the torus
    entries'), ``ints`` and this call's epoch."""
    world = a.shape[0]
    ws = get_world(world, a.device).workspace
    tables = ring_tables(*buffers, ws.flags(name, n_flags),
                         ws.flags(name + "_cnt", n_flags),
                         ws.flags("barrier", world))
    if group is not None:
        tables.append((ctypes.c_int * 7)(*group))
    epoch = ws.next_epoch()
    lib = _build.load("ag_gemm", _SIG)
    with torch.cuda.device(a.device):
        err = getattr(lib, entry)(*tables, *ints, epoch,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, entry[4:])


def _empty(a, *shape, dtype=None):
    return torch.empty(shape, dtype=dtype or a.dtype, device=a.device)


def ag_gemm_shard(a, b, *, trans_b: bool = False, plain: bool = False,
                  chunks: int = 1, wire_dtype=None, ring_mode: str = "uni",
                  mesh: Mesh | None = None, axis=None):
    """(A_full [W, W m_loc, K], C [W, W m_loc, n]) of rank-stacked a
    [W, m_loc, K] and b [W, K, n] (``trans_b``: b [W, n, K], the product
    taking b[r]^T), through the schedule :func:`ag_gemm_schedule` picks;
    int8 a and b take the int8 mode (:func:`ag_gemm_i8`, int32 C).
    ``mesh`` and ``axis`` (the reference's ``axis``): a tuple of two or
    more axes of more than one rank takes the torus schedule over that
    joint group (:func:`torus_ag_gemm`: A_full and C [W, G m_loc, .], flat
    axes-major); otherwise ``axis`` must be the mesh's one real axis."""
    return _ag_gemm(a, b, trans_b=trans_b, plain=plain, chunks=chunks,
                    wire_dtype=wire_dtype, ring_mode=ring_mode,
                    gathered=True, mesh=mesh, axis=axis)


def _ag_gemm(a, b, *, trans_b, plain, chunks, wire_dtype, ring_mode,
             gathered, mesh=None, axis=None):
    """:func:`ag_gemm_shard`; ``gathered=False`` leaves the wire's A_full
    unbuilt (None), as the host's ``ag_gemm`` needs none."""
    _reject_bidir(chunks, wire_dtype, ring_mode)
    world, k, n = check_operands("ag_gemm", a, b, trans_b)
    int8 = _check_mode(a, b, trans_b)
    joint = None
    if mesh is not None:
        if world != mesh.size:
            raise ValueError(f"ag_gemm: {world} ranks stacked, the mesh "
                             f"{mesh.shape} has {mesh.size}")
        joint = joint_axes(axis, mesh)
        if joint is None:
            flat_axis(mesh, axis, "ag_gemm")
    sched = ag_gemm_schedule(a.shape[1], world, int8, chunks=chunks,
                             wire_dtype=wire_dtype, ring_mode=ring_mode,
                             torus=joint is not None)
    if joint is not None:
        fn = torus_ag_gemm_i8 if int8 else torus_ag_gemm
        return fn(a, b, mesh, joint, trans_b=trans_b, plain=plain)
    if trans_b and (sched.mode == "bidir" or sched.wire):
        raise ValueError("ag_gemm: the bidir and wire modes take b [W, K, "
                         "n], not trans_b")
    if int8:
        return ag_gemm_i8(a, b, plain=plain, chunks=sched.chunks)
    if plain or a.device.type == "cpu":
        a_full, c = ag_gemm_ref(a, b, trans_b=trans_b, wire=sched.wire)
        return (a_full if gathered else None), c
    if not a.is_cuda:
        raise ValueError(f"ag_gemm: unsupported device {a.device}")
    m_loc = a.shape[1]
    check_kernel_operands("ag_gemm", a, b, m_loc, k, n,
                          k_mult=16 if sched.wire else 8)
    a, b = a.contiguous(), b.contiguous()
    c = _empty(a, world, world * m_loc, n)
    dims = (world, m_loc, n, k)
    if sched.wire:
        q, scale = _wire_rows(a)
        ag_q = _empty(a, world, world * m_loc, k, dtype=torch.int8)
        ag_s = _empty(a, world, world * m_loc, dtype=torch.float32)
        _launch("tdt_ag_gemm_wire", a, (q, scale, b, ag_q, ag_s, c),
                (*dims, m_loc // sched.chunks), "ag_gemm_wire",
                world * sched.chunks)
        a_full = _dequant(ag_q, ag_s, a.dtype) if gathered else None
        mode = "wire"
    else:
        a_full = _empty(a, world, world * m_loc, k)
        _check_tma("ag_gemm", a, b)
        if sched.mode == "bidir":
            _launch("tdt_ag_gemm_bidir", a, (a, b, a_full, c), dims,
                    "ag_gemm_bidir", 2 * world)
        else:
            _launch("tdt_ag_gemm", a, (a, b, a_full, c),
                    (*dims, m_loc // sched.chunks, int(trans_b)), "ag_gemm",
                    world * sched.chunks)
            ag_gemm_shard.launches += 1
        mode = sched.mode
    if mode != "uni":
        ag_gemm_shard.mode_launches[mode] += 1
    if sched.chunks > 1:
        ag_gemm_shard.mode_launches["chunked"] += 1
    return a_full, c


def ag_gemm_i8(a, b, *, plain: bool = False, chunks: int = 1):
    """The int8 mode: (A_full [W, W m_loc, K] int8, C [W, W m_loc, n]
    int32, exact) of rank-stacked int8 a [W, m_loc, K] and b [W, K, n],
    ``chunks`` clamped as the bf16 mode's.  CUDA operands launch
    ``tdt_ag_gemm_i8`` (K % 32 == 0, n % 16 == 0, any m_loc; TMA's rules,
    :func:`ag_gemm_operand_ok`); CPU operands (or ``plain``) run
    :func:`ag_gemm_ref`."""
    world, k, n = check_operands("ag_gemm_i8", a, b, False)
    if plain or a.device.type == "cpu":
        return ag_gemm_ref(a, b)
    if not a.is_cuda:
        raise ValueError(f"ag_gemm_i8: unsupported device {a.device}")
    m_loc = a.shape[1]
    check_kernel_operands("ag_gemm_i8", a, b, m_loc, k, n,
                          dtype=torch.int8, k_mult=32, n_mult=16)
    chunks = clamp_chunks(m_loc, chunks)
    a, b = a.contiguous(), b.contiguous()
    _check_tma("ag_gemm_i8", a, b)
    a_full = _empty(a, world, world * m_loc, k)
    c = _empty(a, world, world * m_loc, n, dtype=torch.int32)
    _launch("tdt_ag_gemm_i8", a, (a, b, a_full, c),
            (world, m_loc, n, k, m_loc // chunks), "ag_gemm_i8",
            world * chunks)
    ag_gemm_i8.launches += 1
    if chunks > 1:
        ag_gemm_shard.mode_launches["chunked"] += 1
    return a_full, c


ag_gemm_shard.launches = 0
ag_gemm_shard.mode_launches = {"chunked": 0, "bidir": 0, "wire": 0}
ag_gemm_i8.launches = 0


# ---------------------------------------------------------------------------
# The torus schedule (reference ``_torus_ag_gemm_kernel`` :428)
# ---------------------------------------------------------------------------


def torus_ag_gemm_ref(a, b, mesh: Mesh, axes, *, trans_b: bool = False):
    """Plain (A_full [W, G m_loc, K], C [W, G m_loc, n]) over the joint
    group ``axes``: A_full[r] is r's group's rows in joint order (flat
    axes-major), C[r] = A_full[r] @ b[r] (``b[r]^T`` with ``trans_b``) in
    f32, cast to a's dtype; int8 a and b give the exact int32 C."""
    world, k, _ = check_operands("ag_gemm", a, b, trans_b)
    int8 = _check_mode(a, b, trans_b)
    m_loc = a.shape[1]
    a_full = torus.torus_all_gather_ref(a.reshape(*mesh.shape, m_loc, k),
                                        mesh, axes).reshape(world, -1, k)
    bt = b.transpose(1, 2) if trans_b else b
    if int8:
        c = torch.stack([matmul_i8_ref(a_full[r], bt[r])
                         for r in range(world)])
    else:
        c = torch.stack([(a_full[r].float() @ bt[r].float()).to(a.dtype)
                         for r in range(world)])
    return a_full, c


def torus_ag_gemm(a, b, mesh: Mesh, axes, *, trans_b: bool = False,
                  plain: bool = False):
    """The torus AG-GEMM, bf16 (:func:`torus_ag_gemm_ref`'s function):
    CUDA operands launch ``tdt_ag_gemm_torus`` (``csrc/ag_gemm.cu``: the
    uni kernel over the joint group, one flag per segment, each rank's own
    segment first; TMA's rules, :func:`ag_gemm_operand_ok`), counted in
    ``.launches``; CPU operands (or ``plain``) run the plain version."""
    world, k, n = check_operands("torus_ag_gemm", a, b, trans_b)
    if plain or a.device.type == "cpu":
        return torus_ag_gemm_ref(a, b, mesh, axes, trans_b=trans_b)
    if not a.is_cuda:
        raise ValueError(f"torus_ag_gemm: unsupported device {a.device}")
    m_loc, G = a.shape[1], mesh.joint_size(axes)
    check_kernel_operands("torus_ag_gemm", a, b, m_loc, k, n)
    a, b = a.contiguous(), b.contiguous()
    _check_tma("torus_ag_gemm", a, b)
    a_full = _empty(a, world, G * m_loc, k)
    c = _empty(a, world, G * m_loc, n)
    _launch("tdt_ag_gemm_torus", a, (a, b, a_full, c),
            (world, m_loc, n, k, int(trans_b)), "ag_gemm_torus", G,
            group=mesh.group_args(axes))
    torus_ag_gemm.launches += 1
    return a_full, c


def torus_ag_gemm_i8(a, b, mesh: Mesh, axes, *, trans_b: bool = False,
                     plain: bool = False):
    """The torus AG-GEMM's int8 mode (the reference's int8 A, int32 C,
    :596-598): CUDA operands launch ``tdt_ag_gemm_torus_i8`` (K % 32,
    n % 16), counted in ``.launches``; CPU operands (or ``plain``) run
    :func:`torus_ag_gemm_ref`."""
    world, k, n = check_operands("torus_ag_gemm_i8", a, b, trans_b)
    _check_mode(a, b, trans_b)
    if plain or a.device.type == "cpu":
        return torus_ag_gemm_ref(a, b, mesh, axes)
    if not a.is_cuda:
        raise ValueError(f"torus_ag_gemm_i8: unsupported device "
                         f"{a.device}")
    m_loc, G = a.shape[1], mesh.joint_size(axes)
    check_kernel_operands("torus_ag_gemm_i8", a, b, m_loc, k, n,
                          dtype=torch.int8, k_mult=32, n_mult=16)
    a, b = a.contiguous(), b.contiguous()
    _check_tma("torus_ag_gemm_i8", a, b)
    a_full = _empty(a, world, G * m_loc, k)
    c = _empty(a, world, G * m_loc, n, dtype=torch.int32)
    _launch("tdt_ag_gemm_torus_i8", a, (a, b, a_full, c),
            (world, m_loc, n, k), "ag_gemm_torus_i8", G,
            group=mesh.group_args(axes))
    torus_ag_gemm_i8.launches += 1
    return a_full, c


torus_ag_gemm.launches = 0
torus_ag_gemm_i8.launches = 0


# ---------------------------------------------------------------------------
# Host entries (reference :65-96, :859-890)
# ---------------------------------------------------------------------------


@dataclass
class AllGatherGEMMContext:
    """Counterpart of the reference's context (:65): the mesh and axis,
    ``impl`` ("auto" | "pallas": the kernels on CUDA tensors; "xla": the
    plain versions), ``config`` (kept; no effect: the Hopper tiles are
    fixed), the ring modes ``chunks`` / ``wire_dtype`` / ``ring_mode``,
    and ``interpret`` (kept; no effect)."""

    mesh: Mesh
    axis: Any = "tp"
    impl: str = "auto"
    config: Any = None
    chunks: int = 1
    wire_dtype: str | None = None
    ring_mode: str = "uni"
    interpret: bool = False

    @property
    def world(self) -> int:
        return self.mesh.joint_size(self.axis)


def create_ag_gemm_context(mesh, axis="tp", impl="auto", config=None,
                           chunks=1, wire_dtype=None, ring_mode="uni",
                           interpret=False) -> AllGatherGEMMContext:
    return AllGatherGEMMContext(mesh=mesh, axis=axis, impl=impl,
                                config=config, chunks=chunks,
                                wire_dtype=wire_dtype, ring_mode=ring_mode,
                                interpret=interpret)


def flat_axis(mesh: Mesh, axis, what: str) -> str | None:
    """The one axis the ring kernels run over: ``axis`` (or the one real
    axis of a tuple), when every other axis of the mesh has one rank;
    else ``NotImplementedError`` (a joint group of two or more real axes
    is the torus schedule, which only the AG-GEMM and GEMM-RS take)."""
    real = [a for a in as_axes(axis) if mesh.axis_size(a) > 1]
    others = [a for a in mesh.axis_names
              if a not in real[:1] and mesh.axis_size(a) > 1]
    if others:
        raise NotImplementedError(
            f"{what} over {axis!r} of a mesh {mesh.shape}: the ring kernels "
            f"run over one flat world, the other axes {others} must have "
            f"one rank (ROADMAP Queue 1's seventeenth entry: the ring GEMMs "
            f"over one axis of a larger mesh)")
    if not isinstance(axis, (tuple, list)):
        return axis
    return real[0] if real else None


def check_pallas_shape(impl, what, m, n, k):
    """The reference's explicit ``impl="pallas"`` contract (``use_fallback``,
    gemm.py :105): where its torus entries would leave the Pallas kernel
    for another path, because a per-shard (m, n, k) is off the MXU tiling
    (m % 8, n % 128, k % 128), they raise instead; so does the port's host
    entry, whatever the Hopper kernel would take."""
    if impl == "pallas" and (m % 8 or n % 128 or k % 128):
        raise ValueError(
            f"{what}: impl='pallas' requested but per-shard ({m}, {n}, {k}) "
            f"fails the reference kernel's tiling contract (m % 8, n % 128, "
            f"k % 128); pass impl='auto' to permit the other path")


def _check_impl(impl):
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"impl must be 'auto', 'pallas' or 'xla', got "
                         f"{impl!r}")
    return impl == "xla"


def ag_gemm_gathered(a, b, ctx: AllGatherGEMMContext):
    """(A_full [M, K], C [M, N]): a [M, K] sharded over ``ctx.axis`` by
    rows, b [K, N] by columns; every rank's gathered A is the same (rank
    0's copy is returned), C's column blocks are the ranks' in rank
    order."""
    return _host(a, b, ctx, gathered=True)


def ag_gemm(a, b, ctx: AllGatherGEMMContext):
    """C = allgather(A, axis) @ B_local, overlapped (reference :859)."""
    return _host(a, b, ctx, gathered=False)[1]


def _host(a, b, ctx, *, gathered):
    plain = _check_impl(ctx.impl)
    mesh = ctx.mesh
    joint = joint_axes(ctx.axis, mesh)
    if joint is not None:
        return _torus_host(a, b, ctx, joint, plain)
    axis = flat_axis(mesh, ctx.axis, "ag_gemm")
    world = mesh.size
    if b.shape[1] % world:
        raise ValueError(f"ag_gemm: {b.shape[1]} columns do not shard over "
                         f"{world} ranks")
    a_r = shard_over(a, mesh, axis) if axis else a.unsqueeze(0)
    a_r = a_r.reshape(world, -1, a.shape[1])
    b_r = b.reshape(b.shape[0], world, -1).permute(1, 0, 2)
    a_full, c = _ag_gemm(a_r, b_r, trans_b=False, plain=plain,
                         chunks=ctx.chunks, wire_dtype=ctx.wire_dtype,
                         ring_mode=ctx.ring_mode, gathered=gathered)
    c = c.permute(1, 0, 2).reshape(c.shape[1], -1)
    return (a_full[0] if a_full is not None else None), c


def _torus_host(a, b, ctx, joint, plain):
    """:func:`_host` over the joint group ``joint``: a's rows and b's
    columns sharded by joint index (flat axes-major), C's column blocks
    in that order."""
    mesh, world = ctx.mesh, ctx.mesh.size
    G = mesh.joint_size(joint)
    if b.shape[1] % G:
        raise ValueError(f"ag_gemm: {b.shape[1]} columns do not shard over "
                         f"{G} ranks")
    check_pallas_shape(ctx.impl, "ag_gemm (torus)", a.shape[0] // G,
                       b.shape[1] // G, a.shape[1])
    a_r = shard_over(a, mesh, ctx.axis).reshape(world, -1, a.shape[1])
    b_r = b.reshape(b.shape[0], G, -1).permute(1, 0, 2)[
        torch.tensor(mesh.joint_index(joint), device=b.device)]
    a_full, c = _ag_gemm(a_r, b_r, trans_b=False, plain=plain,
                         chunks=ctx.chunks, wire_dtype=ctx.wire_dtype,
                         ring_mode=ctx.ring_mode, gathered=True, mesh=mesh,
                         axis=ctx.axis)
    c = c[mesh.joint_groups(joint)[0]]
    return a_full[0], c.permute(1, 0, 2).reshape(c.shape[1], -1)


# ---------------------------------------------------------------------------
# The autotuned entry (reference :897-962)
# ---------------------------------------------------------------------------

# The reference's mode axis (chunks 1 / 2 / 4 and the bidir ring) without
# its TPU block triples: the Hopper kernels take no block size.
AG_GEMM_TUNE_SPACE = [Config(chunks=1), Config(chunks=2), Config(chunks=4),
                      Config(chunks=1, ring_mode="bidir")]


def _resolved(configs, a, ctx):
    """Each config's schedule for a [M, K] under ``ctx`` (None where it
    raises: the sweep skips it as a bad config)."""
    joint = joint_axes(ctx.axis, ctx.mesh)
    world = ctx.mesh.joint_size(joint) if joint else ctx.mesh.size
    int8 = a.dtype == torch.int8
    out = []
    for cfg in configs:
        try:
            out.append(ag_gemm_schedule(
                a.shape[0] // world, world, int8,
                chunks=cfg.get("chunks", 1), wire_dtype=ctx.wire_dtype,
                ring_mode=cfg.get("ring_mode", "uni"),
                torus=joint is not None))
        except ValueError:
            out.append(None)
    return out


def dedupe_configs(configs, scheds):
    """The first config of each distinct schedule (and every config whose
    schedule is None, to fail as the sweep's bad configs)."""
    seen, keep = set(), []
    for cfg, s in zip(configs, scheds):
        if s is None or s not in seen:
            keep.append(cfg)
            seen.add(s)
    return keep


def _prune(configs, args, kwargs):
    return dedupe_configs(configs, _resolved(configs, args[0],
                                             kwargs["ctx"]))


@autotune(configs=AG_GEMM_TUNE_SPACE, key=(), prune=_prune)
def _ag_gemm_tunable(a, b, *, ctx, chunks=1, ring_mode="uni"):
    tuned = AllGatherGEMMContext(
        mesh=ctx.mesh, axis=ctx.axis, impl=ctx.impl, config=ctx.config,
        chunks=chunks, wire_dtype=ctx.wire_dtype, ring_mode=ring_mode,
        interpret=ctx.interpret)
    return ag_gemm(a, b, tuned)


def ag_gemm_autotuned(a, b, ctx: AllGatherGEMMContext):
    """:func:`ag_gemm` with its ring mode picked by the autotuner (each
    config times the whole call, gather and GEMM together); winners are
    cached per (shapes, dtypes, ctx).  Inside a ``contextual_autotune``
    region the sweep advances in lockstep with the region's other tuners;
    outside one, the first call sweeps eagerly."""
    return _ag_gemm_tunable(a, b, ctx=ctx)
