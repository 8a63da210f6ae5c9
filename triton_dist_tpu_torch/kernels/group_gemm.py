"""Grouped (expert-blocked) GEMM: the MoE family's expert compute.

Counterpart of ``triton_dist_tpu/kernels/group_gemm.py``.  Every
``block_m``-row tile of the expert-sorted token buffer (``moe_utils.
sort_align``) belongs to ONE expert, so row tile i is ``x_tile @
w[tile_expert[i]]`` with w ``[E, K, N]`` in the reference's layout.

- :func:`group_gemm_ref`: the plain version, a loop over runs of row tiles
  that share an expert (never the ``w[tile_expert]`` gather of the
  reference's ``group_gemm_xla``, which at Mixtral widths would copy 117 MB
  per tile): f32 products cast to the output dtype, or float64 cast to
  int32 for int8 (exact, as ``quant.matmul_i8_ref``).
- :func:`group_gemm` (bf16 forward), :func:`group_gemm_dx` (dy @ w[e]^T,
  the backward's dx) and :func:`group_gemm_i8` (exact int8 -> int32): on
  CUDA tensors each launches its mode of the hand-written Hopper kernel
  ``group_gemm_wg_kernel`` (``csrc/group_gemm.cu``, the port of the TPU
  ``_kernel``, on the persistent wgmma / TMA GEMM of
  ``csrc/sm90_gemm.cuh``) or raises on what it does not take (operands
  that break ``quant.gemm_operand_ok``, TMA's rule, included), and counts
  its launches; on CPU tensors it runs the plain version.  ``plain=True``
  takes the plain version on any device (a reference computation on the
  card).
- Under autograd, :func:`group_gemm` goes through :class:`GroupGemmFn`,
  the counterpart of the reference's ``custom_vjp``: dx is the transposed
  mode of the same kernel on dy cast to x's dtype; dW[e] sums x_tile^T @
  dy_tile over the expert's tiles with f32 accumulation, cast to w's dtype
  (an XLA product in the reference, so ``torch.mm`` here), holding at most
  E K N f32 values.
- :func:`load_aware_block_m` and :func:`moe_ffn_sorted`, copied.

The reference's ``bn`` / ``bk`` block arguments have no counterpart: the
kernel's tiles are its own.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build
from triton_dist_tpu_torch.kernels.quant import check_operands

_SIG = {"tdt_group_gemm_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_void_p],
        "tdt_group_gemm_i8": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}
# what the kernel takes: block_m, N and K multiples of these (a tile lies
# in one expert: bf16 tiles are 128 rows, int8 ones 64 where block_m %
# 128 != 0)
TILE_M, TILE_N, TILE_K = 128, 128, 32
I8_TILE_M = 64
# csrc/group_gemm.cu: output tiles of 128 x 256 (int8 at block_m % 256:
# 256 x 128), walked in groups of GROUP row tiles, column band by column
# band within a group
TILE_SHAPE, TALL_SHAPE, GROUP = (128, 256), (256, 128), 8


def tile_shape(block_m: int, int8: bool = False):
    """(rows, columns) of the kernel's output tiles for ``block_m``: int8
    takes 256 x 128 where block_m % 256 == 0; 64-row tiles where block_m
    % 128 != 0 (int8 only)."""
    if int8 and block_m % TALL_SHAPE[0] == 0:
        return TALL_SHAPE
    rows, cols = TILE_SHAPE
    return (rows if block_m % rows == 0 else rows // 2), cols


def tile_order(m_pad: int, n: int, block_m: int, int8: bool = False):
    """The output tiles of one launch in the order its persistent blocks
    take them (``tdt_gemm90::tile_rc``): (first row, rows, first column,
    columns, row tile of ``block_m`` whose expert the tile reads) for
    every tile of :func:`tile_shape`.  A pure function: the CPU tests
    walk it."""
    rows, cols = tile_shape(block_m, int8)
    tiles_m, tiles_n = -(-m_pad // rows), -(-n // cols)
    for t in range(tiles_m * tiles_n):
        g0 = t // (GROUP * tiles_n) * GROUP
        in_group = min(GROUP, tiles_m - g0)
        r = t - g0 * tiles_n
        row0 = (g0 + r % in_group) * rows
        yield row0, rows, r // in_group * cols, cols, row0 // block_m


def load_aware_block_m(total_rows: int, n_experts: int,
                       floor: int = 128) -> int:
    """Row-tile size for a load: the largest of {floor, 256, 512} not above
    the balanced per-expert load ``total_rows / n_experts`` (dense prefill
    gets large tiles, sparse decode the padding-lean floor)."""
    per_expert = max(total_rows // max(n_experts, 1), 1)
    best = floor
    for b in (256, 512):
        if per_expert >= b:
            best = b
    return best


def _expert_runs(tile_expert):
    """[(expert, first tile, end tile)] over maximal runs of equal
    experts (one host read of the map)."""
    te = tile_expert.tolist()
    runs, t0 = [], 0
    for t in range(1, len(te) + 1):
        if t == len(te) or te[t] != te[t0]:
            runs.append((te[t0], t0, t))
            t0 = t
    return runs


def _check_plan(x, w, tile_expert, block_m):
    m_pad = x.shape[0]
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"group_gemm: x {tuple(x.shape)} must be [M, K] and "
                         f"w {tuple(w.shape)} [E, K, N]")
    if m_pad % block_m or tuple(tile_expert.shape) != (m_pad // block_m,):
        raise ValueError(f"group_gemm: tile_expert {tuple(tile_expert.shape)}"
                         f" does not tile {m_pad} rows by block_m {block_m}")


def group_gemm_ref(x_sorted, w_stack, tile_expert, *, block_m: int,
                   trans_w: bool = False):
    """Plain grouped GEMM: row tile i is ``x_tile @ w[tile_expert[i]]``
    (``@ w[e]^T`` with ``trans_w``).  Float inputs multiply in f32 and
    cast to x's dtype; int8 inputs multiply in float64 and cast to int32
    (exact)."""
    quantized = x_sorted.dtype == torch.int8
    out_cols = w_stack.shape[1] if trans_w else w_stack.shape[2]
    _check_plan(x_sorted, w_stack, tile_expert, block_m)
    out_dtype = torch.int32 if quantized else x_sorted.dtype
    calc = torch.float64 if quantized else torch.float32
    y = torch.empty((x_sorted.shape[0], out_cols), dtype=out_dtype,
                    device=x_sorted.device)
    for e, t0, t1 in _expert_runs(tile_expert):
        slab = w_stack[e].t() if trans_w else w_stack[e]
        rows = slice(t0 * block_m, t1 * block_m)
        y[rows] = (x_sorted[rows].to(calc) @ slab.to(calc)).to(out_dtype)
    return y


def _launch(name, x, w, tile_expert, block_m, out_cols, out_dtype, *,
            b_nk=False):
    """One launch of a mode of ``csrc/group_gemm.cu``; checks what the
    kernel takes and raises on anything else."""
    if w.device != x.device or tile_expert.device != x.device:
        raise ValueError(f"{name}: w on {w.device}, tile_expert on "
                         f"{tile_expert.device}, x on {x.device}")
    int8 = name == "group_gemm_i8"
    want = torch.int8 if int8 else torch.bfloat16
    if x.dtype != want or w.dtype != want:
        raise TypeError(f"{name} kernel takes {want} operands, got {x.dtype} "
                        f"and {w.dtype}")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"{name}: tile_expert must be int32, got "
                        f"{tile_expert.dtype}")
    tm = I8_TILE_M if int8 else TILE_M
    m_pad, k = x.shape
    if block_m % tm or out_cols % TILE_N or k % TILE_K:
        raise ValueError(f"{name} kernel: block_m={block_m} must be a "
                         f"multiple of {tm}, N={out_cols} of {TILE_N} and "
                         f"K={k} of {TILE_K}")
    check_operands(name, x, w)
    te = tile_expert.contiguous()
    y = torch.empty((m_pad, out_cols), dtype=out_dtype, device=x.device)
    if m_pad == 0:
        return y
    lib = _build.load("group_gemm", _SIG)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if int8:
            err = lib.tdt_group_gemm_i8(x.data_ptr(), w.data_ptr(),
                                        te.data_ptr(), y.data_ptr(), m_pad,
                                        out_cols, k, block_m, stream)
        else:
            err = lib.tdt_group_gemm_bf16(x.data_ptr(), w.data_ptr(),
                                          te.data_ptr(), y.data_ptr(), m_pad,
                                          out_cols, k, block_m, int(b_nk),
                                          stream)
    _build.check(err, name)
    return y


def _run(name, x, w, tile_expert, block_m, *, trans_w, plain):
    """(y, launched): the plain version for CPU tensors or ``plain``, the
    kernel for CUDA tensors, a raise for anything else."""
    out_cols = w.shape[1] if trans_w else w.shape[2]
    _check_plan(x, w, tile_expert, block_m)
    if x.shape[1] != (w.shape[2] if trans_w else w.shape[1]):
        raise ValueError(f"{name}: x {tuple(x.shape)} against w "
                         f"{tuple(w.shape)}{' transposed' if trans_w else ''}")
    if plain or x.device.type == "cpu":
        return group_gemm_ref(x, w, tile_expert, block_m=block_m,
                              trans_w=trans_w), False
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    out_dtype = torch.int32 if x.dtype == torch.int8 else x.dtype
    return _launch(name, x, w, tile_expert, block_m, out_cols, out_dtype,
                   b_nk=trans_w), True


def _group_gemm_fwd(x, w, tile_expert, block_m, plain):
    y, launched = _run("group_gemm", x, w, tile_expert, block_m,
                       trans_w=False, plain=plain)
    group_gemm.launches += launched
    return y


def group_gemm_dx(dy, w_stack, tile_expert, *, block_m: int,
                  plain: bool = False):
    """dx [M_pad, K] = row tile i of dy [M_pad, N] @ w[tile_expert[i]]^T:
    the backward's grouped GEMM, the kernel's transposed mode (w stays
    [E, K, N]; no transposed copy is made)."""
    y, launched = _run("group_gemm_dx", dy, w_stack, tile_expert, block_m,
                       trans_w=True, plain=plain)
    group_gemm_dx.launches += launched
    return y


def group_gemm_i8(x_q, w_q, tile_expert, *, block_m: int,
                  plain: bool = False):
    """int8 grouped GEMM: y [M_pad, N] int32, exact (the W8A8 expert
    compute; the caller dequantizes)."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"group_gemm_i8 takes int8 operands, got {x_q.dtype} "
                        f"and {w_q.dtype}")
    y, launched = _run("group_gemm_i8", x_q, w_q, tile_expert, block_m,
                       trans_w=False, plain=plain)
    group_gemm_i8.launches += launched
    return y


def _group_gemm_dw(x, dy, tile_expert, block_m, n_experts, w_dtype):
    """dW[e] = sum over e's row tiles of x_tile^T @ dy_tile, accumulated
    in f32 and cast to w's dtype once (padding rows of x are zero and add
    nothing; an expert with no tile gets zeros).  One expert's f32 [K, N]
    sum is live at a time."""
    rows_of = {}
    for e, t0, t1 in _expert_runs(tile_expert):
        rows_of.setdefault(e, []).append(slice(t0 * block_m, t1 * block_m))
    dw = torch.zeros((n_experts, x.shape[1], dy.shape[1]), dtype=w_dtype,
                     device=x.device)
    for e, slices in rows_of.items():
        total = None
        for rows in slices:
            xt, g = x[rows].t(), dy[rows]
            if x.is_cuda and x.dtype != torch.float32:
                part = torch.mm(xt, g, out_dtype=torch.float32)
            else:
                part = xt.float() @ g.float()
            total = part if total is None else total + part
        dw[e] = total.to(w_dtype)
    return dw


class GroupGemmFn(torch.autograd.Function):
    """Differentiable grouped GEMM, the counterpart of the reference's
    ``_group_gemm_core`` custom VJP: saves (x, w, tile_expert); dx is
    :func:`group_gemm_dx` on dy cast to x's dtype, dW the per-expert sum
    of :func:`_group_gemm_dw`."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, block_m, plain):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.block_m, ctx.plain = block_m, plain
        return _group_gemm_fwd(x, w, tile_expert, block_m, plain)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = group_gemm_dx(dy.to(x.dtype), w, tile_expert,
                               block_m=ctx.block_m, plain=ctx.plain)
        if ctx.needs_input_grad[1]:
            dw = _group_gemm_dw(x, dy, tile_expert, ctx.block_m, w.shape[0],
                                w.dtype)
        return dx, dw, None, None, None


def group_gemm(x_sorted, w_stack, tile_expert, *, block_m: int,
               plain: bool = False):
    """y [M_pad, N] where row tile i is ``x_tile @ w[tile_expert[i]]``.
    ``block_m`` is the block size given to ``moe_utils.sort_align``.
    bf16 (f32 accumulation, bf16 out) or int8 (:func:`group_gemm_i8`,
    exact int32 out) on the card; any float dtype on the CPU.
    Differentiable through :class:`GroupGemmFn` when grad is enabled and
    x or w requires grad."""
    if x_sorted.dtype == torch.int8:
        return group_gemm_i8(x_sorted, w_stack, tile_expert, block_m=block_m,
                             plain=plain)
    if torch.is_grad_enabled() and (x_sorted.requires_grad
                                    or w_stack.requires_grad):
        return GroupGemmFn.apply(x_sorted, w_stack, tile_expert, block_m,
                                 plain)
    return _group_gemm_fwd(x_sorted, w_stack, tile_expert, block_m, plain)


group_gemm.launches = 0
group_gemm_dx.launches = 0
group_gemm_i8.launches = 0


def moe_ffn_sorted(x_sorted, w_gate, w_up, w_down, tile_expert, *,
                   block_m: int, plain: bool = False):
    """SwiGLU expert FFN over the sorted buffer, three grouped GEMMs:
    ``(silu(x @ Wg[e]) * (x @ Wu[e])) @ Wd[e]`` per row tile, the
    activation in f32 cast to x's dtype."""
    gate = group_gemm(x_sorted, w_gate, tile_expert, block_m=block_m,
                      plain=plain)
    up = group_gemm(x_sorted, w_up, tile_expert, block_m=block_m,
                    plain=plain)
    hidden = (torch.nn.functional.silu(gate.float())
              * up.float()).to(x_sorted.dtype)
    return group_gemm(hidden, w_down, tile_expert, block_m=block_m,
                      plain=plain)
