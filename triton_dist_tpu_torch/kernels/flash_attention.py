"""Flash attention: blockwise causal GQA forward and its gradient.

Counterpart of ``triton_dist_tpu/kernels/flash_attention.py``.
:func:`flash_attention` takes the reference's arguments (causal,
``q_offset``/``kv_offset`` as ints or 0-d tensors, ``window``,
``soft_cap``, ``return_lse``) and returns out ``[B, Hq, Sq, D]`` in q's
dtype plus lse ``[B, Hq, Sq]`` f32.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/flash_fwd.cu`` (``flash_fwd_wg_kernel``, the port of the TPU
``_flash_kernel`` on wgmma, TMA and warp specialisation; its source note
says what bounds it and how it is built) or raises on what that kernel
does not take (:func:`flash_operand_ok`: TMA reads the operands). On a CPU
tensor it runs :func:`flash_attention_ref`, the plain PyTorch version (the
counterpart of ``_flash_xla``), which the CPU tests and ``chip_smoke.py``
also call directly.

int8 K/V (``k_scale``/``v_scale`` [B, Hkv, Sk] f32, the serving int8
cache) dequantize inside attention as the reference's ``_flash_xla`` does;
on a CUDA tensor that is the same kernel's int8 instantiation
(``flash_fwd_wg_kernel<SEGM, true>`` through :func:`flash_fwd_i8`, the
port of ``_flash_kernel_i8``, with its own launch count; q by TMA as
above, the int8 rows by 1-D bulk copies).  The quantized path is
forward-only, as in the reference.

Sequence parallelism: :func:`sp_flash_partials` runs flash over each
rank's span of a rank-stacked cache at its global ``kv_offset``, and
:func:`sp_flash_attention_shard` merges the partials through the SP
combine (the reference's ``sp_flash_attention_shard``).

Segmented layouts (the zigzag context-parallel shard): ``q_offset`` and
``kv_offset`` may each be a tuple of run starts, as in the reference
(``_as_starts`` :440): the rows are ``len(tuple)`` equal runs, each
position-contiguous.  The port also takes a sequence of such tuples, one
per batch row, so that the ranks of one ring step fold into the batch
and share one launch.  On the card the runs ride per-block start vectors
(``_block_starts``, blocks of :data:`SEG` rows); each run must tile by
:data:`SEG`.

Under autograd (grad enabled, an input that requires grad, no
``return_lse``) the call goes through :class:`FlashAttentionFn`, the
counterpart of the reference's ``jax.custom_vjp`` ``_flash_diff``: it saves
(q, k, v, out, lse) and its backward is :func:`flash_attention_bwd` — on
CUDA tensors the two kernels of ``csrc/flash_bwd.cu`` (the ports of
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``, wrapped by
:func:`flash_bwd_dq` and :func:`flash_bwd_dkv`), on CPU tensors
:func:`flash_attention_bwd_ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from triton_dist_tpu_torch.kernels import _build

NEG_INF = -1.0e30  # finite -inf proxy: survives exp/log without NaNs

SEG = 64   # positions per entry of a start vector (csrc/flash_fwd.cu SEG)

_STARTS = [ctypes.c_void_p, ctypes.c_longlong] * 2
_FLASH_TAIL = ([ctypes.c_int] * 4 + [ctypes.c_float] * 2
               + [ctypes.c_void_p])
_FLASH_SIG = {"tdt_flash_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 9 + _STARTS + _FLASH_TAIL,
              "tdt_flash_fwd_i8": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
              + [ctypes.c_longlong] * 15 + _STARTS + _FLASH_TAIL}
_BWD_TAIL = ([ctypes.c_int] * 5 + [ctypes.c_longlong] * 12 + _STARTS
             + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_FLASH_BWD_SIG = {"tdt_flash_bwd_dq": [ctypes.c_void_p] * 7 + _BWD_TAIL,
                  "tdt_flash_bwd_dkv": [ctypes.c_void_p] * 8 + _BWD_TAIL}


def _as_int(x) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _as_starts(starts_or_offset) -> tuple:
    """Normalize an offset-like argument to a tuple of run starts: a
    scalar offset (an int or a 0-d tensor) means ONE contiguous run."""
    if isinstance(starts_or_offset, (tuple, list)):
        return tuple(_as_int(s) for s in starts_or_offset)
    return (_as_int(starts_or_offset),)


def _row_starts(offset) -> tuple:
    """``offset`` as a tuple of per-batch-row run-start tuples: one entry
    shared by every row (a scalar or one tuple of run starts), or one per
    row (a sequence of tuples, the port's fold of ranks into the batch)."""
    if isinstance(offset, (tuple, list)) and offset and isinstance(
            offset[0], (tuple, list)):
        return tuple(_as_starts(r) for r in offset)
    return (_as_starts(offset),)


def _check_rows(rows, total, B, what):
    if len(rows) not in (1, B):
        raise ValueError(f"{what}: {len(rows)} per-row run starts for "
                         f"{B} batch rows")
    for r in rows:
        if total % len(r):
            raise ValueError(f"{what}: {total} rows do not split into "
                             f"{len(r)} equal runs")


def _run_positions(rows, total, device):
    """[R, total] global positions of ``total`` rows split evenly over the
    runs of each of the R per-row start tuples (reference
    ``_run_positions`` :563, a row dimension added)."""
    out = []
    for starts in rows:
        run = total // len(starts)
        out.append(torch.cat([s + torch.arange(run, device=device)
                              for s in starts]))
    return torch.stack(out)


def flash_shapes_ok(sq: int, sk: int, d: int, n_runs_q: int = 1,
                    n_runs_k: int = 1) -> bool:
    """The reference's legality rule for its flash tiles (:618): 128-lane
    D, Sq and Sk tiling by 128, and each run of a segmented layout tiling
    by 128 (blocks never straddle a run).  The ring attention's ``auto``
    choice and the context-parallel zigzag rule read it, as the
    reference's do.  The CUDA kernels take more: D 128, any Sq and Sk
    (ragged tiles masked), and each run of a segmented side tiling by
    :data:`SEG` (64), so a 128-row tile of the bf16 forward or of the
    backward may span two runs (its liveness and fullness take the least
    and largest position over them); the bf16 forward's operands must be
    TMA operands (:func:`flash_operand_ok`)."""
    return (d % 128 == 0 and sq % n_runs_q == 0 and sk % n_runs_k == 0
            and (sq // n_runs_q) % 128 == 0 and (sk // n_runs_k) % 128 == 0)


def apply_soft_cap(logits, soft_cap):
    """Gemma-2-style logit soft-capping ``cap * tanh(logits / cap)``;
    0/None is the identity."""
    if not soft_cap:
        return logits
    return soft_cap * torch.tanh(logits / soft_cap)


def _visibility_mask(Sq, Sk, *, causal, window, q_offset, kv_offset,
                     device):
    """THE masking rule (``_visibility_mask``): [R, Sq, Sk] bool (R = 1,
    or the batch rows of per-row offsets), key j visible to row i iff
    (not causal or qpos >= kpos) and (not window or qpos - kpos <
    window); None when neither is set.  Offsets as :func:`_row_starts`
    takes them."""
    if not (causal or window):
        return None
    rows = _run_positions(_row_starts(q_offset), Sq, device)[:, :, None]
    cols = _run_positions(_row_starts(kv_offset), Sk, device)[:, None, :]
    mask = (rows >= cols) if causal else torch.ones(
        (1, Sq, Sk), dtype=torch.bool, device=device)
    if window:
        mask = mask & (rows - cols < window)
    return mask


def flash_attention_ref(q, k, v, *, causal=True, scale=None, q_offset=0,
                        kv_offset=0, k_scale=None, v_scale=None,
                        soft_cap=0.0, window=0):
    """Plain PyTorch version (dense, f32 math): out [B, Hq, Sq, D] in
    q.dtype, lse [B, Hq, Sq] f32 — the ``_flash_xla`` contract, int8 K/V
    with ``k_scale``/``v_scale`` [B, Hkv, Sk] included; offsets may be
    run-start tuples, shared or per batch row (module docstring)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    _check_rows(_row_starts(q_offset), Sq, B, "q_offset")
    _check_rows(_row_starts(kv_offset), Sk, B, "kv_offset")
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    logits = torch.einsum("bhgsd,bhtd->bhgst", qf, k.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, None, :]
    logits = apply_soft_cap(logits, soft_cap)
    mask = _visibility_mask(Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset, kv_offset=kv_offset,
                            device=q.device)
    if mask is not None:
        mask = mask[:, None, None]
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    nonempty = m > NEG_INF / 2
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :]
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    l_safe = torch.where(nonempty, l, torch.ones_like(l))
    out = torch.where(nonempty[..., None], out / l_safe[..., None],
                      torch.zeros_like(out))
    lse = torch.where(nonempty, m + torch.log(l_safe),
                      torch.full_like(m, NEG_INF))
    return (out.reshape(B, Hq, Sq, D).to(q.dtype), lse.reshape(B, Hq, Sq))


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=True,
                            scale=None, q_offset=0, kv_offset=0,
                            soft_cap=0.0, window=0, grad_dtype=None):
    """Plain PyTorch gradient (dense, f32 math) with the arguments of the
    reference's ``_flash_bwd_pallas``: P recomputed from the saved lse,
    dS = P * (dP - delta) * scale (times the soft-cap's 1 - tanh^2),
    delta = rowsum(dO * O).  Returns (dq, dk, dv) in the primal dtypes, or
    all in ``grad_dtype`` when set.  Masked lanes are zeroed before use,
    so rows with nothing visible (lse = NEG_INF) give zero gradients.
    Offsets as :func:`flash_attention_ref` takes them."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    _check_rows(_row_starts(q_offset), Sq, B, "q_offset")
    _check_rows(_row_starts(kv_offset), Sk, B, "kv_offset")
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Hkv, g, Sq, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qf, kf) * scale
    dcap = None
    if soft_cap:
        t = torch.tanh(s / soft_cap)
        s = soft_cap * t
        dcap = 1.0 - t * t
    p = torch.exp(s - lse.float().reshape(B, Hkv, g, Sq)[..., None])
    mask = _visibility_mask(Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset, kv_offset=kv_offset,
                            device=q.device)
    if mask is not None:
        p = torch.where(mask[:, None, None], p, torch.zeros_like(p))
    delta = (do.float() * out.float()).sum(-1).reshape(B, Hkv, g, Sq)
    dp = torch.einsum("bhgsd,bhtd->bhgst", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bhgst,bhtd->bhgsd", ds, kf).reshape(B, Hq, Sq, D)
    dk = torch.einsum("bhgst,bhgsd->bhtd", ds, qf)
    dv = torch.einsum("bhgst,bhgsd->bhtd", p, dof)
    return (dq.to(grad_dtype or q.dtype), dk.to(grad_dtype or k.dtype),
            dv.to(grad_dtype or v.dtype))


def _check_cuda_operand(name, x, dtype):
    if x.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{x.dtype}")
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            s * x.element_size() % 16 for s in x.stride()[:-1]):
        raise ValueError(f"{name}: the CUDA kernel needs a unit last "
                         f"stride, 16-byte aligned rows (strides "
                         f"{tuple(x.stride())})")


def _check_scale(name, s, shape, device):
    """An int8 cache's f32 scale plane: one scale per cached position."""
    if s is None:
        raise ValueError(f"int8 K/V needs both k_scale and v_scale "
                         f"({name} is missing)")
    if s.dtype != torch.float32 or tuple(s.shape) != tuple(shape):
        raise ValueError(f"{name}: f32 {tuple(shape)} expected, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if s.device != device:
        raise ValueError(f"{name} is on {s.device}, q on {device}")


_BLOCK_STARTS: dict = {}


def _starts_arg(offset, total, B, device, what):
    """(vector, batch stride, scalar offset) of one side for the kernels:
    a single contiguous run shared by every row is the scalar (no vector,
    the path a CUDA graph can capture); anything else the per-block start
    vector [R, total / SEG] int32 of every row (reference
    ``_block_starts`` :448 at the kernels' SEG), made once per layout and
    kept on the device, with batch stride 0 when one vector serves every
    row."""
    rows = _row_starts(offset)
    _check_rows(rows, total, B, what)
    if len(rows) == 1 and len(rows[0]) == 1:
        return None, 0, rows[0][0]
    for r in rows:
        if (total // len(r)) % SEG:
            raise ValueError(f"{what}: the kernels' segmented mode needs "
                             f"each run to tile by {SEG} rows, got runs of "
                             f"{total // len(r)}")
    key = (rows, total, str(device))
    vec = _BLOCK_STARTS.get(key)
    if vec is None:
        if len(_BLOCK_STARTS) > 1024:
            _BLOCK_STARTS.clear()
        host = _run_positions(rows, total, "cpu")[:, ::SEG]
        vec = _BLOCK_STARTS[key] = host.to(device=device,
                                           dtype=torch.int32).contiguous()
    return vec, (vec.shape[1] if vec.shape[0] > 1 else 0), 0


def _segmented(starts) -> int:
    """1 when a launch carries a start vector (its segmented mode)."""
    return int(starts[0] is not None or starts[2] is not None)


def _starts_args(q, k, q_offset, kv_offset):
    """The kernels' (qoffs, qoffs_sb, koffs, koffs_sb) pointers and
    strides and their scalar (q_offset, kv_offset)."""
    B, Sq, Sk = q.shape[0], q.shape[2], k.shape[2]
    qv, qsb, qo = _starts_arg(q_offset, Sq, B, q.device, "q_offset")
    kv, ksb, ko = _starts_arg(kv_offset, Sk, B, q.device, "kv_offset")
    ptr = lambda t: None if t is None else t.data_ptr()
    return (ptr(qv), qsb, ptr(kv), ksb), (qo, ko)


_TMA_STRIDE_LIMIT = 1 << 40   # bytes: TMA's bound on a global stride


def flash_operand_ok(shape, strides, dtype, offset=0) -> bool:
    """Whether the bf16 forward kernel reads an operand [B, H, S, D] of
    ``shape`` and element ``strides`` (``offset``: its storage offset in
    elements, on a 16-byte aligned allocation) by TMA: bf16, D 128, unit
    d stride, a 16-byte aligned base, and the stride of every dim of more
    than one row a nonzero multiple of 16 bytes below 2**40 (a dim of one
    row is never stepped; the wrapper hands the kernel a valid stride for
    it).  A pure function of the layout: the CPU tests hold every model
    path's operands to it."""
    if dtype != torch.bfloat16 or len(shape) != 4 or shape[-1] != 128:
        return False
    size = torch.finfo(dtype).bits // 8
    if strides[-1] != 1 or (offset * size) % 16:
        return False
    return all(n == 1 or (0 < st * size < _TMA_STRIDE_LIMIT
                          and st * size % 16 == 0)
               for n, st in zip(shape[:-1], strides[:-1]))


def _tma_strides(x):
    """(b, h, s) element strides of a [B, H, S, D] operand for the bf16
    kernel's tensor maps: a dim of one row (never stepped) gets the
    tensor's extent, a valid stride whatever its own."""
    extent = 8 * -(-max(n * st for n, st in zip(x.shape, x.stride())) // 8)
    return tuple(st if n > 1 else extent
                 for n, st in zip(x.shape[:3], x.stride()[:3]))


def _flash_fwd_operands(q, k, v, kv_dtype):
    """Check what the forward kernel takes (D 128, G dividing 64, bf16 q,
    k/v in ``kv_dtype``; q and bf16 k / v: :func:`flash_operand_ok`, int8
    k / v: 16-byte aligned rows); returns the outputs."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if D != 128:
        raise ValueError(f"flash_fwd kernel: head_dim must be 128, got {D}")
    g = Hq // Hkv
    if 64 % g:
        raise ValueError(f"flash_fwd kernel: the group size Hq/Hkv={g} must "
                         f"divide 64 (a q tile folds the group)")
    for name, x, dt in (("q", q, torch.bfloat16), ("k", k, kv_dtype),
                        ("v", v, kv_dtype)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        # TMA reads q and bf16 k / v; int8 rows come by 1-D bulk copies
        if dt == torch.int8 or x.dtype != dt:
            _check_cuda_operand(name, x, dt)
        elif x.data_ptr() % 16 or not flash_operand_ok(
                x.shape, x.stride(), x.dtype, x.storage_offset()):
            raise ValueError(
                f"flash_fwd kernel: {name} {tuple(x.shape)} with strides "
                f"{tuple(x.stride())} (offset {x.storage_offset()}) is not "
                f"a TMA operand: unit last stride, 16-byte aligned base, "
                f"every stride of a dim of more than one row a nonzero "
                f"multiple of 16 bytes")
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    return out, lse


def _flash_fwd_cuda(q, k, v, *, causal, scale, q_offset, kv_offset,
                    soft_cap, window):
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out, lse = _flash_fwd_operands(q, k, v, torch.bfloat16)
    starts, offs = _starts_args(q, k, q_offset, kv_offset)
    lib = _build.load("flash_fwd", _FLASH_SIG)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Sq, Sk, *_tma_strides(q),
            *_tma_strides(k), *_tma_strides(v), *starts, *offs,
            int(bool(causal)), int(window), float(scale),
            float(soft_cap or 0.0), stream)
    _build.check(err, "flash_fwd")
    flash_attention.launches += 1
    flash_attention.segmented_launches += _segmented(starts)
    return out, lse


def flash_fwd_i8(q, k, v, k_scale, v_scale, *, causal, scale, q_offset,
                 kv_offset, soft_cap, window):
    """The int8 instantiation of the forward kernel on CUDA tensors (the
    port of ``_flash_kernel_i8``): q bf16 [B, Hq, Sq, D], a TMA operand
    (:func:`flash_operand_ok`); k/v int8 [B, Hkv, Sk, D] with 16-byte
    aligned rows and f32 ``k_scale``/``v_scale`` [B, Hkv, Sk] (any
    strides).  Returns (out bf16, lse f32)."""
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out, lse = _flash_fwd_operands(q, k, v, torch.int8)
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check_scale(name, sc, k.shape[:3], q.device)
    starts, offs = _starts_args(q, k, q_offset, kv_offset)
    lib = _build.load("flash_fwd", _FLASH_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_flash_fwd_i8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
            v_scale.data_ptr(), out.data_ptr(), lse.data_ptr(), B, Hq, Hkv,
            Sq, Sk, *_tma_strides(q), *k.stride()[:3], *v.stride()[:3],
            *k_scale.stride(), *v_scale.stride(), *starts, *offs,
            int(bool(causal)), int(window), float(scale),
            float(soft_cap or 0.0), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd_i8")
    flash_fwd_i8.launches += 1
    return out, lse


flash_fwd_i8.launches = 0


def _bwd_operands(q, k, v, do):
    """Check what the backward kernels take: D 128, bf16, G = Hq / Hkv
    dividing 32 (the dkv kernel's 32-row q tile holds the whole group),
    unit last strides.  Returns dO made contiguous if autograd handed over
    a layout the kernels cannot read by stride."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if D != 128:
        raise ValueError(f"flash_bwd kernels: head_dim must be 128, got {D}")
    if 32 % (Hq // Hkv):
        raise ValueError(f"flash_bwd kernels: the group size Hq/Hkv="
                         f"{Hq // Hkv} must divide 32")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, x, torch.bfloat16)
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if do.shape != q.shape:
        raise ValueError(f"dout {tuple(do.shape)} != q {tuple(q.shape)}")
    if do.dtype != torch.bfloat16:
        raise TypeError(f"dout: the CUDA kernels take bf16, got {do.dtype}")
    if do.stride(-1) != 1 or any(st % 8 for st in do.stride()[:-1]) \
            or do.data_ptr() % 16:
        do = do.contiguous()
    return do


def _bwd_args(q, k, v, do, lse, delta, *, causal, scale, q_offset,
              kv_offset, soft_cap, window, out_f32):
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    starts, offs = _starts_args(q, k, q_offset, kv_offset)
    tail = (B, Hq, Hkv, Sq, Sk, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], *starts, *offs,
            int(bool(causal)), int(window), int(out_f32),
            float(scale), float(soft_cap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail, _segmented(starts)


def flash_bwd_dq(q, k, v, do, lse, delta, *, out_dtype, **kw):
    """The dq kernel (``_flash_bwd_dq_kernel``) on CUDA tensors checked by
    :func:`_flash_bwd_cuda`: dq [B, Hq, Sq, D] in ``out_dtype``."""
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    head, tail, seg = _bwd_args(q, k, v, do, lse, delta,
                                out_f32=out_dtype == torch.float32, **kw)
    lib = _build.load("flash_bwd", _FLASH_BWD_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_flash_bwd_dq(*head, dq.data_ptr(), *tail)
    _build.check(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    flash_bwd_dq.segmented_launches += seg
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.segmented_launches = 0   # of them, with a start vector


def flash_bwd_dkv(q, k, v, do, lse, delta, *, out_dtype, **kw):
    """The dkv kernel (``_flash_bwd_dkv_kernel``) on CUDA tensors checked
    by :func:`_flash_bwd_cuda`: (dk, dv) [B, Hkv, Sk, D] in
    ``out_dtype``."""
    dk = torch.empty(k.shape, dtype=out_dtype, device=k.device)
    dv = torch.empty(k.shape, dtype=out_dtype, device=k.device)
    head, tail, seg = _bwd_args(q, k, v, do, lse, delta,
                                out_f32=out_dtype == torch.float32, **kw)
    lib = _build.load("flash_bwd", _FLASH_BWD_SIG)
    with torch.cuda.device(q.device):
        err = lib.tdt_flash_bwd_dkv(*head, dk.data_ptr(), dv.data_ptr(),
                                    *tail)
    _build.check(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.segmented_launches += seg
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.segmented_launches = 0


def _flash_bwd_cuda(q, k, v, out, lse, do, *, grad_dtype=None, delta=None,
                    **kw):
    """``_flash_bwd_pallas`` on the card: delta = rowsum(dO * O) in f32 by
    one torch op (the reference leaves it to XLA; a caller that runs
    several blocks against one (out, dO) passes it once), then the dq and
    dkv kernels.  Gradients come back contiguous, bf16 or ``grad_dtype``
    (f32 only)."""
    do = _bwd_operands(q, k, v, do)
    if grad_dtype not in (None, torch.bfloat16, torch.float32):
        raise TypeError(f"flash_bwd kernels write bf16 or f32, not "
                        f"{grad_dtype}")
    out_dtype = grad_dtype or torch.bfloat16
    lse = lse.float().contiguous()
    if delta is None:
        delta = bwd_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, out_dtype=out_dtype, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, out_dtype=out_dtype,
                           **kw)
    return dq, dk, dv


def bwd_delta(out, do):
    """rowsum(dO * O) [B, Hq, Sq] f32, contiguous: what both backward
    kernels read beside lse."""
    return (do.float() * out.float()).sum(-1).contiguous()


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, scale=None,
                        q_offset=0, kv_offset=0, soft_cap=0.0, window=0,
                        grad_dtype=None, delta=None):
    """(dq, dk, dv) of :func:`flash_attention` from its saved (q, k, v,
    out, lse) and the output cotangent ``do``: the two backward kernels
    on CUDA tensors (raising on what they do not take; ``delta`` is
    :func:`bwd_delta` of (out, do) when the caller has it), the plain
    :func:`flash_attention_bwd_ref` on CPU tensors.  Offsets as
    :func:`flash_attention` takes them."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset, soft_cap=soft_cap, window=window,
              grad_dtype=grad_dtype)
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, out, lse, do, delta=delta, **kw)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")


def _flash_fwd(q, k, v, **kw):
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, **kw)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``_flash_diff`` custom VJP: the forward saves (q, k, v, out, lse) as
    ``_flash_diff_fwd`` does, the backward is :func:`flash_attention_bwd`.
    ``kw`` holds the static arguments (causal, scale, offsets, soft_cap,
    window)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        out, lse = _flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, **ctx.kw)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=True, scale=None, q_offset=0,
                    kv_offset=0, return_lse=False, k_scale=None,
                    v_scale=None, soft_cap=0.0, window=0):
    """Blockwise GQA attention: q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D] →
    out [B, Hq, Sq, D] in q.dtype (+ lse [B, Hq, Sq] f32 when
    ``return_lse``).  The causal rule is ``q_offset + i >= kv_offset + j``;
    ``window`` keeps keys with ``qpos - kpos < window``.  Differentiable
    through :class:`FlashAttentionFn` when grad is enabled and an input
    requires grad (not with ``return_lse``, as in the reference).  int8
    k/v with ``k_scale``/``v_scale`` [B, Hkv, Sk] f32: forward only.
    ``q_offset``/``kv_offset``: ints, 0-d tensors, run-start tuples, or
    one such tuple per batch row (module docstring)."""
    q_offset, kv_offset = _row_starts(q_offset), _row_starts(kv_offset)
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a multiple of Hkv={Hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset, soft_cap=soft_cap, window=window)
    if k_scale is not None or v_scale is not None:
        if torch.is_grad_enabled() and q.requires_grad:
            raise NotImplementedError(
                "the int8 K/V path is forward-only (serving), as in the "
                "reference: no gradient through a quantized cache")
        if q.is_cuda:
            out, lse = flash_fwd_i8(q, k, v, k_scale, v_scale, **kw)
        elif q.device.type == "cpu":
            out, lse = flash_attention_ref(q, k, v, k_scale=k_scale,
                                           v_scale=v_scale, **kw)
        else:
            raise ValueError(f"flash_attention: unsupported device "
                             f"{q.device}")
        return (out, lse) if return_lse else out
    if (not return_lse and torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return FlashAttentionFn.apply(q, k, v, kw)
    out, lse = _flash_fwd(q, k, v, **kw)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
# the launches that carried a start vector (segmented mode), counted
# again here beside the total
flash_attention.segmented_launches = 0


def sp_flash_partials(q, k_shard, v_shard, *, causal=True, scale=None,
                      q_offset=0, k_scale=None, v_scale=None, soft_cap=0.0,
                      window=0):
    """Every rank's flash partial over its span: q [B, Hq, Sq, D] held
    once; k/v_shard [W, B, Hkv, S_loc, D] (rank r's positions
    ``[r * S_loc, (r + 1) * S_loc)`` at [r]; any strides the kernel reads,
    int8 with ``k_scale``/``v_scale`` [W, B, Hkv, S_loc]).  One flash call
    per rank at ``kv_offset = r * S_loc``; returns (out [W, B, Hq, Sq, D]
    in q's dtype, lse [W, B, Hq, Sq] f32), a rank with nothing visible
    giving out 0 and lse NEG_INF."""
    world, s_loc = k_shard.shape[0], k_shard.shape[3]
    outs, lses = [], []
    for r in range(world):
        out, lse = flash_attention(
            q, k_shard[r], v_shard[r], causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=r * s_loc, return_lse=True,
            k_scale=None if k_scale is None else k_scale[r],
            v_scale=None if v_scale is None else v_scale[r],
            soft_cap=soft_cap, window=window)
        outs.append(out)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def sp_flash_attention_shard(q, k_shard, v_shard, *, causal=True,
                             scale=None, q_offset=0, k_scale=None,
                             v_scale=None, soft_cap=0.0, window=0):
    """Sequence-parallel prefill attention (the reference's
    ``sp_flash_attention_shard``): :func:`sp_flash_partials`, then the
    partials merge where the reference's ``pmax`` and two ``psum`` over
    the ranks do, through the SP paths' one inter-rank combine
    (``flash_decode._combine_across_ranks``: the combine kernel on CUDA
    tensors, its plain version on CPU tensors).  A row visible on no rank
    merges to 0.  Returns [B, Hq, Sq, D] in q's dtype."""
    # flash_decode imports this module, so its combine is reached at call
    from triton_dist_tpu_torch.kernels.flash_decode import (
        _combine_across_ranks,
    )

    outs, lses = sp_flash_partials(
        q, k_shard, v_shard, causal=causal, scale=scale, q_offset=q_offset,
        k_scale=k_scale, v_scale=v_scale, soft_cap=soft_cap, window=window)
    return _combine_across_ranks(outs, lses, q.dtype)


def flash_gqa_attention(q, k, v, *, causal=True, scale=None, window=0,
                        soft_cap=0.0, plain=False):
    """The model families' ``[S, B, H, D]`` layout: q [S, B, Hq, D];
    k/v [S, B, Hkv, D]; returns [S, B, Hq, D] in q's dtype.  The
    transposes are views — the kernels read them by stride.  With a
    leading rank dimension (q [W, S, B, Hq_loc, D], each rank's heads) the
    ranks' heads are laid side by side, rank-major (the world-1 head
    order, so every q head keeps its kv head), and attended in one call.
    ``plain`` runs :func:`flash_attention_ref` on any device (a reference
    forward, differentiated by autograd op by op)."""
    if q.dim() == 5:
        world, s, b, hq, d = q.shape

        def heads(t):
            return t.permute(1, 2, 0, 3, 4).reshape(s, b, -1, d)

        o = flash_gqa_attention(heads(q), heads(k), heads(v), causal=causal,
                                scale=scale, window=window,
                                soft_cap=soft_cap, plain=plain)
        return o.reshape(s, b, world, hq, d).permute(2, 0, 1, 3, 4)
    qt = q.permute(1, 2, 0, 3)
    kt = k.permute(1, 2, 0, 3)
    vt = v.permute(1, 2, 0, 3)
    if plain:
        out, _ = flash_attention_ref(qt, kt, vt, causal=causal, scale=scale,
                                     window=window, soft_cap=soft_cap)
    else:
        out = flash_attention(qt, kt, vt, causal=causal, scale=scale,
                              window=window, soft_cap=soft_cap)
    return out.permute(2, 0, 1, 3)
