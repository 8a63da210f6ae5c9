"""int8 quantization and the exact int8 GEMM behind the W8A8 projections.

Counterpart of ``triton_dist_tpu/kernels/quant.py``:

- :func:`symmetric_quantize` — the one symmetric absmax recipe behind every
  int8 surface (W8A8 rows and channels, the int8 KV cache), copied:
  ``scale = absmax / 127`` (1 where absmax is 0), ``q = clip(round(x /
  scale), -127, 127)`` in f32, rounding half to even;
- :func:`quantize_rowwise` (dynamic, per activation row) and
  :func:`quantize_channelwise` (static, per weight output channel);
- :func:`matmul_i8` — ``C[m, n] int32 = A[m, k] int8 @ B[k, n] int8``,
  exact.  On a CUDA tensor it launches one of the two hand-written Hopper
  kernels of ``csrc/matmul_i8.cu`` (the port of the TPU
  ``_matmul_i8_kernel``), as :func:`matmul_i8_kernel_for` says: the
  persistent wgmma / TMA kernel above a measured row count, the split-K
  tile loop at decode width; it raises on what they do not take
  (:func:`gemm_operand_ok`: TMA reads the operands).  On a CPU tensor it
  runs :func:`matmul_i8_ref`;
- :func:`w8a8_linear` — per-row activation quant, the int8 GEMM, and the
  reference's rank-1 f32 dequant in its order
  (``acc * x_scale[:, None] * w_scale[None, :]``), so f32 results are
  bit-identical to the reference's.

The reference's TPU block config (``Int8MatmulConfig``) has no counterpart:
the kernel's tile is its own.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

_MATMUL_I8_SIG = {"tdt_matmul_i8": [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p],
                  "tdt_matmul_i8_wg": [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
TILE_M, TILE_N, TILE_K = 64, 128, 64   # the split-K kernel's BM, BN, BK
SPLIT_TARGET = 2   # split-K: about this many blocks per SM at least
# The crossover, measured over m 8 .. 2,048 at Llama-3-8B's gate/up and
# down widths (PERF.md row 8): the split-K tile loop up to SPLIT_K_MAX_M
# rows, and wherever the wgmma kernel's 256 x 128 tiles would be fewer than
# WG_MIN_TILES (one block an SM: half the card idle, each tile's k loop
# on one SM).
SPLIT_K_MAX_M = 32
WG_MIN_TILES = 64
WG_TILE_M, WG_TILE_N = 256, 128
_TMA_STRIDE_LIMIT = 1 << 40   # bytes: TMA's bound on a global stride


def symmetric_quantize(x, axis: int):
    """Symmetric absmax int8 quant along ``axis``: x ≈ q * expand(scale).
    Returns (q int8, scale f32 with ``axis`` reduced)."""
    xf = x.float()
    absmax = xf.abs().amax(dim=axis)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def quantize_rowwise(x):
    """Dynamic symmetric per-row int8: x [m, k] ≈ q * scale[:, None]."""
    return symmetric_quantize(x, 1)


def quantize_channelwise(w):
    """Static symmetric per-output-channel int8: w [k, n] ≈ q *
    scale[None, :]."""
    return symmetric_quantize(w, 0)


def matmul_i8_ref(a, b):
    """Plain int8 GEMM: the product in float64, cast to int32.  Exact: each
    partial sum is an integer below 127² k in magnitude, far inside the
    53-bit mantissa, and the int32 result holds for k < 133,000 (the
    kernel's own int32 accumulator has the same limit).  float64 because
    PyTorch has no int32 matrix product on CUDA, and on the CPU an int8
    product would wrap."""
    return (a.double() @ b.double()).to(torch.int32)


def _split_k(m_tiles, n_tiles, k_tiles, sms):
    """Splits of the k loop so that about SPLIT_TARGET blocks run per SM
    (decode-width rows give few output tiles); each split at least one
    k tile."""
    want = -(-SPLIT_TARGET * sms // max(m_tiles * n_tiles, 1))
    per = -(-k_tiles // max(1, min(want, k_tiles)))
    return -(-k_tiles // per), per


def matmul_i8_kernel_for(m: int, n: int, k: int) -> str:
    """Which kernel of ``csrc/matmul_i8.cu`` a CUDA call of (m, n, k)
    launches: "wg" (the persistent wgmma kernel) above SPLIT_K_MAX_M rows
    where it has at least WG_MIN_TILES tiles, else "split_k" (the tile
    loop that splits k across blocks)."""
    tiles = -(-m // WG_TILE_M) * -(-n // WG_TILE_N)
    return "wg" if m > SPLIT_K_MAX_M and tiles >= WG_MIN_TILES \
        else "split_k"


def gemm_operand_ok(shape, strides, dtype, offset=0) -> bool:
    """Whether the GEMM kernels on ``csrc/sm90_gemm.cuh`` (``matmul_i8``,
    the grouped GEMM) read an operand of ``shape`` and element
    ``strides`` (``offset``: its storage offset in elements, on a 16-byte
    aligned allocation) by TMA: bf16 or int8, dense row-major (their
    entries take no strides), a 16-byte aligned base and rows a nonzero
    multiple of 16 bytes below 2**40.  A pure function of the layout: the
    CPU tests hold every model path's operands to it."""
    if dtype not in (torch.bfloat16, torch.int8) or not shape:
        return False
    size = 2 if dtype == torch.bfloat16 else 1
    dense = 1
    for n, st in zip(reversed(shape), reversed(strides)):
        if n != 1 and st != dense:
            return False
        dense *= n
    row = shape[-1] * size
    return (offset * size) % 16 == 0 and 0 < row < _TMA_STRIDE_LIMIT \
        and row % 16 == 0


def check_operands(name, *tensors):
    """Raise unless every operand meets :func:`gemm_operand_ok` at its
    address."""
    for t in tensors:
        if not gemm_operand_ok(tuple(t.shape), t.stride(),
                               t.dtype) or t.data_ptr() % 16:
            raise ValueError(f"{name} kernel: an operand {tuple(t.shape)} "
                             f"of strides {t.stride()} at offset "
                             f"{t.storage_offset()} breaks TMA's rules "
                             f"(gemm_operand_ok)")


def matmul_i8(a, b):
    """``C[m, n] int32 = A[m, k] int8 @ B[k, n] int8``, exact.  CUDA
    operands launch the kernel :func:`matmul_i8_kernel_for` names (any m;
    k % 32 == 0 and n % 16 == 0; operands that meet
    :func:`gemm_operand_ok`) and count it in ``matmul_i8.launches`` and
    ``matmul_i8.mode_launches``; CPU operands run :func:`matmul_i8_ref`."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"matmul_i8 takes int8 operands, got {a.dtype} and "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_i8: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return matmul_i8_ref(a, b)
    if not a.is_cuda:
        raise ValueError(f"matmul_i8: unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    m, k = a.shape
    n = b.shape[1]
    if k % 32 or n % 16:
        raise ValueError(f"matmul_i8 kernel: k={k} must be a multiple of 32 "
                         f"and n={n} of 16")
    check_operands("matmul_i8", a, b)
    kind = matmul_i8_kernel_for(m, n, k)
    n_split = 1
    if kind == "split_k":
        n_split, k_per = _split_k(-(-m // TILE_M), -(-n // TILE_N),
                                  -(-k // TILE_K), _build.sm_count(a.device))
    # split-K partial sums meet by int32 atomics: exact in any order
    alloc = torch.zeros if n_split > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    lib = _build.load("matmul_i8", _MATMUL_I8_SIG)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "wg":
            err = lib.tdt_matmul_i8_wg(a.data_ptr(), b.data_ptr(),
                                       out.data_ptr(), m, n, k, stream)
        else:
            err = lib.tdt_matmul_i8(a.data_ptr(), b.data_ptr(),
                                    out.data_ptr(), m, n, k, k_per * TILE_K,
                                    stream)
    _build.check(err, "matmul_i8")
    matmul_i8.launches += 1
    matmul_i8.mode_launches[kind] += 1
    return out


matmul_i8.launches = 0
matmul_i8.mode_launches = {"wg": 0, "split_k": 0}


def w8a8_linear(x, w_q, w_scale, *, out_dtype=None, plain=False):
    """y = x @ dequant(w): per-row activation quant, the exact int8 GEMM,
    rank-1 f32 dequant.  x [m, k] bf16/f32; w_q [k, n] int8 with
    per-channel ``w_scale`` [n] (from :func:`quantize_channelwise`).
    ``plain`` takes :func:`matmul_i8_ref` on any device (a reference
    forward on the card)."""
    out_dtype = out_dtype or x.dtype
    x_q, x_scale = quantize_rowwise(x)
    acc = matmul_i8_ref(x_q, w_q) if plain else matmul_i8(x_q, w_q)
    y = acc.float() * x_scale[:, None] * w_scale[None, :]
    return y.to(out_dtype)
