"""int8 quantization and the exact int8 GEMM behind the W8A8 projections.

Counterpart of ``triton_dist_tpu/kernels/quant.py``:

- :func:`symmetric_quantize` — the one symmetric absmax recipe behind every
  int8 surface (W8A8 rows and channels, the int8 KV cache), copied:
  ``scale = absmax / 127`` (1 where absmax is 0), ``q = clip(round(x /
  scale), -127, 127)`` in f32, rounding half to even;
- :func:`quantize_rowwise` (dynamic, per activation row) and
  :func:`quantize_channelwise` (static, per weight output channel);
- :func:`matmul_i8` — ``C[m, n] int32 = A[m, k] int8 @ B[k, n] int8``,
  exact.  On a CUDA tensor it launches the hand-written Hopper kernel
  ``csrc/matmul_i8.cu`` (the port of the TPU ``_matmul_i8_kernel``) or
  raises on what it does not take; on a CPU tensor it runs
  :func:`matmul_i8_ref`;
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
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p]}
TILE_M, TILE_N, TILE_K = 64, 128, 64   # csrc/matmul_i8.cu BM, BN, BK
SPLIT_TARGET = 2   # split-K: about this many blocks per SM at least


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


def matmul_i8(a, b):
    """``C[m, n] int32 = A[m, k] int8 @ B[k, n] int8``, exact.  CUDA
    operands launch the kernel (any m; k % 32 == 0 and n % 16 == 0, so
    every row is whole 16-byte copies); CPU operands run
    :func:`matmul_i8_ref`."""
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
    a, b = a.contiguous(), b.contiguous()
    n_split, k_per = _split_k(-(-m // TILE_M), -(-n // TILE_N),
                              -(-k // TILE_K), _build.sm_count(a.device))
    # split-K partial sums meet by int32 atomics: exact in any order
    alloc = torch.zeros if n_split > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0:
        return out
    lib = _build.load("matmul_i8", _MATMUL_I8_SIG)
    with torch.cuda.device(a.device):
        err = lib.tdt_matmul_i8(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                m, n, k, k_per * TILE_K,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "matmul_i8")
    matmul_i8.launches += 1
    return out


matmul_i8.launches = 0


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
