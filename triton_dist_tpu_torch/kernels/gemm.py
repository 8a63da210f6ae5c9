"""Dense GEMM: C = A @ B with f32 accumulation, any (M, N, K).

Counterpart of ``triton_dist_tpu/kernels/gemm.py``'s ``matmul`` (:229)
over ``_matmul_kernel`` (:192).  The reference's model paths take XLA's
dot wherever it needs no collective, and so do the port's: no model path
calls this kernel.

- :func:`matmul_ref`: the plain version, f32 products cast to the output
  dtype.
- :func:`matmul`: on CUDA tensors it launches one kernel of
  ``csrc/gemm.cu`` (bf16 operands, bf16 or f32 output), the one
  :func:`matmul_kernel_for` names, and counts the launch, or raises on
  what the kernels do not take; on CPU tensors the plain version.
- :func:`matmul_kernel_for`: "wgmma" (``matmul_wg_kernel``, the persistent
  GEMM of ``csrc/sm90_gemm.cuh``: TMA, wgmma, 128 x 256 tiles in groups
  of 8 row tiles) wherever TMA takes the operands, else "tile" (the
  element-wise tile loop of ``csrc/bf16_tile.cuh``, 128 x 128 tiles,
  which takes any shape: TMA refuses rows whose byte length is not a
  multiple of 16 and bases off 16 bytes).

The reference's ``config`` (block sizes) has no counterpart: the kernels'
tiles are their own.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels import _build

_SIG = {"tdt_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
        + [ctypes.c_void_p]}


def _shapes(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: a {tuple(a.shape)} @ b {tuple(b.shape)} "
                         f"needs [M, K] @ [K, N]")


def matmul_kernel_for(m: int, n: int, k: int, aligned: bool) -> str:
    """Which kernel of ``csrc/gemm.cu`` a CUDA call of C [m, n] = A [m, k]
    @ B [k, n] launches: "wgmma" where TMA reads the operands in place (k
    % 8 == 0 and n % 8 == 0: rows of whole 16-byte vectors; ``aligned``:
    the three bases 16-byte aligned), else "tile"."""
    del m  # any m: TMA loads zeros past the last row
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and aligned else "tile"


def matmul_ref(a, b, out_dtype=None):
    """Plain C = A @ B: the product in f32, cast to ``out_dtype`` (a's
    dtype by default)."""
    _shapes(a, b)
    return (a.float() @ b.float()).to(out_dtype or a.dtype)


def matmul(a, b, out_dtype=None):
    """C [M, N] = A [M, K] @ B [K, N] with f32 accumulation, rounded once
    to ``out_dtype`` (a's dtype by default; the kernels write bf16 or
    f32)."""
    _shapes(a, b)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype)
    if not a.is_cuda:
        raise ValueError(f"matmul: unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError(f"matmul: b on {b.device}, a on {a.device}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"matmul kernel writes bf16 or f32, not {out_dtype}")
    a, b = a.contiguous(), b.contiguous()
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if c.numel() == 0 or k == 0:   # an empty sum: no launch
        return c.zero_()
    kind = matmul_kernel_for(m, n, k, all(t.data_ptr() % 16 == 0
                                          for t in (a, b, c)))
    lib = _build.load("gemm", _SIG)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.tdt_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n,
                             k, int(kind == "wgmma"),
                             int(out_dtype == torch.float32), stream)
    _build.check(err, "matmul")
    matmul.launches += 1
    matmul.mode_launches[kind] += 1
    return c


matmul.launches = 0
matmul.mode_launches = {"wgmma": 0, "tile": 0}
