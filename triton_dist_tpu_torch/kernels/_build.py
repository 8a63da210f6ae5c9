"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers: seconds, not
minutes), cached under ``build/torch_kernels/`` at the repository root by a
hash of the sources and flags.  :func:`build` starts one ``nvcc`` per
missing library, all at once, and keeps each compiler's ``-Xptxas -v``
report (registers, shared memory, spills) for :func:`ptxas_report`.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("flash_fwd", "flash_bwd", "decode", "matmul_i8", "group_gemm",
           "all_to_all", "gemm", "ag_gemm", "gemm_rs", "sp_combine",
           "ring_attn", "barrier", "allgather", "reduce_scatter",
           "ag_group_gemm", "moe_rs", "torus")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ptxas: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH,
    or the toolkit's default location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels build at first use on a machine with the "
                       "CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Raises with the
    compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp, p)
        errors = []
        for n, (proc, tmp, p) in procs.items():
            out, _ = proc.communicate()
            _ptxas[n] = out
            if proc.returncode != 0:
                errors.append(f"nvcc {n}.cu failed ({proc.returncode}):\n"
                              f"{out}")
                continue
            os.replace(tmp, p)
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def ptxas_report() -> dict[str, str]:
    """``-Xptxas -v`` output of the libraries this process compiled."""
    return dict(_ptxas)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed) with the
    ``argtypes``/``restype`` of each C entry in ``signatures`` set:
    ``{"fn": [ctypes types...]}``, every entry returning ``int`` (the
    launch's ``cudaGetLastError()``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build((name,))[name]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (grid sizing)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
