"""ctypes bindings of the native host planning ops: the AG-GroupGEMM
feeder's host planner.

Counterpart of ``triton_dist_tpu/runtime/host_ops.py``
(``moe_ag_scatter_align_block_size`` :90, ``stable_rank_in_group_host``
:153).  The C source is the port's own copy,
``triton_dist_tpu_torch/csrc/host_ops/moe_utils.cc``; it is built with
``g++`` at first use into ``build/host_ops/`` at the repository root,
under a name that hashes the source and flags, and published with an
atomic rename, so concurrent processes (test workers) never load a
half-written library.

``impl`` is the reference's contract: "native" takes the C library and
raises when it cannot be built, "numpy" the numpy version of the same
semantics, "auto" the library when it builds and numpy otherwise; every
impl returns the same dict.  This is host code: no device kernel, and
nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "host_ops" / \
    "moe_utils.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_ops"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libtdt_hostops-{h.hexdigest()[:16]}.so"


def _build() -> Path | None:
    """The library's path, compiled first if needed (None when there is no
    ``g++`` or it fails)."""
    path = _lib_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, path)
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
    return path if path.exists() else None   # a peer may have won


def _load():
    """The loaded library, or None; built and bound once per process."""
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.tdt_moe_ag_scatter_align_block_size.restype = ctypes.c_int
        lib.tdt_moe_ag_scatter_align_block_size.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            i32p, i32p, i32p, i32p, i32p]
        lib.tdt_stable_rank_in_group.restype = ctypes.c_int
        lib.tdt_stable_rank_in_group.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _capacity(numel_per_rank: int, n_ranks: int, n_experts: int,
              block_m: int) -> int:
    per_rank = (numel_per_rank + n_experts * (block_m - 1)
                + block_m - 1) // block_m * block_m
    return per_rank * n_ranks


def _plan_numpy(flat, numel_per_rank, n_ranks, n_experts, block_m, out):
    """The numpy version of the C planner, filling ``out``'s arrays."""
    sorted_ids, tile_expert, tile_src_rank, rank_block_num = out
    base = 0
    for r in range(n_ranks):
        seg = flat[r * numel_per_rank:(r + 1) * numel_per_rank]
        if seg.size and (seg.min() < 0 or seg.max() >= n_experts):
            raise ValueError("expert id out of range")
        counts = np.bincount(seg, minlength=n_experts)
        padded = (counts + block_m - 1) // block_m * block_m
        starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
        order = np.argsort(seg, kind="stable")
        rank_in = np.arange(seg.size) - np.concatenate(
            [[0], np.cumsum(counts)[:-1]])[seg[order]]
        sorted_ids[base + starts[seg[order]] + rank_in] = \
            order + r * numel_per_rank
        for e in range(n_experts):
            t0 = (base + starts[e]) // block_m
            tile_expert[t0:t0 + padded[e] // block_m] = e
            tile_src_rank[t0:t0 + padded[e] // block_m] = r
        rank_block_num[r] = padded.sum() // block_m
        base += int(padded.sum())
    return base


def moe_ag_scatter_align_block_size(topk_ids, n_ranks: int, n_experts: int,
                                    block_m: int, pad_value: int = -1,
                                    impl: str = "auto"):
    """Host planner for the AG-GroupGEMM feeder (reference :90).

    ``topk_ids``: [n_ranks * numel_per_rank] (or [n_ranks, ...]) expert
    ids in gathered rank-major order.  Returns a dict with
    ``sorted_token_ids`` [capacity] (``pad_value`` in padding slots),
    ``tile_expert`` / ``tile_src_rank`` [capacity // block_m] (-1 past the
    last tile), ``rank_block_num`` [n_ranks] and ``total_padded`` int.
    An expert id out of range raises ValueError.
    """
    if impl not in ("auto", "native", "numpy"):
        raise ValueError(f"impl must be 'auto', 'native' or 'numpy', got "
                         f"{impl!r}")
    flat = _as_i32(topk_ids).reshape(-1)
    if n_ranks <= 0 or flat.size % n_ranks != 0:
        raise ValueError(
            f"topk_ids size {flat.size} not divisible by n_ranks {n_ranks}")
    numel_per_rank = flat.size // n_ranks
    cap = _capacity(numel_per_rank, n_ranks, n_experts, block_m)

    lib = _load() if impl in ("auto", "native") else None
    if impl == "native" and lib is None:
        raise RuntimeError("native host ops unavailable (no g++, or the "
                           "build failed)")

    sorted_ids = np.full(cap, pad_value, np.int32)
    tile_expert = np.full(cap // block_m, -1, np.int32)
    tile_src_rank = np.full(cap // block_m, -1, np.int32)
    rank_block_num = np.zeros(n_ranks, np.int32)
    if lib is not None:
        total = np.zeros(1, np.int32)
        rc = lib.tdt_moe_ag_scatter_align_block_size(
            _ptr(flat), numel_per_rank, n_ranks, n_experts, block_m,
            pad_value, cap, _ptr(sorted_ids), _ptr(tile_expert),
            _ptr(tile_src_rank), _ptr(rank_block_num), _ptr(total))
        if rc != 0:
            raise ValueError(f"moe_ag_scatter_align_block_size rc={rc}")
        total = int(total[0])
    else:
        total = _plan_numpy(flat, numel_per_rank, n_ranks, n_experts,
                            block_m, (sorted_ids, tile_expert, tile_src_rank,
                                      rank_block_num))
    return {"sorted_token_ids": sorted_ids, "tile_expert": tile_expert,
            "tile_src_rank": tile_src_rank, "rank_block_num": rank_block_num,
            "total_padded": total}


def stable_rank_in_group_host(keys, n_groups: int):
    """Host twin of ``moe_utils.stable_rank_in_group`` (reference :153):
    (rank [n] int32, counts [n_groups] int32), native when the library
    builds; a key out of range raises ValueError."""
    flat = _as_i32(keys).reshape(-1)
    lib = _load()
    if lib is not None:
        rank = np.empty(flat.size, np.int32)
        counts = np.zeros(n_groups, np.int32)
        if lib.tdt_stable_rank_in_group(_ptr(flat), flat.size, n_groups,
                                        _ptr(rank), _ptr(counts)) != 0:
            raise ValueError("key out of range")
        return rank, counts
    if flat.size and (flat.min() < 0 or flat.max() >= n_groups):
        raise ValueError("key out of range")
    counts = np.bincount(flat, minlength=n_groups)
    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.empty(flat.size, np.int32)
    rank[order] = np.arange(flat.size) - starts[flat[order]]
    return rank, counts.astype(np.int32)
