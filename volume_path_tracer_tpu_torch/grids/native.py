"""Loader for the C++ core of .nvdb file I/O (csrc/nvdb_core.cpp).

Port of volume_path_tracer_tpu/grids/native.py. The core scatters leaf
blocks into a dense array (reading) and gathers the nonzero 8^3 blocks out of
one (writing); grids/nvdb.py holds the same two functions in numpy, which are
the plain version and give the same arrays bit for bit. This is host code.

The library is built with g++ at first use, from the package's own source,
into volume_path_tracer_tpu_torch/_build/ (one library per source content),
and bound with ctypes. Which path runs is decided once and said:

  - no g++ on PATH: the numpy path, with one warning through utils.logging;
  - g++ present and the build or the load fails: an exception with the
    compiler's output. Nothing falls back quietly.

available() tells callers and tests which one runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils import logging as vlog

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "nvdb_core.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_decided = False
_numpy_only = False


def build(cxx: str) -> str:
    """Compile csrc/nvdb_core.cpp (once per source content) and return the
    library's path."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libnvdb_core-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _decided
    with _lock:
        if _decided:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            vlog.warn("no g++ on PATH: .nvdb leaves are scattered and gathered with numpy")
            _decided = True
            return None
        lib = ctypes.CDLL(build(cxx))
        i64, p = ctypes.c_int64, ctypes.c_void_p
        lib.vpt_fill_leaves.restype = i64
        lib.vpt_fill_leaves.argtypes = [p, i64, i64, p, i64, i64, i64, i64, i64, i64]
        lib.vpt_extract_leaves.restype = i64
        lib.vpt_extract_leaves.argtypes = [p, i64, i64, i64, i64, i64, i64, p, p, i64]
        _lib, _decided = lib, True
        return _lib


@contextlib.contextmanager
def numpy_only():
    """Within the block fill_leaves and extract_leaves report the core
    absent, so grids/nvdb.py takes its numpy path: for holding the two
    against each other."""
    global _numpy_only
    before, _numpy_only = _numpy_only, True
    try:
        yield
    finally:
        _numpy_only = before


def available() -> bool:
    """True when the C++ core runs (g++ found, library built and loaded)."""
    return _load() is not None


def fill_leaves(leaf_bytes: np.ndarray, leaf_stride: int, dense: np.ndarray, lo) -> bool:
    """Scatter leaves (raw [n_leaf, stride] u8) into `dense`, whose voxel
    [0, 0, 0] lies at index coords `lo`; False where the core is absent."""
    lib = None if _numpy_only else _load()
    if lib is None:
        return False
    if dense.dtype != np.float32 or not dense.flags.c_contiguous or not leaf_bytes.flags.c_contiguous:
        raise ValueError("fill_leaves: dense must be C-contiguous float32, leaf_bytes C-contiguous")
    lib.vpt_fill_leaves(
        leaf_bytes.ctypes.data, leaf_stride, leaf_bytes.shape[0],
        dense.ctypes.data, *dense.shape, int(lo[0]), int(lo[1]), int(lo[2]),
    )
    return True


def extract_leaves(dense: np.ndarray, lo):
    """Nonzero 8^3 blocks of dense -> (origins [M, 3] i32, values
    [M, 8, 8, 8] f32) in x-major block order, or None where the core is
    absent."""
    lib = None if _numpy_only else _load()
    if lib is None:
        return None
    dense = np.ascontiguousarray(dense, np.float32)
    X, Y, Z = dense.shape
    max_blocks = ((X + 15) // 8) * ((Y + 15) // 8) * ((Z + 15) // 8)
    origins = np.empty((max_blocks, 3), np.int32)
    values = np.empty((max_blocks, 512), np.float32)
    count = lib.vpt_extract_leaves(
        dense.ctypes.data, X, Y, Z, int(lo[0]), int(lo[1]), int(lo[2]),
        origins.ctypes.data, values.ctypes.data, max_blocks,
    )
    if count < 0:
        raise RuntimeError("vpt_extract_leaves: more blocks than the block cover of the array")
    return origins[:count], values[:count].reshape(count, 8, 8, 8)
