"""ctypes bindings for the native fast-ingest library (a copy of spmf_tpu's
data/native.py over the port's own ``data/_native/fast_io.cpp``).

Compiled with g++ on first use into the git-ignored
``spmf_tpu_torch/_build/`` (never next to the source); the library's name
carries a hash of the source and flags, so an edited source is rebuilt.
Every entry point falls back to numpy / scipy when the toolchain, the
build or the parse fails: this is host ingest, so the port never depends on
the native build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

__all__ = ["BUILD_SECONDS", "load_csv", "load_mtx_coo", "native_available"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "data", "_native", "fast_io.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False
#: seconds the g++ build took in this process (0.0: found built)
BUILD_SECONDS: dict = {}


def _so_path():
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libfastio_{h.hexdigest()[:16]}.so")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
            BUILD_SECONDS["fastio"] = 0.0
            if not os.path.exists(so):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                # another process may build the same library at once: each
                # writes its own file and renames it into place
                tmp = f"{so}.{os.getpid()}.tmp"
                t0 = time.perf_counter()
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                               check=True, capture_output=True, timeout=120)
                BUILD_SECONDS["fastio"] = time.perf_counter() - t0
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.csv_parse.restype = ctypes.c_void_p
            lib.csv_parse.argtypes = [ctypes.c_char_p]
            lib.mtx_parse.restype = ctypes.c_void_p
            lib.mtx_parse.argtypes = [ctypes.c_char_p]
            for name in ("io_rows", "io_cols", "io_nnz"):
                getattr(lib, name).restype = ctypes.c_int64
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.io_copy_values.restype = None
            lib.io_copy_values.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.io_copy_coords.restype = None
            lib.io_copy_coords.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.io_free.restype = None
            lib.io_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            # no g++, a failed build or an unloadable library: numpy
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def load_csv(path: str, dtype=np.float64) -> np.ndarray:
    """Dense CSV -> (N, D) array; native parser with numpy fallback."""
    lib = _load()
    if lib is None:
        return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
    h = lib.csv_parse(os.fsencode(path))
    if not h:
        return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
    try:
        rows, cols = lib.io_rows(h), lib.io_cols(h)
        out = np.empty(rows * cols, np.float64)
        lib.io_copy_values(h, out.ctypes.data_as(ctypes.c_void_p))
        return out.reshape(rows, cols).astype(dtype, copy=False)
    finally:
        lib.io_free(h)


def _mmread_coo(path: str):
    from scipy.io import mmread

    m = mmread(path).tocoo()
    return (m.row.astype(np.int64), m.col.astype(np.int64),
            m.data.astype(np.float64), m.shape)


def load_mtx_coo(path: str):
    """MatrixMarket coordinate file -> (rows, cols, values, shape)."""
    lib = _load()
    if lib is None:
        return _mmread_coo(path)
    h = lib.mtx_parse(os.fsencode(path))
    if not h:
        # the native parser handles 'coordinate real|integer general' only;
        # pattern / complex / symmetric files go to scipy
        return _mmread_coo(path)
    try:
        shape = (lib.io_rows(h), lib.io_cols(h))
        nnz = lib.io_nnz(h)
        vals = np.empty(nnz, np.float64)
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        lib.io_copy_values(h, vals.ctypes.data_as(ctypes.c_void_p))
        lib.io_copy_coords(h, rows.ctypes.data_as(ctypes.c_void_p),
                           cols.ctypes.data_as(ctypes.c_void_p))
        return rows, cols, vals, shape
    finally:
        lib.io_free(h)
