"""Build and load the hand-written CUDA kernels of ``spmf_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into ``spmf_tpu_torch/_build/``, then
loaded with ``ctypes``. The library's file name carries a hash of the
source, of every header under ``csrc/`` that it includes, and of the flags,
so an edited source or shared header is rebuilt and a stale library is never
loaded. Nothing here runs at import time: a host without nvcc can
import every module and run the plain PyTorch twins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["NVCC_FLAGS", "BUILD_DIR", "BUILD_SECONDS", "load_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: seconds each library took to compile in this process (0.0: found built)
BUILD_SECONDS: dict = {}
_LIBS: dict = {}
_LOCKS: dict = {}               # one per library: different ones build at once
_LOCK = threading.Lock()        # guards _LOCKS


def _nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "spmf_tpu_torch are built from source on the machine with the card")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_files(src):
    """``src`` and every file it includes with ``#include "..."``, followed
    through the headers, each relative to the including file's directory
    (system headers in angle brackets are the toolkit's, not ours)."""
    files, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            todo.append(os.path.normpath(
                os.path.join(os.path.dirname(path), name.decode())))
    return files


def _source_hash(src):
    h = hashlib.sha256()
    for path in _source_files(src):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, signatures: dict):
    """Build (if needed) and load ``csrc/<name>.cu``. ``signatures`` maps
    each exported C function to its ctypes argument types; every function
    returns an int (the launch's ``cudaGetLastError()``). Thread-safe;
    different libraries may be built from different threads at once."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name in _LIBS:
            return _LIBS[name]
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}_{_source_hash(src)}.so")
        BUILD_SECONDS[name] = 0.0
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                capture_output=True, text=True,
            )
            BUILD_SECONDS[name] = time.perf_counter() - t0
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
        return lib


def check(err: int, what: str):
    """Raise if a launch reported an error (``cudaGetLastError()`` != 0)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
