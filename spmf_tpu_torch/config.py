"""Global configuration helpers for spmf_tpu_torch.

Mirrors spmf_tpu/config.py. The port's default dtype is float32 (what the
H100 kernels take); float64 is honoured everywhere the plain PyTorch paths
run, which is how the CPU tests hold the port to the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["canonical_dtype", "canonical_device", "default_device",
           "default_dtype"]


def default_device() -> torch.device:
    """The port runs on the card unless the caller asks for the CPU."""
    return torch.device("cuda")


def canonical_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises on a
    host without one (the port never moves to the CPU on its own)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: spmf_tpu_torch runs on the card by "
            "default; pass device='cpu' to run on the CPU")
    return default_device()


def default_dtype() -> torch.dtype:
    """float32, the dtype the card's kernels take (spmf_tpu gives float64
    under JAX's x64 switch; the port takes a dtype per call instead)."""
    return torch.float32


def canonical_dtype(dtype=None) -> torch.dtype:
    """Map a user dtype (torch dtype, numpy dtype, or a string such as
    'float64', 'tf.float32', 'double') to a torch floating dtype."""
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        dtype = dtype.replace("tf.", "").replace("torch.", "")
        dtype = {"double": "float64", "float": "float32"}.get(dtype, dtype)
    dt = np.dtype(dtype)
    out = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}.get(dt)
    if out is None:
        raise ValueError(f"unsupported dtype {dtype!r}: float32 or float64")
    return out
