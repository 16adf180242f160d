"""Global configuration helpers for spmf_tpu_torch.

Mirrors spmf_tpu/config.py. The port's default dtype is float32 (what the
H100 kernels take); float64 is honoured everywhere the plain PyTorch paths
run, which is how the CPU tests hold the port to the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["canonical_dtype", "canonical_device", "default_device"]


def default_device() -> torch.device:
    """cuda when a card is present, else cpu."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def canonical_device(device=None) -> torch.device:
    if device is None:
        return default_device()
    return torch.device(device)


def canonical_dtype(dtype=None) -> torch.dtype:
    """Map a user dtype (torch dtype, numpy dtype, or a string such as
    'float64', 'tf.float32', 'double') to a torch floating dtype."""
    if dtype is None:
        return torch.float32
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
