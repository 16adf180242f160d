"""COO-to-dense scatter: the CUDA kernel behind ``_densify_coo`` and its twin.

The dense-scatter sparse path (``models/poisson.py`` ``_densify_coo``)
turns a batch's (row, col, value) triplets into a dense (B, D) slab for K1:
``out[r, c] += v`` over every slot. The JAX package does it with XLA's
scatter-add (``.at[].add``, ``spmf_tpu/models/poisson.py:952``); no Pallas
kernel is replaced. For CUDA tensors ``coo_scatter`` zeroes the slab and
launches ``csrc/coo_scatter.cu``: one pass over the slots with atomic adds,
no sort, slots whose value is 0 skipped (exact: adding 0 changes no cell).
For CPU tensors it runs the twin, the accumulating ``index_put_`` the path
used before. The two give the same slab bit for bit where no cell takes
more than one nonzero slot, and on integer counts whose sums stay under
2^24 (float32); a cell that several other values share sums them in the
atomics' order on the card.
"""
from __future__ import annotations

import ctypes

import torch

from spmf_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "coo_scatter", "coo_scatter_twin"]

#: kernel launches, counted by the wrapper where it launches
LAUNCHES = {"coo_scatter": 0}

_INDEX_DTYPES = (torch.int32, torch.int64)
_VALUE_DTYPES = (torch.float32, torch.float64)


def _check_args(rows, cols, vals, shape):
    if rows.dim() != 1 or cols.dim() != 1 or vals.dim() != 1:
        raise ValueError(
            "rows, cols and vals must be 1-D, got shapes "
            f"{tuple(rows.shape)}, {tuple(cols.shape)}, {tuple(vals.shape)}")
    if not rows.shape[0] == cols.shape[0] == vals.shape[0]:
        raise ValueError(
            "rows, cols and vals must have one length, got "
            f"{rows.shape[0]}, {cols.shape[0]}, {vals.shape[0]}")
    if rows.dtype not in _INDEX_DTYPES or cols.dtype not in _INDEX_DTYPES:
        raise ValueError("rows and cols must be int32 or int64, got "
                         f"{rows.dtype} and {cols.dtype}")
    if vals.dtype not in _VALUE_DTYPES:
        raise ValueError(f"vals must be float32 or float64, got {vals.dtype}")
    if not rows.device == cols.device == vals.device:
        raise ValueError(
            "rows, cols and vals must lie on one device, got "
            f"{rows.device}, {cols.device}, {vals.device}")
    if len(shape) != 2 or min(shape) < 0:
        raise ValueError(f"shape must be (B, D) with B, D >= 0, got {shape}")


def coo_scatter_twin(rows, cols, vals, shape):
    """Plain PyTorch: a zero (B, D) slab of ``vals``' dtype with
    ``vals`` added at (rows, cols), repeated cells summed."""
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    out.index_put_((rows, cols), vals, accumulate=True)
    return out


# ---------------------------------------------------------------- kernel
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"coo_scatter": [_P] * 4 + [_L] * 3 + [_I] * 2 + [_P]}


def _lib():
    return _build.load_library("coo_scatter", _SIGNATURES)


def _kernel(rows, cols, vals, shape):
    if rows.dtype != cols.dtype:
        rows, cols = rows.long(), cols.long()
    rows, cols, vals = (t.contiguous() for t in (rows, cols, vals))
    B, D = shape
    out = torch.zeros((B, D), dtype=vals.dtype, device=vals.device)
    if vals.shape[0] == 0:
        return out
    err = _lib().coo_scatter(
        rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), out.data_ptr(),
        vals.shape[0], B, D, int(rows.dtype == torch.int64),
        int(vals.dtype == torch.float64),
        torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(err, "coo_scatter")
    LAUNCHES["coo_scatter"] += 1
    return out


def coo_scatter(rows, cols, vals, shape):
    """The dense (B, D) slab ``out[rows[i], cols[i]] += vals[i]``, in
    ``vals``' dtype on its device. rows, cols: (n,) int32 or int64, each
    row in [0, B) and column in [0, D); vals: (n,) float32 or float64.
    CUDA tensors go through the kernel (an index outside the slab stops it
    with a device-side assert); CPU tensors through the twin."""
    shape = tuple(int(s) for s in shape)
    _check_args(rows, cols, vals, shape)
    if vals.is_cuda:
        return _kernel(rows, cols, vals, shape)
    return coo_scatter_twin(rows, cols, vals, shape)
