"""Numerical debugging helpers (mirrors spmf_tpu/utils/debug.py).

``check_finite`` checks a tree of tensors on the host; ``debug_nans`` is a
scoped NaN trap in the manner of ``jax_debug_nans``. spmf_tpu's
``warn_known_bad_sample_dim`` fences an XLA:TPU miscompilation and has no
counterpart here.
"""
from __future__ import annotations

import contextlib
import numbers

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["check_finite", "debug_nans"]


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict / list / tuple, the path in
    ``jax.tree_util.keystr`` form (``['a'][0]``); dict keys in sorted
    order, as JAX flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _all_finite(leaf):
    """False when a floating leaf holds a NaN or an infinity; other leaves
    (integers, booleans, strings) pass."""
    if isinstance(leaf, torch.Tensor):
        return (not (leaf.is_floating_point() or leaf.is_complex())
                or bool(torch.isfinite(leaf).all()))
    if isinstance(leaf, (np.ndarray, np.generic, numbers.Number)):
        arr = np.asarray(leaf)
        return (not np.issubdtype(arr.dtype, np.inexact)
                or bool(np.isfinite(arr).all()))
    return True


def check_finite(tree, name="pytree"):
    """Raise ``FloatingPointError`` naming every leaf of ``tree`` (nested
    dicts, lists and tuples of tensors, numpy arrays or numbers) that holds
    a non-finite value; return ``tree`` unchanged. Reads device tensors on
    the host."""
    bad = [path for path, leaf in _leaves(tree) if not _all_finite(leaf)]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
    return tree


# ``debug_nans`` settings, innermost last; the dispatch mode follows the
# innermost one. Global, like JAX's config flag, so that autograd's worker
# threads (which inherit the mode) read it too.
_SETTINGS: list = []
# aten ops whose output is uninitialized memory, never a computed NaN
_UNINITIALIZED = ("empty", "new_empty", "empty_like", "empty_strided",
                  "resize_")


class _NaNCheck(TorchDispatchMode):
    """Checks the floating outputs of every aten op for NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (_SETTINGS and _SETTINGS[-1]
                and func.overloadpacket.__name__ not in _UNINITIALIZED):
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if (isinstance(t, torch.Tensor) and t.layout == torch.strided
                        and t.device.type != "meta"
                        and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN trap, as ``jax_debug_nans``: inside ``debug_nans(True)``
    any aten op that produces a NaN raises ``FloatingPointError`` naming
    the op, forward and backward alike, and autograd's anomaly mode
    (``check_nan``) records each op's forward traceback, which a failing
    backward prints. ``debug_nans(False)`` turns the trap off inside an
    enabled scope. Each scope restores the previous setting on exit.

    A debugging tool: every op then reads its output on the host, which
    syncs the device once an op, and a CUDA graph cannot be captured
    inside. The hand-written kernels launch outside the aten dispatcher,
    so a NaN they write is caught at the first aten op that reads it."""
    outermost = not _SETTINGS
    _SETTINGS.append(bool(enable))
    try:
        with contextlib.ExitStack() as stack:
            if outermost:
                stack.enter_context(_NaNCheck())
            stack.enter_context(torch.autograd.set_detect_anomaly(
                bool(enable), check_nan=bool(enable)))
            yield
    finally:
        _SETTINGS.pop()
