"""Distribution base classes (mirrors spmf_tpu/distributions/base.py).

Lightweight stateless objects: parameters are tensors captured at
construction and every method is a plain function of tensors, so autograd
flows through them.
"""
from __future__ import annotations

import torch

__all__ = ["Distribution", "Independent"]


class Distribution:
    """Minimal distribution interface: elementwise log_prob (the port's
    energies never sample from a distribution object)."""

    #: dtype of the distribution's parameters / samples
    dtype = None

    def log_prob(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def batch_shape(self):
        """Broadcast shape of the parameters."""
        raise NotImplementedError

    def _promote(self, x):
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)


class Independent(Distribution):
    """Reinterpret the last ``reinterpreted_batch_ndims`` batch dims as event
    dims: ``log_prob`` sums over them (mirrors ``tfd.Independent``)."""

    def __init__(self, distribution, reinterpreted_batch_ndims=1):
        self.distribution = distribution
        self.reinterpreted_batch_ndims = int(reinterpreted_batch_ndims)

    @property
    def dtype(self):
        return self.distribution.dtype

    @property
    def batch_shape(self):
        shape = self.distribution.batch_shape
        k = self.reinterpreted_batch_ndims
        return shape[: len(shape) - k] if k else shape

    def log_prob(self, x):
        lp = self.distribution.log_prob(x)
        k = self.reinterpreted_batch_ndims
        if k == 0:
            return lp
        return torch.sum(lp, dim=tuple(range(-k, 0)))
