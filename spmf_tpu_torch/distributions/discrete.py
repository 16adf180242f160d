"""Discrete observation distributions (mirrors
spmf_tpu/distributions/discrete.py; Poisson only in this slice)."""
from __future__ import annotations

import torch

from .continuous import _as_tensors, _Base

__all__ = ["Poisson"]


class Poisson(_Base):
    def __init__(self, rate):
        (self.rate,) = _as_tensors(rate)
        self._ref = self.rate

    @property
    def batch_shape(self):
        return self.rate.shape

    def log_prob(self, x):
        """x * log(rate) - rate - lgamma(x+1), with the log floored at the
        dtype's tiny (an f32 rate that underflows to 0 must not poison the
        gradients through the energy's finite mask); negative rates still
        give NaN, as in the reference."""
        x = self._promote(x)
        tiny = torch.finfo(self.dtype).tiny
        log_rate = torch.log(torch.clamp_min(self.rate, tiny))
        log_rate = torch.where(self.rate < 0, torch.nan, log_rate)
        return x * log_rate - self.rate - torch.lgamma(x + 1.0)
