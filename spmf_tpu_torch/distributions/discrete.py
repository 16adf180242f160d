"""Discrete observation distributions (mirrors
spmf_tpu/distributions/discrete.py): Poisson and Bernoulli."""
from __future__ import annotations

import torch

from spmf_tpu_torch.bijectors import softplus

from .continuous import _as_tensors, _Base

__all__ = ["Poisson", "Bernoulli"]


class Poisson(_Base):
    """Poisson(rate) or Poisson(log_rate=): exactly one of the two. Given
    ``log_rate``, ``log_prob`` uses it as it is (no floor)."""

    def __init__(self, rate=None, log_rate=None):
        if (rate is None) == (log_rate is None):
            raise ValueError("Provide exactly one of rate / log_rate")
        if rate is not None:
            (self.rate,) = _as_tensors(rate)
            self._log_rate = None
        else:
            (self._log_rate,) = _as_tensors(log_rate)
            self.rate = torch.exp(self._log_rate)
        self._ref = self.rate

    @property
    def log_rate(self):
        if self._log_rate is not None:
            return self._log_rate
        return torch.log(self.rate)

    @property
    def batch_shape(self):
        return self.rate.shape

    def log_prob(self, x):
        """x * log(rate) - rate - lgamma(x+1), with the log floored at the
        dtype's tiny (an f32 rate that underflows to 0 must not poison the
        gradients through the energy's finite mask); negative rates still
        give NaN, as in the reference."""
        x = self._promote(x)
        log_rate = self._log_rate
        if log_rate is None:
            tiny = torch.finfo(self.dtype).tiny
            log_rate = torch.log(torch.clamp_min(self.rate, tiny))
            log_rate = torch.where(self.rate < 0, torch.nan, log_rate)
        return x * log_rate - self.rate - torch.lgamma(x + 1.0)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        return torch.poisson(torch.broadcast_to(self.rate, shape).contiguous(),
                             generator=generator)

    def mean(self):
        return self.rate


class Bernoulli(_Base):
    def __init__(self, logits=None, probs=None):
        if (logits is None) == (probs is None):
            raise ValueError("Provide exactly one of logits / probs")
        if logits is not None:
            (self.logits,) = _as_tensors(logits)
        else:
            (p,) = _as_tensors(probs)
            self.logits = torch.log(p) - torch.log1p(-p)
        self._ref = self.logits

    @property
    def batch_shape(self):
        return self.logits.shape

    def log_prob(self, x):
        """x * logits - softplus(logits), stable for large |logits|."""
        return self._promote(x) * self.logits - softplus(self.logits)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        probs = torch.sigmoid(torch.broadcast_to(self.logits, shape))
        return torch.bernoulli(probs.contiguous(), generator=generator)

    def mean(self):
        return torch.sigmoid(self.logits)
