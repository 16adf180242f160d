"""Continuous distributions (mirrors spmf_tpu/distributions/continuous.py).

This slice carries the families the dense horseshoe+ PoissonFactorization
uses: Normal, HalfNormal, InverseGamma and SqrtInverseGamma.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution

__all__ = ["Normal", "HalfNormal", "InverseGamma", "SqrtInverseGamma"]

_LOG_2PI = math.log(2.0 * math.pi)
_HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)


def _as_tensors(*arrs):
    """Parameters as tensors of one floating dtype and device: the first
    tensor argument decides both (Python scalars follow it)."""
    ref = next((a for a in arrs if isinstance(a, torch.Tensor)), None)
    dtype = ref.dtype if ref is not None else torch.get_default_dtype()
    device = ref.device if ref is not None else None
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


class _Base(Distribution):
    @property
    def device(self):
        return self._ref.device

    @property
    def dtype(self):
        return self._ref.dtype


class Normal(_Base):
    def __init__(self, loc, scale):
        self.loc, self.scale = _as_tensors(loc, scale)
        self._ref = self.loc

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def log_prob(self, x):
        z = (self._promote(x) - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI


class HalfNormal(_Base):
    """|Z|, Z ~ Normal(0, scale)."""

    def __init__(self, scale):
        (self.scale,) = _as_tensors(scale)
        self._ref = self.scale

    @property
    def batch_shape(self):
        return self.scale.shape

    def log_prob(self, x):
        z = self._promote(x) / self.scale
        return _HALF_LOG_2_OVER_PI - torch.log(self.scale) - 0.5 * z * z


class InverseGamma(_Base):
    def __init__(self, concentration, scale):
        self.concentration, self.scale = _as_tensors(concentration, scale)
        self._ref = self.concentration

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.concentration.shape,
                                      self.scale.shape)

    def log_prob(self, x):
        x = self._promote(x)
        a, b = self.concentration, self.scale
        return (a * torch.log(b) - (a + 1.0) * torch.log(x) - b / x
                - torch.lgamma(a))


class SqrtInverseGamma(_Base):
    """Distribution of sqrt(Y) with Y ~ InverseGamma(concentration, scale)
    (the Makalic–Schmidt half-Cauchy decomposition of the horseshoe+)."""

    def __init__(self, concentration, scale):
        self.ig = InverseGamma(concentration, scale)
        self._ref = self.ig.concentration

    @property
    def batch_shape(self):
        return self.ig.batch_shape

    def log_prob(self, x):
        # p_X(x) = p_Y(x^2) * 2x in log space, so x^2 never materializes
        x = self._promote(x)
        a, b = self.ig.concentration, self.ig.scale
        logx = torch.log(x)
        return (
            a * torch.log(b)
            - (2.0 * a + 1.0) * logx
            - torch.exp(torch.log(b) - 2.0 * logx)
            - torch.lgamma(a)
            + math.log(2.0)
        )
