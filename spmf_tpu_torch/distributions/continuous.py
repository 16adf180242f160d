"""Continuous distributions (mirrors spmf_tpu/distributions/continuous.py):
Normal, HalfNormal, Cauchy, HalfCauchy, Gamma, InverseGamma,
SqrtInverseGamma, LogNormal and the exact-E1 Horseshoe / AbsHorseshoe.
``sample`` draws from an explicit ``torch.Generator`` (the JAX package takes
a PRNG key), so the two packages agree in distribution, not draw for draw.
"""
from __future__ import annotations

import math

import torch

from .base import Distribution
from .special import log_exp1

__all__ = ["Normal", "HalfNormal", "Cauchy", "HalfCauchy", "Gamma",
           "InverseGamma", "SqrtInverseGamma", "LogNormal", "Horseshoe",
           "AbsHorseshoe", "standard_gamma"]

_LOG_2PI = math.log(2.0 * math.pi)
_HALF_LOG_2_OVER_PI = 0.5 * math.log(2.0 / math.pi)
# log((2 pi^3)^{-1/2}): normalizer of the exact horseshoe marginal
_LOG_HORSESHOE_K = -0.5 * math.log(2.0 * math.pi**3)


def _as_tensors(*arrs):
    """Parameters as tensors of one floating dtype and device: the first
    tensor argument decides both (Python scalars follow it, filled on the
    device rather than copied from the host, so a captured step can take
    them)."""
    ref = next((a for a in arrs if isinstance(a, torch.Tensor)), None)
    dtype = ref.dtype if ref is not None else torch.get_default_dtype()
    device = ref.device if ref is not None else None
    return [torch.full((), float(a), dtype=dtype, device=device)
            if isinstance(a, (int, float)) else
            torch.as_tensor(a, dtype=dtype, device=device) for a in arrs]


class _Base(Distribution):
    @property
    def device(self):
        return self._ref.device

    @property
    def dtype(self):
        return self._ref.dtype

    def _randn(self, generator, sample_shape):
        return torch.randn(tuple(sample_shape) + tuple(self.batch_shape),
                           generator=generator, dtype=self.dtype,
                           device=self.device)

    def _uniform(self, generator, sample_shape):
        """Uniforms in [1e-7, 1 - 1e-7] (the JAX samplers' bounds)."""
        u = torch.rand(tuple(sample_shape) + tuple(self.batch_shape),
                       generator=generator, dtype=self.dtype,
                       device=self.device)
        return u * (1.0 - 2e-7) + 1e-7


def standard_gamma(generator, concentration):
    """Exact Gamma(concentration, 1) draws (Marsaglia and Tsang 2000) from
    ``generator``: each round redraws the still-rejected elements;
    concentrations below 1 draw at a + 1 and scale by U^(1/a)."""
    a = concentration.detach().reshape(-1)
    small = a < 1.0
    d = torch.where(small, a + 1.0, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    pending = torch.arange(a.numel(), device=a.device)
    while pending.numel():
        dd, cc = d[pending], c[pending]
        x = torch.randn(dd.shape, generator=generator, dtype=a.dtype,
                        device=a.device)
        u = torch.rand(dd.shape, generator=generator, dtype=a.dtype,
                       device=a.device)
        v = (1.0 + cc * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + dd - dd * v
                        + dd * torch.log(v.clamp_min(1e-300)))
        out[pending[ok]] = (dd * v)[ok]
        pending = pending[~ok]
    u = torch.rand(a.shape, generator=generator, dtype=a.dtype,
                   device=a.device)
    out = torch.where(small, out * u ** (1.0 / a), out)
    return out.reshape(concentration.shape)


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

    def sample(self, generator, sample_shape=()):
        return self.loc + self.scale * self._randn(generator, sample_shape)

    def mean(self):
        return torch.broadcast_to(self.loc, self.batch_shape)

    def entropy(self):
        return torch.broadcast_to(
            0.5 * (1.0 + _LOG_2PI) + torch.log(self.scale), self.batch_shape)


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

    def sample(self, generator, sample_shape=()):
        return torch.abs(self._randn(generator, sample_shape)) * self.scale

    def mean(self):
        return self.scale * math.sqrt(2.0 / math.pi)


class Cauchy(_Base):
    def __init__(self, loc, scale):
        self.loc, self.scale = _as_tensors(loc, scale)
        self._ref = self.loc

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def log_prob(self, x):
        z = (self._promote(x) - self.loc) / self.scale
        return -torch.log(math.pi * self.scale) - torch.log1p(z * z)

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, sample_shape)
        return self.loc + self.scale * torch.tan(math.pi * (u - 0.5))


class HalfCauchy(_Base):
    def __init__(self, loc, scale):
        self.loc, self.scale = _as_tensors(loc, scale)
        self._ref = self.loc

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.loc.shape, self.scale.shape)

    def log_prob(self, x):
        z = (self._promote(x) - self.loc) / self.scale
        return (math.log(2.0 / math.pi) - torch.log(self.scale)
                - torch.log1p(z * z))

    def sample(self, generator, sample_shape=()):
        u = self._uniform(generator, sample_shape)
        return self.loc + self.scale * torch.tan(math.pi * u / 2.0)


class Gamma(_Base):
    """Gamma(concentration, rate) or Gamma(concentration, scale=): exactly
    one of ``rate`` / ``scale``. ``sample`` draws ``standard_gamma`` and
    divides by the rate, so its gradient reaches the rate only (the JAX
    sampler also differentiates in the concentration)."""

    def __init__(self, concentration, rate=None, scale=None):
        if (rate is None) == (scale is None):
            raise ValueError("Provide exactly one of rate / scale")
        self.concentration, given = _as_tensors(
            concentration, rate if rate is not None else scale)
        self.rate = given if rate is not None else 1.0 / given
        self._ref = self.concentration

    @property
    def batch_shape(self):
        return torch.broadcast_shapes(self.concentration.shape,
                                      self.rate.shape)

    def log_prob(self, x):
        x = self._promote(x)
        a, b = self.concentration, self.rate
        return (a * torch.log(b) + (a - 1.0) * torch.log(x) - b * x
                - torch.lgamma(a))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        g = standard_gamma(generator,
                           torch.broadcast_to(self.concentration, shape))
        return g / self.rate

    def mean(self):
        return self.concentration / self.rate


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

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.batch_shape)
        g = standard_gamma(generator,
                           torch.broadcast_to(self.concentration, shape))
        # guard b/g against a float32 gamma underflow in the extreme tail
        g = torch.clamp_min(g, torch.finfo(self.dtype).tiny ** 0.5)
        return self.scale / g

    def mean(self):
        # defined for concentration > 1
        return self.scale / (self.concentration - 1.0)


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

    def sample(self, generator, sample_shape=()):
        return torch.sqrt(self.ig.sample(generator, sample_shape))


class LogNormal(_Base):
    def __init__(self, loc, scale):
        self.normal = Normal(loc, scale)
        self._ref = self.normal.loc

    @property
    def batch_shape(self):
        return self.normal.batch_shape

    def log_prob(self, x):
        x = self._promote(x)
        return self.normal.log_prob(torch.log(x)) - torch.log(x)

    def sample(self, generator, sample_shape=()):
        return torch.exp(self.normal.sample(generator, sample_shape))

    def mean(self):
        return torch.exp(self.normal.loc + 0.5 * self.normal.scale ** 2)


class Horseshoe(_Base):
    """Horseshoe marginal: x | lam ~ N(0, lam^2 scale^2), lam ~ C+(0, 1),
    with the exact density p(x) = (2 pi^3)^{-1/2} e^z E1(z) / scale,
    z = x^2 / (2 scale^2), through ``log_exp1``."""

    def __init__(self, scale):
        (self.scale,) = _as_tensors(scale)
        self._ref = self.scale

    @property
    def batch_shape(self):
        return self.scale.shape

    def log_prob(self, x):
        x = self._promote(x)
        z = torch.square(x / self.scale) / 2.0
        # the density diverges logarithmically at 0: clamp z there
        z = torch.clamp_min(z, torch.finfo(self.dtype).tiny)
        return _LOG_HORSESHOE_K - torch.log(self.scale) + z + log_exp1(z)

    def sample(self, generator, sample_shape=()):
        lam = torch.abs(torch.tan(
            math.pi / 2.0 * self._uniform(generator, sample_shape)))
        return self._randn(generator, sample_shape) * lam * self.scale


class AbsHorseshoe(Horseshoe):
    """|X| for X ~ Horseshoe(scale): the horseshoe density (a function of
    x^2) times 2."""

    def log_prob(self, x):
        return super().log_prob(x) + math.log(2.0)

    def sample(self, generator, sample_shape=()):
        return torch.abs(super().sample(generator, sample_shape))
