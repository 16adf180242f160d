"""Trainable mean-field surrogate posteriors (mirrors
spmf_tpu/vi/surrogates.py).

Parameters are plain dicts of tensors ({name: {"loc", "raw_scale"}} for
Normal surrogates, {name: {"raw_concentration", "raw_scale"}} for
InverseGamma ones), the same leaf names as the JAX pytree. Randomness comes
from an explicit ``torch.Generator``. Draw order within
``sample_and_log_prob`` follows the JAX key split: the Normal block first,
then the InverseGamma block.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd

__all__ = [
    "TrainableNormal",
    "TrainableInverseGamma",
    "TransformedSurrogate",
    "SurrogatePosterior",
    "build_trainable_normal_dist",
    "build_trainable_InverseGamma_dist",
]

_softplus = tfb.Softplus()


def _np_softplus_inverse(y):
    y = np.asarray(y, np.float64)
    return y + np.log(-np.expm1(-y))


def _sum_event(x, event_ndims):
    if event_ndims == 0:
        return x
    return torch.sum(x, dim=tuple(range(-event_ndims, 0)))


class _Trainable:
    def __init__(self, shape, event_ndims, dtype, device):
        from spmf_tpu_torch.config import canonical_device, canonical_dtype

        self.dtype = canonical_dtype(dtype)
        self.device = canonical_device(device)
        self.shape = tuple(shape)
        self.event_ndims = (len(self.shape) if event_ndims is None
                            else int(event_ndims))

    def _tensor(self, a):
        return torch.as_tensor(np.array(a), dtype=self.dtype,
                               device=self.device)


class TrainableNormal(_Trainable):
    """Mean-field Normal with trainable loc and softplus-parameterized
    scale."""

    def __init__(self, loc, scale, event_ndims=None, dtype=None,
                 device=None):
        loc, scale = np.asarray(loc), np.asarray(scale)
        super().__init__(np.broadcast_shapes(loc.shape, scale.shape),
                         event_ndims, dtype, device)
        self._loc0 = np.broadcast_to(loc, self.shape)
        self._raw_scale0 = _np_softplus_inverse(
            np.broadcast_to(scale, self.shape))

    def init(self) -> Dict[str, torch.Tensor]:
        return {"loc": self._tensor(self._loc0),
                "raw_scale": self._tensor(self._raw_scale0)}


class TrainableInverseGamma(_Trainable):
    """Trainable InverseGamma surrogate (softplus-parameterized
    concentration and scale), for the horseshoe+ auxiliaries."""

    def __init__(self, concentration, scale, event_ndims=None, dtype=None,
                 device=None):
        conc, scale = np.asarray(concentration), np.asarray(scale)
        super().__init__(np.broadcast_shapes(conc.shape, scale.shape),
                         event_ndims, dtype, device)
        self._raw_conc0 = _np_softplus_inverse(
            np.broadcast_to(conc, self.shape))
        self._raw_scale0 = _np_softplus_inverse(
            np.broadcast_to(scale, self.shape))

    def init(self) -> Dict[str, torch.Tensor]:
        return {"raw_concentration": self._tensor(self._raw_conc0),
                "raw_scale": self._tensor(self._raw_scale0)}


class TransformedSurrogate:
    """base surrogate pushed through a bijector: y = b(x), with
    log q(y) = log q_base(x) - fldj(x) accumulated in base space."""

    def __init__(self, base, bijector):
        self.base = base
        self.bijector = bijector or tfb.Identity()

    @property
    def event_ndims(self):
        return self.base.event_ndims

    @property
    def shape(self):
        return self.base.shape

    def init(self):
        return self.base.init()


class SurrogatePosterior:
    """Named mean-field surrogate: a dict of independent
    TransformedSurrogates over Normal or InverseGamma bases.

    Base samples are drawn with ONE flattened draw for all Normal
    surrogates and ONE IG-block draw for all InverseGamma surrogates.
    ``gamma_sampler``: 'fast' (boosted Wilson–Hilferty from generator
    draws, spmf_tpu_torch.ops.gamma) or 'fused' (the fused IG sampler:
    the CUDA kernel for CUDA tensors, its Philox twin on the CPU)."""

    def __init__(self, surrogates: Dict[str, TransformedSurrogate],
                 gamma_sampler: str = "fast"):
        if gamma_sampler not in ("fast", "fused"):
            raise NotImplementedError(
                f"gamma_sampler={gamma_sampler!r} is not ported to "
                "spmf_tpu_torch yet (use 'fast' or 'fused')")
        self.gamma_sampler = gamma_sampler
        self.surrogates = dict(surrogates)
        self._normal_names = [n for n, s in self.surrogates.items()
                              if isinstance(s.base, TrainableNormal)]
        self._ig_names = [n for n, s in self.surrogates.items()
                          if isinstance(s.base, TrainableInverseGamma)]
        other = set(self.surrogates) - set(self._normal_names) \
            - set(self._ig_names)
        if other:
            raise TypeError(f"unsupported surrogate bases for {sorted(other)}")
        self._sizes = {n: int(np.prod(s.shape))
                       for n, s in self.surrogates.items()}
        dtypes = {s.base.dtype for s in self.surrogates.values()}
        self.dtype = dtypes.pop() if len(dtypes) == 1 else None
        devices = {s.base.device for s in self.surrogates.values()}
        self.device = devices.pop() if len(devices) == 1 else None

    def init(self):
        return {k: s.init() for k, s in self.surrogates.items()}

    def _sample_normals(self, names, params, generator, sample_shape,
                        antithetic=False, eps=None):
        values, logq = {}, 0.0
        total = sum(self._sizes[n] for n in names)
        if eps is None:
            if antithetic:
                S = sample_shape[0]
                eps_h = torch.randn((S // 2, total), generator=generator,
                                    dtype=self.dtype, device=self.device)
                eps = torch.cat([eps_h, -eps_h], dim=0)
            else:
                eps = torch.randn(sample_shape + (total,),
                                  generator=generator, dtype=self.dtype,
                                  device=self.device)
        else:
            eps = torch.as_tensor(
                eps if isinstance(eps, torch.Tensor) else np.array(eps),
                dtype=self.dtype, device=self.device)
        # eps-form logq: at x = loc + scale*eps the mean-field normal density
        # is exactly -0.5 eps^2 - log(scale) - 0.5 log(2 pi) per coordinate,
        # gradients included (needs fully summed events)
        eps_logq = all(self.surrogates[n].event_ndims
                       == len(self.surrogates[n].shape) for n in names)
        scale_logsum = 0.0
        off = 0
        for n in names:
            s = self.surrogates[n]
            p = params[n]
            sz = self._sizes[n]
            e = eps[..., off:off + sz].reshape(sample_shape + s.shape)
            off += sz
            scale = _softplus.forward(p["raw_scale"])
            x = p["loc"] + scale * e
            if eps_logq:
                scale_logsum = scale_logsum + torch.sum(torch.log(scale))
                if not isinstance(s.bijector, tfb.Identity):
                    logq = logq - _sum_event(
                        s.bijector.forward_log_det_jacobian(x), s.event_ndims)
            else:
                logq = logq + _sum_event(
                    tfd.Normal(p["loc"], scale).log_prob(x), s.event_ndims
                ) - _sum_event(s.bijector.forward_log_det_jacobian(x),
                               s.event_ndims)
            values[n] = s.bijector.forward(x)
        if eps_logq:
            logq = logq + (-0.5 * torch.sum(eps * eps, dim=-1) - scale_logsum
                           - 0.5 * total * math.log(2.0 * math.pi))
        return values, logq

    def _fused_igs_ok(self, names, sample_shape):
        """The fused IG sampler takes softplus bijectors, float32 and a
        0/1-dim sample shape (the JAX dispatch rules)."""
        return (self.gamma_sampler == "fused" and len(sample_shape) <= 1
                and self.dtype == torch.float32
                and all(isinstance(self.surrogates[n].bijector, tfb.Softplus)
                        for n in names))

    def _ig_kernel(self, a_flat, b_flat, seed, S, antithetic=False):
        from spmf_tpu_torch.ops.fused_ig import fused_ig_sample_logq

        return fused_ig_sample_logq(a_flat, b_flat, seed, S, antithetic)

    def _sample_igs_fused(self, names, params, generator, sample_shape,
                          antithetic=False):
        """One fused-sampler call for the whole IG block: draws -> boosted
        WH gamma -> IG transform -> softplus -> logq partial sums."""
        a_flat = torch.cat([
            _softplus.forward(params[n]["raw_concentration"]).reshape(-1)
            for n in names])
        b_flat = torch.cat([
            _softplus.forward(params[n]["raw_scale"]).reshape(-1)
            for n in names])
        S = sample_shape[0] if sample_shape else 1
        # drawn on the device: the kernel reads the seed there, no host sync
        seed = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             dtype=torch.int32, device=self.device)
        y, logq = self._ig_kernel(a_flat, b_flat, seed, S,
                                  antithetic=antithetic)
        values = {}
        off = 0
        for n in names:
            s = self.surrogates[n]
            sz = self._sizes[n]
            block = y[:, off:off + sz]
            off += sz
            values[n] = (block.reshape(sample_shape + s.shape) if sample_shape
                         else block[0].reshape(s.shape))
        return values, (logq if sample_shape else logq[0])

    def _sample_igs(self, names, params, generator, sample_shape,
                    antithetic=False, draws=None):
        from spmf_tpu_torch.ops.gamma import sample_gamma

        if draws is None and self._fused_igs_ok(names, sample_shape):
            return self._sample_igs_fused(names, params, generator,
                                          sample_shape, antithetic=antithetic)
        values, logq = {}, 0.0
        conc_flat = torch.cat([
            _softplus.forward(params[n]["raw_concentration"]).reshape(-1)
            for n in names])
        conc_b = conc_flat.expand(sample_shape + conc_flat.shape)
        # 'fused' degrades to the same WH sampler where the kernel's rules
        # do not hold (float64, multi-dim sample shapes, injected draws)
        g = sample_gamma(generator, conc_b, "fast", antithetic=antithetic,
                         draws=draws)
        off = 0
        for n in names:
            s = self.surrogates[n]
            sz = self._sizes[n]
            a = _softplus.forward(params[n]["raw_concentration"])
            b = _softplus.forward(params[n]["raw_scale"])
            gs = g[..., off:off + sz].reshape(sample_shape + s.shape)
            off += sz
            x = b / gs
            logq = logq + _sum_event(
                tfd.InverseGamma(a, b).log_prob(x), s.event_ndims
            ) - _sum_event(s.bijector.forward_log_det_jacobian(x),
                           s.event_ndims)
            values[n] = s.bijector.forward(x)
        return values, logq

    def sample_and_log_prob(self, params, generator, sample_shape=(),
                            antithetic=False, draws=None):
        """Joint reparameterized sample and log q. ``antithetic``: mirror
        the base draws across the (1-d, even) sample axis.

        ``draws`` (tests): a dict replacing the generator's draws —
        ``normal_eps`` (sample_shape + (total normal,)), and ``ig_eps`` /
        ``ig_u`` (sample_shape + (total IG,), and (8,) + that) for the
        'fast' IG sampler."""
        sample_shape = tuple(sample_shape)
        if antithetic == "stratified":
            raise NotImplementedError(
                "antithetic='stratified' is not ported to spmf_tpu_torch yet")
        if antithetic and (len(sample_shape) != 1 or sample_shape[0] % 2):
            raise ValueError("antithetic sampling needs a 1-d even sample "
                             f"shape, got {sample_shape}")
        draws = draws or {}
        values, logq = {}, 0.0
        if self._normal_names:
            v, lp = self._sample_normals(
                self._normal_names, params, generator, sample_shape,
                antithetic, eps=draws.get("normal_eps"))
            values.update(v)
            logq = logq + lp
        if self._ig_names:
            ig_draws = None
            if "ig_eps" in draws:
                ig_draws = (draws["ig_eps"], draws["ig_u"])
            v, lp = self._sample_igs(self._ig_names, params, generator,
                                     sample_shape, antithetic, ig_draws)
            values.update(v)
            logq = logq + lp
        logq = torch.as_tensor(logq, dtype=self.dtype, device=self.device)
        return values, torch.broadcast_to(logq, sample_shape)

    @torch.no_grad()
    def mean(self, params, generator=None, num_samples=250, chunk=10):
        """Calibrated expectations: the sample mean of each constrained
        variable, drawn in chunks of ``chunk`` samples."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(42)
        chunk = min(chunk, num_samples)
        n_chunks = max(num_samples // chunk, 1)
        out = {n: torch.zeros(s.shape, dtype=s.base.dtype,
                              device=s.base.device)
               for n, s in self.surrogates.items()}
        for _ in range(n_chunks):
            values, _ = self.sample_and_log_prob(params, generator, (chunk,))
            for n, v in values.items():
                out[n] = out[n] + torch.mean(v, dim=0) / n_chunks
        return out


def build_trainable_normal_dist(loc, scale, ndims=None, dtype=None,
                                strategy=None, device=None):
    """API-parity helper (``strategy`` accepted and ignored)."""
    del strategy
    return TrainableNormal(loc, scale, event_ndims=ndims, dtype=dtype,
                           device=device)


def build_trainable_InverseGamma_dist(concentration, scale, ndims=None,
                                      dtype=None, strategy=None,
                                      device=None):
    del strategy
    return TrainableInverseGamma(concentration, scale, event_ndims=ndims,
                                 dtype=dtype, device=device)
