"""Fast differentiable Gamma sampling (mirrors spmf_tpu/ops/gamma.py).

Boosted Wilson–Hilferty: for shape a + B (B = 8 boost) the WH cube
approximation draws G_{a+B} from one standard normal eps, and Stuart's
theorem reduces it to shape a with B uniforms:

    G_a = (a+B) * max(c, 0.05)^3 * exp(sum_i log(U_i) / (a+i)),
    c   = 1 - 1/(9(a+B)) + eps / (3 sqrt(a+B))

Every step is elementary, so the gradient is a plain pathwise derivative;
the backward is written by hand (``_WHReduce``) and keeps two weighted
log-uniform sums instead of the (B, ...) uniform tensor. The draws come
from a ``torch.Generator``, or are injected (``draws=``) so that a test can
feed the JAX package and the port the same randomness.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["sample_gamma", "wilson_hilferty_gamma"]

_BOOST = 8


def _wh_value(a, eps, s1, boost):
    """x = (a+B) * max(c, 0.05)^3 * exp(s1), floored at sqrt(tiny) (a
    uniform at its minval can underflow g to 0 in f32, which would make the
    InverseGamma sample b/g infinite)."""
    ab = a + float(boost)
    c = 1.0 - 1.0 / (9.0 * ab) + eps / (3.0 * torch.sqrt(ab))
    g = ab * torch.clamp_min(c, 0.05) ** 3 * torch.exp(s1)
    return torch.clamp_min(g, torch.finfo(g.dtype).tiny ** 0.5)


def _weights(a, boost):
    i = torch.arange(boost, dtype=a.dtype, device=a.device).reshape(
        (boost,) + (1,) * a.dim())
    return 1.0 / (a + i)


class _WHReduce(torch.autograd.Function):
    """x = WH(a, eps, logu) with the hand VJP of the JAX ``wh_reduce``
    custom_vjp: d/da and d/deps from the residuals (a, eps, s1, s2, x); no
    gradient to the uniforms."""

    @staticmethod
    def forward(ctx, a, eps, logu):
        boost = logu.shape[0]
        w = _weights(a, boost)
        s1 = torch.sum(logu * w, dim=0)
        s2 = torch.sum(logu * w * w, dim=0)
        x = _wh_value(a, eps, s1, boost)
        ctx.boost = boost
        ctx.save_for_backward(a, eps, s2, x)
        return x

    @staticmethod
    def backward(ctx, gx):
        a, eps, s2, x = ctx.saved_tensors
        ab = a + float(ctx.boost)
        sqrt_ab = torch.sqrt(ab)
        c = 1.0 - 1.0 / (9.0 * ab) + eps / (3.0 * sqrt_ab)
        cc = torch.clamp_min(c, 0.05)
        active_c = (c > 0.05).to(x.dtype)
        floor = torch.finfo(x.dtype).tiny ** 0.5
        not_floored = (x > floor).to(x.dtype)
        # d log x / da = 1/ab + 3 (dc/da)/cc [c>.05] - s2
        dc_da = 1.0 / (9.0 * ab * ab) - eps / (6.0 * ab * sqrt_ab)
        dlogx_da = 1.0 / ab + 3.0 * active_c * dc_da / cc - s2
        da = gx * x * dlogx_da * not_floored
        # d log x / d eps = [c>.05] / (cc * sqrt(ab))
        deps = gx * x * active_c / (cc * sqrt_ab) * not_floored
        return da, deps, None


def _uniform(generator, shape, dtype, device):
    """U(tiny, 1), as ``jax.random.uniform(minval=tiny, maxval=1)``."""
    tiny = torch.finfo(dtype).tiny
    r = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return torch.clamp_min(r * (1.0 - tiny) + tiny, tiny)


def _mirror_base_draws(generator, shape, dtype, device, boost):
    """Antithetic base randomness: the leading axis of ``shape`` is the
    sample axis (even); the second half mirrors the first (eps -> -eps,
    U -> 1-U), so each sample keeps its marginal law and the pairs are
    negatively coupled."""
    S = shape[0]
    if S % 2:
        raise ValueError(
            f"antithetic sampling needs an even sample count, got {S}")
    half = (S // 2,) + tuple(shape[1:])
    tiny = torch.finfo(dtype).tiny
    eps_h = torch.randn(half, generator=generator, dtype=dtype,
                        device=device)
    eps = torch.cat([eps_h, -eps_h], dim=0)
    u_h = _uniform(generator, (boost,) + half, dtype, device)
    # 1-u can land arbitrarily close to 0 when u -> 1: same tiny floor
    u = torch.cat([u_h, torch.clamp_min(1.0 - u_h, tiny)], dim=1)
    return eps, u


def wilson_hilferty_gamma(generator, concentration, boost: int = _BOOST,
                          antithetic: bool = False, draws=None):
    """Pathwise-differentiable Gamma(concentration, 1) sampler.

    ``draws``: optional ``(eps, u)`` replacing the generator's draws —
    eps of the concentration's shape, u of shape ``(boost,) + shape``
    (already mirrored when the caller wants antithetic pairs)."""
    a = concentration
    if antithetic == "stratified":
        raise NotImplementedError(
            "antithetic='stratified' is not ported to spmf_tpu_torch yet")
    if draws is not None:
        eps, u = (torch.as_tensor(
            d if isinstance(d, torch.Tensor) else np.array(d),
            dtype=a.dtype, device=a.device) for d in draws)
    elif antithetic:
        eps, u = _mirror_base_draws(generator, a.shape, a.dtype, a.device,
                                    boost)
    else:
        eps = torch.randn(a.shape, generator=generator, dtype=a.dtype,
                          device=a.device)
        u = _uniform(generator, (boost,) + tuple(a.shape), a.dtype, a.device)
    return _WHReduce.apply(a, eps, torch.log(u))


def sample_gamma(generator, concentration, method: str = "fast",
                 antithetic: bool = False, draws=None):
    """Gamma(concentration, 1). Only the pathwise 'fast' sampler is ported;
    'exact' (rejection sampling with implicit gradients) raises."""
    if method != "fast":
        raise NotImplementedError(
            f"gamma_sampler={method!r} is not ported to spmf_tpu_torch yet "
            "(use 'fast' or 'fused')")
    return wilson_hilferty_gamma(generator, concentration,
                                 antithetic=antithetic, draws=draws)
