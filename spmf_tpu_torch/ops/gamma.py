"""Differentiable Gamma sampling (mirrors spmf_tpu/ops/gamma.py): the
'fast' pathwise sampler below and the 'exact' rejection sampler
(``exact_gamma``).

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

from spmf_tpu_torch.config import canonical_device

__all__ = ["exact_gamma", "lattice_shift", "lattice_uniform", "sample_gamma",
           "wilson_hilferty_gamma"]

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


# Korobov-style generators for multi-uniform draws: when one logical draw
# consumes several uniforms (the WH gamma: 1 normal + 8 boost), giving each
# its own lattice direction (u_jp = frac(u0_j + (p g_j mod H) / H)) makes the
# H pairs equidistribute over the joint torus instead of tracing a 1-d
# lockstep curve. All generators are odd (coprime with any power-of-2 H);
# marginals are exact either way. The fused IG sampler's stream uses them
# too (ops/fused_ig.py).
_LATTICE_GENS = (1, 3299, 4919, 6029, 2543, 7723, 1031, 5501, 6577)


def lattice_shift(p, half):
    """floor(p * 2^23 / half) for pair index p < half (an int or an integer
    tensor), as p q + (p r) // half with q, r = divmod(2^23, half): the split
    quotient of the JAX package, which never forms p * 2^23 and keeps p * r
    below 2^32."""
    q, r = (1 << 23) // half, (1 << 23) % half
    return p * q + (p * r) // half


_GENS: dict = {}


def _gens_tensor(gens, device):
    """The lattice generators as an int64 tensor on ``device``, made once
    per (gens, device): a step copies nothing from the host (which a CUDA
    graph of it could not)."""
    key = (gens, str(device))
    if key not in _GENS:
        _GENS[key] = torch.tensor(gens, dtype=torch.int64, device=device)
    return _GENS[key]


def lattice_uniform(generator, half, shape, dtype, gens=None, *,
                    device=None, bits=None):
    """``(half,) + shape`` uniforms stratified across the leading (pair)
    axis: one 23-bit base integer per coordinate; pair ``p`` adds the
    lattice shift floor((p g mod half) 2^23 / half) in the bit domain
    (exact: no rounding of frac(u + p/half) near 1), then
    u = bits 2^-23 + 2^-24, on the grid ``[2^-24, 1 - 2^-24]`` where log u
    is finite and 1 - u exact. Each pair's u is marginally uniform.

    ``gens``: optional generators, one per ``shape[0]`` (default 1 for every
    coordinate). ``device``: the generator's by default, else the card's.
    ``bits`` (tests): the base integers, of ``shape``, in place of the
    generator's draw."""
    if half > 65536:
        raise ValueError(f"lattice_uniform supports at most 65536 pairs, "
                         f"got {half}")
    if device is None:
        device = (generator.device if generator is not None
                  else canonical_device())
    if bits is None:
        bits = torch.randint(0, 1 << 23, tuple(shape), generator=generator,
                             dtype=torch.int64, device=device)
    else:
        if not isinstance(bits, torch.Tensor):
            bits = np.asarray(bits, np.int64)
        bits = torch.as_tensor(bits, dtype=torch.int64, device=device)
    H = max(half, 1)
    p = torch.arange(half, dtype=torch.int64, device=device).reshape(
        (half,) + (1,) * len(shape))
    if gens is not None:
        g = _gens_tensor(tuple(gens), device).reshape(
            (1, len(gens)) + (1,) * (len(shape) - 1))
        p = (p * g) % H
    b = (bits[None] + lattice_shift(p, H)) & 0x7FFFFF
    return b.to(dtype) * 2.0 ** -23 + 2.0 ** -24


def _mirror_base_draws(generator, shape, dtype, device, boost,
                       stratified=False, bits=None):
    """Antithetic base randomness: the leading axis of ``shape`` is the
    sample axis (even); the second half mirrors the first (eps -> -eps,
    U -> 1-U), so each sample keeps its marginal law and the pairs are
    negatively coupled. ``stratified``: the pairs share one base draw per
    coordinate, lattice-shifted across the pair axis (``lattice_uniform``;
    eps = ndtri(u), the boost uniforms on ``_LATTICE_GENS[1:]``); ``bits``
    (tests): their base integers, (eps bits, boost bits), of shape
    ``shape[1:]`` and ``(boost,) + shape[1:]``."""
    S = shape[0]
    if S % 2:
        raise ValueError(
            f"antithetic sampling needs an even sample count, got {S}")
    H = S // 2
    rest = tuple(shape[1:])
    half = (H,) + rest
    tiny = torch.finfo(dtype).tiny
    if stratified:
        bits_e, bits_u = (None, None) if bits is None else bits
        eps_h = torch.special.ndtri(lattice_uniform(
            generator, H, rest, dtype, device=device, bits=bits_e))
        eps = torch.cat([eps_h, -eps_h], dim=0)
        u_b = lattice_uniform(generator, H, (boost,) + rest, dtype,
                              gens=_LATTICE_GENS[1:boost + 1], device=device,
                              bits=bits_u)
        u_h = torch.movedim(u_b, 0, 1)          # (boost, H) + rest
        # the grid is symmetric about 1/2: 1 - u is exact and >= 2^-24
        return eps, torch.cat([u_h, 1.0 - u_h], dim=1)
    eps_h = torch.randn(half, generator=generator, dtype=dtype,
                        device=device)
    eps = torch.cat([eps_h, -eps_h], dim=0)
    u_h = _uniform(generator, (boost,) + half, dtype, device)
    # 1-u can land arbitrarily close to 0 when u -> 1: same tiny floor
    u = torch.cat([u_h, torch.clamp_min(1.0 - u_h, tiny)], dim=1)
    return eps, u


def wilson_hilferty_gamma(generator, concentration, boost: int = _BOOST,
                          antithetic: bool = False, *, draws=None):
    """Pathwise-differentiable Gamma(concentration, 1) sampler.
    ``antithetic``: mirror the base draws across the leading (sample) axis;
    'stratified' also lattice-couples the pairs (``_mirror_base_draws``).

    ``draws``: optional ``(eps, u)`` replacing the generator's draws —
    eps of the concentration's shape, u of shape ``(boost,) + shape``
    (already mirrored when the caller wants antithetic pairs)."""
    a = concentration
    if draws is not None:
        eps, u = (torch.as_tensor(
            d if isinstance(d, torch.Tensor) else np.array(d),
            dtype=a.dtype, device=a.device) for d in draws)
    elif antithetic:
        eps, u = _mirror_base_draws(generator, a.shape, a.dtype, a.device,
                                    boost,
                                    stratified=antithetic == "stratified")
    else:
        eps = torch.randn(a.shape, generator=generator, dtype=a.dtype,
                          device=a.device)
        u = _uniform(generator, (boost,) + tuple(a.shape), a.dtype, a.device)
    return _WHReduce.apply(a, eps, torch.log(u))


def exact_gamma(generator, concentration):
    """Gamma(concentration, 1) by torch's rejection sampler, drawn from
    ``generator``, with the implicit reparameterisation gradient of
    ``torch._standard_gamma`` (one kernel each way, and capturable: no
    loop reads a value on the host), floored at sqrt(tiny) as the JAX
    package floors ``jax.random.gamma``. The draws match spmf_tpu's in
    distribution only; the gradient at the same (a, x) agrees with
    ``jax.lax.random_gamma_grad`` to about 1e-3 relative (a deliberate
    difference: JAX's series and continued fraction loop on convergence)."""
    a = concentration
    g = torch._standard_gamma(a, generator=generator)
    return torch.clamp_min(g, torch.finfo(g.dtype).tiny ** 0.5)


def sample_gamma(generator, concentration, method: str = "exact",
                 antithetic: bool = False, *, draws=None):
    """Gamma(concentration, 1) with selectable gradient machinery:
    - 'exact': rejection sampling with implicit reparameterisation
      gradients (``exact_gamma``);
    - 'fast': the boosted Wilson–Hilferty pathwise sampler above.
    ``antithetic`` ('fast' only): False, True or 'stratified' (see
    ``wilson_hilferty_gamma``); 'exact' draws by rejection, which has no
    base randomness to mirror."""
    if method == "fast":
        return wilson_hilferty_gamma(generator, concentration,
                                     antithetic=antithetic, draws=draws)
    if method != "exact":
        raise ValueError(f"unknown gamma sampler {method!r}")
    if antithetic:
        raise ValueError("antithetic sampling requires gamma_sampler "
                         "'fast' or 'fused' (rejection sampling has no "
                         "pathwise base draws to mirror)")
    return exact_gamma(generator, concentration)
