"""Special functions of the distribution library (mirrors
spmf_tpu/distributions/special.py): ``exp1`` (the exponential integral E1)
and ``log_exp1``, which give the exact horseshoe marginal density

    p(x) = (2 pi^3)^{-1/2} / sigma * exp(z) * E1(z),   z = x^2 / (2 sigma^2).

Loop-free: a truncated power series for z < 1 and two degree-10/10 rational
approximations of g(z) = z e^z E1(z) for z >= 1, evaluated by unrolled
Horner with the JAX package's coefficient tables (max relative error
3.3e-14). Both functions are ``torch.autograd.Function``s whose backward is
the JAX custom JVP: E1'(z) = -e^{-z}/z, and d/dz log E1(z) = -1/g(z) (the
exact quotient below 1). The forward runs without autograd and saves only
``z``; the backward recomputes g(z). Under plain autograd each Horner step
would keep its intermediate alive: about 100 tensors the size of ``z``, and
the autoencoder's weight prior evaluates E1 on every sampled weight.
Nothing here reads a value on the host, so the functions run inside a
captured CUDA graph.
"""
from __future__ import annotations

import torch

__all__ = ["exp1", "log_exp1"]

_EULER_GAMMA = 0.57721566490153286060651209008240243

# --- coefficient tables (spmf_tpu's, generated by its tools/fit_exp1.py) ---
# series: E1(z) = -gamma - log z + sum_{k>=1} (-1)^{k+1} z^k / (k k!)
# truncated at 18 terms (truncation < 4e-19 at z=1)
_SERIES_C = (
    1.0, -0.25, 0.05555555555555555, -0.010416666666666666,
    0.0016666666666666668, -0.0002314814814814815, 2.834467120181406e-05,
    -3.1001984126984127e-06, 3.0619243582206544e-07, -2.755731922398589e-08,
    2.27746439867652e-09, -1.7397297489890083e-10, 1.2353110643708935e-11,
    -8.193389712664089e-13, 5.0981091545465446e-14, -2.9871733327421158e-15,
    1.6537983849091297e-16, -8.677337204770125e-18,
)
# g(z) = z e^z E1(z) ~= P(u)/Q(u), u = (1/z - c)/h
# z in [1, 6): validated max rel err 3.2e-14
_MID_C, _MID_H = 0.5833333333333334, 0.4166666666666667
_MID_P = (
    0.6961834961428736, -0.05792581009812459, -0.02232410245965699,
    0.04811046053973706, -0.05912396644990247, 0.04999869798867648,
    -0.00805749459382555, -0.04628337650562764, -0.015333442570339873,
    -0.0012708306634312734, -8.559632307681197e-06,
)
_MID_Q = (
    1.0, 0.09671000143826465, -0.062482585659980355, 0.06848482152188395,
    -0.07356809949891012, 0.055912672639165356, 0.002742910840677374,
    -0.07000850468522625, -0.033427240896129785, -0.004931216511145416,
    -0.0001963131294960051,
)
# z in [6, inf): fitted with nodes down to t=1e-12 (z=1e12); as z -> inf,
# u -> -1 and P/Q -> 1 = lim g. validated max rel err 8.2e-15
_FAR_C, _FAR_H = 0.08333333333383333, 0.08333333333283333
_FAR_P = (
    0.9279135976666468, -0.03351116929133046, 0.0026382358755323108,
    0.00033789257110549564, -0.0015070863773699217, 0.003050102760169851,
    -0.005162199947028265, 0.005725843925541163, 0.0031070749864311486,
    0.00030595059690550125, 2.6805301364662227e-06,
)
_FAR_Q = (
    1.0, 0.03164691244258015, -0.003223233510251107, 0.0012398211770431116,
    -0.0017438994836199225, 0.003209394475699138, -0.005343480216788939,
    0.005783538440802476, 0.0037878782378168415, 0.0005310741388969905,
    1.7157820780248396e-05,
)


def _horner(u, coeffs):
    """Unrolled Horner evaluation, in place on one accumulator; coeffs
    ascending, Python floats (the result's dtype is ``u``'s)."""
    acc = torch.full_like(u, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc.mul_(u).add_(c)
    return acc


def _series_e1(z):
    """E1(z) for z in (0, 1] via the power series (exact to ~4e-19)."""
    return (z * _horner(z, _SERIES_C)).sub_(torch.log(z)).sub_(_EULER_GAMMA)


def _rational(t, c, h, p, q):
    u = (t - c).div_(h)
    return _horner(u, p).div_(_horner(u, q))


def _rational_g(z):
    """g(z) = z e^z E1(z) for z >= 1 via the two shifted rationals."""
    t = torch.reciprocal(torch.clamp_min(z, 1.0))
    mid = _rational(t, _MID_C, _MID_H, _MID_P, _MID_Q)
    far = _rational(t, _FAR_C, _FAR_H, _FAR_P, _FAR_Q)
    return torch.where(z < 6.0, mid, far)


def _exp1(z):
    small = _series_e1(torch.clamp_max(z, 1.0))
    big = torch.exp(-z).mul_(_rational_g(z)).div_(z)
    return torch.where(z < 1.0, small, big)


def _log_exp1(z):
    small = torch.log(_series_e1(torch.clamp_max(z, 1.0)))
    big = torch.log(_rational_g(z)).sub_(z).sub_(
        torch.log(torch.clamp_min(z, 1.0)))
    return torch.where(z < 1.0, small, big)


class _Exp1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _exp1(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        return torch.exp(-z).div_(z).neg_().mul_(grad)


class _LogExp1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _log_exp1(z)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        # d/dz log E1(z) = E1'/E1 = -e^{-z}/(z E1(z)) = -1/g(z). For z < 1
        # the rational is out of range: the exact quotient there
        (z,) = ctx.saved_tensors
        zs = torch.clamp_max(z, 1.0)
        small = torch.exp(-zs).div_(zs * _series_e1(zs)).neg_()
        big = torch.reciprocal(_rational_g(z)).neg_()
        return torch.where(z < 1.0, small, big).mul_(grad)


def exp1(z):
    """Exponential integral E1(z) for z > 0, elementwise."""
    return _Exp1.apply(torch.as_tensor(z))


def log_exp1(z):
    """log(E1(z)), stable for large z where E1 underflows (log E1(z) =
    -z - log z + log g(z) with g the non-underflowing rational)."""
    return _LogExp1.apply(torch.as_tensor(z))
