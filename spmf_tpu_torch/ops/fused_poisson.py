"""Fused decode + clipped Poisson log-likelihood: the CUDA kernel K1/K2 and
its twin.

Port of spmf_tpu/ops/fused_poisson.py (``fused_poisson_loglik`` and the
``_fused_stats`` / ``_fused_sum_static`` custom VJPs). Per ELBO sample s:

    rate = f(theta_s @ v_s) * eta + phi_s      f: identity, or exp(.) - 1
    ll   = x log(rate) - rate - lgamma(x + 1)
    out  = sum(clip(ll, m, 0), non-finite -> m),  m = max(min(finite ll) - 10,
                                                      FLOOR) in float32

With the clip decomposition (see the JAX module docstring) one sweep emits
per sample the sum of min(ll, 0) over finite ll > FLOOR, the count of the
other cells and the global finite minimum; the bound ``m`` combines outside,
as a constant to autograd. The same sweep emits the gradients at unit
cotangent, so the backward is a per-sample scalar rescale. ``clip='static'``
clips at the constant FLOOR (the K2 flag of the same kernel): identical
values on healthy data, identical gradients always.

``fused_poisson_loglik`` launches the kernel (``csrc/fused_poisson.cu``)
for CUDA tensors and runs ``stats_twin`` for CPU tensors. The twin is the
explicit formulas of ``_tile_ll_grads`` over the whole (B, D) slab of each
sample, for any dtype and device.
"""
from __future__ import annotations

import ctypes

import torch

from spmf_tpu_torch.ops import _build

__all__ = ["FLOOR", "LAUNCHES", "fused_poisson_loglik",
           "poisson_loglik_reference", "stats_twin"]

FLOOR = -1e27  # static clip-bound floor (see _floor_min_val)

#: kernel launches, counted by the wrapper where it launches: "stats" for
#: clip='reference' (K1), "static" for clip='static' (K2)
LAUNCHES = {"stats": 0, "static": 0}


def _safe_log(rate):
    """log with a tiny positive floor; negative rates give NaN."""
    tiny = torch.finfo(rate.dtype).tiny
    out = torch.log(torch.clamp_min(rate, tiny))
    return torch.where(rate < 0, torch.nan, out)


def _floor_min_val(min_val):
    """Clamp the data-dependent clip bound at -1e27 in float32 only (an
    astronomical finite ll would make the clipped sum overflow)."""
    if min_val.dtype == torch.float32:
        return torch.clamp_min(min_val, -1e27)
    return min_val


def _decode_rate(theta_v, eta, phi, log_transform):
    if log_transform:
        return torch.exp(theta_v * eta) - 1.0 + phi
    return theta_v * eta + phi


def poisson_loglik_reference(theta, v, phi, x, eta, log_transform=False):
    """Plain autograd version of the same semantics (full autodiff,
    including the clip bound's gradient)."""
    rate = _decode_rate(torch.matmul(theta, v), eta, phi, log_transform)
    ll = x * _safe_log(rate) - rate - torch.lgamma(x + 1.0)
    finite = torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll))
    min_val = _floor_min_val(torch.min(finite) - 10.0)
    ll = torch.minimum(torch.maximum(ll, min_val), torch.zeros_like(ll))
    ll = torch.where(torch.isfinite(ll), ll, min_val)
    return torch.sum(ll, dim=(-1, -2))


def stats_twin(theta, v, phi, x, eta, log_transform=False, static=False):
    """Plain PyTorch K1/K2: (sums (S,), counts (S,) int32, gmin (1,),
    dtheta (S,B,K), dv (S,K,D), dphi (S,1,D)) — the kernel's outputs, from
    the explicit ``_tile_ll_grads`` formulas (not autograd through a clip).
    ``static``: clipped cells add FLOOR to the sums; counts and gmin are
    zeros. Loops over samples so one (B, D) slab is live at a time."""
    S = theta.shape[0]
    dtype = theta.dtype
    tiny = torch.finfo(dtype).tiny
    lgx = torch.lgamma(x + 1.0)
    sums, cnts, dths, dvs, dphis = [], [], [], [], []
    gmin = torch.zeros((), dtype=dtype, device=theta.device)
    for s in range(S):
        tv = theta[s] @ v[s]
        if log_transform:
            ev = torch.exp(tv * eta)
            rate = ev - 1.0 + phi[s]
        else:
            rate = tv * eta + phi[s]
        ll = x * _safe_log(rate) - rate - lgx
        dll = torch.where(rate > tiny, x / torch.clamp_min(rate, tiny),
                          torch.zeros_like(rate)) - 1.0
        finite = torch.isfinite(ll)
        keep = finite & (ll > FLOOR)
        active = keep & (ll < 0.0)
        drate = torch.where(active, dll, torch.zeros_like(dll))
        dtv = drate * (ev * eta if log_transform else eta)
        dtv = torch.where(active, dtv, torch.zeros_like(dtv))
        ll_kept = torch.clamp_max(ll, 0.0)
        if static:
            sums.append(torch.where(keep, ll_kept,
                                    torch.full_like(ll, FLOOR)).sum())
            cnts.append(torch.zeros((), dtype=torch.int32,
                                    device=theta.device))
        else:
            sums.append(torch.where(keep, ll_kept,
                                    torch.zeros_like(ll)).sum())
            cnts.append((~keep).sum().to(torch.int32))
            gmin = torch.minimum(gmin, torch.where(
                finite, ll, torch.zeros_like(ll)).min())
        dths.append(dtv @ v[s].T)
        dvs.append(theta[s].T @ dtv)
        dphis.append(drate.sum(0, keepdim=True))
    return (torch.stack(sums), torch.stack(cnts), gmin.reshape(1),
            torch.stack(dths), torch.stack(dvs), torch.stack(dphis))


# ---------------------------------------------------------------- kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"poisson_stats": [_P] * 11 + [_I] * 6 + [_P]}
_TB, _TD = 128, 64          # must match csrc/fused_poisson.cu
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use


def _lib():
    return _build.load_library("fused_poisson", _SIGNATURES)


def _kernel_stats(theta, v, phi, x, eta, log_transform, static):
    S, B, K = theta.shape
    D = x.shape[-1]
    for name, t, shape in (("theta", theta, (S, B, K)), ("v", v, (S, K, D)),
                           ("phi", phi, (S, 1, D)), ("x", x, (B, D)),
                           ("eta", eta, (1, D))):
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.device != theta.device):
            raise ValueError(
                f"fused Poisson kernel: {name} must be a contiguous float32 "
                f"CUDA tensor of shape {shape} on {theta.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    smem = 4 * (2 * _TB * K + K * (_TD + 1) + _TB * (_TD + 1) + 2 * _TD)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"latent dim K={K} is too wide for the fused "
                         "Poisson kernel's shared-memory tiles")
    dev = theta.device
    nrb = -(-B // _TB)
    psum = torch.empty((S, nrb), dtype=torch.float64, device=dev)
    pcnt = torch.zeros((S, nrb), dtype=torch.int32, device=dev)
    pmin = torch.zeros((S, nrb), dtype=torch.float32, device=dev)
    dtheta = torch.empty((S, B, K), dtype=torch.float32, device=dev)
    dv = torch.zeros((S, K, D), dtype=torch.float32, device=dev)
    dphi = torch.zeros((S, 1, D), dtype=torch.float32, device=dev)
    err = _lib().poisson_stats(
        theta.data_ptr(), v.data_ptr(), phi.data_ptr(), x.data_ptr(),
        eta.data_ptr(), psum.data_ptr(), pcnt.data_ptr(), pmin.data_ptr(),
        dtheta.data_ptr(), dv.data_ptr(), dphi.data_ptr(), S, B, K, D,
        int(bool(log_transform)), int(bool(static)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "poisson_stats")
    LAUNCHES["static" if static else "stats"] += 1
    return (psum.sum(1).to(torch.float32), pcnt.sum(1, dtype=torch.int32),
            pmin.min().reshape(1), dtheta, dv, dphi)


class _FusedStats(torch.autograd.Function):
    """(sums, counts, gmin) with the kernel's unit-cotangent gradients
    saved; the backward rescales them by the sums' cotangent (the counts
    are piecewise constant and the clip bound is a constant by design)."""

    @staticmethod
    def forward(ctx, theta, v, phi, x, eta, log_transform, static):
        stats = _kernel_stats if theta.is_cuda else stats_twin
        ssum, cnt, gmin, dth, dv, dphi = stats(theta, v, phi, x, eta,
                                               log_transform, static)
        ctx.save_for_backward(dth, dv, dphi)
        ctx.mark_non_differentiable(cnt, gmin)
        return ssum, cnt, gmin

    @staticmethod
    def backward(ctx, gsum, gcnt, gmin):
        dth, dv, dphi = ctx.saved_tensors
        g = gsum.to(dth.dtype)[:, None, None]
        return dth * g, dv * g, dphi * g, None, None, None, None


def fused_poisson_loglik(theta, v, phi, x, eta, log_transform=False,
                         likelihood="poisson", clip="reference"):
    """Per-sample clipped log-likelihood sums, shape (S,), float32.

    theta (S,B,K), v (S,K,D), phi (S,1,D), x (B,D), eta (1,D) or anything
    broadcastable to it. Inputs are cast to float32, as the JAX entry
    does. ``clip='reference'`` reproduces the data-dependent bound
    ``m = min(finite ll) - 10``; ``clip='static'`` clips at FLOOR."""
    if likelihood != "poisson":
        raise NotImplementedError(
            f"likelihood={likelihood!r} is not ported to spmf_tpu_torch yet "
            "(Poisson only)")
    if clip not in ("reference", "static"):
        raise ValueError(f"unknown clip mode {clip!r}")
    f32 = torch.float32
    theta = theta.to(f32).contiguous()
    v = v.to(f32).contiguous()
    phi = phi.to(f32).contiguous()
    x = torch.as_tensor(x, device=theta.device).to(f32).contiguous()
    D = x.shape[-1]
    eta = torch.as_tensor(eta, dtype=f32, device=theta.device)
    eta = eta.broadcast_to((1, D)).contiguous()
    ssum, cnt, gmin = _FusedStats.apply(theta, v, phi, x, eta,
                                        log_transform, clip == "static")
    if clip == "static":
        return ssum
    m = _floor_min_val(gmin - 10.0)
    return ssum + cnt.to(f32) * m[0]
