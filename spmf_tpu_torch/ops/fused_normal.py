"""Fused Normal-surrogate sampler: the CUDA kernel K6 and its twin.

Port of spmf_tpu/ops/fused_normal.py. The Normal mean-field surrogates
(u, v, w, s: 1,340,000 parameters at D=20000, K=32) are sampled S times per
step. Per element and sample: one uniform, eps = sqrt(2) erfinv(2u-1),
x = loc + softplus(raw_scale) * eps, y = softplus(x) where the variable's
bijector is Softplus (mask 1.0) or x where it is Identity (mask 0.0), and
the per-sample sum of

    log q(x) - fldj = -log(scale) - eps^2/2 - log(2 pi)/2 + mask*softplus(-x)

Randomness: Philox4x32-10 with key (seed, 1) (the IG sampler K3 uses
(seed, 0)); sample s of element i takes word s % 4 of the call at counter
(flat element index i, s // 4, 0, 0), on the uniform grid of
``fused_ig.uniform_from_bits``: one call serves four samples, and for S not
a multiple of 4 the last call's first S % 4 words are used. This is the
replay contract between the forward kernel, the backward kernel
(``csrc/fused_normal.cu``) and the plain PyTorch twin below: the stream is
keyed by element and sample, never by block geometry, so all three draw the
same bits and can be compared element by element.

``fused_normal_sample_logq`` launches the kernels for CUDA tensors (float32
only) and runs the twin for CPU tensors; its backward replays the stream (no
samples are saved). A forward is two device kernels (the sampler and the
fixed-order sum of its per-block log q partials), a backward one.
"""
from __future__ import annotations

import ctypes

import torch

from spmf_tpu_torch.bijectors import softplus as _softplus
from spmf_tpu_torch.ops import _build
from spmf_tpu_torch.ops.fused_ig import philox4x32, uniform_from_bits

__all__ = ["LAUNCHES", "MAX_SAMPLES", "draw_eps", "fused_normal_sample_logq",
           "kernel_info", "normal_twin_bwd", "normal_twin_fwd"]

_SQRT2 = 1.4142135623730951
_HALF_LOG_2PI = 0.9189385332046727
_MASK32 = 0xFFFFFFFF
#: the most samples one K6f launch takes (its per-sample block sums fill
#: 64 bytes of shared memory each)
MAX_SAMPLES = 2048

#: kernel launches, counted by the wrappers where they launch
LAUNCHES = {"fwd": 0, "bwd": 0}


def draw_eps(total, s, seed, dtype, device):
    """The standard normals (total,) of sample ``s``: the stream above."""
    idx = torch.arange(total, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    bits = philox4x32(idx, zero + s // 4, zero, zero, int(seed) & _MASK32,
                      1)[s % 4]
    return _SQRT2 * torch.erfinv(2.0 * uniform_from_bits(bits, dtype) - 1.0)


# -------------------------------------------------------------- tile math
def _ntile_fwd(loc, scale, logscale, mask, eps):
    """y and elementwise logq from the standard normal ``eps``; ``mask`` is
    1.0 where the variable's bijector is softplus, 0.0 for identity."""
    x = loc + scale * eps
    y = torch.where(mask > 0, _softplus(x), x)
    lq = -logscale - 0.5 * eps * eps - _HALF_LOG_2PI + mask * _softplus(-x)
    return y, lq


def _ntile_bwd(loc, scale, sig_rs, mask, eps):
    """(dy_dloc, dy_drs, dlq_dloc, dlq_drs) holding eps fixed (pathwise)."""
    x = loc + scale * eps
    sig_x = torch.sigmoid(x)
    dy_dx = torch.where(mask > 0, sig_x, torch.ones_like(sig_x))
    dy_drs = dy_dx * eps * sig_rs
    dlq_dx = mask * (sig_x - 1.0)
    dlq_drs = -sig_rs / scale + dlq_dx * eps * sig_rs
    return dy_dx, dy_drs, dlq_dx, dlq_drs


# ------------------------------------------------------------------ twin
def _check_args(loc, raw_scale, mask):
    if loc.dim() != 1 or loc.shape != raw_scale.shape \
            or loc.shape != mask.shape:
        raise ValueError(
            "loc, raw_scale, mask must be flat and equal-shaped, got "
            f"{tuple(loc.shape)}, {tuple(raw_scale.shape)}, "
            f"{tuple(mask.shape)}")


def normal_twin_fwd(loc, raw_scale, mask, seed, S):
    """Plain PyTorch K6f: y (S, total), lq (S,), any dtype and device.
    Differentiable in (loc, raw_scale) by autograd (the draws are
    constants)."""
    _check_args(loc, raw_scale, mask)
    seed = int(seed)
    scale = _softplus(raw_scale)
    logscale = torch.log(scale)
    ys, lqs = [], []
    for s in range(S):
        eps = draw_eps(loc.shape[0], s, seed, loc.dtype, loc.device)
        y, lq = _ntile_fwd(loc, scale, logscale, mask, eps)
        ys.append(y)
        lqs.append(lq.sum())
    return torch.stack(ys), torch.stack(lqs)


def normal_twin_bwd(loc, raw_scale, mask, seed, S, gy, glq):
    """Plain PyTorch K6b: replays the stream and returns (gloc, grs)."""
    _check_args(loc, raw_scale, mask)
    seed = int(seed)
    scale = _softplus(raw_scale)
    sig_rs = torch.sigmoid(raw_scale)
    gloc = torch.zeros_like(loc)
    grs = torch.zeros_like(raw_scale)
    for s in range(S):
        eps = draw_eps(loc.shape[0], s, seed, loc.dtype, loc.device)
        dy_dloc, dy_drs, dlq_dloc, dlq_drs = _ntile_bwd(loc, scale, sig_rs,
                                                        mask, eps)
        gloc = gloc + gy[s] * dy_dloc + glq[s] * dlq_dloc
        grs = grs + gy[s] * dy_drs + glq[s] * dlq_drs
    return gloc, grs


# ---------------------------------------------------------------- kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "normal_fwd": [_P] * 7 + [_I] * 2 + [_P],
    "normal_bwd": [_P] * 8 + [_I] * 2 + [_P],
    "normal_fwd_blocks": [_I],
    "normal_kernel_info": [_I] * 2 + [_P],
}


def _lib():
    return _build.load_library("fused_normal", _SIGNATURES)


def _check_cuda(seed, S, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(
                "the fused Normal kernel takes contiguous float32 CUDA "
                f"tensors on one device, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32
            or seed.numel() != 1 or seed.device != dev):
        raise ValueError("seed must be a one-element int32 tensor on the "
                         "kernel's device")
    if not 1 <= S <= MAX_SAMPLES or tensors[0].shape[0] == 0:
        raise ValueError(f"the fused Normal kernel takes 1 to {MAX_SAMPLES} "
                         f"samples of a non-empty block, got S={S}, "
                         f"total={tensors[0].shape[0]}")


def _kernel_fwd(loc, raw_scale, mask, seed, S):
    _check_args(loc, raw_scale, mask)
    _check_cuda(seed, S, loc, raw_scale, mask)
    total = loc.shape[0]
    lib = _lib()
    y = torch.empty((S, total), dtype=torch.float32, device=loc.device)
    part = torch.empty((S, lib.normal_fwd_blocks(total)), dtype=torch.float64,
                       device=loc.device)
    lq = torch.empty((S,), dtype=torch.float32, device=loc.device)
    err = lib.normal_fwd(
        loc.data_ptr(), raw_scale.data_ptr(), mask.data_ptr(),
        seed.data_ptr(), y.data_ptr(), part.data_ptr(), lq.data_ptr(), total,
        S, torch.cuda.current_stream(loc.device).cuda_stream)
    _build.check(err, "normal_fwd")
    LAUNCHES["fwd"] += 1
    return y, lq


def _kernel_bwd(loc, raw_scale, mask, seed, S, gy, glq):
    _check_args(loc, raw_scale, mask)
    gy = gy.to(torch.float32).contiguous()
    glq = glq.to(torch.float32).contiguous()
    _check_cuda(seed, S, loc, raw_scale, mask, gy, glq)
    total = loc.shape[0]
    if gy.shape != (S, total) or glq.shape != (S,):
        raise ValueError(f"cotangent shapes {tuple(gy.shape)}, "
                         f"{tuple(glq.shape)} do not match S={S}, "
                         f"total={total}")
    gloc = torch.empty_like(loc)
    grs = torch.empty_like(raw_scale)
    err = _lib().normal_bwd(
        loc.data_ptr(), raw_scale.data_ptr(), mask.data_ptr(),
        seed.data_ptr(), glq.data_ptr(), gy.data_ptr(), gloc.data_ptr(),
        grs.data_ptr(), total, S,
        torch.cuda.current_stream(loc.device).cuda_stream)
    _build.check(err, "normal_bwd")
    LAUNCHES["bwd"] += 1
    return gloc, grs


def kernel_info(kind, S=8):
    """What the built library reports for K6f (``'fwd'``, at S samples) or
    K6b (``'bwd'``): registers per thread, static and dynamic shared memory
    per block, and resident blocks per SM (the occupancy API's). Needs the
    card."""
    info = (ctypes.c_int * 4)()
    err = _lib().normal_kernel_info(int(kind == "fwd"), S, info)
    _build.check(err, "normal_kernel_info")
    return dict(zip(("registers", "static_smem_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


class _FusedNormal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loc, raw_scale, mask, seed, S):
        fwd = _kernel_fwd if loc.is_cuda else normal_twin_fwd
        y, lq = fwd(loc, raw_scale, mask, seed, S)
        ctx.save_for_backward(loc, raw_scale, mask, seed)
        ctx.S = S
        return y, lq

    @staticmethod
    def backward(ctx, gy, glq):
        loc, raw_scale, mask, seed = ctx.saved_tensors
        S = ctx.S
        if gy is None:
            gy = loc.new_zeros((S, loc.shape[0]))
        if glq is None:
            glq = loc.new_zeros((S,))
        bwd = _kernel_bwd if loc.is_cuda else normal_twin_bwd
        gloc, grs = bwd(loc, raw_scale, mask, seed, S, gy, glq)
        return gloc, grs, None, None, None


def fused_normal_sample_logq(loc_flat, raw_scale_flat, mask_flat, seed, S):
    """Sample the Normal surrogates S times (pathwise), bijector applied.

    loc_flat, raw_scale_flat: (total,) location and unconstrained scale;
    mask_flat: (total,), 1.0 where the bijector is softplus and 0.0 for
    identity (no gradient); seed: a one-element int32 tensor on the same
    device (read by the kernel on the device, so drawing it costs no host
    sync); S: sample count. Returns y (S, total) and logq (S,), which
    includes the -fldj correction. CUDA tensors go through the kernels
    (float32 only, anything else raises); CPU tensors through the twin."""
    return _FusedNormal.apply(loc_flat.contiguous(),
                              raw_scale_flat.contiguous(),
                              mask_flat.contiguous(), seed.reshape(1), S)
