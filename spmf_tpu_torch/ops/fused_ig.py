"""Fused InverseGamma-surrogate sampler: the CUDA kernel K3 and its twin.

Port of spmf_tpu/ops/fused_ig.py. The horseshoe+ auxiliary block (8
InverseGamma surrogates, ~1.4M parameters at D=20000, K=32) is sampled S
times per step. Per element and sample: 9 uniforms, eps = sqrt(2)
erfinv(2u-1), the 8 Stuart log-uniform sums, the boosted Wilson–Hilferty
gamma g, y = softplus(b / g), and the per-sample sum of
log q_IG(b/g) - fldj_softplus(b/g).

Randomness: Philox4x32-10 with key (seed, 0) and counter
(flat element index, stream, j, 0) for j = 0, 1, 2; the 9 uniforms are the
first 9 of the 12 words, U_j = (word_j >> 9) 2^-23 + 2^-24, in the order
``_draw_eps_s1_s2`` consumes them. Independent mode: stream = s.
Antithetic: stream = s % (S/2), and the second half mirrors U -> 1-U.
Stratified: stream 0 serves every sample of an element; pair p = s % (S/2)
adds ``lattice_shift((p * _LATTICE_GENS[j]) % (S/2), S/2)`` to the 23-bit
integer word_j >> 9 modulo 2^23 (j = 0 is eps, 1..8 the boost uniforms, the
Korobov lattice of spmf_tpu's kernel), and the second half mirrors. The
stream is keyed by element, not by tile, so the CUDA kernel
(``csrc/fused_ig.cu``) and the plain PyTorch twin below draw the same bits
and can be compared element by element.

``fused_ig_sample_logq`` launches the kernel for CUDA tensors (float32
only) and runs the twin for CPU tensors; its backward replays the stream
(no samples are saved).
"""
from __future__ import annotations

import ctypes

import torch

from spmf_tpu_torch.bijectors import softplus as _softplus
from spmf_tpu_torch.ops import _build
from spmf_tpu_torch.ops.gamma import (_LATTICE_GENS, _wh_value, lattice_shift,
                                     wilson_hilferty_gamma)

__all__ = ["LAUNCHES", "fused_ig_sample_logq", "ig_sample_logq_reference",
           "ig_twin_fwd", "ig_twin_bwd", "kernel_info", "lattice_shift",
           "philox4x32", "uniform_from_bits", "uniforms"]

BOOST = 8
_SQRT2 = 1.4142135623730951
_MODES = {False: 0, True: 1, "stratified": 2}
#: the most samples one K3f launch takes (its per-sample block sums fill
#: 64 bytes of shared memory each)
MAX_SAMPLES = 2048

#: kernel launches, counted by the wrappers where they launch
LAUNCHES = {"fwd": 0, "bwd": 0}


# ----------------------------------------------------------------- Philox
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(m, b):
    """(hi, lo) 32-bit halves of m * b for uint32 values held in int64: b is
    split into 16-bit halves so no product exceeds 2^48."""
    p_hi = m * (b >> 16)
    p_lo = m * (b & 0xFFFF)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _u23_to_uniform(m, dtype):
    return m.to(dtype) * 2.0 ** -23 + 2.0 ** -24


def uniform_from_bits(bits, dtype):
    """U = (bits >> 9) 2^-23 + 2^-24, on [2^-24, 1 - 2^-24] (log-safe,
    exactly mirrorable), from uint32 words held in int64."""
    return _u23_to_uniform(bits >> 9, dtype)


def _pair_shifts(p, half):
    """The bit-domain shifts of pair p for the 9 uniforms of a draw."""
    return [lattice_shift((p * g) % half, half) for g in _LATTICE_GENS]


def uniforms(total, stream, seed, dtype, device, pair=None, half=1):
    """The 9 uniforms (9, total) of one stream, on the grid of
    ``uniform_from_bits``; with ``pair``, the stratified uniforms of that
    pair of ``half`` (each 23-bit integer shifted by ``_pair_shifts``)."""
    idx = torch.arange(total, dtype=torch.int64, device=device)
    zero = torch.zeros_like(idx)
    words = []
    for j in range(3):
        words.extend(philox4x32(idx, zero + stream, zero + j, zero,
                                int(seed) & _MASK, 0))
    m = torch.stack(words[:BOOST + 1]) >> 9
    if pair is not None:
        shift = torch.tensor(_pair_shifts(pair, half), dtype=torch.int64,
                             device=device)
        m = (m + shift[:, None]) & 0x7FFFFF
    return _u23_to_uniform(m, dtype)


def _mode(antithetic):
    """The kernel's mode: 0 independent, 1 antithetic, 2 stratified."""
    if antithetic not in _MODES:
        raise ValueError(f"antithetic must be False, True or 'stratified', "
                         f"got {antithetic!r}")
    return _MODES[antithetic]


def _draw_eps_s1_s2(a, seed, s, S, antithetic):
    """eps, s1, s2 for sample ``s`` (the replay contract of fwd and bwd)."""
    mode = _mode(antithetic)
    half = S // 2 if mode else S
    if mode == 2:
        u = uniforms(a.shape[0], 0, seed, a.dtype, a.device, pair=s % half,
                     half=half)
    else:
        u = uniforms(a.shape[0], s % half, seed, a.dtype, a.device)
    if mode and s >= half:
        u = 1.0 - u
    eps = _SQRT2 * torch.erfinv(2.0 * u[0] - 1.0)
    w = 1.0 / (a + torch.arange(BOOST, dtype=a.dtype,
                                device=a.device)[:, None])
    logu = torch.log(u[1:])
    return eps, torch.sum(logu * w, 0), torch.sum(logu * w * w, 0)


# -------------------------------------------------------------- tile math
def _tile_fwd(a, b, logb, t0, eps, s1):
    """y = softplus(b / G_a) and logq = log q_IG(x) - fldj_softplus(x),
    x = b / G_a, with t0 = a log b - lgamma(a):
    logq = t0 - (a+1)(log b - log g) - g + softplus(-x)."""
    g = _wh_value(a, eps, s1, BOOST)
    x = b / g
    y = _softplus(x)
    lq = t0 - (a + 1.0) * (logb - torch.log(g)) - g + _softplus(-x)
    return y, lq


def _tile_bwd(a, b, logb, dg0, eps, s1, s2):
    """Pathwise d(y, logq)/d(a, b) with the base randomness held fixed;
    dg0 = log b - digamma(a). Returns (dy_da, dy_db, dlq_da, dlq_db)."""
    ab = a + float(BOOST)
    sqrt_ab = torch.sqrt(ab)
    c = 1.0 - 1.0 / (9.0 * ab) + eps / (3.0 * sqrt_ab)
    cc = torch.clamp_min(c, 0.05)
    active_c = (c > 0.05).to(a.dtype)
    g_raw = ab * cc ** 3 * torch.exp(s1)
    floor = torch.finfo(a.dtype).tiny ** 0.5
    g = torch.clamp_min(g_raw, floor)
    not_floored = (g_raw > floor).to(a.dtype)
    x = b / g
    sig_x = torch.sigmoid(x)

    dc_da = 1.0 / (9.0 * ab * ab) - eps / (6.0 * ab * sqrt_ab)
    dlogg_da = (1.0 / ab + 3.0 * active_c * dc_da / cc - s2) * not_floored
    dx_da = -x * dlogg_da
    dx_db = 1.0 / g
    dy_da = sig_x * dx_da
    dy_db = sig_x * dx_db
    dlq_da = (dg0 - (logb - torch.log(g)) + (a + 1.0) * dlogg_da
              - g * dlogg_da - (1.0 - sig_x) * dx_da)
    dlq_db = -1.0 / b - (1.0 - sig_x) * dx_db
    return dy_da, dy_db, dlq_da, dlq_db


# ------------------------------------------------------------------ twin
def _check_args(a, b, S, antithetic):
    if a.dim() != 1 or a.shape != b.shape:
        raise ValueError(f"a, b must be flat and equal-shaped, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if _mode(antithetic) and S % 2:
        raise ValueError(f"antithetic sampling needs an even S, got {S}")


def ig_twin_fwd(a, b, seed, S, antithetic=False):
    """Plain PyTorch K3f: y (S, total), lq (S,), any dtype and device.
    Differentiable in (a, b) by autograd (the draws are constants)."""
    _check_args(a, b, S, antithetic)
    seed = int(seed)
    logb = torch.log(b)
    t0 = a * logb - torch.lgamma(a)
    ys, lqs = [], []
    for s in range(S):
        eps, s1, _ = _draw_eps_s1_s2(a, seed, s, S, antithetic)
        y, lq = _tile_fwd(a, b, logb, t0, eps, s1)
        ys.append(y)
        lqs.append(lq.sum())
    return torch.stack(ys), torch.stack(lqs)


def ig_twin_bwd(a, b, seed, S, antithetic, gy, glq):
    """Plain PyTorch K3b: replays the stream and returns (ga, gb)."""
    _check_args(a, b, S, antithetic)
    seed = int(seed)
    logb = torch.log(b)
    dg0 = logb - torch.digamma(a)
    ga = torch.zeros_like(a)
    gb = torch.zeros_like(b)
    for s in range(S):
        eps, s1, s2 = _draw_eps_s1_s2(a, seed, s, S, antithetic)
        dy_da, dy_db, dlq_da, dlq_db = _tile_bwd(a, b, logb, dg0, eps, s1, s2)
        ga = ga + gy[s] * dy_da + glq[s] * dlq_da
        gb = gb + gy[s] * dy_db + glq[s] * dlq_db
    return ga, gb


# ---------------------------------------------------------------- kernel
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ig_fwd": [_P] * 7 + [_I] * 3 + [_P],
    "ig_bwd": [_P] * 8 + [_I] * 3 + [_P],
    "ig_kernel_info": [_I] * 3 + [_P],
}
_THREADS = 256
_SHIFT_TABLES: dict = {}


def _lib():
    return _build.load_library("fused_ig", _SIGNATURES)


def _shift_table(half, device):
    """The stratified mode's (half, 9) int32 table of ``_pair_shifts``, made
    once per (half, device) and kept."""
    key = (half, str(device))
    if key not in _SHIFT_TABLES:
        _SHIFT_TABLES[key] = torch.tensor(
            [_pair_shifts(p, half) for p in range(half)], dtype=torch.int32,
            device=device)
    return _SHIFT_TABLES[key]


def _check_cuda(seed, S, *tensors):
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "the fused IG kernel takes contiguous float32 CUDA tensors, "
                f"got {t.dtype} on {t.device} (contiguous="
                f"{t.is_contiguous()})")
    if (not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32
            or seed.numel() != 1 or seed.device != tensors[0].device):
        raise ValueError("seed must be a one-element int32 tensor on the "
                         "kernel's device")
    if not 1 <= S <= MAX_SAMPLES or tensors[0].shape[0] == 0:
        raise ValueError(f"the fused IG kernel takes 1 to {MAX_SAMPLES} "
                         f"samples of a non-empty block, got S={S}, "
                         f"total={tensors[0].shape[0]}")


def _launch_args(a, S, antithetic):
    """(mode, the shift table's pointer or 0, the current stream)."""
    mode = _mode(antithetic)
    shifts = _shift_table(S // 2, a.device).data_ptr() if mode == 2 else 0
    return mode, shifts, torch.cuda.current_stream(a.device).cuda_stream


def _kernel_fwd(a, b, seed, S, antithetic):
    _check_args(a, b, S, antithetic)
    _check_cuda(seed, S, a, b)
    total = a.shape[0]
    mode, shifts, stream = _launch_args(a, S, antithetic)
    y = torch.empty((S, total), dtype=torch.float32, device=a.device)
    part = torch.empty((S, -(-total // _THREADS)), dtype=torch.float64,
                       device=a.device)
    lq = torch.empty((S,), dtype=torch.float32, device=a.device)
    err = _lib().ig_fwd(
        a.data_ptr(), b.data_ptr(), seed.data_ptr(), shifts, y.data_ptr(),
        part.data_ptr(), lq.data_ptr(), total, S, mode, stream)
    _build.check(err, "ig_fwd")
    LAUNCHES["fwd"] += 1
    return y, lq


def _kernel_bwd(a, b, seed, S, antithetic, gy, glq):
    _check_args(a, b, S, antithetic)
    gy = gy.to(torch.float32).contiguous()
    glq = glq.to(torch.float32).contiguous()
    _check_cuda(seed, S, a, b, gy, glq)
    if gy.shape != (S, a.shape[0]) or glq.shape != (S,):
        raise ValueError(f"cotangent shapes {tuple(gy.shape)}, "
                         f"{tuple(glq.shape)} do not match S={S}, "
                         f"total={a.shape[0]}")
    mode, shifts, stream = _launch_args(a, S, antithetic)
    ga = torch.empty_like(a)
    gb = torch.empty_like(b)
    err = _lib().ig_bwd(
        a.data_ptr(), b.data_ptr(), seed.data_ptr(), shifts, glq.data_ptr(),
        gy.data_ptr(), ga.data_ptr(), gb.data_ptr(), a.shape[0], S, mode,
        stream)
    _build.check(err, "ig_bwd")
    LAUNCHES["bwd"] += 1
    return ga, gb


def kernel_info(kind, antithetic=False, S=8):
    """What the built library reports for K3f (``'fwd'``, at S samples) or
    K3b (``'bwd'``) in a mode: registers per thread, static and dynamic
    shared memory per block, and resident blocks per SM (the occupancy
    API's). Needs the card."""
    info = (ctypes.c_int * 4)()
    err = _lib().ig_kernel_info(int(kind == "fwd"), _mode(antithetic), S,
                                info)
    _build.check(err, "ig_kernel_info")
    return dict(zip(("registers", "static_smem_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


class _FusedIG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, seed, S, antithetic):
        fwd = _kernel_fwd if a.is_cuda else ig_twin_fwd
        y, lq = fwd(a, b, seed, S, antithetic)
        ctx.save_for_backward(a, b, seed)
        ctx.S, ctx.antithetic = S, antithetic
        return y, lq

    @staticmethod
    def backward(ctx, gy, glq):
        a, b, seed = ctx.saved_tensors
        S = ctx.S
        if gy is None:
            gy = a.new_zeros((S, a.shape[0]))
        if glq is None:
            glq = a.new_zeros((S,))
        bwd = _kernel_bwd if a.is_cuda else ig_twin_bwd
        ga, gb = bwd(a, b, seed, S, ctx.antithetic, gy, glq)
        return ga, gb, None, None, None


def fused_ig_sample_logq(a_flat, b_flat, seed, S, antithetic=False):
    """Sample y = softplus(InverseGamma(a, b)) pathwise, S times.

    a_flat, b_flat: (total,) constrained concentration / scale; seed: a
    one-element int32 tensor on the same device (read by the kernel on the
    device, so drawing it costs no host sync); S: sample count; antithetic:
    samples s and s + S/2 use mirrored draws, and 'stratified' also
    lattice-couples the S/2 pairs (one base draw per element, pair p
    shifted by the Korobov lattice in the bit domain, as in spmf_tpu's
    kernel; the module docstring has the stream). Returns y (S, total) and
    logq (S,), the summed IG log-density minus the softplus
    forward-log-det-Jacobian. CUDA tensors go through the kernel (float32
    only, anything else raises); CPU tensors through the twin."""
    return _FusedIG.apply(a_flat.contiguous(), b_flat.contiguous(),
                          seed.reshape(1), S, antithetic)


def ig_sample_logq_reference(a_flat, b_flat, generator, S, antithetic=False):
    """The plain path of ``fused_ig_sample_logq`` on a flat block (spmf_tpu's
    ``ig_sample_logq_reference``): the 'fast' Wilson–Hilferty draws of
    ``SurrogatePosterior._sample_igs`` from ``generator`` in place of the
    kernel's Philox stream, for statistical tests. Returns y (S, total) and
    logq (S,)."""
    g = wilson_hilferty_gamma(generator, a_flat.expand((S,) + a_flat.shape),
                              antithetic=antithetic)
    x = b_flat / g
    lq = (a_flat * torch.log(b_flat) - torch.lgamma(a_flat)
          - (a_flat + 1.0) * torch.log(x) - b_flat / x + _softplus(-x))
    return _softplus(x), torch.sum(lq, dim=-1)
