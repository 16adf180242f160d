"""Fused decode + likelihood kernels and their twins: K1/K2 (clipped
log-likelihood sums with their gradients), K4 (per-row log-likelihood sums)
and K5 (the exp-rate total of the sparse energy).

Port of spmf_tpu/ops/fused_poisson.py (``fused_poisson_loglik`` and the
``_fused_stats`` / ``_fused_sum_static`` custom VJPs,
``fused_poisson_row_loglik`` and ``fused_exp_rate_sum``). Per ELBO sample s:

    rate = f(theta_s @ v_s) * eta + phi_s      f: identity, or exp(.) - 1
    ll   = x log(rate) - rate - lgamma(x + 1)  (likelihood='poisson')
    out  = sum(clip(ll, m, 0), non-finite -> m),  m = max(min(finite ll) - 10,
                                                      FLOOR) in float32

K1/K2 and K4 carry a likelihood selector, as the TPU kernels do:
``'poisson'``, ``'bernoulli'`` (rate as logits), ``('normal', obs_scale)``,
``'poisson_softplus'`` (Poisson at softplus(rate)) and
``('mixed', obs_scale)``, which picks one of the last three per column from
a (1, D) ``codes`` lane (CODE_POISSON / CODE_BERNOULLI / CODE_NORMAL).

With the clip decomposition (see the JAX module docstring) one sweep emits
per sample the sum of min(ll, 0) over finite ll > FLOOR, the count of the
other cells and the global finite minimum; the bound ``m`` combines outside,
as a constant to autograd. The same sweep emits the gradients at unit
cotangent, so the backward is a per-sample scalar rescale. ``clip='static'``
clips at the constant FLOOR (the K2 flag of the same kernel): identical
values on healthy data, identical gradients always.

``fused_poisson_row_loglik`` sums the unclipped ll over features per row,
(S, B), for WAIC and held-out scoring; it has no gradient. The sparse
energy's rate total under the log link, R_s = sum exp((theta_s @ v_s) *
eta), is ``fused_exp_rate_sum``; like K1 its kernel emits the gradients at
unit cotangent from the same tiles, so the backward is a rescale.

Each wrapper launches its kernel (K1/K2 and K4 in ``csrc/fused_poisson.cu``,
or past the latent dimensions its whole-K kernel takes in
``csrc/fused_poisson_wide.cu``; K5 in ``csrc/fused_expsum.cu``) for CUDA
tensors, at every latent dimension K >= 1, and runs its twin
(``stats_twin``, ``row_loglik_twin``, ``expsum_twin``) for CPU tensors. The
twins are the explicit formulas over the whole (B, D) slab of each sample,
for any dtype and device.
"""
from __future__ import annotations

import ctypes
import math
import typing

import numpy as np
import torch

from spmf_tpu_torch.bijectors import softplus as _softplus
from spmf_tpu_torch.ops import _build

__all__ = ["CODE_BERNOULLI", "CODE_NORMAL", "CODE_POISSON", "FLOOR",
           "LAUNCHES", "LaunchGeometry", "bernoulli_loglik_reference",
           "expsum_twin", "fused_exp_rate_sum", "fused_poisson_loglik",
           "fused_poisson_loglik_sharded", "fused_poisson_row_loglik",
           "fused_poisson_row_loglik_sharded", "kernel_info",
           "launch_geometry",
           "lgamma_table", "normal_loglik_reference",
           "poisson_loglik_reference", "row_loglik_twin", "stats_twin"]

FLOOR = -1e27  # static clip-bound floor (see _floor_min_val)
_HALF_LOG_2PI = 0.9189385332046727

#: per-column type codes of the ('mixed', obs_scale) likelihood: a (1, D)
#: float lane selects each column's log-density
CODE_POISSON, CODE_BERNOULLI, CODE_NORMAL = 0.0, 1.0, 2.0

#: the selector as the kernels take it (LIK_* in csrc/fused_poisson.cu)
_LIKELIHOODS = {"poisson": 0, "bernoulli": 1, "normal": 2,
                "poisson_softplus": 3, "mixed": 4}


def _check_likelihood(likelihood, codes):
    """Validate the likelihood selector: an unknown value raises, and so
    does ``('mixed', s)`` without the per-column ``codes`` lane (zeros would
    make every column Poisson)."""
    if likelihood in ("poisson", "bernoulli", "poisson_softplus"):
        return
    if (isinstance(likelihood, tuple) and len(likelihood) == 2
            and likelihood[0] in ("normal", "mixed")
            and isinstance(likelihood[1], (int, float))):
        if likelihood[0] == "mixed" and codes is None:
            raise ValueError(
                "likelihood=('mixed', obs_scale) requires the per-column "
                "codes lane (codes=None would default every column to "
                "Poisson)")
        return
    raise ValueError(
        f"unknown likelihood {likelihood!r}: expected 'poisson', "
        "'bernoulli', 'poisson_softplus', ('normal', obs_scale) or "
        "('mixed', obs_scale)")


def _split_likelihood(likelihood):
    """(family name, obs_scale) of a validated selector."""
    if isinstance(likelihood, tuple):
        return likelihood[0], float(likelihood[1])
    return likelihood, 1.0

#: kernel launches, counted by the wrappers where they launch: "stats" for
#: clip='reference' (K1), "static" for clip='static' (K2), "row_ll" (K4) and
#: "expsum" (K5); with "_wide" where the K-chunked kernel ran (past the
#: latent dimensions the whole-K kernels take: K1/K2 padded K > 124, K4 and
#: K5 K > 64)
LAUNCHES = {"stats": 0, "static": 0, "row_ll": 0, "expsum": 0,
            "stats_wide": 0, "static_wide": 0, "row_ll_wide": 0,
            "expsum_wide": 0}


def _count(key, geom):
    LAUNCHES[key + ("_wide" if geom.chunks > 1 else "")] += 1


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


def _clip_sum(ll):
    """The reference's clip / sum frame: clip at [min(finite ll) - 10, 0],
    non-finite cells at the bound, summed over rows and features."""
    finite = torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll))
    min_val = _floor_min_val(torch.min(finite) - 10.0)
    ll = torch.minimum(torch.maximum(ll, min_val), torch.zeros_like(ll))
    ll = torch.where(torch.isfinite(ll), ll, min_val)
    return torch.sum(ll, dim=(-1, -2))


def poisson_loglik_reference(theta, v, phi, x, eta, log_transform=False):
    """Plain autograd version of the same semantics (full autodiff,
    including the clip bound's gradient)."""
    rate = _decode_rate(torch.matmul(theta, v), eta, phi, log_transform)
    return _clip_sum(x * _safe_log(rate) - rate - torch.lgamma(x + 1.0))


def normal_loglik_reference(theta, v, phi, x, eta, obs_scale=1.0,
                            log_transform=False):
    """Plain autograd Normal(loc=rate, scale=obs_scale) counterpart of
    ``poisson_loglik_reference``."""
    rate = _decode_rate(torch.matmul(theta, v), eta, phi, log_transform)
    r = (x - rate) / obs_scale
    return _clip_sum(-0.5 * r * r - (math.log(obs_scale) + _HALF_LOG_2PI))


def bernoulli_loglik_reference(theta, v, phi, x, eta, log_transform=False):
    """Plain autograd Bernoulli(logits=rate) counterpart of
    ``poisson_loglik_reference``."""
    logits = _decode_rate(torch.matmul(theta, v), eta, phi, log_transform)
    return _clip_sum(x * logits - _softplus(logits))


def _cell_ll(x, rate, lgx, likelihood, codes, grads=True):
    """(ll, dll) per cell for a likelihood selector, the explicit formulas
    of the kernels' ``cell_ll``; dll = d ll / d rate (None unless
    ``grads``). ``lgx`` = lgamma(x + 1), where the selector needs it."""
    name, obs_scale = _split_likelihood(likelihood)
    tiny = torch.finfo(rate.dtype).tiny

    def gated(lam):  # x / lam, an underflowed lam contributing nothing
        return torch.where(lam > tiny, x / torch.clamp_min(lam, tiny),
                           torch.zeros_like(lam))

    if name == "poisson":
        ll = x * _safe_log(rate) - rate - lgx
        return ll, (gated(rate) - 1.0 if grads else None)
    sig = torch.sigmoid(rate) if grads else None
    if name == "bernoulli":
        return x * rate - _softplus(rate), (x - sig if grads else None)
    r = (x - rate) / obs_scale
    ll_n = -0.5 * r * r - (math.log(obs_scale) + _HALF_LOG_2PI)
    if name == "normal":
        return ll_n, (r / obs_scale if grads else None)
    # the softplus link, with a plain log (an underflowed lam is -inf / NaN)
    lam = _softplus(rate)
    ll_p = x * torch.log(lam) - lam - lgx
    dll_p = (gated(lam) - 1.0) * sig if grads else None
    if name == "poisson_softplus":
        return ll_p, dll_p
    # mixed: a select per column, never a multiply by a 0/1 mask (the
    # branch not taken may hold NaN)
    is_b, is_n = codes == CODE_BERNOULLI, codes == CODE_NORMAL
    ll = torch.where(is_b, x * rate - lam, torch.where(is_n, ll_n, ll_p))
    if not grads:
        return ll, None
    return ll, torch.where(is_b, x - sig,
                           torch.where(is_n, r / obs_scale, dll_p))


def _lgamma_xp1(x, likelihood):
    """lgamma(x + 1) where the selector has a Poisson branch, else 0."""
    if _split_likelihood(likelihood)[0] in ("bernoulli", "normal"):
        return torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.lgamma(x + 1.0)


def stats_twin(theta, v, phi, x, eta, log_transform=False, static=False,
               likelihood="poisson", codes=None):
    """Plain PyTorch K1/K2: (sums (S,), counts (S,) int32, gmin (1,),
    dtheta (S,B,K), dv (S,K,D), dphi (S,1,D)) — the kernel's outputs, from
    the explicit ``_tile_ll_grads`` formulas (not autograd through a clip).
    ``static``: clipped cells add FLOOR to the sums; counts and gmin are
    zeros. Loops over samples so one (B, D) slab is live at a time."""
    _check_likelihood(likelihood, codes)
    S = theta.shape[0]
    dtype = theta.dtype
    lgx = _lgamma_xp1(x, likelihood)
    sums, cnts, dths, dvs, dphis = [], [], [], [], []
    gmin = torch.zeros((), dtype=dtype, device=theta.device)
    for s in range(S):
        tv = theta[s] @ v[s]
        if log_transform:
            ev = torch.exp(tv * eta)
            rate = ev - 1.0 + phi[s]
        else:
            rate = tv * eta + phi[s]
        ll, dll = _cell_ll(x, rate, lgx, likelihood, codes)
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


def row_loglik_twin(theta, v, phi, x, eta, log_transform=False,
                    likelihood="poisson", codes=None):
    """Plain PyTorch K4: (S, B) per-row sums over features of the UNCLIPPED
    ll, through the same ``_decode_rate`` and per-cell formulas (under
    'poisson' a negative rate makes its row NaN). Loops over samples so one
    (B, D) slab is live at a time."""
    _check_likelihood(likelihood, codes)
    lgx = _lgamma_xp1(x, likelihood)
    rows = []
    for s in range(theta.shape[0]):
        rate = _decode_rate(theta[s] @ v[s], eta, phi[s], log_transform)
        rows.append(_cell_ll(x, rate, lgx, likelihood, codes,
                             grads=False)[0].sum(-1))
    return torch.stack(rows)


def expsum_twin(theta, v, eta):
    """Plain PyTorch K5: (R (S,), dtheta (S,B,K), dv (S,K,D)) with
    R_s = sum exp((theta_s @ v_s) * eta) and its gradients at unit
    cotangent. Loops over samples so one (B, D) slab is live at a time."""
    sums, dths, dvs = [], [], []
    for s in range(theta.shape[0]):
        ev = torch.exp((theta[s] @ v[s]) * eta)
        sums.append(ev.sum())
        dtv = ev * eta
        dths.append(dtv @ v[s].T)
        dvs.append(theta[s].T @ dtv)
    return torch.stack(sums), torch.stack(dths), torch.stack(dvs)


# ---------------------------------------------------------------- kernels
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"poisson_stats": [_P] * 13 + [_I] * 7 + [_F] * 2 + [_P],
               "poisson_row_ll": [_P] * 8 + [_I] * 6 + [_F] * 2 + [_P],
               "poisson_smem_bytes": [_I, _I],
               "poisson_kernel_info": [_I, _I, _P]}
_WIDE_SIGNATURES = {"poisson_stats_wide": _SIGNATURES["poisson_stats"],
                    "poisson_row_ll_wide": _SIGNATURES["poisson_row_ll"],
                    "poisson_wide_kernel_info": [_I, _P]}
_EXPSUM_SIGNATURES = {"poisson_expsum": [_P] * 6 + [_I] * 4 + [_P],
                      "expsum_smem_bytes": [_I],
                      "expsum_kernel_info": [_I, _P]}
# The tilings of csrc/fused_poisson.cuh and csrc/fused_expsum.cu (their
# constants of the same names; the GPU tests hold launch_geometry to the
# libraries' poisson_smem_bytes and expsum_smem_bytes).
_THREADS, _TB, _TD, _K_STEP = 256, 128, 64, 4
_TBP, _TP, _NLANE, _TABLE_N = _TB + 4, _TD + 4, 3, 64
# K5: k-steps of 8 (mma.m16n8k8), an instance per k-step to K = 64 (its
# dtheta sums live in registers); v and G tiles at pitch 72, two blocks an
# SM to K = 32
_EXPSUM_K_STEP, _VP = 8, _TD + 8
# the switches of K4 and K5: their whole-K kernels to padded K = 64, the
# split-TF32 wide kernels past it (K1/K2's whole-K tiles end where they fit)
_WHOLE_K_MAX = {"row_ll": 64, "expsum": 64}
# the wide K1/K2 and K5 (csrc/split_tf32.cuh): chunks of 32 latent
# dimensions; one size of shared memory, the larger of the layout that keeps
# everything on chip to padded K = 128 (theta [128][132], the tile's split
# v [2][128][72], two raw v stages [32][64], split G [2][128][68]) and the
# streaming one past it; then K1/K2's lanes, dphi rows and table, or K5's
# eta
_W_KC = 32
_W_RES = (_TB * (4 * _W_KC + 4) + 2 * 4 * _W_KC * (_TD + 8) + 2 * _W_KC * _TD
          + 2 * _TB * (_TD + 4))
# the wide K4 on the same decode: theta on chip to padded K = 256 ([128][260];
# past it two streamed chunks), two raw v chunks [32][64], two split ones
# [2][32][72], one x tile at pitch 72, its lanes, the table
_RL_KRES = 256
_RL_WIDE = (_TB * (_RL_KRES + 4) + 2 * _W_KC * _TD + 2 * 2 * _W_KC * _VP
            + _TB * (_TD + 8) + _NLANE * _TD + _TABLE_N)
_RL_THREADS = 512           # 16 warps: 8 row groups x 2 column halves
_STATIC_SMEM = {"stats": 128, "expsum": 8 * 8, "row_ll": 8 * _TB}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use
_SMEM_PER_SM = 233472       # ... and an SM holds, each block reserving 1 KB


class LaunchGeometry(typing.NamedTuple):
    """How one launch of a fused_poisson.cu kernel is cut into blocks."""
    kind: str            # 'stats' (K1/K2), 'row_ll' (K4) or 'expsum' (K5)
    samples: int
    rows: int
    threads: int         # per block
    row_tile: int        # rows a block owns
    col_tile: int        # columns per step of a block's loop
    k_step: int
    k_padded: int        # K padded with zeros to a multiple of k_step
    k_chunk: int         # latent dimensions a block holds at once: k_padded,
                         # or past the whole-K tiles the wide kernel's chunk
    chunks: int          # k-chunks a column tile walks (1: the whole-K kernel)
    stages: int          # buffers of the v tile (or chunk) in shared memory
    smem_bytes: int      # dynamic shared memory per block
    static_smem_bytes: int
    blocks_per_sm: int   # resident blocks an SM's shared memory allows (K5:
                         # and its launch bounds, 2 to K = 32, else 1)
    row_tiles: int
    col_tiles: int
    grid: int            # blocks: samples * row_tiles

    def block(self, i):
        """(sample, first row, one past the last row) of block ``i``:
        samples of one row tile are adjacent in the grid."""
        r0 = (i // self.samples) * self.row_tile
        return i % self.samples, r0, min(r0 + self.row_tile, self.rows)


def launch_geometry(kind, S, B, K, D):
    """The launch geometry of K1/K2 (``'stats'``), K4 (``'row_ll'``) or K5
    (``'expsum'``) at theta (S, B, K) and D features: the whole-K kernel
    while its tiles fit a block's shared memory (K1/K2 to padded K = 124)
    or to its switch (K4 and K5 to K = 64), the K-chunked wide kernel past
    that; raises ``ValueError`` only for K < 1. Plain arithmetic on the
    tiling constants: no card needed."""
    if kind not in _STATIC_SMEM:
        raise ValueError(f"unknown kernel kind {kind!r}")
    if K < 1:
        raise ValueError(f"latent dim K={K}: the kernels take K >= 1")
    k_step = _EXPSUM_K_STEP if kind == "expsum" else _K_STEP
    kp = -(-K // k_step) * k_step
    static = _STATIC_SMEM[kind]
    v_tile = (kp + _NLANE) * _TP          # v rows, then eta, phi, codes
    if kind == "row_ll":                  # theta^T, 2 x (v, x), the table
        floats = kp * _TBP + 2 * v_tile + 2 * _TB * _TD + _TABLE_N
        # wide: the split-TF32 decode's layout, x and its lanes, the table
        wide = _RL_WIDE
        stages, wide_chunk = 2, _W_KC
    elif kind == "stats":  # theta^T, dtheta, v, x, dtv, dphi, the table
        floats = (kp * _TBP + _TB * kp + v_tile + _TB * _TD + _TB * _TP
                  + _TD + _TABLE_N)
        # wide: the split-TF32 layout, the lanes, a row of dphi a warp, the
        # table
        wide = _W_RES + _NLANE * _TD + (_THREADS // 32) * _TD + _TABLE_N
        stages, wide_chunk = 1, _W_KC
    else:   # the raw v tile with eta, v hi/lo, eta, theta^T hi/lo, G
        kp16 = -(-kp // 16) * 16
        floats = ((kp + 1) * _TD + 2 * kp * _VP + _TD + 2 * kp16 * _TBP
                  + _TB * _VP)
        # wide: the split-TF32 layout, eta
        wide = _W_RES + _TD
        stages, wide_chunk = 2, _W_KC
    fits = (kp <= _WHOLE_K_MAX[kind] if kind in _WHOLE_K_MAX
            else 4 * floats + static <= _SMEM_LIMIT)
    chunk = kp if fits else wide_chunk
    if not fits:                          # the wide kernels: two stages
        floats, stages = wide, 2
        if kind == "row_ll":              # no static shared memory
            static = 0
    smem = 4 * floats
    blocks = _SMEM_PER_SM // (smem + static + 1024)
    if kind == "expsum" and fits:  # __launch_bounds__(256, 2) to K = 32
        blocks = min(blocks, 2 if kp <= 32 else 1)
    row_tiles = -(-B // _TB)
    threads = _RL_THREADS if kind == "row_ll" and not fits else _THREADS
    return LaunchGeometry(
        kind=kind, samples=S, rows=B, threads=threads, row_tile=_TB,
        col_tile=_TD, k_step=k_step, k_padded=kp, k_chunk=chunk,
        chunks=-(-kp // chunk), stages=stages, smem_bytes=smem,
        static_smem_bytes=static, blocks_per_sm=blocks,
        row_tiles=row_tiles, col_tiles=-(-D // _TD), grid=S * row_tiles)


def lgamma_table():
    """lgamma(n + 1) for n = 0..63, float64 values rounded to float32: what
    the kernels look up for integer counts below 64 (their Stirling series,
    the JAX package's ``_lgamma_xp1``, serves every other x)."""
    n = torch.arange(_TABLE_N, dtype=torch.float64)
    return torch.lgamma(n + 1.0).to(torch.float32)


_TABLES: dict = {}   # the table on each card, made at first use


def _device_table(device):
    if device not in _TABLES:
        _TABLES[device] = lgamma_table().to(device)
    return _TABLES[device]


def _lib():
    return _build.load_library("fused_poisson", _SIGNATURES)


def _wide_lib():
    return _build.load_library("fused_poisson_wide", _WIDE_SIGNATURES)


def _expsum_lib():
    return _build.load_library("fused_expsum", _EXPSUM_SIGNATURES)


def kernel_info(kind, K):
    """What the built library reports for the Poisson identity-link instance
    of K1 (``'stats'``) or K4 (``'row_ll'``), or for K5 (``'expsum'``), at
    latent dimension K (the whole-K or the wide kernel, as
    ``launch_geometry`` says): registers per thread, static and dynamic
    shared memory per block, and resident blocks per SM (the occupancy
    API's). Needs the card."""
    info = (ctypes.c_int * 4)()
    if kind == "expsum":
        err = _expsum_lib().expsum_kernel_info(K, info)
    elif launch_geometry(kind, 1, 1, K, 1).chunks > 1:
        err = _wide_lib().poisson_wide_kernel_info(int(kind == "row_ll"),
                                                   info)
    else:
        err = _lib().poisson_kernel_info(int(kind == "row_ll"), K, info)
    _build.check(err, f"{kind} kernel_info")
    return dict(zip(("registers", "static_smem_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def _check_cuda(kind, theta, tensors, D):
    """Raise unless every (name, tensor, shape) is a contiguous float32 CUDA
    tensor of that shape on theta's device; the launch geometry
    otherwise."""
    for name, t, shape in tensors:
        if (not t.is_cuda or t.dtype != torch.float32
                or not t.is_contiguous() or tuple(t.shape) != shape
                or t.device != theta.device):
            raise ValueError(
                f"{kind} kernel: {name} must be a contiguous float32 CUDA "
                f"tensor of shape {shape} on {theta.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return launch_geometry(kind, *theta.shape, D)


def _kernel_selector(likelihood, codes, D, device):
    """(LIK_* code, 1 / obs_scale, log(obs_scale) + log(2 pi) / 2, codes
    lane) as the kernels take them; the constants are computed here in
    double."""
    _check_likelihood(likelihood, codes)
    name, obs_scale = _split_likelihood(likelihood)
    return (_LIKELIHOODS[name], 1.0 / obs_scale,
            math.log(obs_scale) + _HALF_LOG_2PI, _f32_lane(codes, D, device))


def _kernel_stats(theta, v, phi, x, eta, log_transform, static,
                  likelihood="poisson", codes=None):
    S, B, K = theta.shape
    D = x.shape[-1]
    lik, inv_scale, norm_const, codes = _kernel_selector(
        likelihood, codes, D, theta.device)
    geom = _check_cuda("stats", theta,
                       (("theta", theta, (S, B, K)), ("v", v, (S, K, D)),
                        ("phi", phi, (S, 1, D)), ("x", x, (B, D)),
                        ("eta", eta, (1, D)), ("codes", codes, (1, D))), D)
    dev = theta.device
    nrb = geom.row_tiles
    psum = torch.empty((S, nrb), dtype=torch.float64, device=dev)
    pcnt = torch.zeros((S, nrb), dtype=torch.int32, device=dev)
    pmin = torch.zeros((S, nrb), dtype=torch.float32, device=dev)
    dtheta = torch.empty((S, B, K), dtype=torch.float32, device=dev)
    dv = torch.zeros((S, K, D), dtype=torch.float32, device=dev)
    dphi = torch.zeros((S, 1, D), dtype=torch.float32, device=dev)
    launch = (_wide_lib().poisson_stats_wide if geom.chunks > 1
              else _lib().poisson_stats)
    err = launch(
        theta.data_ptr(), v.data_ptr(), phi.data_ptr(), x.data_ptr(),
        eta.data_ptr(), codes.data_ptr(), _device_table(dev).data_ptr(),
        psum.data_ptr(), pcnt.data_ptr(), pmin.data_ptr(), dtheta.data_ptr(),
        dv.data_ptr(), dphi.data_ptr(), S, B, K, D, int(bool(log_transform)),
        int(bool(static)), lik, inv_scale, norm_const,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "poisson_stats_wide" if geom.chunks > 1
                 else "poisson_stats")
    _count("static" if static else "stats", geom)
    return (psum.sum(1).to(torch.float32), pcnt.sum(1, dtype=torch.int32),
            pmin.min().reshape(1), dtheta, dv, dphi)


def _kernel_row_ll(theta, v, phi, x, eta, log_transform,
                   likelihood="poisson", codes=None):
    S, B, K = theta.shape
    D = x.shape[-1]
    lik, inv_scale, norm_const, codes = _kernel_selector(
        likelihood, codes, D, theta.device)
    geom = _check_cuda("row_ll", theta,
                       (("theta", theta, (S, B, K)), ("v", v, (S, K, D)),
                        ("phi", phi, (S, 1, D)), ("x", x, (B, D)),
                        ("eta", eta, (1, D)), ("codes", codes, (1, D))), D)
    dev = theta.device
    out = torch.empty((S, B), dtype=torch.float32, device=dev)
    launch = (_wide_lib().poisson_row_ll_wide if geom.chunks > 1
              else _lib().poisson_row_ll)
    err = launch(
        theta.data_ptr(), v.data_ptr(), phi.data_ptr(), x.data_ptr(),
        eta.data_ptr(), codes.data_ptr(), _device_table(dev).data_ptr(),
        out.data_ptr(), S, B, K, D, int(bool(log_transform)), lik,
        inv_scale, norm_const, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "poisson_row_ll_wide" if geom.chunks > 1
                 else "poisson_row_ll")
    _count("row_ll", geom)
    return out


def _kernel_expsum(theta, v, eta):
    S, B, K = theta.shape
    D = v.shape[-1]
    geom = _check_cuda("expsum", theta,
                       (("theta", theta, (S, B, K)), ("v", v, (S, K, D)),
                        ("eta", eta, (1, D))), D)
    dev = theta.device
    psum = torch.empty((S, geom.row_tiles), dtype=torch.float64, device=dev)
    dtheta = torch.empty((S, B, K), dtype=torch.float32, device=dev)
    dv = torch.zeros((S, K, D), dtype=torch.float32, device=dev)
    err = _expsum_lib().poisson_expsum(
        theta.data_ptr(), v.data_ptr(), eta.data_ptr(), psum.data_ptr(),
        dtheta.data_ptr(), dv.data_ptr(), S, B, K, D,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "poisson_expsum")
    _count("expsum", geom)
    return psum.sum(1).to(torch.float32), dtheta, dv


class _FusedStats(torch.autograd.Function):
    """(sums, counts, gmin) with the kernel's unit-cotangent gradients
    saved; the backward rescales them by the sums' cotangent (the counts
    are piecewise constant and the clip bound is a constant by design)."""

    @staticmethod
    def forward(ctx, theta, v, phi, x, eta, log_transform, static,
                likelihood, codes):
        stats = _kernel_stats if theta.is_cuda else stats_twin
        ssum, cnt, gmin, dth, dv, dphi = stats(theta, v, phi, x, eta,
                                               log_transform, static,
                                               likelihood, codes)
        ctx.save_for_backward(dth, dv, dphi)
        ctx.mark_non_differentiable(cnt, gmin)
        return ssum, cnt, gmin

    @staticmethod
    def backward(ctx, gsum, gcnt, gmin):
        dth, dv, dphi = ctx.saved_tensors
        g = gsum.to(dth.dtype)[:, None, None]
        return dth * g, dv * g, dphi * g, None, None, None, None, None, None


def fused_poisson_loglik(theta, v, phi, x, eta, log_transform=False,
                         likelihood="poisson", clip="reference", codes=None):
    """Per-sample clipped log-likelihood sums, shape (S,), float32.

    theta (S,B,K), v (S,K,D), phi (S,1,D), x (B,D), eta (1,D) or anything
    broadcastable to it. Inputs are cast to float32, as the JAX entry
    does. ``likelihood``: 'poisson', 'bernoulli' (rate as logits),
    ('normal', obs_scale), 'poisson_softplus' or ('mixed', obs_scale) with
    a (1, D) per-column ``codes`` lane (CODE_POISSON / CODE_BERNOULLI /
    CODE_NORMAL). ``clip='reference'`` reproduces the data-dependent bound
    ``m = min(finite ll) - 10``; ``clip='static'`` clips at FLOOR."""
    _check_likelihood(likelihood, codes)
    if clip not in ("reference", "static"):
        raise ValueError(f"unknown clip mode {clip!r}")
    f32 = torch.float32
    theta = theta.to(f32).contiguous()
    v = v.to(f32).contiguous()
    phi = phi.to(f32).contiguous()
    x = torch.as_tensor(x, device=theta.device).to(f32).contiguous()
    eta = _f32_lane(eta, x.shape[-1], theta.device)
    codes = _f32_lane(codes, x.shape[-1], theta.device)
    ssum, cnt, gmin = _FusedStats.apply(theta, v, phi, x, eta,
                                        log_transform, clip == "static",
                                        likelihood, codes)
    if clip == "static":
        return ssum
    m = _floor_min_val(gmin - 10.0)
    return ssum + cnt.to(f32) * m[0]


def _row_axes(mesh, data_axis):
    """Live row-sharding mesh axes as a tuple (or None): ``data_axis`` may
    be one name ('dp') or a joint tuple (('dcn', 'dp') on a multi-slice
    mesh, where rows shard over both)."""
    names = (data_axis if isinstance(data_axis, (tuple, list))
             else (data_axis,))
    live = tuple(a for a in names
                 if a in mesh.axis_names and mesh.shape[a] > 1)
    return live or None


def _mesh_axes(mesh, data_axis, feature_axis):
    """(row axes or None, the fp axis or None) of ``mesh``."""
    fp = (feature_axis if feature_axis in mesh.axis_names
          and mesh.shape[feature_axis] > 1 else None)
    return _row_axes(mesh, data_axis), fp


def fused_poisson_loglik_sharded(theta, v, phi, x, eta, mesh,
                                 log_transform=False, data_axis="dp",
                                 feature_axis="fp", likelihood="poisson",
                                 codes=None, clip="reference"):
    """The clipped log-likelihood of the whole batch, (S,) float32 on
    every rank, from this rank's tile (the port of spmf_tpu's
    ``fused_poisson_loglik_sharded``): theta (S, B/dp, K) of its rows,
    v (S, K, D/fp), phi (S, 1, D/fp), x (B/dp, D/fp), eta and ``codes``
    (1, D/fp) of its columns. One K1 launch on the tile (K2 at
    ``clip='static'``), then across the row and fp ranks: the MIN of the
    finite minima (which start at 0.0) and the SUM of the clipped-cell
    counts, both without gradient, and the differentiable SUM of the
    sums; the bound ``m = _floor_min_val(gmin - 10)`` combines as on one
    device. At ``clip='static'`` the one collective is the SUM."""
    _check_likelihood(likelihood, codes)
    if clip not in ("reference", "static"):
        raise ValueError(f"unknown clip mode {clip!r}")
    rows, fp = _mesh_axes(mesh, data_axis, feature_axis)
    axes = (rows or ()) + ((fp,) if fp is not None else ())
    if not axes:
        return fused_poisson_loglik(theta, v, phi, x, eta, log_transform,
                                    likelihood, clip, codes)
    f32 = torch.float32
    theta = theta.to(f32).contiguous()
    v = v.to(f32).contiguous()
    phi = phi.to(f32).contiguous()
    x = torch.as_tensor(x, device=theta.device).to(f32).contiguous()
    eta = _f32_lane(eta, x.shape[-1], theta.device)
    codes = _f32_lane(codes, x.shape[-1], theta.device)
    ssum, cnt, gmin = _FusedStats.apply(theta, v, phi, x, eta,
                                        log_transform, clip == "static",
                                        likelihood, codes)
    total = mesh.all_sum(ssum, axes)
    if clip == "static":
        return total
    gmin = mesh.all_min_(gmin.clone(), axes)
    cnt = mesh.all_sum_(cnt.clone(), axes)
    m = _floor_min_val(gmin - 10.0)
    return total + cnt.to(f32) * m[0]


def fused_poisson_row_loglik_sharded(theta, v, phi, x, eta, mesh,
                                     log_transform=False, data_axis="dp",
                                     feature_axis="fp", likelihood="poisson",
                                     codes=None):
    """Per-row log-likelihood sums of this rank's rows, (S, B/dp) float32
    (the port of spmf_tpu's ``fused_poisson_row_loglik_sharded``): K4 on
    the tile, then the SUM over the fp line; rows stay where they are.
    Inputs as in ``fused_poisson_loglik_sharded``. No gradient."""
    rows, fp = _mesh_axes(mesh, data_axis, feature_axis)
    out = fused_poisson_row_loglik(theta, v, phi, x, eta, log_transform,
                                   likelihood, codes)
    if fp is not None:
        out = mesh.all_sum_(out, (fp,))
    return out


def _f32_lane(lane, D, device):
    """A per-column lane (eta, codes) as a contiguous float32 (1, D) tensor
    on ``device``; None gives zeros (the codes of a single-family model)."""
    if lane is None:
        return torch.zeros((1, D), dtype=torch.float32, device=device)
    if not isinstance(lane, torch.Tensor):
        lane = np.asarray(lane)
    lane = torch.as_tensor(lane, dtype=torch.float32, device=device)
    return lane.broadcast_to((1, D)).contiguous()


def fused_poisson_row_loglik(theta, v, phi, x, eta, log_transform=False,
                             likelihood="poisson", codes=None):
    """Per-row raw (unclipped) log-likelihood sums, shape (S, B), float32:
    the WAIC pointwise unit, without materialising (S, B, D). Evaluation
    only: the result carries no gradient. theta (S,B,K), v (S,K,D),
    phi (S,1,D), x (B,D), eta (1,D) or broadcastable; cast to float32 as the
    JAX entry does. ``likelihood`` and ``codes`` as in
    ``fused_poisson_loglik``."""
    _check_likelihood(likelihood, codes)
    f32 = torch.float32
    with torch.no_grad():
        theta = theta.to(f32).contiguous()
        v = v.to(f32).contiguous()
        phi = phi.to(f32).contiguous()
        x = torch.as_tensor(x, device=theta.device).to(f32).contiguous()
        eta = _f32_lane(eta, x.shape[-1], theta.device)
        codes = _f32_lane(codes, x.shape[-1], theta.device)
        row_ll = _kernel_row_ll if theta.is_cuda else row_loglik_twin
        return row_ll(theta, v, phi, x, eta, log_transform, likelihood,
                      codes)


class _FusedExpRateSum(torch.autograd.Function):
    """R (S,) with the kernel's unit-cotangent gradients saved; the backward
    rescales them by the per-sample cotangent. eta gets no gradient."""

    @staticmethod
    def forward(ctx, theta, v, eta):
        expsum = _kernel_expsum if theta.is_cuda else expsum_twin
        r, dth, dv = expsum(theta, v, eta)
        ctx.save_for_backward(dth, dv)
        return r

    @staticmethod
    def backward(ctx, g):
        dth, dv = ctx.saved_tensors
        g = g.to(dth.dtype)[:, None, None]
        return dth * g, dv * g, None


def fused_exp_rate_sum(theta, v, eta):
    """R_s = sum_ij exp((theta_s @ v_s) * eta), shape (S,), float32.

    theta (S,B,K), v (S,K,D), eta (1,D) or scalar; inputs are cast to
    float32 as the JAX entry does. The forward emits the unit-cotangent
    gradients from the same tiles; the backward rescales."""
    f32 = torch.float32
    theta = theta.to(f32).contiguous()
    v = v.to(f32).contiguous()
    return _FusedExpRateSum.apply(theta, v,
                                  _f32_lane(eta, v.shape[-1], theta.device))
