"""The arithmetic of the wide K1/K2 (csrc/fused_poisson_wide.cu's
stats_wide_kernel on csrc/split_tf32.cuh's design, past padded K = 124),
emulated on the CPU: do its three split-TF32 products, with the tensor
cores' truncating accumulators, meet the tolerances the kernel is held to on
the card?

The kernel's order, emulated here (tests/_torch_split_tf32.py has the
split and the k-steps):
  decode  T = theta @ v, k-steps of 8 along the latent dimension (K padded
          with zeros to a multiple of 32), a fresh float32 partial per
          k-step, the partials added into T in float32;
  cells   the likelihood's ll and d ll / d rate in float32 (the twin's
          formulas; lgamma(x + 1) from the kernel's table), each row's
          clipped cells of a 64-column tile summed in float32, the tiles in
          float64; gmin and the counts of the other cells;
  dtheta  += dtv @ v^T, k-steps of 8 along the columns, a fresh partial per
          32 columns, a tile's two added in float32, then into the sums;
  dv      += theta^T @ dtv, k-steps of 8 along a block's 128 rows in one
          accumulator, each block's partial added in float32 (the kernel's
          atomics).

Tolerances (the card's: tests/test_torch_gpu.py, chip_smoke.py phase W):
sums 1e-5 relative, gmin 1e-6 relative, counts exact, gradients 1e-4 of
their largest entry, against ``stats_twin`` in float64.

The partials are what keep gmin inside its tolerance: the tensor cores add
into their float32 accumulator without rounding to nearest (``truncate``),
a bias that grows with the number of additions. One accumulator over all
of K = 1024 (128 k-steps) reads gmin 2.9e-6 to 3.6e-6 off, past 1e-6; a
partial per chunk of 4 k-steps 6e-8 to 7e-8. The kernel takes one per
k-step for the worst cells of the log link: at tests/test_torch_gpu.py's
spread of theta . v (K = 128), whose largest rates are about 30, a partial
per chunk reads gmin 1.04e-6 for 'mixed' and 1.12e-6 for 'normal' (the
card read the first), one per k-step 4.0e-7 and 8.3e-8.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch
from _torch_split_tf32 import mma_steps, pad_to

from spmf_tpu_torch.ops import fused_poisson as tfp
from test_torch_gpu import SELECTORS, _likelihood_inputs

ROW_BLOCK, COL_TILE = 128, 64
CHUNK = 4       # k-steps of a chunk of the latent dimension: 32
DECODE_PARTIAL = 1   # k-steps of the kernel's decode partial
LATENT_PAD = 32


def emulated_stats(theta, v, phi, x, eta, log_transform=False, static=False,
                   decode_partial=DECODE_PARTIAL, likelihood="poisson",
                   codes=None):
    """(sums, counts, gmin, dtheta, dv, dphi) as the wide K1/K2 computes
    them from float32 inputs, with truncating accumulators; the decode
    takes a fresh partial every ``decode_partial`` k-steps (None: one
    accumulator over all of K)."""
    S, B, K = theta.shape
    D = x.shape[-1]
    th = pad_to(pad_to(theta, 2, LATENT_PAD), 1, ROW_BLOCK)
    vv = pad_to(pad_to(v, 1, LATENT_PAD), 2, COL_TILE)
    T = mma_steps(th, vv, 3, partial=decode_partial,
                  truncate=True)[:, :B, :D]
    if likelihood == "poisson":   # the kernel's table of lgamma(x + 1)
        lgx = tfp.lgamma_table()[x.long()]
    else:
        lgx = tfp._lgamma_xp1(x, likelihood)
    if log_transform:
        ev = torch.exp(T * eta)
        rate = ev - 1.0 + phi
    else:
        rate = T * eta + phi
    ll, dll = tfp._cell_ll(x, rate, lgx, likelihood, codes)
    finite = torch.isfinite(ll)
    keep = finite & (ll > tfp.FLOOR)
    active = keep & (ll < 0.0)
    zero = torch.zeros_like(ll)
    drate = torch.where(active, dll, zero)
    dtv = torch.where(active, drate * (ev * eta if log_transform else eta),
                      zero)
    kept = torch.where(keep, torch.clamp_max(ll, 0.0),
                       torch.full_like(ll, tfp.FLOOR) if static else zero)
    tiles = pad_to(kept, 2, COL_TILE).reshape(S, B, -1, COL_TILE).sum(-1)
    sums = tiles.double().sum((1, 2))
    if static:
        counts = torch.zeros(S, dtype=torch.int32)
        gmin = torch.zeros(1)
    else:
        counts = (~keep).sum((1, 2)).to(torch.int32)
        gmin = torch.where(finite, ll, zero).min().reshape(1)
    g = pad_to(pad_to(dtv, 1, ROW_BLOCK), 2, COL_TILE)
    dtheta = mma_steps(g, vv.transpose(1, 2), 3, partial=CHUNK, group=2,
                       truncate=True)[:, :B, :K]
    dv = torch.zeros(vv.shape, dtype=torch.float32)
    for r0 in range(0, th.shape[1], ROW_BLOCK):
        rows = slice(r0, r0 + ROW_BLOCK)
        dv = dv + mma_steps(th[:, rows].transpose(1, 2), g[:, rows], 3,
                            truncate=True)
    return (sums, counts, gmin, dtheta, dv[:, :K, :D],
            drate.sum(1, keepdim=True))


def inputs(S, B, K, D, seed):
    """chip_smoke.py phase W's batches at a small size: theta in [0, 0.5),
    v in [0, 0.05 min(1, sqrt(8 / K))), phi in [0.05, 0.55), Poisson(1)
    counts, eta in [0.5, 2), float32, from numpy."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, (S, B, K)).astype(np.float32)
    v = (rng.uniform(0.0, 1.0, (S, K, D)) * 0.05
         * min(1.0, (8.0 / K) ** 0.5)).astype(np.float32)
    phi = rng.uniform(0.05, 0.55, (S, 1, D)).astype(np.float32)
    x = rng.poisson(1.0, (B, D)).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, (1, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in (theta, v, phi, x, eta)]


def errors(out, ref):
    """(sums relative, gmin relative, counts equal, gradients relative to
    their largest entry) of ``out`` against the float64 ``ref``."""
    def rel(a, b):
        return float(((a.double() - b.double()).abs()
                      / b.double().abs().clamp_min(1e-300)).max())

    grads = max(float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(out[3:], ref[3:]))
    return (rel(out[0], ref[0]), rel(out[2], ref[2]),
            bool(torch.equal(out[1], ref[1])), grads)


#: (S, B, K, D, log_transform, static): the wide K1 at K = 128 and 256 (B no
#: multiple of the row block and D of the column tile at 256) at both links,
#: and K2 (clip='static') at K = 128
CASES = [(1, 256, 128, 1000, False, False), (1, 256, 128, 1000, True, False),
         (1, 200, 256, 999, False, False), (1, 200, 256, 999, True, False),
         (1, 256, 128, 1000, False, True)]


@pytest.mark.parametrize("S,B,K,D,log_transform,static", CASES)
def test_wide_k1_split_meets_the_kernel_tolerances(S, B, K, D, log_transform,
                                                   static):
    args = inputs(S, B, K, D, seed=K + B)
    ref = tfp.stats_twin(*[a.double() for a in args],
                         log_transform=log_transform, static=static)
    e_sum, e_min, counts, e_grad = errors(
        emulated_stats(*args, log_transform, static), ref)
    assert e_sum < 1e-5 and e_min < 1e-6 and counts and e_grad < 1e-4, (
        e_sum, e_min, counts, e_grad)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("decode_partial,ok", [(None, False), (CHUNK, True),
                                               (DECODE_PARTIAL, True)])
def test_decode_partials_under_a_truncating_accumulator(decode_partial, ok,
                                                        log_transform):
    """K = 1024 (S=1, B=128, D=512): one truncating decode accumulator over
    all 128 k-steps reads gmin past its 1e-6 tolerance; a fresh partial per
    chunk of 4 k-steps, or the kernel's per k-step, stays well inside it."""
    args = inputs(1, 128, 1024, 512, seed=7)
    ref = tfp.stats_twin(*[a.double() for a in args],
                         log_transform=log_transform)
    e_min = errors(emulated_stats(*args, log_transform,
                                  decode_partial=decode_partial), ref)[1]
    assert (e_min < 1e-6) if ok else (e_min > 1e-6), e_min


#: (likelihood, decode partial in k-steps, gmin within 1e-6)
SPREAD_CASES = ([(name, DECODE_PARTIAL, True) for name in SELECTORS]
                + [("normal", CHUNK, False), ("mixed", CHUNK, False)])


@pytest.mark.parametrize("name,decode_partial,ok", SPREAD_CASES)
def test_decode_partial_per_kstep_at_the_log_links_spread(name,
                                                          decode_partial, ok):
    """tests/test_torch_gpu.py's wide inputs for the four likelihoods past
    'poisson' under the log link (S=2, B=300, K=128, D=997; theta . v of
    spread about 0.34, rates up to about 30): the kernel's partial per
    k-step meets every tolerance; a partial per chunk misses gmin's 1e-6
    for 'normal' and 'mixed' (1.12e-6 and 1.04e-6), as the card did for
    'mixed'."""
    args, codes = _likelihood_inputs(name, 2, 300, 128, 997, "cpu", seed=11)
    lik = SELECTORS[name]
    ref = tfp.stats_twin(*[a.double() for a in args], log_transform=True,
                         likelihood=lik, codes=codes)
    e_sum, e_min, counts, e_grad = errors(
        emulated_stats(*args, True, decode_partial=decode_partial,
                       likelihood=lik, codes=codes), ref)
    assert e_sum < 1e-5 and counts and e_grad < 1e-4, (e_sum, counts, e_grad)
    assert (e_min < 1e-6) if ok else (e_min > 1e-6), e_min
