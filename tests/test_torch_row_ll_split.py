"""The arithmetic of the wide K4 (csrc/fused_poisson_wide.cu's
row_ll_wide_kernel on csrc/split_tf32.cuh's decode, past padded K = 64),
emulated on the CPU: does its split-TF32 decode, with the tensor cores'
truncating accumulators, meet the tolerances the kernel is held to on the
card?

The kernel's order, emulated here (tests/_torch_split_tf32.py has the
split and the k-steps):
  decode  T = theta @ v, k-steps of 8 along the latent dimension (K padded
          with zeros to a multiple of 32), three TF32 passes (lo.hi, hi.lo,
          hi.hi) into a truncating float32 accumulator that restarts every
          PART k-steps, each partial added into T in float32;
  cells   the unclipped ll of the likelihood in float32 (the twin's
          formulas; lgamma(x + 1) from the kernel's table for integer
          counts below 64);
  rows    16 warps: two a group of 16 rows, one for each half of a
          64-column tile. Thread (g, t) of a warp holds rows g and g + 8 of
          its 16 at the columns h + 8j + 2t and h + 8j + 2t + 1 of its half
          (h = 0 or 32, j = 0..3): its 8 cells of a row summed in float32 in
          that order (j, then the column pair), the 4 lanes t combined by
          xor-shuffles (t ^ 1, then t ^ 2), the tiles in float64 by the
          owner lane, and at the end the two halves' doubles added, the
          first half's first.

Tolerance (the card's: tests/test_torch_gpu.py, chip_smoke.py phase W):
row sums 1e-5 relative against ``row_loglik_twin`` in float64; NaN rows at
the twin's positions.

The decode partial. K4 has no minimum to hold, only row sums of 32-cell
half tiles, so a partial a chunk of 4 k-steps (K5's) is enough. Over the
60 cases of ``test_wide_k4_split_meets_the_kernel_tolerance`` (both links,
the five likelihoods, K = 65 to 1024) the worst row reads 5.4e-7 relative
with a partial a chunk (K = 200, 'mixed', log link) and 2.4e-7 with one a
k-step (K = 256, 'normal', log link); one truncating accumulator over all
of K reads 8.8e-6 (K = 1024, 'mixed', log link), within 12% of the
tolerance (``test_decode_partials_under_a_truncating_accumulator``). The
kernel takes a partial a chunk (PART = 4, 18 times inside 1e-5): one
float32 add of T a chunk, where one a k-step adds four.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_split_tf32 import mma_steps, pad_to

from spmf_tpu.ops import fused_poisson as jfp

from spmf_tpu_torch.ops import fused_poisson as tfp
from test_torch_gpu import SELECTORS, _likelihood_inputs
from test_torch_stats_split import inputs as poisson_inputs

COL_TILE, ROW_BLOCK, LATENT_PAD = 64, 128, 32
CHUNK = 4            # k-steps of a chunk of the latent dimension: 32
DECODE_PARTIAL = 4   # k-steps of the kernel's decode partial: one a chunk
LIKELIHOODS = dict(SELECTORS, poisson="poisson")


def kernel_lgamma(x):
    """lgamma(x + 1) as the kernels take it: the float32 table for integer
    x in [0, 64), else lgamma in float32 (the kernels' Stirling series)."""
    n = x.long().clamp(0, 63)
    table = (x == n.to(x.dtype)) & (x >= 0) & (x < 64)
    return torch.where(table, tfp.lgamma_table()[n],
                       torch.lgamma(x + 1.0))


def emulated_row_ll(theta, v, phi, x, eta, log_transform=False,
                    likelihood="poisson", codes=None,
                    decode_partial=DECODE_PARTIAL):
    """(S, B) float32 row sums as the wide K4 computes them from float32
    inputs; the decode takes a fresh partial every ``decode_partial``
    k-steps (None: one truncating accumulator over all of K)."""
    S, B, _ = theta.shape
    D = x.shape[-1]
    th = pad_to(pad_to(theta, 2, LATENT_PAD), 1, ROW_BLOCK)
    vv = pad_to(pad_to(v, 1, LATENT_PAD), 2, COL_TILE)
    T = mma_steps(th, vv, 3, partial=decode_partial,
                  truncate=True)[:, :B, :D]
    lgx = (kernel_lgamma(x) if tfp._split_likelihood(likelihood)[0]
           not in ("bernoulli", "normal") else torch.zeros(()))
    rate = tfp._decode_rate(T, eta, phi, log_transform)
    ll = tfp._cell_ll(x, rate, lgx, likelihood, codes, grads=False)[0]
    # a select after the arithmetic: padded columns add exact zeros
    ll = pad_to(ll, 2, COL_TILE)
    tiles = ll.shape[-1] // COL_TILE
    # [s][b][tile][half][j][t][column of the pair] -> each thread's 8 cells
    # of a row in its half of the tile
    cells = ll.reshape(S, B, tiles, 2, 4, 4, 2).permute(0, 1, 2, 3, 5, 4, 6)
    cells = cells.reshape(S, B, tiles, 2, 4, 8)
    lane = torch.zeros(S, B, tiles, 2, 4, dtype=torch.float32)
    for i in range(8):
        lane = lane + cells[..., i]
    pair = lane + lane[..., [1, 0, 3, 2]]           # t ^ 1
    row = (pair + pair[..., [2, 3, 0, 1]])[..., 0]  # t ^ 2
    half = torch.zeros(S, B, 2, dtype=torch.float64)
    for j in range(tiles):
        half = half + row[:, :, j].double()
    return (half[..., 0] + half[..., 1]).to(torch.float32)


def rel_rows(out, ref):
    """max relative error of the finite rows, after the NaN rows are held
    to the same positions."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(out), nan)
    a, b = out[~nan].double(), ref[~nan].double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def case_inputs(name, S, B, K, D, seed):
    """The wide tests' inputs: ``test_torch_stats_split.inputs`` (phase
    W's) for 'poisson', ``test_torch_gpu._likelihood_inputs`` for the
    four others; v scaled by sqrt(8 / K) in both."""
    if name == "poisson":
        return poisson_inputs(S, B, K, D, seed), None
    return _likelihood_inputs(name, S, B, K, D, "cpu", seed=seed)


WIDE_K = (65, 96, 128, 200, 256, 1024)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", list(LIKELIHOODS))
@pytest.mark.parametrize("K", WIDE_K)
def test_wide_k4_split_meets_the_kernel_tolerance(K, name, log_transform):
    """S=2, B=37, D=131 (no tile multiples): the emulated kernel within
    1e-5 of the float64 twin at every wide K, both links and the five
    likelihoods ('mixed' with its three column codes)."""
    args, codes = case_inputs(name, 2, 37, K, 131, seed=K)
    lik = LIKELIHOODS[name]
    ref = tfp.row_loglik_twin(*[a.double() for a in args],
                              log_transform=log_transform, likelihood=lik,
                              codes=codes)
    out = emulated_row_ll(*args, log_transform, lik, codes)
    assert out.shape == (2, 37) and out.dtype == torch.float32
    e = rel_rows(out, ref)
    assert e < 1e-5, e


@pytest.mark.parametrize("name", ["normal", "mixed"])
@pytest.mark.parametrize("decode_partial", [None, CHUNK, 1])
def test_decode_partials_under_a_truncating_accumulator(decode_partial,
                                                        name):
    """K = 1024 at the log link (S=2, B=37, D=131, the signed inputs of the
    GPU tests), the worst cases of a single accumulator: one truncating
    decode accumulator over all 128 k-steps reads 8.6e-6 ('normal') and
    8.8e-6 ('mixed'), past 4e-6 and close to the row sums' 1e-5; a
    partial a chunk of 4 k-steps, the kernel's, and one a k-step stay
    under 1e-6 (4.4e-7 / 5.2e-7 and 2.2e-7 / 2.2e-7)."""
    args, codes = case_inputs(name, 2, 37, 1024, 131, seed=1024)
    lik = LIKELIHOODS[name]
    ref = tfp.row_loglik_twin(*[a.double() for a in args],
                              log_transform=True, likelihood=lik,
                              codes=codes)
    e = rel_rows(emulated_row_ll(*args, True, lik, codes,
                                 decode_partial=decode_partial), ref)
    assert (e > 4e-6) if decode_partial is None else (e < 1e-6), e


@pytest.mark.parametrize("K", [128, 256])
def test_rescue_batch_rows_are_nan_where_the_twins_are(K):
    """A negative intercept in one column of sample 1 and three rows of that
    sample encoded at 0: under 'poisson' exactly those rows are NaN, and
    the softplus link's underflowed rates poison theirs ('mixed' and
    'poisson_softplus', the GPU tests' rescue inputs); the finite rows
    within 1e-5."""
    args, _ = case_inputs("poisson", 2, 150, K, 400, seed=4)
    args[2][1, :, 5] = -1e-3
    args[0][1, [3, 70, 149]] = 0.0
    ref = tfp.row_loglik_twin(*[a.double() for a in args])
    assert int(torch.isnan(ref).sum()) == 3
    assert rel_rows(emulated_row_ll(*args), ref) < 1e-5
    for name in ("poisson_softplus", "mixed"):
        args, codes = _likelihood_inputs(name, 2, 150, K, 400, "cpu",
                                         seed=1, rescue=True)
        lik = LIKELIHOODS[name]
        ref = tfp.row_loglik_twin(*[a.double() for a in args],
                                  likelihood=lik, codes=codes)
        out = emulated_row_ll(*args, likelihood=lik, codes=codes)
        bad = ~torch.isfinite(ref)
        assert bad.any()
        assert torch.equal(~torch.isfinite(out), bad)
        a, b = out[~bad].double(), ref[~bad]
        assert bool(((a - b).abs() <= 1e-5 * b.abs()).all())


def _row_inputs_k128(seed, rescue):
    """test_torch_row_ll_expsum.py's row inputs at latent dimension 128
    (S=3, B=37, D=150; v scaled by sqrt(4 / 128)); ``rescue``: rows 3 and
    11 of sample 1 NaN."""
    rng = np.random.default_rng(seed)
    S, B, K, D = 3, 37, 128, 150
    theta = rng.uniform(0.0, 0.5, (S, B, K))
    v = rng.uniform(0.0, 0.5, (S, K, D)) * (4 / K) ** 0.5
    phi = rng.uniform(0.05, 0.5, (S, 1, D))
    x = rng.poisson(1.0, (B, D)).astype(float)
    eta = rng.uniform(0.5, 2.0, (1, D))
    if rescue:
        phi[1, :, 7] = -1e-3
        theta[1, [3, 11]] = 0.0
    return [np.asarray(a, np.float32) for a in (theta, v, phi, x, eta)]


def _test_ops_inputs_k128():
    """tests/test_ops.py's inputs (S=3, B=70, D=40: no tile multiples;
    gamma loadings) at latent dimension 128, v scaled by 5 / 128."""
    rng = np.random.default_rng(0)
    S, B, K, D = 3, 70, 128, 40
    theta = rng.gamma(1.0, 0.1, size=(S, B, K))
    v = rng.gamma(1.0, 0.1, size=(S, K, D)) * 5 / K
    phi = rng.gamma(1.0, 0.05, size=(S, 1, D)) + 1e-3
    x = rng.poisson(1.0, size=(B, D))
    eta = 1.0 + rng.random((1, D))
    return [np.asarray(a, np.float32) for a in (theta, v, phi, x, eta)]


@pytest.mark.parametrize("inputs", ["test_ops", "row_ll_expsum"])
@pytest.mark.parametrize("log_transform", [False, True])
def test_wide_k4_split_matches_the_interpreted_tpu_kernel_at_k128(
        inputs, log_transform):
    """At K = 128 the emulated kernel against spmf_tpu's ``_row_ll_kernel``
    run interpreted in float32, at the JAX tests' tolerance of 3e-5 (f32
    cells, another lgamma), on the cases of tests/test_ops.py
    (``test_fused_row_loglik_matches_xla``) and
    tests/test_torch_row_ll_expsum.py (the rescue batch: rows 3 and 11 of
    sample 1 NaN in both)."""
    args = (_test_ops_inputs_k128() if inputs == "test_ops"
            else _row_inputs_k128(seed=2, rescue=True))
    out_j = np.asarray(jfp.fused_poisson_row_loglik(
        *map(jnp.asarray, args), log_transform, True))
    out_e = emulated_row_ll(*(torch.tensor(a) for a in args),
                            log_transform).numpy()
    nan_j = np.isnan(out_j)
    if inputs == "row_ll_expsum":
        assert nan_j.sum() == 2 and nan_j[1, [3, 11]].all()
    np.testing.assert_array_equal(np.isnan(out_e), nan_j)
    np.testing.assert_allclose(out_e[~nan_j], out_j[~nan_j], rtol=3e-5)
