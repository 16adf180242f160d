"""The twins of the row log-likelihood kernel (K4) and the exp-rate-sum
kernel (K5) against spmf_tpu: its Pallas kernels run interpreted in float32
and its plain formulas in float64. Shapes are ragged (neither B nor D a
tile multiple)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import gammaln

from spmf_tpu.ops import fused_poisson as jfp

from spmf_tpu_torch.ops import fused_poisson as tfp

S, B, K, D = 3, 37, 4, 150


def _wide(latent):
    """v's scale past K: theta . v keeps the spread it has at K."""
    return min(1.0, (K / latent) ** 0.5)


def _expsum_inputs(seed=5, latent=K):
    rng = np.random.default_rng(seed)
    theta = rng.normal(0.1, 0.2, (S, B, latent))
    v = np.abs(rng.normal(0.1, 0.1, (S, latent, D))) * _wide(latent)
    eta = np.abs(rng.normal(1.0, 0.1, (1, D)))
    return theta, v, eta


def _row_inputs(seed=0, rescue=False, latent=K):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, (S, B, latent))
    v = rng.uniform(0.0, 0.5, (S, latent, D)) * _wide(latent)
    phi = rng.uniform(0.05, 0.5, (S, 1, D))
    x = rng.poisson(1.0, (B, D)).astype(float)
    eta = rng.uniform(0.5, 2.0, (1, D))
    if rescue:
        # a small negative intercept in one column of sample 1, and rows 3
        # and 11 of that sample encoded at 0: their rate there is the
        # negative intercept, so those two rows (only) are NaN
        phi[1, :, 7] = -1e-3
        theta[1, [3, 11]] = 0.0
    return theta, v, phi, x, eta


def test_expsum_twin_matches_interpreted_kernel_f32():
    """Value within 1e-5 relative (f32 exps summed in another order), the
    gradients at a non-unit cotangent within 1e-4 of the largest entry
    (the JAX test's tolerances)."""
    _check_expsum_against_interpreted_kernel(_expsum_inputs())


@pytest.mark.parametrize("latent", [80, 128])
def test_expsum_twin_matches_interpreted_kernel_f32_wide(latent):
    """The same past K = 64, where the port's K5 takes its K-chunked
    kernel on the card (the TPU kernel holds the whole of K)."""
    _check_expsum_against_interpreted_kernel(
        _expsum_inputs(seed=latent, latent=latent))


def _check_expsum_against_interpreted_kernel(inputs):
    theta, v, eta = (np.asarray(a, np.float32) for a in inputs)
    g = np.array([0.7, -1.3, 2.0], np.float32)
    val_j, vjp = jax.vjp(lambda t, vv: jfp.fused_exp_rate_sum(t, vv, eta, True),
                         jnp.asarray(theta), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    t = [torch.tensor(a).requires_grad_(True) for a in (theta, v)]
    val_t = tfp.fused_exp_rate_sum(*t, torch.tensor(eta))
    (val_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(val_t.detach().numpy(), np.asarray(val_j),
                               rtol=1e-5)
    for a, gj in zip(t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(a.grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max())


def test_expsum_twin_matches_direct_sum_f64():
    """float64 twin against jax's direct sum and its autodiff, 1e-10."""
    theta, v, eta = _expsum_inputs(seed=6)

    def direct(t, vv):
        return jnp.sum(jnp.exp(jnp.matmul(t, vv) * eta), axis=(-1, -2))

    ref = direct(jnp.asarray(theta), jnp.asarray(v))
    gref = jax.grad(lambda t, vv: jnp.sum(direct(t, vv)), (0, 1))(
        jnp.asarray(theta), jnp.asarray(v))
    r, dth, dv = tfp.expsum_twin(*(torch.tensor(a) for a in (theta, v, eta)))
    np.testing.assert_allclose(r.numpy(), np.asarray(ref), rtol=1e-10)
    for a, b in zip((dth, dv), gref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10)


@pytest.mark.parametrize("log_transform", [False, True])
def test_row_ll_twin_matches_interpreted_kernel_f32(log_transform):
    """Row sums within 3e-5 relative (the JAX test's tolerance: f32 cells,
    another lgamma); NaN rows of a rescue batch at the same positions."""
    _check_row_ll_against_interpreted_kernel(_row_inputs(rescue=True),
                                             log_transform)


@pytest.mark.parametrize("log_transform", [False, True])
def test_row_ll_twin_matches_interpreted_kernel_f32_at_k128(log_transform):
    """The same at K = 128 (the port's K4 takes its whole-K kernel there
    to padded K = 152, the K-chunked one past it)."""
    _check_row_ll_against_interpreted_kernel(
        _row_inputs(seed=2, rescue=True, latent=128), log_transform)


def _check_row_ll_against_interpreted_kernel(inputs, log_transform):
    args = [np.asarray(a, np.float32) for a in inputs]
    out_j = np.asarray(jfp.fused_poisson_row_loglik(
        *map(jnp.asarray, args), log_transform, True))
    out_t = tfp.fused_poisson_row_loglik(
        *(torch.tensor(a) for a in args), log_transform=log_transform).numpy()
    assert out_t.shape == (S, B) and out_t.dtype == np.float32
    nan_j = np.isnan(out_j)
    assert nan_j.sum() == 2 and nan_j[1, [3, 11]].all()
    np.testing.assert_array_equal(np.isnan(out_t), nan_j)
    np.testing.assert_allclose(out_t[~nan_j], out_j[~nan_j], rtol=3e-5)


@pytest.mark.parametrize("log_transform", [False, True])
def test_row_ll_twin_matches_formula_f64(log_transform):
    """float64 twin against the plain per-row formula, 1e-10."""
    theta, v, phi, x, eta = _row_inputs(seed=1, rescue=True)
    tv = np.matmul(theta, v)
    rate = (np.exp(tv * eta) - 1.0 + phi) if log_transform else tv * eta + phi
    with np.errstate(invalid="ignore"):
        ll = x * np.log(rate) - rate - np.asarray(gammaln(x + 1.0))
    ref = ll.sum(-1)
    out = tfp.row_loglik_twin(*(torch.tensor(a) for a in
                                (theta, v, phi, x, eta)),
                              log_transform=log_transform).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-10)


def test_row_ll_is_evaluation_only_and_poisson_only():
    t = [torch.tensor(a, dtype=torch.float32) for a in _row_inputs()]
    t[0].requires_grad_(True)
    assert not tfp.fused_poisson_row_loglik(*t).requires_grad
    # the other likelihoods of the selector are evaluation-only too; an
    # unknown one raises (tests/test_torch_likelihoods.py holds their values)
    out = tfp.fused_poisson_row_loglik(*t, likelihood="bernoulli")
    assert out.shape == t[0].shape[:2] and not out.requires_grad
    with pytest.raises(ValueError, match="unknown likelihood"):
        tfp.fused_poisson_row_loglik(*t, likelihood="gamma")


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("latent", [20, 33])
def test_row_ll_twin_at_ragged_latent_dims_f64(latent, log_transform):
    """K = 20 and K = 33 with B = 37, D = 130 (no multiple of the kernels'
    k-step or tiles): the float64 twin against the per-row formula through
    jax's gammaln, 1e-9, so it is a trusted reference at those shapes."""
    rng = np.random.default_rng(latent)
    theta = rng.uniform(0.0, 0.5, (S, 37, latent))
    v = rng.uniform(0.0, 0.1, (S, latent, 130))
    phi = rng.uniform(0.05, 0.5, (S, 1, 130))
    x = rng.poisson(1.0, (37, 130)).astype(float)
    eta = rng.uniform(0.5, 2.0, (1, 130))
    tv = jnp.matmul(jnp.asarray(theta), jnp.asarray(v))
    rate = (jnp.exp(tv * eta) - 1.0 + phi) if log_transform else tv * eta + phi
    ref = np.asarray((x * jnp.log(rate) - rate - gammaln(x + 1.0)).sum(-1))
    out = tfp.row_loglik_twin(*(torch.tensor(a) for a in
                                (theta, v, phi, x, eta)),
                              log_transform=log_transform)
    assert out.shape == (S, 37) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9)


@pytest.mark.parametrize("latent", [20, 33])
def test_expsum_twin_at_ragged_latent_dims_f64(latent):
    """The same shapes for K5's twin: value and gradients against jax's
    direct sum and its autodiff in float64, 1e-9."""
    rng = np.random.default_rng(latent)
    theta = rng.normal(0.1, 0.2, (S, 37, latent))
    v = np.abs(rng.normal(0.05, 0.05, (S, latent, 130)))
    eta = np.abs(rng.normal(1.0, 0.1, (1, 130)))

    def direct(t, vv):
        return jnp.sum(jnp.exp(jnp.matmul(t, vv) * eta), axis=(-1, -2))

    ref = direct(jnp.asarray(theta), jnp.asarray(v))
    gref = jax.grad(lambda t, vv: jnp.sum(direct(t, vv)), (0, 1))(
        jnp.asarray(theta), jnp.asarray(v))
    r, dth, dv = tfp.expsum_twin(*(torch.tensor(a) for a in (theta, v, eta)))
    np.testing.assert_allclose(r.numpy(), np.asarray(ref), rtol=1e-9)
    for a, b in zip((dth, dv), gref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max())
