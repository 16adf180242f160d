"""The boosted Wilson–Hilferty sampler and its hand VJP against
spmf_tpu.ops.gamma, with the same base draws fed to both (float64, 1e-12:
the same elementary formulas in two libraries)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.ops import gamma as jgamma

from spmf_tpu_torch.ops import gamma as tgamma

RTOL = 1e-12


def _draws(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 6.0, shape)
    eps = rng.normal(0.0, 1.0, shape)
    # include the clamp (c < 0.05) and floor regimes: very negative eps,
    # uniforms near 0
    eps.flat[::17] = -12.0
    u = rng.uniform(1e-300, 1.0, (8,) + shape)
    u[0].flat[::13] = 1e-300
    return a, eps, u


@pytest.mark.parametrize("shape", [(4, 50), (7,)])
def test_wh_value_and_vjp_match_jax(shape):
    a, eps, u = _draws(shape)
    gx = np.random.default_rng(1).normal(size=shape)
    wh = jgamma._WH_REDUCE[8]
    xj, vjp = jax.vjp(wh, jnp.asarray(a), jnp.asarray(eps),
                      jnp.asarray(np.log(u)))
    da_j, deps_j, _ = vjp(jnp.asarray(gx))

    at = torch.tensor(a, requires_grad=True)
    et = torch.tensor(eps, requires_grad=True)
    xt = tgamma._WHReduce.apply(at, et, torch.log(torch.tensor(u)))
    xt.backward(torch.tensor(gx))
    np.testing.assert_allclose(xt.detach().numpy(), np.asarray(xj), rtol=RTOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(da_j), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(deps_j),
                               rtol=RTOL, atol=1e-300)


@pytest.mark.parametrize("antithetic", [False, True, "stratified"])
def test_sampler_with_jax_draws_matches_jax(antithetic):
    """wilson_hilferty_gamma from a key in JAX; the port fed the same base
    draws (reproduced from the key, mirrored in antithetic mode)."""
    S, n = 6, 40
    a = np.random.default_rng(2).uniform(0.3, 5.0, (S, n))
    key = jax.random.PRNGKey(11)
    gj = jgamma.wilson_hilferty_gamma(key, jnp.asarray(a),
                                      antithetic=antithetic)
    if antithetic:
        eps, u = jgamma._mirror_base_draws(
            key, (S, n), jnp.float64, 8,
            stratified=antithetic == "stratified")
    else:
        kn, ku = jax.random.split(key)
        eps = jax.random.normal(kn, (S, n), jnp.float64)
        u = jax.random.uniform(ku, (8, S, n), jnp.float64,
                               minval=jnp.finfo(jnp.float64).tiny, maxval=1.0)
    gt = tgamma.wilson_hilferty_gamma(
        None, torch.tensor(a), draws=(np.asarray(eps), np.asarray(u)))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL)


def test_port_antithetic_draws_mirror_exactly():
    gen = torch.Generator().manual_seed(0)
    eps, u = tgamma._mirror_base_draws(gen, (6, 100), torch.float64, "cpu", 8)
    assert torch.equal(eps[3:], -eps[:3])
    tiny = torch.finfo(torch.float64).tiny
    assert torch.equal(u[:, 3:], torch.clamp_min(1.0 - u[:, :3], tiny))
    assert bool((u > 0).all() and (u <= 1).all())


def test_odd_antithetic_and_exact_sampler_raise():
    """An odd antithetic sample axis raises; the exact sampler draws, and
    refuses antithetic draws with spmf_tpu's ValueError."""
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        tgamma.wilson_hilferty_gamma(gen, torch.ones(3, 4), antithetic=True)
    g = tgamma.sample_gamma(gen, torch.ones(4), method="exact")
    assert g.shape == (4,) and bool((g > 0).all())
    with pytest.raises(ValueError, match="antithetic"):
        tgamma.sample_gamma(gen, torch.ones(2, 4), method="exact",
                            antithetic=True)
