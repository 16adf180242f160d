"""Bijectors and distributions of the port against spmf_tpu (float64,
1e-12: the same closed forms evaluated by two libraries)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu import bijectors as jb
from spmf_tpu import distributions as jd

from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch import distributions as td

from torch_ref import model_pair, random_samples, torch_params

RTOL = 1e-12
RNG = np.random.default_rng(0)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=1e-300)


@pytest.mark.parametrize("name", ["Softplus", "Identity"])
def test_bijector_matches_jax(name):
    x = RNG.uniform(-40.0, 40.0, 500)
    y = RNG.uniform(1e-3, 30.0, 500)
    jbij, tbij = getattr(jb, name)(), getattr(tb, name)()
    _close(tbij.forward(_t(x)), jbij.forward(_j(x)))
    _close(tbij.inverse(_t(y)), jbij.inverse(_j(y)))
    _close(tbij.forward_log_det_jacobian(_t(x)),
           jbij.forward_log_det_jacobian(_j(x)))
    _close(tbij.inverse_log_det_jacobian(_t(y)),
           jbij.inverse_log_det_jacobian(_j(y)))


def _case(name):
    rng = np.random.default_rng(7)
    pos = lambda *s: rng.uniform(0.2, 4.0, s)  # noqa: E731
    args = {"Normal": (rng.normal(0.0, 2.0, (3, 5)), pos(3, 5)),
            "HalfNormal": (pos(3, 5),),
            "InverseGamma": (pos(3, 5), pos(3, 5)),
            "SqrtInverseGamma": (pos(3, 5), pos(3, 5)),
            "Poisson": (pos(3, 5),)}[name]
    if name == "Normal":
        x = rng.normal(0.0, 3.0, (2, 3, 5))
    elif name == "Poisson":
        x = rng.poisson(2.0, (2, 3, 5)).astype(float)
    else:
        x = pos(2, 3, 5)
    return args, x


@pytest.mark.parametrize("name", ["Normal", "HalfNormal", "InverseGamma",
                                  "SqrtInverseGamma", "Poisson"])
@pytest.mark.parametrize("ndims", [0, 2])
def test_log_prob_matches_jax(name, ndims):
    args, x = _case(name)
    tdist = td.Independent(getattr(td, name)(*map(_t, args)), ndims)
    jdist = jd.Independent(getattr(jd, name)(*map(_j, args)), ndims)
    _close(tdist.log_prob(_t(x)), jdist.log_prob(_j(x)))


def test_poisson_negative_rate_is_nan_and_zero_rate_floored():
    rate = np.array([-1.0, 0.0, 0.0, 2.0])
    x = np.array([1.0, 0.0, 3.0, 2.0])
    out = td.Poisson(rate=_t(rate)).log_prob(_t(x)).numpy()
    ref = np.asarray(jd.Poisson(rate=_j(rate)).log_prob(_j(x)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out[1:], ref[1:], rtol=RTOL)


def test_horseshoe_plus_prior_log_prob_parts_match_jax():
    """The model's JointDistributionNamed prior, lambda dependencies
    resolved by argument name, part for part."""
    jm, tm, _ = model_pair("float64")
    samples = random_samples(jm)
    jparts = jax.jit(jm.prior_distribution.log_prob_parts)(
        {k: jnp.asarray(v) for k, v in samples.items()})
    tparts = tm.prior_distribution.log_prob_parts(
        torch_params(samples, torch.float64))
    assert set(tparts) == set(jparts)
    for k in jparts:
        _close(tparts[k], jparts[k])
