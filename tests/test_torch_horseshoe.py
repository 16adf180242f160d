"""The exact-E1 horseshoe prior and the distributions and bijectors of the
port against spmf_tpu's: ``exp1`` / ``log_exp1`` values and gradients
(scipy and the JAX custom JVPs), every new distribution's ``log_prob``,
``mean`` and ``entropy``, the Horseshoe normalisation and tail bounds of
tests/test_distributions.py, the ``Exp`` and ``Chain`` cases of
tests/test_bijectors.py, and the ``horshoe_plus=False`` factorization
energy and its gradient in three families."""
import _torch_threads  # noqa: F401  (first: one torch thread)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import torch

import spmf_tpu
from spmf_tpu import bijectors as jb
from spmf_tpu import distributions as jd

import spmf_tpu_torch
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch import distributions as td
from spmf_tpu_torch.vi.minibatch import elbo_loss

from torch_ref import jax_draws, to_np, torch_params

#: the grid of tests/test_distributions.py::test_exp1_vs_scipy
Z_GRID = np.concatenate([np.geomspace(1e-10, 1.0, 500),
                         np.linspace(1.0, 650.0, 2000)])
#: the points of test_distributions.py::test_exp1_gradients_match_analytic
Z_POINTS = np.array([1e-3, 0.2, 0.9, 1.0, 1.5, 3.8, 6.0, 12.0, 40.0, 300.0])


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_exp1_and_log_exp1_match_jax_and_scipy():
    e_t = td.exp1(_t(Z_GRID)).numpy()
    np.testing.assert_allclose(e_t, sp.exp1(Z_GRID), rtol=1e-12)
    np.testing.assert_allclose(e_t, np.asarray(jd.exp1(jnp.asarray(Z_GRID))),
                               rtol=1e-12)
    l_t = td.log_exp1(_t(Z_GRID)).numpy()
    np.testing.assert_allclose(
        l_t, np.asarray(jd.log_exp1(jnp.asarray(Z_GRID))), rtol=1e-12)
    # finite deep into the tail, where E1 underflows; asymptotic there
    zt = np.array([50.0, 200.0, 600.0, 1e4, 1e8, 1e12])
    lt = td.log_exp1(_t(zt)).numpy()
    np.testing.assert_allclose(lt[:2], np.log(sp.exp1(zt[:2])), rtol=1e-12)
    assert np.isfinite(lt).all()
    za = zt[3:]
    asym = -za - np.log(za) + np.log1p(-1.0 / za + 2.0 / za**2)
    np.testing.assert_allclose(lt[3:], asym, rtol=1e-10)
    np.testing.assert_allclose(
        lt, np.asarray(jd.log_exp1(jnp.asarray(zt))), rtol=1e-12)


@pytest.mark.parametrize("name", ["exp1", "log_exp1"])
def test_exp1_gradients_match_the_jax_jvp(name):
    z = _t(Z_POINTS).requires_grad_(True)
    (g_t,) = torch.autograd.grad(getattr(td, name)(z).sum(), z)
    g_j = jax.vmap(jax.grad(getattr(jd, name)))(jnp.asarray(Z_POINTS))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)
    exact = (-np.exp(-Z_POINTS) / Z_POINTS if name == "exp1" else
             -np.exp(-Z_POINTS) / (Z_POINTS * sp.exp1(Z_POINTS)))
    np.testing.assert_allclose(g_t.numpy(), exact, rtol=1e-12)


@pytest.mark.parametrize("name", ["exp1", "log_exp1"])
def test_exp1_float32_matches_jax_float32(name):
    """The dtype follows the input: float32 in, float32 arithmetic out,
    within 1e-5 of JAX's float32 (log E1 crosses 0 near z = 0.27, so the
    comparison there is absolute, 1e-6)."""
    z = Z_GRID.astype(np.float32)
    out = getattr(td, name)(_t(z, torch.float32))
    assert out.dtype == torch.float32
    ref = np.asarray(getattr(jd, name)(jnp.asarray(z, jnp.float32)))
    assert ref.dtype == np.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_log_exp1_saves_only_its_input():
    """The autograd graph of log_exp1 holds one tensor, z itself: the
    Horner intermediates are recomputed in the backward."""
    saved = []

    def pack(t):
        saved.append(t)
        return t

    z = _t(np.linspace(0.1, 20.0, 64)).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = td.log_exp1(z)
    assert len(saved) == 1 and saved[0] is z
    out.sum().backward()
    assert torch.isfinite(z.grad).all()


def _x(*shape, seed=0, positive=True):
    rng = np.random.default_rng(seed)
    x = rng.lognormal(-0.3, 0.8, shape)
    return x if positive else x * rng.choice([-1.0, 1.0], shape)


#: name -> (the distribution made in a module, positive x, the methods
#: besides log_prob that spmf_tpu defines on it)
DISTRIBUTIONS = {
    "Normal": (lambda m: m.Normal(_p(m, [0.0, 1.5, -2.0]),
                                  _p(m, [1.0, 2.5, 0.3])), False,
               ("mean", "entropy")),
    "HalfNormal": (lambda m: m.HalfNormal(_p(m, [0.5, 1.0, 3.0])), True,
                   ("mean",)),
    "Cauchy": (lambda m: m.Cauchy(_p(m, [1.0, -0.5, 0.0]),
                                  _p(m, [2.0, 0.1, 1.0])), False, ()),
    "HalfCauchy": (lambda m: m.HalfCauchy(_p(m, [0.0, 0.0, 0.1]),
                                          _p(m, [1.0, 0.01, 3.0])), True, ()),
    "Gamma rate": (lambda m: m.Gamma(_p(m, [0.5, 3.0, 7.0]),
                                     rate=_p(m, [1.0, 2.0, 0.4])), True,
                   ("mean",)),
    "Gamma scale": (lambda m: m.Gamma(_p(m, [0.5, 3.0, 7.0]),
                                      scale=_p(m, [1.0, 2.0, 0.4])), True,
                    ("mean",)),
    "InverseGamma": (lambda m: m.InverseGamma(_p(m, [1.5, 2.0, 4.0]),
                                              _p(m, [1.0, 3.0, 0.5])), True,
                     ("mean",)),
    "LogNormal": (lambda m: m.LogNormal(_p(m, [0.3, -1.0, 0.0]),
                                        _p(m, [0.8, 0.2, 1.5])), True,
                  ("mean",)),
    "Horseshoe": (lambda m: m.Horseshoe(_p(m, [1.0, 0.01, 3.0])), False, ()),
    # a negative x goes through x^2, as spmf_tpu takes it
    "AbsHorseshoe": (lambda m: m.AbsHorseshoe(_p(m, [2.0, 0.1, 1.0])),
                     False, ()),
    "Poisson rate": (lambda m: m.Poisson(rate=_p(m, [0.5, 4.0, 1e-3])),
                     True, ("mean",)),
    "Poisson log_rate": (lambda m: m.Poisson(
        log_rate=_p(m, [-0.7, 1.4, -7.0])), True, ("mean",)),
    "Bernoulli": (lambda m: m.Bernoulli(logits=_p(m, [-2.0, 0.3, 5.0])),
                  True, ("mean",)),
}


def _p(module, values):
    a = np.asarray(values, np.float64)
    return _t(a) if module is td else jnp.asarray(a)


@pytest.mark.parametrize("name", list(DISTRIBUTIONS))
def test_distribution_matches_jax(name):
    """log_prob (a (4, 3) batch of values), and mean and entropy where
    spmf_tpu defines them, at 1e-12; the port's sampler draws the batch
    shape with leading sample dims."""
    make, positive, methods = DISTRIBUTIONS[name]
    dt, dj = make(td), make(jd)
    x = _x(4, 3, seed=len(name), positive=positive)
    if name.startswith("Poisson"):
        x = np.floor(x * 3.0)
    elif name == "Bernoulli":
        x = (x > 1.0).astype(np.float64)
    np.testing.assert_allclose(dt.log_prob(_t(x)).numpy(),
                               np.asarray(dj.log_prob(jnp.asarray(x))),
                               rtol=1e-12)
    for method in methods:
        np.testing.assert_allclose(getattr(dt, method)().numpy(),
                                   np.asarray(getattr(dj, method)()),
                                   rtol=1e-12, err_msg=method)
    draw = dt.sample(torch.Generator().manual_seed(0), (5,))
    assert draw.shape == (5, 3) and torch.isfinite(draw).all()


def test_exactly_one_parameterization_or_value_error():
    with pytest.raises(ValueError):
        td.Gamma(_t([1.0]))
    with pytest.raises(ValueError):
        td.Gamma(_t([1.0]), rate=_t([1.0]), scale=_t([1.0]))
    with pytest.raises(ValueError):
        td.Poisson()
    with pytest.raises(ValueError):
        td.Poisson(rate=_t([1.0]), log_rate=_t([0.0]))


def test_horseshoe_log_prob_gradient_matches_jax():
    """d/dx log p(x) through log_exp1's backward, against jax.grad of the
    JAX Horseshoe (its custom JVP), at 1e-12."""
    scale = np.array([[1.0, 0.3], [2.0, 0.05]])
    x = np.array([[-0.7, 1e-3], [4.0, -0.2]])
    xt = _t(x).requires_grad_(True)
    (g_t,) = torch.autograd.grad(
        td.Horseshoe(_t(scale)).log_prob(xt).sum(), xt)
    g_j = jax.grad(lambda v: jd.Horseshoe(jnp.asarray(scale)).log_prob(v)
                   .sum())(jnp.asarray(x))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)


def test_horseshoe_density_integrates_to_one():
    d = td.Horseshoe(scale=_t(1.0))
    grid = np.logspace(-10, 5, 40000)
    pdf = np.exp(d.log_prob(_t(grid)).numpy())
    assert abs(2 * np.trapezoid(pdf, grid) - 1.0) < 1e-4


def test_horseshoe_tail_matches_analytic():
    # p(x) ~ K log(1 + 2/x^2), K = (2 pi^3)^{-1/2}: the sandwich bounds
    d = td.Horseshoe(scale=_t(1.0))
    k = (2 * np.pi**3) ** -0.5
    for x in [0.5, 1.0, 3.0, 10.0]:
        p = float(torch.exp(d.log_prob(_t(x))))
        lo = k / 2 * np.log(1 + 4 / x**2)
        hi = k * np.log(1 + 2 / x**2)
        assert lo < p < hi, (x, lo, p, hi)


def test_abs_horseshoe_integrates_to_one():
    d = td.AbsHorseshoe(scale=_t(2.0))
    grid = np.logspace(-10, 5, 40000)
    pdf = np.exp(d.log_prob(_t(grid)).numpy())
    assert abs(np.trapezoid(pdf, grid) - 1.0) < 1e-4


def test_exp():
    b = tb.Exp()
    x = _t([-3.0, 0.0, 2.0]).requires_grad_(True)
    y = b.forward(x)
    np.testing.assert_allclose(b.inverse(y).detach().numpy(),
                               x.detach().numpy(), rtol=1e-9, atol=1e-12)
    (jac,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(b.forward_log_det_jacobian(x).detach().numpy(),
                               np.log(np.abs(jac.numpy())), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(
        b.inverse_log_det_jacobian(y).detach().numpy(),
        np.asarray(jb.Exp().inverse_log_det_jacobian(
            jnp.asarray(y.detach().numpy()))), rtol=1e-12)


def test_chain():
    b = tb.Chain([tb.Softplus(), tb.Exp()])  # softplus(exp(x))
    x = _t([-1.0, 0.5]).requires_grad_(True)
    y = b.forward(x)
    jchain = jb.Chain([jb.Softplus(), jb.Exp()])
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jax.nn.softplus(jnp.exp(
            jnp.asarray([-1.0, 0.5])))), rtol=1e-12)
    np.testing.assert_allclose(b.inverse(y).detach().numpy(),
                               x.detach().numpy(), rtol=1e-9)
    (jac,) = torch.autograd.grad(y.sum(), x)
    fldj = b.forward_log_det_jacobian(x).detach().numpy()
    np.testing.assert_allclose(fldj, np.log(np.abs(jac.numpy())), rtol=1e-9)
    np.testing.assert_allclose(
        fldj, np.asarray(jchain.forward_log_det_jacobian(
            jnp.asarray([-1.0, 0.5]))), rtol=1e-12)


# ---------------------------------------------- horshoe_plus=False models
N, D, K, S = 24, 7, 3, 2


def _nonplus_pair(cls):
    """(JAX model, port model, counts) at horshoe_plus=False; the JAX
    model's calibrated expectations are skipped (every parameter is
    passed explicitly)."""
    x = np.random.default_rng(5).poisson(1.0, (N, D)).astype(np.float64)
    if cls == "BernoulliFactorization":
        x = np.minimum(x, 1.0)
    kw = dict(latent_dim=K, feature_dim=D, u_tau_scale=0.1,
              horshoe_plus=False, dtype="float64",
              data={"counts": x, "indices": np.arange(N)})
    jcls = getattr(spmf_tpu, cls)
    with mock.patch.object(jcls, "set_calibration_expectations",
                           lambda self, *a, **k: None):
        jm = jcls(**kw)
    return jm, getattr(spmf_tpu_torch, cls)(device="cpu", **kw), x


@pytest.mark.parametrize("cls", ["PoissonFactorization",
                                 "BernoulliFactorization",
                                 "GaussianFactorization"])
def test_nonplus_energy_and_gradient_match_jax(cls):
    """The surrogate is v, w, s, u in that order (so the Normal block is
    flattened in JAX's order), the priors and bijectors are JAX's, and the
    ELBO of one S=2 draw (JAX's base draws, reproduced from its key) and
    its gradient in every surrogate parameter agree at 1e-9."""
    jm, tm, x = _nonplus_pair(cls)
    assert list(tm.surrogate_params) == list(jm.surrogate_params) == [
        "v", "w", "s", "u"]
    assert tm.var_list == ["v", "w", "s", "u"]
    assert set(tm.prior_distribution.names) == set(
        jm.prior_distribution.names) == {"v", "w", "s", "u"}
    assert sorted(tm.bijectors) == sorted(jm.bijectors)
    for name, b in tm.bijectors.items():
        assert type(b).__name__ == type(jm.bijectors[name]).__name__, name
    for name in ("u", "s"):
        node = tm.prior_distribution.model[name].distribution
        assert type(node).__name__ == "AbsHorseshoe"
    rng = np.random.default_rng(2)
    p_np = {n: {k: v + 0.1 * rng.standard_normal(v.shape)
                for k, v in sub.items()}
            for n, sub in to_np(jm.surrogate_params).items()}
    key = jax.random.PRNGKey(3)
    batch = x[:12]

    def loss_j(p):
        samples, logq = jm._surrogate.sample_and_log_prob(p, key, (S,))
        lp = jm.unormalized_log_prob(data={"counts": jnp.asarray(batch)},
                                     **samples)
        return -jnp.mean(lp - logq) / batch.shape[0]

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params = torch_params(p_np, torch.float64)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_(True)
    l_t = elbo_loss(tm._surrogate, tm._energy, params,
                    {"counts": _t(batch)}, None, S,
                    draws=jax_draws(jm, key, S))
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-9)
    for n, sub in to_np(g_j).items():
        for k, ref in sub.items():
            np.testing.assert_allclose(
                params[n][k].grad.numpy(), ref, rtol=1e-9,
                atol=1e-9 * np.abs(ref).max(), err_msg=f"{n}.{k}")


@pytest.mark.parametrize("cls", ["MixedFactorization",
                                 "PoissonMatrixFactorization"])
def test_nonplus_builds_and_fits(cls):
    """The Mixed family and the legacy constructor reach the non-plus
    branch through PoissonFactorization.__init__: a float64 fit of two
    epochs gives finite losses; the IG block is empty."""
    x = np.random.default_rng(6).poisson(1.0, (N, D)).astype(np.float64)
    data = spmf_tpu_torch.data.ArrayDataset(
        {"counts": x, "indices": np.arange(N)}).batch(12)
    kw = dict(latent_dim=K, u_tau_scale=0.1, horshoe_plus=False,
              dtype="float64", device="cpu")
    if cls == "MixedFactorization":
        m = spmf_tpu_torch.MixedFactorization(
            feature_dim=D, data=data, scale_columns=False,
            column_types=["poisson"] * 4 + ["bernoulli"] * 3, **kw)
    else:
        m = spmf_tpu_torch.PoissonMatrixFactorization(data, **kw)
    assert list(m.surrogate_params) == ["v", "w", "s", "u"]
    assert m._surrogate._ig_names == []
    losses = m.fit(num_steps=2, learning_rate=0.05, sample_size=S,
                   verbose=False)
    assert np.isfinite(losses).all()
