"""Names of spmf_tpu's public API that the port lacked, held to spmf_tpu on
the CPU in float64: ``build_surrogate_posterior`` in ``vi`` and
``vi.advi``; the nine exports of ``ops``, ``ig_sample_logq_reference`` and
``config.default_dtype``; ``dist`` / ``sample_and_log_prob`` / ``mean`` of
the per-variable surrogates and any other base inside
``SurrogatePosterior``; ``shard_batch(..., axis='dp')``."""
import _torch_threads  # noqa: F401  (first: one torch thread)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmf_tpu.ops as jops
from spmf_tpu import bijectors as jb
from spmf_tpu.ops import fused_ig as jig
from spmf_tpu.vi import surrogates as jsur

from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch import distributions as td
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.vi import minibatch as tmb
from spmf_tpu_torch.vi import surrogates as tsur

F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


# ------------------------------------------------------------------- F5
def test_build_surrogate_posterior_is_exported():
    from spmf_tpu_torch.vi import build_surrogate_posterior as a
    from spmf_tpu_torch.vi.advi import build_surrogate_posterior as b

    import spmf_tpu_torch.vi as tvi
    import spmf_tpu_torch.vi.advi as tadvi

    assert a is b is tsur.build_surrogate_posterior
    assert "build_surrogate_posterior" in tvi.__all__
    assert "build_surrogate_posterior" in tadvi.__all__


# ------------------------------------------------------------------- F6
def test_ops_exports_spmf_tpu_names_without_building():
    import spmf_tpu_torch.ops as tops
    from spmf_tpu_torch.config import canonical_dtype, default_dtype
    from spmf_tpu_torch.ops import _build

    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in jops.__all__:
        assert callable(getattr(tops, name)), name
    assert not _build._LIBS          # nothing was compiled to import them
    assert default_dtype() is torch.float32 is canonical_dtype(None)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", ["poisson", "normal", "bernoulli"])
def test_loglik_references_equal_spmf_tpu(name, log_transform):
    import spmf_tpu_torch.ops as tops

    rng = np.random.default_rng(3)
    S, B, K, D = 2, 6, 3, 7
    theta = rng.gamma(2.0, 0.3, (S, B, K))
    v = rng.gamma(2.0, 0.3, (S, K, D))
    phi = rng.gamma(2.0, 0.1, (S, B, D))
    eta = rng.uniform(0.5, 1.5, (1, D))
    x = (rng.poisson(1.0, (B, D)) if name != "bernoulli"
         else rng.integers(0, 2, (B, D))).astype(np.float64)
    kw = {"obs_scale": 0.7} if name == "normal" else {}
    fn = name + "_loglik_reference"
    want = getattr(jops, fn)(*map(jnp.asarray, (theta, v, phi, x, eta)),
                             log_transform=log_transform, **kw)
    got = getattr(tops, fn)(*map(_t, (theta, v, phi, x, eta)),
                            log_transform=log_transform, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


@pytest.mark.parametrize("antithetic", [False, True, "stratified"])
def test_ig_sample_logq_reference_equals_spmf_tpu(antithetic):
    """On the port's Gamma draws (injected into spmf_tpu's sampler), y and
    log q equal spmf_tpu's ``ig_sample_logq_reference``."""
    from spmf_tpu_torch.ops import gamma as tgamma
    from spmf_tpu_torch.ops.fused_ig import ig_sample_logq_reference

    rng = np.random.default_rng(4)
    S, total = 4, 37
    a = _t(rng.uniform(0.3, 3.0, total))
    b = _t(rng.uniform(0.2, 2.0, total))
    y, lq = ig_sample_logq_reference(a, b, torch.Generator().manual_seed(9),
                                     S, antithetic=antithetic)
    g = tgamma.wilson_hilferty_gamma(torch.Generator().manual_seed(9),
                                     a.expand(S, total),
                                     antithetic=antithetic)
    with mock.patch("spmf_tpu.ops.gamma.wilson_hilferty_gamma",
                    lambda key, conc, antithetic=False: jnp.asarray(
                        g.numpy())):
        jy, jlq = jig.ig_sample_logq_reference(
            jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
            jax.random.PRNGKey(0), S, antithetic=antithetic)
    assert y.shape == (S, total) and lq.shape == (S,)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-12)
    np.testing.assert_allclose(lq.numpy(), np.asarray(jlq), rtol=1e-12)


# ------------------------------------------------------------------- F7
def _pairs():
    """(port, spmf_tpu) surrogates of each class, float64, shape (3, 4)."""
    rng = np.random.default_rng(5)
    loc, scale = rng.normal(0.0, 1.0, (3, 4)), rng.uniform(0.2, 1.0, (3, 4))
    conc, igs = rng.uniform(2.0, 5.0, (3, 4)), rng.uniform(0.5, 2.0, (3, 4))
    tn = tsur.TrainableNormal(loc, scale, dtype=F64, device="cpu")
    jn = jsur.TrainableNormal(loc, scale, dtype=jnp.float64)
    ti = tsur.TrainableInverseGamma(conc, igs, dtype=F64, device="cpu")
    ji = jsur.TrainableInverseGamma(conc, igs, dtype=jnp.float64)
    return {
        "normal": (tn, jn),
        "inverse_gamma": (ti, ji),
        "transformed": (tsur.TransformedSurrogate(tn, tb.Softplus()),
                        jsur.TransformedSurrogate(jn, jb.Softplus())),
    }


def _params(s):
    return {k: v for k, v in s.init().items()}


@pytest.mark.parametrize("kind", ["normal", "inverse_gamma", "transformed"])
def test_surrogate_log_prob_and_mean_equal_spmf_tpu(kind):
    ts, js = _pairs()[kind]
    tp, jp = _params(ts), js.init()
    x = np.random.default_rng(6).uniform(0.3, 2.0, (5, 3, 4))
    np.testing.assert_allclose(
        ts.log_prob(tp, _t(x)).numpy(),
        np.asarray(js.log_prob(jp, jnp.asarray(x))), rtol=1e-12)
    if kind != "transformed":
        d = ts.dist(tp)
        assert isinstance(d, td.Normal if kind == "normal"
                          else td.InverseGamma)
        np.testing.assert_allclose(ts.mean(tp).numpy(),
                                   np.asarray(js.mean(jp)), rtol=1e-12)
        return
    # a bijected Normal's mean is sampled: within 4 standard errors
    n = 250
    got = ts.mean(tp, torch.Generator().manual_seed(1), num_samples=n)
    want = np.asarray(js.mean(jp, jax.random.PRNGKey(1), num_samples=n))
    y, _ = ts.sample_and_log_prob(tp, torch.Generator().manual_seed(2), (n,))
    se = y.numpy().std(0) / np.sqrt(n)
    assert got.shape == (3, 4) and ts.mean(tp).shape == (3, 4)
    assert np.all(np.abs(got.numpy() - want) < 4.0 * np.sqrt(2.0) * se)


@pytest.mark.parametrize("kind", ["normal", "inverse_gamma", "transformed"])
def test_surrogate_sample_and_log_prob_scores_its_draws(kind):
    ts, _ = _pairs()[kind]
    tp = {k: v.requires_grad_() for k, v in _params(ts).items()}
    x, lp = ts.sample_and_log_prob(tp, torch.Generator().manual_seed(3),
                                   (5,))
    assert x.shape == (5, 3, 4) and lp.shape == (5,)
    np.testing.assert_allclose(lp.detach().numpy(),
                               ts.log_prob(tp, x).detach().numpy(),
                               rtol=1e-12)
    # a pathwise draw: every parameter leaf gets a gradient
    grads = torch.autograd.grad(x.sum(), list(tp.values()))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)


class LogScaleNormal:
    """A base that is neither TrainableNormal nor TrainableInverseGamma: a
    Normal whose scale is exp(log_scale)."""

    def __init__(self, loc, log_scale):
        self.shape = np.shape(loc)
        self.event_ndims = len(self.shape)
        self.dtype, self.device = F64, torch.device("cpu")
        self._init = {"loc": _t(loc), "log_scale": _t(log_scale)}

    def init(self):
        return {k: v.clone() for k, v in self._init.items()}

    def dist(self, params):
        return td.Normal(params["loc"], torch.exp(params["log_scale"]))

    def sample_and_log_prob(self, params, generator, sample_shape=()):
        x = self.dist(params).sample(generator, sample_shape)
        return x, self.log_prob(params, x)

    def log_prob(self, params, x):
        return torch.sum(self.dist(params).log_prob(x),
                         dim=tuple(range(-self.event_ndims, 0)))


def _custom_surrogate(gamma_sampler="exact"):
    rng = np.random.default_rng(7)
    return tsur.SurrogatePosterior({
        "u": tsur.TransformedSurrogate(tsur.TrainableNormal(
            rng.normal(-1.0, 0.3, (4, 2)), 0.3, dtype=F64, device="cpu"),
            tb.Softplus()),
        "c": tsur.TransformedSurrogate(
            LogScaleNormal(rng.normal(0.0, 1.0, (3,)), np.full(3, -1.0)),
            tb.Exp()),
        "a": tsur.TransformedSurrogate(tsur.TrainableInverseGamma(
            rng.uniform(2.0, 4.0, (4,)), 1.0, dtype=F64, device="cpu"),
            tb.Softplus()),
    }, gamma_sampler=gamma_sampler)


@pytest.mark.parametrize("stl", [False, True], ids=["standard", "stl"])
@pytest.mark.parametrize("gamma_sampler", ["exact", "fast"])
def test_surrogate_posterior_samples_other_bases(gamma_sampler, stl):
    """A custom base is drawn through its own ``sample_and_log_prob`` (and,
    under STL, scored at the stopped parameters): the total log q is the
    sum of the per-variable ``log_prob`` of the values."""
    sur = _custom_surrogate(gamma_sampler)
    params = sur.init()
    stopped = ({n: {k: t.detach() for k, t in p.items()}
                for n, p in params.items()} if stl else None)
    values, logq = sur.sample_and_log_prob(
        params, torch.Generator().manual_seed(8), (5,), logq_params=stopped)
    assert set(values) == {"u", "c", "a"} and values["c"].shape == (5, 3)
    want = sum(sur.surrogates[n].log_prob(params[n], values[n])
               for n in values)
    np.testing.assert_allclose(logq.detach().numpy(),
                               want.detach().numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        sur.log_prob(params, values).detach().numpy(),
        want.detach().numpy(), rtol=1e-12)
    assert sur.mean(params, num_samples=20)["c"].shape == (3,)


@pytest.mark.parametrize("estimator", ["standard", "stl"])
def test_fit_with_a_custom_base_runs(estimator):
    sur = _custom_surrogate("fast")
    x = np.random.default_rng(0).normal(1.0, 1.0, (64, 3))

    def energy(batch, samples, prior_weight):
        c = samples["c"]                                   # (S, 3)
        obs = batch["counts"]                              # (B, 3)
        return (-0.5 * torch.sum(torch.log(c) ** 2, -1)
                - 0.5 * torch.sum((obs[None] - c[:, None]) ** 2, (-1, -2))
                - torch.sum(samples["u"], (-1, -2))
                - torch.sum(samples["a"], -1))

    data = ArrayDataset({"counts": x}).batch(32)
    res = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), lambda: iter(data), sample_size=4,
        num_steps=3, learning_rate=0.05, rel_tol=None, verbose=False,
        dtype=F64, device="cpu", elbo_estimator=estimator)
    # the initial loss and three epochs
    assert len(res.losses) == 4 and np.all(np.isfinite(res.losses))
    assert set(res.params["c"]) == {"loc", "log_scale"}


# ------------------------------------------------------------------- F8
def test_shard_batch_takes_the_dp_axis(monkeypatch):
    """On a 2 x 2 (dp, fp) world seen from rank 1, ``axis='dp'`` gives
    what no axis gives; any other axis raises."""
    from spmf_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "_world", lambda: (4, 1))
    monkeypatch.setattr(torch.distributed, "new_group",
                        lambda ranks: object())
    mesh = tmesh.Mesh(np.arange(4).reshape(2, 2), ("dp", "fp"))
    batch = {"counts": torch.arange(48.0).reshape(8, 6),
             "indices": torch.arange(8)}
    want = tmesh.shard_batch(batch, mesh)
    got = tmesh.shard_batch(batch, mesh, axis="dp")
    assert want["counts"].shape == (4, 3)
    for k in batch:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="'fp'"):
        tmesh.shard_batch(batch, mesh, axis="fp")
