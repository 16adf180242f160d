"""Names of spmf_tpu's public API that the port lacked, held to spmf_tpu on
the CPU in float64: ``build_surrogate_posterior`` in ``vi`` and
``vi.advi``; the nine exports of ``ops``, ``ig_sample_logq_reference`` and
``config.default_dtype``; ``dist`` / ``sample_and_log_prob`` / ``mean`` of
the per-variable surrogates and any other base inside
``SurrogatePosterior``; ``shard_batch(..., axis='dp')``."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import inspect
import pathlib
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


# ------------------------------------------------------------------ F14
# The port's public surface against spmf_tpu's: every public callable both
# packages share takes spmf_tpu's positional parameters in spmf_tpu's order
# (without ``interpret``, and with ``generator`` where spmf_tpu takes
# ``key``), the port's own parameters are keyword-only, and shared
# parameters have equal defaults.
_JAX_ROOT = pathlib.Path(__file__).resolve().parents[1] / "spmf_tpu"
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD,
               inspect.Parameter.VAR_POSITIONAL)
_LEFT_OUT_PARAMS = {"interpret"}        # ROADMAP.md §1, left out on purpose
_RENAMED = {"key": "generator"}
# public names of spmf_tpu the port leaves out (ROADMAP.md §1, "Left out of
# the port on purpose")
_LEFT_OUT_NAMES = {"spmf_tpu.config.x64_enabled",
                   "spmf_tpu.utils.checkpoint.OrbaxCheckpointer",
                   "spmf_tpu.utils.debug.warn_known_bad_sample_dim"}
# (spmf_tpu callable, parameter): the defaults that differ on purpose, each
# with the ROADMAP.md §1 line ("Deliberate differences") that records it
_DEFAULT_DIFFERENCES = {
    ("spmf_tpu.nn.dense.DenseHorseshoe", "dtype"):
        "`nn.DenseHorseshoe(dtype=None)` takes the port's float32 default",
    ("spmf_tpu.vi.waic.waic", "dtype"):
        "`vi.waic.waic` casts the batch to its `dtype` (float32 by default)",
}


def _jax_modules():
    """spmf_tpu's public modules, from the file tree (nothing imported)."""
    out = []
    for path in sorted(_JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(_JAX_ROOT.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if not any(p.startswith("_") for p in parts):
            out.append(".".join(parts))
    return out


def _from_spmf_tpu(obj):
    return getattr(obj, "__module__", "").split(".")[0] == "spmf_tpu"


def _public_callables(module):
    """(name, object, listed): the names in ``__all__`` (listed) and the
    other public callables the module defines itself."""
    listed = list(getattr(module, "__all__", []))
    for name in listed:
        yield name, getattr(module, name), True
    for name, obj in vars(module).items():
        if (not name.startswith("_") and name not in listed
                and getattr(obj, "__module__", None) == module.__name__):
            yield name, obj, False


def _public_methods(cls):
    """Public methods of ``cls``, inherited ones included, that spmf_tpu
    defines (``__init__`` is the class's own signature)."""
    for name in dir(cls):
        obj = getattr(cls, name, None)
        if (not name.startswith("_") and callable(obj)
                and not inspect.isclass(obj) and _from_spmf_tpu(obj)):
            yield name


def _default(value):
    """A default in a form both packages share: dtypes by name, functions
    (softplus) by ``__name__``."""
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, np.dtype) or (isinstance(value, type)
                                       and hasattr(value, "dtype")):
        return np.dtype(value).name
    if callable(value) and hasattr(value, "__name__"):
        return value.__name__
    return value


def _signature_gaps(label, where, jfn, tfn):
    """What keeps a call written for ``jfn`` from binding the same way in
    ``tfn``, as a list of messages."""
    js, ts = inspect.signature(jfn), inspect.signature(tfn)
    jparams = {_RENAMED.get(n, n): p for n, p in js.parameters.items()
               if n not in _LEFT_OUT_PARAMS}
    jpos = [n for n, p in jparams.items() if p.kind in _POSITIONAL]
    tpos = [n for n, p in ts.parameters.items() if p.kind in _POSITIONAL]
    gaps = []
    if tpos[:len(jpos)] != jpos:
        gaps.append(f"{label}: spmf_tpu's positional parameters {jpos} are "
                    f"not a prefix of the port's {tpos}")
    for n, p in ts.parameters.items():
        if n not in jparams and p.kind not in (p.KEYWORD_ONLY, p.VAR_KEYWORD):
            gaps.append(f"{label}: the port's own parameter {n!r} is not "
                        "keyword-only")
    for n, p in jparams.items():
        q = ts.parameters.get(n)
        if q is None:
            gaps.append(f"{label}: the port has no parameter {n!r}")
        elif (where, n) not in _DEFAULT_DIFFERENCES:
            a, b = _default(p.default), _default(q.default)
            same = a == b
            if not isinstance(same, bool):
                same = bool(np.array_equal(a, b))
            if not same:
                gaps.append(f"{label}: default of {n!r} is {q.default!r}, "
                            f"spmf_tpu's {p.default!r}")
    return gaps


@pytest.mark.parametrize("module", _jax_modules())
def test_public_signatures_follow_spmf_tpu(module):
    """Every public callable of ``module`` that the port also has, and each
    public method of its classes: spmf_tpu's positional parameters are a
    prefix of the port's, every parameter only the port has is
    keyword-only, and the shared ones default alike."""
    import importlib

    jmod = importlib.import_module(module)
    tmod = importlib.import_module(
        module.replace("spmf_tpu", "spmf_tpu_torch", 1))
    gaps = []
    for name, jobj, listed in _public_callables(jmod):
        if not callable(jobj) or not _from_spmf_tpu(jobj):
            continue
        where = f"{jobj.__module__}.{jobj.__qualname__}"
        tobj = getattr(tmod, name, None)
        if tobj is None:
            if listed and where not in _LEFT_OUT_NAMES:
                gaps.append(f"{name}: missing from the port")
            continue
        gaps += _signature_gaps(name, where, jobj, tobj)
        if inspect.isclass(jobj):
            for m in _public_methods(jobj):
                if not hasattr(tobj, m):
                    gaps.append(f"{name}.{m}: missing from the port")
                    continue
                gaps += _signature_gaps(f"{name}.{m}", f"{where}.{m}",
                                        getattr(jobj, m), getattr(tobj, m))
    assert not gaps, "\n".join(gaps)


# Calls written in spmf_tpu's positional order bind as the keyword calls
# do: the two agree bit for bit from the same generator state, float64 on
# the CPU (fused_poisson_loglik is float32, as in spmf_tpu).
class _FixedDraws:
    """A surrogate whose ``sample`` returns the first n of fixed draws."""

    def __init__(self, draws, to, device=None):
        self.draws, self.to, self.device = draws, to, device

    def sample(self, params, key, sample_shape):
        return {k: self.to(v[:sample_shape[0]]) for k, v in self.draws.items()}


def test_waic_takes_spmf_tpus_positional_order():
    """dtype 7th and sample_chunk 8th (10 draws in chunks of 4, 4, 2), in
    both packages on the same draws: 1e-10 against spmf_tpu, the tolerance
    of tests/test_torch_waic.py::test_waic_matches_jax_with_fixed_draws."""
    from spmf_tpu.vi.waic import waic as jax_waic

    from spmf_tpu_torch.vi.waic import waic

    from torch_ref import model_pair, random_samples

    jm, tm, X = model_pair("float64")
    draws = random_samples(jm, 10, seed=8)
    data = [{"counts": X[i * 32:(i + 1) * 32].astype(float),
             "indices": np.arange(32)} for i in range(2)]
    stub = _FixedDraws(draws, torch.as_tensor, device="cpu")
    pos = waic(tm._row_log_likelihood, stub, None, lambda: iter(data), 10,
               1, F64, 4)
    kw = waic(tm._row_log_likelihood, stub, None, lambda: iter(data),
              num_samples=10, seed=1, sample_chunk=4, dtype=F64,
              device="cpu")
    assert pos == kw and pos["n_rows"] == 64
    out_j = jax_waic(jm._row_log_likelihood, _FixedDraws(draws, jnp.asarray),
                     None, lambda: iter(data), 10, 1, jnp.float64, 4)
    assert set(out_j) == set(pos)
    for k in out_j:
        np.testing.assert_allclose(pos[k], out_j[k], rtol=1e-10, err_msg=k)


def test_fit_surrogate_posterior_takes_spmf_tpus_positional_order(tmp_path):
    """A two-epoch fit with every one of spmf_tpu's 33 parameters by
    position: opt_state (22nd), profile_dir (23rd), remat_sampling (24th)
    and prefetch (27th) at values other than their defaults."""
    import copy

    sur = _custom_surrogate("fast")
    x = np.random.default_rng(0).normal(1.0, 1.0, (64, 3))

    def energy(batch, samples, prior_weight):
        c = samples["c"]
        return (-0.5 * torch.sum(torch.log(c) ** 2, -1)
                - 0.5 * torch.sum((batch["counts"][None] - c[:, None]) ** 2,
                                  (-1, -2))
                - torch.sum(samples["u"], (-1, -2))
                - torch.sum(samples["a"], -1))

    data = ArrayDataset({"counts": x}).batch(32)
    factory = lambda: iter(data)  # noqa: E731
    warm = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), factory, sample_size=4, num_steps=1,
        learning_rate=0.05, rel_tol=None, verbose=False, dtype=F64)
    opts = {"opt_state": warm.opt_state, "profile_dir": str(tmp_path),
            "remat_sampling": True, "prefetch": 0}
    pos = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), factory, None, None, 4, 1, 2, 0.05, 0.99,
        None, None, 5.0, 3, 8, 11, F64, None, None, False,
        copy.deepcopy(opts["opt_state"]), opts["profile_dir"], True, "auto",
        None, 0, None, "standard", False, None, None, True)
    assert any(tmp_path.iterdir())          # profile_dir took the trace
    kw = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), factory, sample_size=4, num_steps=2,
        learning_rate=0.05, rel_tol=None, seed=11, dtype=F64, verbose=False,
        **dict(opts, opt_state=copy.deepcopy(opts["opt_state"])))
    assert len(pos.losses) == 3 and pos.losses == kw.losses
    for n, sub in kw.params.items():
        for k, t in sub.items():
            assert torch.equal(pos.params[n][k], t), (n, k)


def test_sample_and_log_prob_takes_spmf_tpus_positional_order():
    """aux_broadcast=True with apply_broadcast=False and antithetic=True by
    position (4th and 6th): every variable is drawn per sample, mirrored."""
    from spmf_tpu_torch import PoissonFactorization

    X = np.random.default_rng(0).poisson(1.0, (40, 6))
    data = ArrayDataset({"counts": X, "indices": np.arange(40)}).batch(40)
    m = PoissonFactorization(latent_dim=2, feature_dim=6, u_tau_scale=0.1,
                             dtype="float64", device="cpu", data=data,
                             aux_broadcast=True, gamma_sampler="fast")
    sur, params = m._surrogate, m.surrogate_params
    assert sur.broadcast_names
    pos = sur.sample_and_log_prob(params, torch.Generator().manual_seed(5),
                                  (4,), False, None, True)
    kw = sur.sample_and_log_prob(params, torch.Generator().manual_seed(5),
                                 (4,), apply_broadcast=False,
                                 logq_params=None, antithetic=True)
    assert torch.equal(pos[1], kw[1]) and set(pos[0]) == set(kw[0])
    for n, v in kw[0].items():
        assert v.shape[0] == 4 and torch.equal(pos[0][n], v), n


def test_fused_poisson_loglik_takes_spmf_tpus_positional_order():
    """The mixed likelihood's codes 8th and the static clip 9th."""
    import spmf_tpu_torch.ops as tops
    from spmf_tpu_torch.ops import fused_poisson as tfp

    rng = np.random.default_rng(4)
    S, B, K, D = 2, 5, 3, 6
    args = [torch.as_tensor(a) for a in (
        rng.gamma(2.0, 0.3, (S, B, K)), rng.gamma(2.0, 0.3, (S, K, D)),
        rng.gamma(2.0, 0.1, (S, 1, D)),
        rng.poisson(1.0, (B, D)).astype(np.float64), np.ones((1, D)))]
    codes = np.array([[tfp.CODE_POISSON, tfp.CODE_BERNOULLI,
                       tfp.CODE_NORMAL] * 2], np.float64)
    args[3][:, 1::3] = args[3][:, 1::3].clamp(max=1.0)
    lik = ("mixed", 0.7)
    pos = tops.fused_poisson_loglik(*args, False, lik, codes, "static")
    kw = tops.fused_poisson_loglik(*args, log_transform=False,
                                   likelihood=lik, codes=codes, clip="static")
    assert pos.shape == (S,) and torch.equal(pos, kw)


def test_lattice_uniform_takes_spmf_tpus_positional_order():
    """gens 5th; the device is the generator's, else the card."""
    from spmf_tpu_torch.ops.gamma import lattice_uniform

    gens = (1, 3299, 4919)
    pos = lattice_uniform(torch.Generator().manual_seed(2), 4, (3, 5), F64,
                          gens)
    kw = lattice_uniform(torch.Generator().manual_seed(2), 4, (3, 5), F64,
                         gens=gens, device="cpu")
    assert pos.shape == (4, 3, 5) and torch.equal(pos, kw)
    ones = lattice_uniform(torch.Generator().manual_seed(2), 4, (3, 5), F64)
    assert torch.equal(pos[:, 0], ones[:, 0])   # generator 1 in both
    assert not torch.equal(pos[:, 1], ones[:, 1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lattice_uniform(None, 4, (3,), F64, bits=np.zeros(3, np.int64))
