"""The rest of the models' API against spmf_tpu (float64, CPU):
``encode_batched``, ``predictive_distribution``,
``unormalized_log_prob_list``, the bound surrogate view, and
``build_surrogate_posterior`` with the joint prior's ``sample`` and the
surrogates' ``log_prob``."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmf_tpu
from spmf_tpu import bijectors as jb
from spmf_tpu import distributions as jd
from spmf_tpu.data import ArrayDataset as JaxDS
from spmf_tpu.vi.surrogates import \
    build_surrogate_posterior as jax_build_surrogate_posterior

import spmf_tpu_torch
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch import distributions as td
from spmf_tpu_torch.data import ArrayDataset as TorchDS
from spmf_tpu_torch.models.base import BoundSurrogate
from spmf_tpu_torch.utils import flatten_jax_order, params_from_numpy
from spmf_tpu_torch.vi.surrogates import build_surrogate_posterior

from torch_ref import perturbed_params, to_np

N, D, K = 40, 6, 2


def _counts(n=N):
    return np.random.default_rng(0).poisson(1.0, (n, D)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _pair():
    """JAX and port PoissonFactorization on the same data and parameters."""
    x = _counts()
    data = {"counts": x, "indices": np.arange(N)}
    common = dict(latent_dim=K, feature_dim=D, u_tau_scale=0.1,
                  dtype="float64")
    jm = spmf_tpu.PoissonFactorization(data=JaxDS(data).batch(N), **common)
    tm = spmf_tpu_torch.PoissonFactorization(data=TorchDS(data).batch(N),
                                             device="cpu", **common)
    p = perturbed_params(jm, seed=2, scale=0.1)
    jm.surrogate_params = jax.tree_util.tree_map(jnp.asarray, p)
    tm.surrogate_params = params_from_numpy(p, device="cpu",
                                            dtype=torch.float64)
    return jm, tm


def _jax_samples(jm, n=3):
    """Draws of the JAX surrogate, as numpy and as the port's tensors."""
    s = jax.tree_util.tree_map(np.asarray, jm._surrogate.sample(
        jm.surrogate_params, jax.random.PRNGKey(0), (n,)))
    return s, {k: torch.as_tensor(np.array(v)) for k, v in s.items()}


@pytest.mark.parametrize("family", ["PoissonFactorization",
                                    "BernoulliFactorization"])
def test_encode_batched_matches_encode(family):
    """N=100 in chunks of 7 (a remainder of 2): the same rows as the
    one-shot encode, the row-scaling branch included; Bernoulli's own
    encode (no row scaling) is the one the chunks go through."""
    x = np.random.default_rng(1).poisson(1.0, (100, D)).astype(np.float64)
    m = getattr(spmf_tpu_torch, family)(
        latent_dim=K, feature_dim=D, u_tau_scale=1 / np.sqrt(100 * D),
        dtype="float64", device="cpu",
        data=TorchDS({"counts": x}).batch(50))
    full = m.encode(x).numpy()
    chunked = m.encode_batched(x, row_chunk=7)
    assert isinstance(chunked, np.ndarray) and chunked.shape == (100, K)
    np.testing.assert_allclose(chunked, full, rtol=1e-12)
    np.testing.assert_allclose(m.encode_batched(x[:5]), full[:5], rtol=1e-12)
    u = m.calibrated_expectations["u"] * 2.0
    np.testing.assert_allclose(m.encode_batched(x, u=u, row_chunk=9),
                               m.encode(x, u=u).numpy(), rtol=1e-12)


def test_predictive_distribution_matches_jax():
    jm, tm = _pair()
    s_np, s_t = _jax_samples(jm)
    batch = {"counts": _counts()}
    pj = jm.predictive_distribution(data=batch, **s_np)
    pt = tm.predictive_distribution(data=batch, **s_t)
    # tests/test_utils.py's shapes: the sample dims summed out of the
    # log-likelihood, not of the rate
    assert tuple(pt["log_likelihood"].shape) == (N, D)
    assert tuple(pt["rate"].shape) == (3, N, D)
    for key in ("log_likelihood", "rate"):
        np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]),
                                   rtol=1e-12)
    # a single draw keeps its shape
    one = {k: v[0] for k, v in s_t.items()}
    assert tuple(tm.predictive_distribution(
        data=batch, **one)["log_likelihood"].shape) == (N, D)


def test_unormalized_log_prob_list_matches_jax():
    jm, tm = _pair()
    assert tm.var_list == jm.var_list
    s_np, s_t = _jax_samples(jm)
    lj = jm.unormalized_log_prob_list(*[s_np[n] for n in jm.var_list])
    lt = tm.unormalized_log_prob_list(*[s_t[n] for n in tm.var_list])
    assert tuple(lt.shape) == (3,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12)


def test_surrogate_log_prob_matches_jax():
    """log q of the JAX draws under the model's surrogate: Normal and
    InverseGamma bases, Softplus bijectors inverted."""
    jm, tm = _pair()
    s_np, s_t = _jax_samples(jm)
    lj = jm._surrogate.log_prob(jm.surrogate_params, s_np)
    lt = tm._surrogate.log_prob(tm.surrogate_params, s_t)
    assert tuple(lt.shape) == (3,)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-12)
    assert tm._surrogate.names == list(tm.surrogate_params)


def test_bound_surrogate_view():
    _, tm = _pair()
    view = tm.surrogate_distribution
    assert isinstance(view, BoundSurrogate)
    s = view.sample(4)
    assert tuple(s["u"].shape) == (4, D, K)
    assert set(s) == set(tm.surrogate_params)
    assert all(torch.isfinite(v).all() for v in s.values())
    vals, lq = view.sample_and_log_prob((2,), seed=1)
    assert tuple(lq.shape) == (2,)
    ref_vals, ref_lq = tm._surrogate.sample_and_log_prob(
        tm.surrogate_params, torch.Generator().manual_seed(1), (2,))
    assert torch.equal(lq, ref_lq)
    assert all(torch.equal(vals[k], ref_vals[k]) for k in vals)
    # seed=None: the n-th call of a view draws from seed 1000 + n
    fresh = tm.surrogate_distribution
    a, b = fresh.sample(2), fresh.sample(2)
    ref = tm._surrogate.sample(tm.surrogate_params,
                               torch.Generator().manual_seed(1002), (2,))
    assert torch.equal(b["u"], ref["u"]) and not torch.equal(a["u"], b["u"])
    g = torch.Generator().manual_seed(7)
    assert torch.equal(view.sample(2, seed=g)["s"],
                       view.sample(2, seed=7)["s"])
    assert view.variables is tm.surrogate_params
    assert tm.surrogate_vars is tm.surrogate_params


def _priors():
    """The same small joint prior in both packages, with its bijectors: an
    Identity and a Softplus root, and a Softplus node that depends on the
    latter."""
    loc_a, scale_a, scale_b = np.zeros((3, 2)), np.ones((3, 2)), np.full(4, .5)
    jp = jd.JointDistributionNamed({
        "c": lambda b: jd.Independent(jd.HalfNormal(scale=b[..., None, :]),
                                      2),
        "a": jd.Independent(jd.Normal(jnp.asarray(loc_a),
                                      jnp.asarray(scale_a)), 2),
        "b": jd.Independent(jd.HalfNormal(scale=jnp.asarray(scale_b)), 1)})
    t = torch.as_tensor
    tp = td.JointDistributionNamed({
        "c": lambda b: td.Independent(td.HalfNormal(scale=b[..., None, :]),
                                      2),
        "a": td.Independent(td.Normal(t(loc_a), t(scale_a)), 2),
        "b": td.Independent(td.HalfNormal(scale=t(scale_b)), 1)})
    return (jp, {"b": jb.Softplus(), "c": jb.Softplus()},
            tp, {"b": tb.Softplus(), "c": tb.Softplus()})


def test_build_surrogate_posterior_matches_jax():
    jp, jbij, tp, tbij = _priors()
    over = dict(init_loc={"a": 0.5, "c": np.full((1, 4), -1.0)},
                init_scale={"b": np.linspace(0.1, 0.4, 4)})
    js = jax_build_surrogate_posterior(jp, jbij, **over)
    ts = build_surrogate_posterior(tp, tbij, **over)
    # the variables in the prior's topological order
    assert ts.names == js.names == ["b", "c", "a"]
    jinit = jax.tree_util.tree_leaves(js.init())
    tinit = flatten_jax_order(ts.init())
    assert len(jinit) == len(tinit)
    for a, b in zip(jinit, tinit):
        assert b.dtype == torch.float64
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the defaults: loc -3 under Softplus, 0 under Identity, scale 1e-3
    plain = build_surrogate_posterior(tp, tbij).init()
    assert float(plain["b"]["loc"][0]) == -3.0
    assert float(plain["a"]["loc"][0, 0]) == 0.0
    torch.testing.assert_close(
        torch.nn.functional.softplus(plain["a"]["raw_scale"]),
        torch.full((3, 2), 1e-3, dtype=torch.float64))
    # log q of fixed values, from perturbed parameters
    rng = np.random.default_rng(3)
    params = {n: {k: v + 0.2 * rng.standard_normal(v.shape)
                  for k, v in sub.items()}
              for n, sub in to_np(js.init()).items()}
    values = {"a": rng.standard_normal((3, 2)),
              "b": rng.lognormal(0.0, 0.5, 4),
              "c": rng.lognormal(0.0, 0.5, (1, 4))}
    lj = js.log_prob(jax.tree_util.tree_map(jnp.asarray, params),
                     {k: jnp.asarray(v) for k, v in values.items()})
    lt = ts.log_prob(params_from_numpy(params, device="cpu",
                                       dtype=torch.float64),
                     {k: torch.as_tensor(v) for k, v in values.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)


def test_joint_and_distribution_samples():
    _, _, tp, _ = _priors()
    g = torch.Generator().manual_seed(0)
    s = tp.sample(g, (5,))
    # roots take the sample shape; the dependent node inherits it
    assert tuple(s["a"].shape) == (5, 3, 2) and tuple(s["b"].shape) == (5, 4)
    assert tuple(s["c"].shape) == (5, 1, 4) and bool((s["c"] > 0).all())
    assert tp._order.index("b") < tp._order.index("c")
    # exact Gamma draws: mean and variance a, at a < 1 and a > 1
    a = torch.tensor([0.3, 2.5], dtype=torch.float64)
    x = td.standard_gamma(g, a.expand(40000, 2))
    se = torch.sqrt(a / 40000)
    assert bool(((x.mean(0) - a).abs() < 5 * se).all()), x.mean(0)
    assert bool(((x.var(0) - a).abs() < 0.1 * a).all()), x.var(0)
    ig = td.InverseGamma(torch.full((3,), 3.0, dtype=torch.float64),
                         torch.full((3,), 2.0, dtype=torch.float64))
    y = ig.sample(g, (20000,))
    assert tuple(y.shape) == (20000, 3)
    assert bool(((y.mean(0) - 1.0).abs() < 0.05).all())   # b / (a - 1)
    sq = td.SqrtInverseGamma(ig.concentration, ig.scale).sample(g, (2,))
    assert tuple(sq.shape) == (2, 3) and bool((sq > 0).all())
    p = td.Poisson(torch.full((4,), 2.0)).sample(g, (3,))
    assert tuple(p.shape) == (3, 4) and bool((p == p.round()).all())
    bern = td.Bernoulli(logits=torch.zeros(6)).sample(g)
    assert tuple(bern.shape) == (6,) and set(bern.tolist()) <= {0.0, 1.0}
