"""The Bernoulli, Gaussian (both observation models), Mixed and legacy
families of the port against spmf_tpu's, built from the same arguments: the
parameter trees convert leaf for leaf, the energy parts agree at 1e-9 in
float64 on the same numpy-made samples, the twin-fused energy agrees with the
plain one in values and gradients, and the families' own rules hold (prior
weight, surrogate inits, COO dispatch, encode, column types)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmf_tpu
from spmf_tpu.data import ArrayDataset as JaxDS

import spmf_tpu_torch
from spmf_tpu_torch.data import ArrayDataset, SparseCounts
from spmf_tpu_torch.utils import params_from_numpy

from torch_ref import to_np, torch_params

N, D, K, B, S = 48, 13, 3, 24, 3
TYPES = (["poisson"] * 5 + ["bernoulli"] * 5 + ["normal"] * 3)
TYPES = [TYPES[i] for i in np.random.default_rng(7).permutation(D)]


def _data(kind):
    """Counts, binarised counts, or the three column kinds of TYPES."""
    rng = np.random.default_rng(3)
    X = rng.poisson(1.0, (N, D)).astype(np.float64)
    if kind == "binary":
        X = np.minimum(X, 1.0)
    elif kind == "mixed":
        bern = [i for i, t in enumerate(TYPES) if t == "bernoulli"]
        norm = [i for i, t in enumerate(TYPES) if t == "normal"]
        X[:, bern] %= 2
        X[:, norm] = rng.normal(size=(N, len(norm)))
    return X


#: name -> (class name, data kind, constructor arguments)
FAMILIES = {
    "bernoulli": ("BernoulliFactorization", "binary", {}),
    "gaussian_poisson": ("GaussianFactorization", "counts",
                         dict(scale_columns=False)),
    "gaussian_normal": ("GaussianFactorization", "counts",
                        dict(scale_columns=False, observation_model="normal",
                             obs_scale=0.7)),
    "mixed": ("MixedFactorization", "mixed",
              dict(column_types=TYPES, obs_scale=0.8, scale_columns=False)),
    "legacy": ("PoissonMatrixFactorization", "counts",
               dict(scale_rates=False, with_s=True)),
}


def _pair(name, dtype="float64", **extra):
    """(JAX model, port model, data) from the same arguments; the JAX
    model's calibrated expectations (a jitted 250-sample scan) are skipped,
    the tests pass every parameter explicitly."""
    cls, kind, kw = FAMILIES[name]
    X = _data(kind)
    kw = dict(kw, latent_dim=K, u_tau_scale=0.1, dtype=dtype, **extra)
    jcls, tcls = getattr(spmf_tpu, cls), getattr(spmf_tpu_torch, cls)
    jds = JaxDS({"counts": X, "indices": np.arange(N)}).batch(B)
    tds = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(B)
    with mock.patch.object(jcls, "set_calibration_expectations",
                           lambda self, *a, **k: None):
        if name == "legacy":     # the data-first constructor probes D
            jm = jcls(jds, **kw)
        else:
            jm = jcls(feature_dim=D, data=jds, **kw)
    tm = (tcls(tds, device="cpu", **kw) if name == "legacy"
          else tcls(feature_dim=D, data=tds, device="cpu", **kw))
    return jm, tm, X


def _samples(model, n=S, seed=4, positive=False):
    """Values of every surrogate variable's shape with a leading sample
    axis: positive under a Softplus bijector, signed under Identity (unless
    ``positive``)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in model._surrogate.surrogates.items():
        shape = (n,) + tuple(s.shape)
        signed = (type(s.bijector).__name__ == "Identity"
                  and not positive)
        out[name] = (rng.normal(0.0, 0.5, shape) if signed
                     else rng.lognormal(-1.0, 0.5, shape))
    return out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_params_convert_leaf_for_leaf(name):
    """A JAX surrogate_params tree becomes the port's: same structure,
    shapes and initial values (so each family's surrogate inits came
    through its hooks), same bijector kinds."""
    jm, tm, _ = _pair(name)
    tree = params_from_numpy(to_np(jm.surrogate_params), "cpu", "float64")
    assert list(tree) == list(tm.surrogate_params)
    for var, sub in tm.surrogate_params.items():
        assert set(tree[var]) == set(sub)
        for leaf, t in sub.items():
            assert tree[var][leaf].shape == t.shape
            np.testing.assert_allclose(tree[var][leaf].numpy(), t.numpy(),
                                       rtol=1e-12, err_msg=f"{var}.{leaf}")
        assert (type(tm._surrogate.surrogates[var].bijector).__name__
                == type(jm._surrogate.surrogates[var].bijector).__name__)
    assert tm.feature_dim == jm.feature_dim == D
    np.testing.assert_allclose(tm.eta_i.numpy(), np.asarray(jm.eta_i))
    np.testing.assert_allclose(tm.xi_u_global.numpy(),
                               np.asarray(jm.xi_u_global))


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_energy_parts_match_jax_f64(name, log_transform):
    jm, tm, X = _pair(name, log_transform=log_transform)
    samples = _samples(jm)
    batch = X[:B]
    jparts = jax.jit(lambda b, p: jm.unormalized_log_prob_parts(
        {"counts": b}, **p))(jnp.asarray(batch),
                             {k: jnp.asarray(v) for k, v in samples.items()})
    tparts = tm.unormalized_log_prob_parts(
        {"counts": batch}, **torch_params(samples, torch.float64))
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_twin_fused_energy_matches_plain(name):
    """fused_likelihood=True on the CPU runs the twins (float32 inside):
    the 'x' part at 1e-5 of the plain float64 energy, the gradients with
    respect to the samples at rtol 5e-4 of their largest entry."""
    _, plain, X = _pair(name)
    _, fused, _ = _pair(name, fused_likelihood=True)
    assert fused.fusion_active and fused._can_fuse((B, D))
    assert fused.fusion_inactive_reason is None
    # signed loadings under a Poisson likelihood give negative rates, and
    # there the two paths differ by design: autograd sends a gradient through
    # the clip bound, the fused energy holds it constant
    samples = _samples(plain, positive=name == "gaussian_poisson")
    batch = {"counts": X[:B]}
    grads = {}
    for tag, m in (("plain", plain), ("fused", fused)):
        p = torch_params(samples, torch.float64)
        for t in p.values():
            t.requires_grad_(True)
        parts = m.unormalized_log_prob_parts(batch, **p)
        parts["x"].sum().backward()
        grads[tag] = (parts["x"].detach().numpy(),
                      {k: t.grad.numpy() for k, t in p.items()
                       if t.grad is not None})
    np.testing.assert_allclose(grads["fused"][0], grads["plain"][0],
                               rtol=1e-5)
    assert set(grads["fused"][1]) == set(grads["plain"][1]) >= {"u", "v", "w",
                                                                "s"}
    for k, g in grads["plain"][1].items():
        np.testing.assert_allclose(grads["fused"][1][k], g, rtol=5e-4,
                                   atol=5e-4 * np.abs(g).max(), err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_fit_two_epochs_lowers_the_loss(name, fused):
    _, tm, _ = _pair(name, dtype="float32", fused_likelihood=fused,
                     gamma_sampler="fused")
    tm._surrogate.fused_normals = fused
    losses = tm.fit(num_steps=2, learning_rate=0.05, sample_size=4,
                    verbose=False)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert tm.fusion_active == fused


def test_prior_weight_forwarding():
    """Gaussian forwards prior_weight to the parts; Bernoulli and the legacy
    Poisson model hard-code 1, as the reference does."""
    for name, forwards in (("gaussian_normal", True), ("bernoulli", False),
                           ("legacy", False)):
        _, tm, X = _pair(name)
        p = torch_params(_samples(tm), torch.float64)
        batch = {"counts": X[:B]}
        one = tm.unormalized_log_prob(batch, prior_weight=1.0, **p)
        half = tm.unormalized_log_prob(batch, prior_weight=0.5, **p)
        parts = tm.unormalized_log_prob_parts(batch, prior_weight=0.5, **p)
        if forwards:
            np.testing.assert_allclose(half.numpy(),
                                       sum(parts.values()).numpy(),
                                       rtol=1e-12)
            assert not np.allclose(half.numpy(), one.numpy())
        else:
            np.testing.assert_array_equal(half.numpy(), one.numpy())


def test_gaussian_inits_and_signed_loadings():
    _, tm, _ = _pair("gaussian_normal")
    p = tm.surrogate_params
    assert float(p["v"]["loc"][0, 0]) == -5.0
    assert float(p["w"]["loc"][0, 0]) == 0.5
    np.testing.assert_allclose(
        torch.nn.functional.softplus(p["w"]["raw_scale"]).numpy(), 1e-3,
        rtol=1e-9)
    kinds = {n: type(s.bijector).__name__
             for n, s in tm._surrogate.surrogates.items()}
    assert [kinds[n] for n in ("u", "v", "w", "s")] == [
        "Identity", "Identity", "Identity", "Softplus"]
    assert tm._fused_kind() == ("normal", 0.7) and tm._fused_codes() is None
    _, faithful, _ = _pair("gaussian_poisson")
    assert faithful._fused_kind() == "poisson"


@pytest.mark.parametrize("name", ["mixed", "bernoulli", "gaussian_normal"])
def test_scoring_through_row_twin_equals_plain(name):
    """_row_log_likelihood, waic and log_likelihood through row_loglik_twin
    against the plain path, for Mixed's codes lane above all."""
    _, plain, X = _pair(name)
    _, fused, _ = _pair(name, fused_likelihood=True)
    samples = torch_params(_samples(plain, n=4), torch.float64)
    batch = {"counts": X[:B], "indices": np.arange(B)}
    ll_p = plain._row_log_likelihood(batch, samples).numpy()
    ll_f = fused._row_log_likelihood(batch, samples).numpy()
    assert ll_f.shape == (4, B) and np.isfinite(ll_f).all()
    np.testing.assert_allclose(ll_f, ll_p, rtol=2e-5)
    fused.surrogate_params = plain.surrogate_params
    w_p = plain.waic(num_samples=6, sample_chunk=3)
    w_f = fused.waic(num_samples=6, sample_chunk=3)
    for k in ("waic", "se", "lppd", "pwaic"):
        assert np.isfinite(w_f[k])
        np.testing.assert_allclose(w_f[k], w_p[k], rtol=1e-3, err_msg=k)
    ll = fused.log_likelihood(num_samples=6, sample_chunk=3)
    np.testing.assert_allclose(ll["total"], w_f["lppd"], rtol=1e-12)
    if name == "mixed":
        np.testing.assert_array_equal(
            fused._fused_codes(),
            np.asarray(_pair(name)[0]._fused_codes()))


def test_bernoulli_coo_batch_densifies_not_poisson_energy():
    """A COO batch fed to a model whose likelihood is not the stock Poisson
    goes through the densify and the family's own dense machinery: the COO
    energy computes Poisson math only."""
    _, tm, X = _pair("bernoulli")
    assert not tm._coo_energy_supported()
    Xb = X[:B]
    coo = next(iter(SparseCounts.from_dense(Xb).batch(B).as_coo()))
    p = torch_params(_samples(tm), torch.float64)
    lp_d = tm.unormalized_log_prob({"counts": Xb, "indices": np.arange(B)},
                                   **p)
    # patched on the class that defines it: the dispatch goes by where in
    # the MRO the COO energy is defined
    with mock.patch.object(spmf_tpu_torch.PoissonFactorization,
                           "_coo_log_prob_parts",
                           side_effect=AssertionError("Poisson COO energy")):
        lp_c = tm.unormalized_log_prob(coo, **p)
    np.testing.assert_allclose(lp_c.numpy(), lp_d.numpy(), rtol=1e-12)
    _, legacy, _ = _pair("legacy")
    assert legacy._coo_energy_supported()


def test_bernoulli_encode_has_no_row_scaling():
    jm, tm, X = _pair("bernoulli")
    assert tm.scale_rows       # the inherited flag is on, and not consulted
    s = _samples(tm, n=2)
    z = tm.encode(X[:B], torch.tensor(s["u"]), torch.tensor(s["s"]))
    A = tm.encoding_matrix(torch.tensor(s["u"]), torch.tensor(s["s"]))
    np.testing.assert_allclose(
        z.numpy(), (tm.encoder_function(X[:B]) @ A).numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jm.encode(X[:B], jnp.asarray(s["u"]),
                                        jnp.asarray(s["s"]))), rtol=1e-12)


def test_mixed_validates_column_types():
    Mixed = spmf_tpu_torch.MixedFactorization
    with pytest.raises(ValueError, match="column_types is required"):
        Mixed(latent_dim=2, device="cpu")
    with pytest.raises(ValueError, match="Unknown column type"):
        Mixed(column_types=["poisson", "gamma"], latent_dim=2, device="cpu")
    with pytest.raises(ValueError, match="feature_dim must match"):
        Mixed(column_types=["poisson", "normal"], feature_dim=3,
              latent_dim=2, device="cpu")
    m = Mixed(column_types=["poisson", "normal", "bernoulli"], latent_dim=2,
              device="cpu", dtype="float32")
    assert m.feature_dim == 3
    np.testing.assert_array_equal(m._fused_codes(), [[0.0, 2.0, 1.0]])
    assert m._fused_codes().dtype == np.float32


def test_legacy_constructor_shapes():
    Legacy = spmf_tpu_torch.PoissonMatrixFactorization
    X = _data("counts")
    ds = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(B)
    m = Legacy(ds, latent_dim=2, scale_rates=False, with_s=False,
               encoder=None, device="cpu", dtype="float64")
    assert m.feature_dim == D and not m.scale_rows
    assert m.column_norm_factor is m.eta_i
    sp = SparseCounts.from_dense(X).batch(B).as_coo()
    m2 = Legacy(sp, latent_dim=2, device="cpu", dtype="float64")
    assert m2.feature_dim == D and m2.scale_rows
    dec = lambda z: torch.exp(z) - 1.0  # noqa: E731
    m3 = Legacy(ds, latent_dim=2, decoder=dec, device="cpu", dtype="float64")
    assert m3.decoder_function is dec
