"""The engine options of the port against spmf_tpu (CPU): the STL
estimator (``elbo_estimator='stl'`` and the surrogate's ``logq_params``
seam), ``aux_broadcast``, the exact Gamma sampler and ``remat_sampling``.

Tolerances: energies and gradients under the same base draws (JAX's,
reproduced from its key) 1e-10 in float64; the exact sampler's implicit
gradient 1e-3 relative of ``jax.lax.random_gamma_grad`` at the same
(a, x) (torch's series against JAX's; ROADMAP's deliberate differences);
rematerialised fits equal the plain ones bit for bit (to 1e-12 with two
sample batches, whose gradients add in another order)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from spmf_tpu import PoissonFactorization as JaxPF
from spmf_tpu.data import ArrayDataset as JaxDS

from spmf_tpu_torch import (BernoulliFactorization, GaussianFactorization,
                            MixedFactorization, PoissonAutoencoder,
                            PoissonFactorization, PoissonMatrixFactorization)
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.ops import gamma as tgamma
from spmf_tpu_torch.vi import minibatch as tmb
from spmf_tpu_torch.vi import surrogates as tsur
from spmf_tpu_torch.vi.remat import RematDraw

from torch_ref import jax_draws, model_pair, perturbed_params, to_np, \
    torch_params

N_S, D_S, K_S, S_S = 64, 12, 3, 4


# --------------------------------------------- STL and aux_broadcast vs JAX
def _jax_loss(jm, params, batch, key, stl):
    sur = jm._surrogate

    def loss_fn(p):
        lqp = (jax.tree_util.tree_map(jax.lax.stop_gradient, p) if stl
               else None)
        samples, logq = sur.sample_and_log_prob(p, key, (S_S,),
                                                logq_params=lqp)
        lp = jm.unormalized_log_prob(data=batch, **samples)
        return -jnp.mean(lp - logq) / N_S

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), to_np(grads)


def _torch_loss(tm, p_np, batch, draws, stl):
    params = torch_params(p_np, torch.float64)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_(True)
    lqp = ({n: {k: t.detach() for k, t in sub.items()}
            for n, sub in params.items()} if stl else None)
    samples, logq = tm._surrogate.sample_and_log_prob(
        params, None, (S_S,), draws=draws, logq_params=lqp)
    loss = -torch.mean(tm._energy(batch, samples, 1.0) - logq) / N_S
    loss.backward()
    return float(loss.detach()), {n: {k: t.grad.numpy()
                                      for k, t in sub.items()}
                                  for n, sub in params.items()}


@pytest.mark.parametrize("stl, aux", [(True, False), (False, True),
                                      (True, True)])
def test_stl_and_broadcast_loss_and_gradients_match_jax(stl, aux):
    """-ELBO / rows and its gradient with the STL density (log q at the
    stopped parameters) and with the horseshoe auxiliaries drawn once a
    step, against spmf_tpu on the same draws, at 1e-10."""
    jm, tm, X = model_pair("float64", N_S, D_S, K_S, gamma_sampler="fast",
                           aux_broadcast=aux)
    p_np = perturbed_params(jm, scale=0.1)
    key = jax.random.PRNGKey(11)
    x = X.astype(np.float64)
    loss_j, g_j = _jax_loss(jm, jax.tree_util.tree_map(jnp.asarray, p_np),
                            {"counts": jnp.asarray(x),
                             "indices": jnp.arange(N_S)}, key, stl)
    draws = jax_draws(jm, key, S_S)
    assert ("bc_ig_u" in draws) == aux
    loss_t, g_t = _torch_loss(tm, p_np, {"counts": torch.tensor(x),
                                         "indices": torch.arange(N_S)},
                              draws, stl)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-10)
    for n in g_j:
        for k in g_j[n]:
            np.testing.assert_allclose(
                g_t[n][k], g_j[n][k], rtol=1e-10,
                atol=1e-10 * np.abs(g_j[n][k]).max(), err_msg=f"{n}.{k}")


def test_aux_broadcast_shapes_and_unbiasedness():
    """tests/test_engine.py:137 on the port: broadcast variables carry no
    sample axis, log q and the energy stay (S,), the mean ELBO over 40
    generators agrees with the independent estimator, and it trains."""
    Xc = np.random.default_rng(0).poisson(1.0, (100, 6))
    data = ArrayDataset({"counts": Xc, "indices": np.arange(100)}).batch(100)
    kw = dict(latent_dim=2, feature_dim=6, u_tau_scale=0.1, dtype="float64",
              device="cpu", data=data)
    m_ind = PoissonFactorization(**kw)
    m_bc = PoissonFactorization(aux_broadcast=True, **kw)
    assert m_bc._surrogate.broadcast_names == frozenset(
        n for n in m_bc.surrogate_params if "_eta" in n or "_tau" in n)
    gen = torch.Generator().manual_seed(0)
    s, lq = m_bc._surrogate.sample_and_log_prob(m_bc.surrogate_params, gen,
                                                (5,))
    assert s["u"].shape == (5, 6, 2) and s["u_eta"].shape == (6, 2)
    assert lq.shape == (5,)
    batch = {k: torch.as_tensor(v) for k, v in next(iter(data)).items()}
    assert m_bc.unormalized_log_prob(data=batch, **s).shape == (5,)
    # the posterior means draw every variable per sample
    assert m_bc.calibrated_expectations["u_eta"].shape == (6, 2)

    def elbo(m, seed):
        with torch.no_grad():
            s, lq = m._surrogate.sample_and_log_prob(
                m.surrogate_params, torch.Generator().manual_seed(seed), (8,))
            return float(torch.mean(m.unormalized_log_prob(data=batch, **s)
                                    - lq))

    e_ind = np.mean([elbo(m_ind, k) for k in range(40)])
    e_bc = np.mean([elbo(m_bc, k) for k in range(40)])
    np.testing.assert_allclose(e_bc, e_ind, rtol=0.05)
    losses = m_bc.fit(batched_data_factory=data, num_steps=2,
                      learning_rate=0.1, sample_size=4, verbose=False)
    assert np.isfinite(losses).all()


def test_aux_broadcast_without_the_plus_prior_broadcasts_nothing():
    """horshoe_plus=False has no _eta / _tau surrogate: nothing is
    broadcast, in both packages."""
    m = PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu",
                             horshoe_plus=False, aux_broadcast=True)
    jm = JaxPF(latent_dim=2, feature_dim=5, horshoe_plus=False,
               aux_broadcast=True)
    assert m._surrogate.broadcast_names == frozenset()
    assert jm._surrogate.broadcast_names == frozenset()


def _gaussian_problem():
    """tests/test_engine.py's conjugate problem on the port."""
    x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
    sur = tsur.SurrogatePosterior({"z": tsur.TransformedSurrogate(
        tsur.TrainableNormal(np.zeros((1, 1)), 0.5 * np.ones((1, 1)), 2,
                             dtype=torch.float64, device="cpu"),
        tb.Identity())})

    def energy(batch, samples, prior_weight):
        z = samples["z"][..., 0, 0]
        obs = torch.as_tensor(batch["counts"])
        return (-0.5 * z * z - 0.5 * torch.sum(
            (obs[None, :] - z[..., None]) ** 2, dim=-1)
            - 0.5 * (obs.shape[0] + 1) * np.log(2 * np.pi))

    return x, sur, energy


def test_stl_estimator_converges_to_same_posterior():
    """tests/test_engine.py:352 on the port: the STL fit reaches the
    analytic posterior mean, and at the optimum its gradient's variance is
    below the standard estimator's."""
    x, sur, energy = _gaussian_problem()
    data = ArrayDataset({"counts": x}).batch(64)
    result = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), lambda: iter(data), sample_size=32,
        num_steps=300, learning_rate=0.05, rel_tol=None, verbose=False,
        dtype=torch.float64, seed=0, elbo_estimator="stl")
    loc = float(result.params["z"]["loc"][0, 0])
    np.testing.assert_allclose(loc, x.sum() / (len(x) + 1), atol=0.1)

    batch = {"counts": torch.tensor(x)}

    def grad_at(gen, stl):
        p = {n: {k: t.clone().requires_grad_(True) for k, t in sub.items()}
             for n, sub in result.params.items()}
        lqp = ({n: {k: t.detach() for k, t in sub.items()}
                for n, sub in p.items()} if stl else None)
        s, lq = sur.sample_and_log_prob(p, gen, (4,), logq_params=lqp)
        (-torch.mean(energy(batch, s, 1.0) - lq)).backward()
        return float(p["z"]["raw_scale"].grad[0, 0])

    g_std = np.var([grad_at(torch.Generator().manual_seed(k), False)
                    for k in range(64)])
    g_stl = np.var([grad_at(torch.Generator().manual_seed(k), True)
                    for k in range(64)])
    assert g_stl < g_std, (g_stl, g_std)


def test_stl_logq_params_seam_matches_log_prob_and_is_stable():
    """tests/test_engine.py:391 on the port: with a second parameter tree
    the density equals ``log_prob`` at it, evaluated without a
    constrained-space inverse, and the samples equal the plain path's."""
    Xc = np.random.default_rng(0).poisson(1.0, (50, 5))
    m = PoissonFactorization(latent_dim=2, feature_dim=5, u_tau_scale=0.1,
                             dtype="float64", device="cpu",
                             data=ArrayDataset({"counts": Xc}).batch(50))
    sur, p = m._surrogate, m.surrogate_params
    p2 = {n: {k: t + 0.1 for k, t in sub.items()} for n, sub in p.items()}
    s, lq = sur.sample_and_log_prob(p, torch.Generator().manual_seed(4),
                                    (3,), logq_params=p2)
    np.testing.assert_allclose(lq.numpy(), sur.log_prob(p2, s).numpy(),
                               rtol=1e-8)
    s0, _ = sur.sample_and_log_prob(p, torch.Generator().manual_seed(4),
                                    (3,))
    for n in s0:
        assert torch.equal(s[n], s0[n]), n


# --------------------------------------------------------- the exact sampler
def test_exact_gradient_matches_jax_random_gamma_grad():
    """The exact sampler's implicit gradient at its own draws against
    ``jax.lax.random_gamma_grad`` at the same (a, x): 1e-3 relative over
    a in [0.05, 50] (float64)."""
    a = torch.tensor(np.geomspace(0.05, 50.0, 4000), requires_grad=True)
    gen = torch.Generator().manual_seed(2)
    x = tgamma.sample_gamma(gen, a, "exact")
    w = torch.rand(a.shape, generator=gen, dtype=torch.float64)
    (x * w).sum().backward()
    ref = w.numpy() * np.asarray(jax.lax.random_gamma_grad(
        jnp.asarray(a.detach().numpy()), jnp.asarray(x.detach().numpy())))
    np.testing.assert_allclose(a.grad.numpy(), ref, rtol=1e-3)


def test_exact_draws_are_gamma_and_floored():
    """KS distance of the draws from Gamma(a) (tests/test_gamma_sampler.py
    holds the WH draws to 0.02), means near a; no draw under sqrt(tiny),
    even at a small concentration in float32."""
    gen = torch.Generator().manual_seed(0)
    for a in (0.7, 1.0, 2.0, 5.0):
        x = tgamma.sample_gamma(gen, torch.full((20_000,), a), "exact")
        assert st.kstest(x.numpy(), "gamma", args=(a,)).statistic < 0.02
        np.testing.assert_allclose(float(x.mean()), a, rtol=0.05)
    g = tgamma.sample_gamma(gen, torch.full((200_000,), 0.05), "exact")
    assert bool((g >= torch.finfo(torch.float32).tiny ** 0.5).all())


def test_wh_gradient_matches_exact():
    """tests/test_gamma_sampler.py:25 and :42 on the port: d/da of the
    mean draw is about 1 for both samplers, the WH gradient within 0.1 of
    the exact one, and the means agree."""
    def grad_of_mean(method):
        a = torch.tensor(2.0, requires_grad=True)
        gen = torch.Generator().manual_seed(0)
        torch.mean(tgamma.sample_gamma(
            gen, torch.ones(100_000) * a, method)).backward()
        return float(a.grad)

    g_fast, g_exact = grad_of_mean("fast"), grad_of_mean("exact")
    np.testing.assert_allclose(g_exact, 1.0, rtol=0.05)
    np.testing.assert_allclose(g_fast, g_exact, rtol=0.1)
    gen = torch.Generator().manual_seed(1)
    conc = torch.full((1000,), 3.0)
    x_e = tgamma.sample_gamma(gen, conc, "exact")
    x_f = tgamma.sample_gamma(gen, conc, "fast")
    assert x_e.shape == x_f.shape
    np.testing.assert_allclose(float(x_f.mean()), float(x_e.mean()),
                               rtol=0.15)


def test_exact_sampler_refuses_antithetic():
    """tests/test_antithetic.py:123 on the port: an 'exact' surrogate
    refuses antithetic draws with spmf_tpu's ValueError; an odd S refuses
    first."""
    sur = tsur.SurrogatePosterior({"t": tsur.TransformedSurrogate(
        tsur.TrainableInverseGamma(5.0 * np.ones(5), np.ones(5), 1,
                                   dtype=torch.float64, device="cpu"),
        tb.Softplus())})
    assert sur.gamma_sampler == "exact"     # spmf_tpu's default
    params = sur.init()
    with pytest.raises(ValueError, match="even"):
        sur.sample_and_log_prob(params, torch.Generator(), (7,),
                                antithetic=True)
    with pytest.raises(ValueError, match="antithetic"):
        sur.sample_and_log_prob(params, torch.Generator(), (8,),
                                antithetic=True)


def test_model_exact_gamma_trains():
    """tests/test_gamma_sampler.py:51 with the exact sampler."""
    X = np.random.default_rng(0).poisson(1.0, (200, 8))
    data = ArrayDataset({"counts": X, "indices": np.arange(200)}).batch(100)
    m = PoissonFactorization(latent_dim=3, feature_dim=8, u_tau_scale=0.1,
                             dtype="float64", device="cpu",
                             gamma_sampler="exact", data=data)
    losses = m.fit(batched_data_factory=data, num_steps=3, learning_rate=0.1,
                   sample_size=4, verbose=False)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


# -------------------------------------------------------------------- remat
def _remat_fit(remat, dtype="float64", sampler="fast", fused_normals=False,
               scan=False, **fit_kw):
    X = np.random.default_rng(0).poisson(1.0, (250, 30))
    ds = ArrayDataset({"counts": X, "indices": np.arange(250)}).shuffle(
        seed=3).batch(100)
    if scan:
        ds = ds.to_device(device="cpu", dtype=dtype)
    m = PoissonFactorization(latent_dim=3, feature_dim=30, dtype=dtype,
                             device="cpu", gamma_sampler=sampler, data=ds,
                             u_tau_scale=1.0 / np.sqrt(250 * 30))
    m._surrogate.fused_normals = fused_normals
    losses = m.fit(num_steps=2, sample_size=4, verbose=False, rel_tol=None,
                   learning_rate=2.0, patience=1, remat_sampling=remat,
                   **fit_kw)
    assert m.last_fit.extras["epoch_scan"] == scan
    return losses, m.surrogate_params, m.last_fit.learning_rate


@pytest.mark.parametrize("dtype, sampler, fused_normals, scan", [
    ("float64", "fast", False, False), ("float32", "fused", False, True),
    ("float32", "fused", True, False)])
def test_remat_equals_no_remat_bit_for_bit(dtype, sampler, fused_normals,
                                           scan):
    """Two epochs of three steps (a plateau restore between them) with the
    draw rematerialised equal the plain fit bit for bit: the WH path at
    float64, and at float32 the fused samplers' twins (K3's, and K6's
    too), in the general loop and on the scan path."""
    on = _remat_fit(True, dtype, sampler, fused_normals, scan)
    off = _remat_fit(False, dtype, sampler, fused_normals, scan)
    assert on[0] == off[0] and on[2] == off[2]
    for n, sub in on[1].items():
        for k, t in sub.items():
            assert torch.equal(t, off[1][n][k]), (n, k)


@pytest.mark.parametrize("fit_kw", [dict(sample_batches=2),
                                    dict(elbo_estimator="stl")])
def test_remat_with_two_sample_batches_and_stl(fit_kw):
    """With two sample batches each draw is recomputed from its own state;
    their gradients add in another order than the plain backward's, so the
    fit is held at 1e-12. STL under remat equals STL without (bit for bit
    in practice; held at the same 1e-12)."""
    on = _remat_fit(True, **fit_kw)
    off = _remat_fit(False, **fit_kw)
    np.testing.assert_allclose(on[0], off[0], rtol=1e-12)
    for n, sub in on[1].items():
        for k, t in sub.items():
            np.testing.assert_allclose(t.numpy(), off[1][n][k].numpy(),
                                       rtol=1e-12, atol=1e-12)


def test_remat_backward_redraws_the_forward_samples(monkeypatch):
    """The backward's draw equals the forward's bit for bit, and the
    generator is left where the forward left it."""
    seen = []
    m = PoissonFactorization(latent_dim=2, feature_dim=6, dtype="float64",
                             device="cpu")
    gen = torch.Generator().manual_seed(9)
    params = {n: {k: t.clone().requires_grad_(True) for k, t in sub.items()}
              for n, sub in m.surrogate_params.items()}

    def draw(p):
        out = m._surrogate.sample_and_log_prob(p, gen, (4,))
        seen.append({n: v.detach().clone() for n, v in out[0].items()})
        return out

    values, lq = RematDraw(draw, gen)(params)
    after = gen.get_state()
    (sum(v.sum() for v in values.values()) + lq.sum()).backward()
    assert len(seen) == 2
    for n in seen[0]:
        assert torch.equal(seen[0][n], seen[1][n]), n
    assert torch.equal(gen.get_state(), after)
    assert all(t.grad is not None for sub in params.values()
               for t in sub.values())


def test_remat_default_follows_the_sampler(monkeypatch):
    """remat_sampling=None turns rematerialisation on unless the sampler
    is 'fused' (spmf_tpu's default); an explicit value wins."""
    made = []

    class Spy(RematDraw):
        def __init__(self, *a):
            made.append(1)
            super().__init__(*a)

    monkeypatch.setattr(tmb, "RematDraw", Spy)
    X = np.random.default_rng(0).poisson(1.0, (32, 6))
    data = ArrayDataset({"counts": X}).batch(16)
    m = PoissonFactorization(latent_dim=2, feature_dim=6, dtype="float32",
                             device="cpu", data=data)
    for sampler, kw, expect in (("fast", {}, 1), ("exact", {}, 1),
                                ("fused", {}, 0),
                                ("fused", dict(remat_sampling=True), 1),
                                ("fast", dict(remat_sampling=False), 0)):
        made.clear()
        m._surrogate.gamma_sampler = sampler
        tmb.fit_surrogate_posterior(
            m._energy, m._surrogate, m.surrogate_params, m.data,
            num_steps=1, sample_size=2, verbose=False, **kw)
        assert len(made) == expect, (sampler, kw)


# ------------------------------------------------------- across the families
def _family(name):
    X = np.random.default_rng(1).poisson(1.0, (40, 6)).astype(float)
    data = ArrayDataset({"counts": X, "indices": np.arange(40)}).batch(20)
    kw = dict(dtype="float64", device="cpu", data=data)
    if name == "autoencoder":
        return PoissonAutoencoder(data=data, latent_dim=2, dtype="float64",
                                  device="cpu")
    if name == "legacy":
        return PoissonMatrixFactorization(data, latent_dim=2,
                                          dtype="float64", device="cpu")
    cls, extra = {
        "bernoulli": (BernoulliFactorization, {}),
        "gaussian": (GaussianFactorization, dict(observation_model="normal")),
        "mixed": (MixedFactorization,
                  dict(column_types=["poisson"] * 3 + ["bernoulli"] * 3)),
        "nonplus": (PoissonFactorization, dict(horshoe_plus=False)),
    }[name]
    if name == "bernoulli":
        kw["data"] = ArrayDataset({"counts": np.minimum(X, 1.0),
                                   "indices": np.arange(40)}).batch(20)
    return cls(latent_dim=2, feature_dim=6, **extra, **kw)


@pytest.mark.parametrize("family", ["bernoulli", "gaussian", "mixed",
                                    "legacy", "nonplus", "autoencoder"])
def test_every_family_runs_the_options(family):
    """Each option runs in each family it applies to: the fit options (stl,
    remat) in every model, the autoencoder included, and the surrogate
    options (exact, aux_broadcast) in the factorizers (the autoencoder has
    no InverseGamma block and no aux option)."""
    m = _family(family)

    def fit(**kw):
        losses = m.fit(num_steps=1, sample_size=2, learning_rate=0.01,
                       verbose=False, rel_tol=None, **kw)
        assert np.isfinite(losses).all(), kw

    fit(elbo_estimator="stl")
    fit(remat_sampling=True)
    if family == "autoencoder":
        return
    m.gamma_sampler = m._surrogate.gamma_sampler = "exact"
    fit()
    m.gamma_sampler = "fast"
    m.aux_broadcast = True
    m.create_distributions()
    assert bool(m._surrogate.broadcast_names) == (family != "nonplus")
    fit()
