"""fit(antithetic='stratified') in the port against spmf_tpu: the lattice
draws bit for bit (JAX's base integers injected), the mirrored stratified
draws of the WH sampler (eps 1e-12, u exact), the fused IG twin's stratified
stream through the JAX tile math (1e-10), the surrogate fed the JAX
surrogate's stratified draws (1e-10), and the properties of
tests/test_antithetic.py repeated on the port (float64 unless stated)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.ops import fused_ig as jig
from spmf_tpu.ops import gamma as jgamma

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.ops import fused_ig as tig
from spmf_tpu_torch.ops import gamma as tgamma
from spmf_tpu_torch.vi import surrogates as tsur

from torch_ref import S, jax_draws, model_pair, perturbed_params, to_np, torch_params

HALVES = [1, 2, 3, 4, 300]     # 300 > 255: the split quotient


def _jax_bits(key, shape):
    return np.asarray(jax.random.bits(key, shape, jnp.uint32) >> 9)


def test_lattice_generators_agree():
    assert tgamma._LATTICE_GENS == jgamma._LATTICE_GENS == \
        tig._LATTICE_GENS == jig._LATTICE_GENS


@functools.lru_cache(maxsize=None)
def _jax_lattice(half, gens, shape):
    """JAX lattice_uniform from PRNGKey(half) in float32 and float64, one
    compile for both dtypes."""
    key = jax.random.PRNGKey(half)
    out = jax.jit(lambda k: {dt: jgamma.lattice_uniform(k, half, shape,
                                                        jnp.dtype(dt), gens)
                             for dt in ("float32", "float64")})(key)
    return {dt: np.asarray(u) for dt, u in out.items()}, _jax_bits(key, shape)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("gens", [None, jgamma._LATTICE_GENS[1:9]])
@pytest.mark.parametrize("half", HALVES)
def test_lattice_uniform_matches_jax_bit_for_bit(half, gens, dtype):
    shape = (8, 37) if gens is not None else (53,)
    uj, bits = _jax_lattice(half, gens, shape)
    uj = uj[dtype]
    ut = tgamma.lattice_uniform(None, half, shape, getattr(torch, dtype),
                                gens=gens, device="cpu", bits=bits)
    assert ut.shape == (half,) + shape
    np.testing.assert_array_equal(ut.numpy(), uj)


@pytest.mark.parametrize("half", HALVES)
def test_lattice_shift_matches_jax(half):
    p = np.arange(half, dtype=np.int32)
    expect = np.asarray(jig._lattice_shift(jnp.asarray(p), half))
    got = tig.lattice_shift(torch.tensor(p, dtype=torch.int64), half)
    np.testing.assert_array_equal(got.numpy(), expect)
    assert [tig.lattice_shift(int(q), half) for q in p] == expect.tolist()


def test_lattice_uniform_refuses_too_many_pairs():
    with pytest.raises(ValueError):
        tgamma.lattice_uniform(None, 65537, (3,), torch.float64,
                               device="cpu")


@pytest.mark.parametrize("shape", [(8, 30), (6, 11)])   # 4 and 3 pairs
def test_stratified_mirror_draws_match_jax(shape):
    key = jax.random.PRNGKey(sum(shape))
    a = np.random.default_rng(1).uniform(0.3, 5.0, shape)
    # the draws and the WH gamma JAX makes from the key, in one compile
    eps_j, u_j, g_j = jax.jit(lambda k, c: jgamma._mirror_base_draws(
        k, shape, jnp.float64, 8, stratified=True) + (
        jgamma.wilson_hilferty_gamma(k, c, antithetic="stratified"),))(
        key, jnp.asarray(a))
    kn, ku = jax.random.split(key)
    bits = (_jax_bits(kn, shape[1:]), _jax_bits(ku, (8,) + shape[1:]))
    eps_t, u_t = tgamma._mirror_base_draws(None, shape, torch.float64, "cpu",
                                           8, stratified=True, bits=bits)
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_j))
    # and through the WH sampler, as the JAX one draws from the key
    g_t = tgamma.wilson_hilferty_gamma(None, torch.tensor(a),
                                       draws=(eps_t, u_t))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10)


def _ig_params(n, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.uniform(0.6, 6.0, n)),
            torch.tensor(rng.uniform(0.2, 4.0, n)))


@pytest.mark.parametrize("S_", [2, 6, 8])
def test_twin_stratified_stream_is_the_shifted_lattice(S_):
    """Pair p's uniforms are pair 0's with the 23-bit integers shifted by
    lattice_shift((p g_j) % half, half); samples s >= half mirror them."""
    n, seed, half = 257, 4242, S_ // 2
    base = tig.uniforms(n, 0, seed, torch.float64, "cpu")
    m0 = (base * 2.0 ** 23 - 0.5).round().long()
    a = torch.full((n,), 2.0, dtype=torch.float64)
    for s in range(S_):
        p = s % half
        u = tig.uniforms(n, 0, seed, torch.float64, "cpu", pair=p, half=half)
        shifts = torch.tensor([tig.lattice_shift((p * g) % half, half)
                               for g in tig._LATTICE_GENS])
        expect = ((m0 + shifts[:, None]) & 0x7FFFFF).double() * 2.0 ** -23 \
            + 2.0 ** -24
        assert torch.equal(u, expect)
        eps, _, _ = tig._draw_eps_s1_s2(a, seed, s, S_, "stratified")
        eps_p, _, _ = tig._draw_eps_s1_s2(a, seed, p, S_, "stratified")
        assert torch.equal(eps, -eps_p if s >= half else eps_p)
    # the independent and antithetic streams are untouched by the option
    assert torch.equal(base, tig.uniforms(n, 0, seed, torch.float64, "cpu"))


def test_twin_stratified_chain_matches_jax_tile_math():
    """The twin's stratified K3f / K3b on the draws of its own stream equal
    spmf_tpu's _tile_fwd / _tile_bwd fed those draws (1e-10)."""
    S_, n, seed = 6, 300, 99
    a, b = _ig_params(n, 5)
    rng = np.random.default_rng(6)
    gy, glq = rng.normal(size=(S_, n)), rng.normal(size=S_)
    y, lq = tig.ig_twin_fwd(a, b, seed, S_, "stratified")
    ga, gb = tig.ig_twin_bwd(a, b, seed, S_, "stratified", torch.tensor(gy),
                             torch.tensor(glq))
    an, bn = a.numpy(), b.numpy()
    logb = np.log(bn)
    t0 = an * logb - np.asarray(jax.lax.lgamma(jnp.asarray(an)))
    dg0 = logb - np.asarray(jax.lax.digamma(jnp.asarray(an)))
    ga_j, gb_j = np.zeros(n), np.zeros(n)
    for s in range(S_):
        eps, s1, s2 = (t.numpy() for t in tig._draw_eps_s1_s2(
            a, seed, s, S_, "stratified"))
        yj, lqj = jig._tile_fwd(an, bn, logb, t0, eps, s1)
        np.testing.assert_allclose(y[s].numpy(), np.asarray(yj), rtol=1e-10)
        np.testing.assert_allclose(float(lq[s]), float(np.sum(lqj)),
                                   rtol=1e-10)
        dy_da, dy_db, dlq_da, dlq_db = (np.asarray(t) for t in jig._tile_bwd(
            an, bn, logb, dg0, eps, s1, s2))
        ga_j += gy[s] * dy_da + glq[s] * dlq_da
        gb_j += gy[s] * dy_db + glq[s] * dlq_db
    np.testing.assert_allclose(ga.numpy(), ga_j, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gb.numpy(), gb_j, rtol=1e-10, atol=1e-12)


def test_fused_ig_stratified_runs_and_refuses_odd_s():
    a, b = _ig_params(40)
    seed = torch.tensor([7], dtype=torch.int32)
    y, lq = tig.fused_ig_sample_logq(a, b, seed, 4, "stratified")
    assert y.shape == (4, 40) and bool(torch.isfinite(lq).all())
    with pytest.raises(ValueError):
        tig.fused_ig_sample_logq(a, b, seed, 3, "stratified")
    with pytest.raises(ValueError):
        tig.fused_ig_sample_logq(a, b, seed, 4, "lattice")


def test_surrogate_with_jax_stratified_draws_matches_jax():
    """The port's PoissonFactorization surrogate, fed the base draws the JAX
    surrogate makes from a key in stratified mode, gives its values and log
    q at 1e-10."""
    jm, tm, _ = model_pair("float64", gamma_sampler="fast")
    p_np = perturbed_params(jm, seed=3)
    key = jax.random.PRNGKey(21)
    vj, lqj = jax.jit(lambda p, k: jm._surrogate.sample_and_log_prob(
        p, k, (S,), antithetic="stratified"))(
        jax.tree_util.tree_map(jnp.asarray, p_np), key)
    vt, lqt = tm._surrogate.sample_and_log_prob(
        torch_params(p_np, torch.float64), None, (S,),
        antithetic="stratified",
        draws=jax_draws(jm, key, S, antithetic="stratified"))
    for n in vj:
        np.testing.assert_allclose(to_np(vt[n]), np.asarray(vj[n]),
                                   rtol=1e-10)
    np.testing.assert_allclose(lqt.numpy(), np.asarray(lqj), rtol=1e-10)


# ------------------------------------- tests/test_antithetic.py on the port
def _mixed_surrogate():
    f64 = dict(dtype=torch.float64, device="cpu")
    # the pathwise sampler, which antithetic draws need ('exact' refuses)
    return tsur.SurrogatePosterior({
        "a": tsur.TransformedSurrogate(tsur.TrainableNormal(
            1.5 * np.ones((3, 2)), 0.7 * np.ones((3, 2)), 2, **f64),
            tb.Identity()),
        "b": tsur.TransformedSurrogate(tsur.TrainableNormal(
            -2.0 * np.ones((4,)), 0.3 * np.ones((4,)), 1, **f64),
            tb.Softplus()),
        "t": tsur.TransformedSurrogate(tsur.TrainableInverseGamma(
            5.0 * np.ones((5,)), 1.0 * np.ones((5,)), 1, **f64),
            tb.Softplus()),
    }, gamma_sampler="fast")


def test_stratified_marginals_match_independent():
    sur = _mixed_surrogate()
    params = sur.init()
    S_ = 4096
    v_strat, _ = sur.sample_and_log_prob(
        params, torch.Generator().manual_seed(2), (S_,),
        antithetic="stratified")
    v_ind, _ = sur.sample_and_log_prob(
        params, torch.Generator().manual_seed(3), (S_,))
    for name in ("a", "b", "t"):
        a, b = v_strat[name].numpy(), v_ind[name].numpy()
        np.testing.assert_allclose(a.mean(), b.mean(), rtol=0.08)
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.12)


def test_lattice_uniform_grid_and_stratification():
    u = tgamma.lattice_uniform(torch.Generator().manual_seed(0), 4, (257,),
                               torch.float64, device="cpu").numpy()
    assert u.min() >= 2.0 ** -24 and u.max() <= 1 - 2.0 ** -24
    k = u * 2.0 ** 23 - 0.5
    np.testing.assert_allclose(k, np.round(k), atol=0)
    for p in range(4):
        np.testing.assert_allclose(np.sort((u[p] - u[0]) % 1.0),
                                   np.full(257, p / 4.0), atol=2 ** -22)


def _gaussian_problem():
    """tests/test_engine.py's conjugate 1-d problem on the port."""
    x = torch.tensor(np.random.default_rng(0).normal(1.5, 1.0, size=64))
    sur = tsur.SurrogatePosterior({"z": tsur.TransformedSurrogate(
        tsur.TrainableNormal(np.zeros((1, 1)), 0.5 * np.ones((1, 1)), 2,
                             dtype=torch.float64, device="cpu"),
        tb.Identity())})

    def energy(samples):
        z = samples["z"][..., 0, 0]
        lp = -0.5 * z ** 2 - 0.5 * ((x[None, :] - z[:, None]) ** 2).sum(-1)
        return lp - 0.5 * (len(x) + 1) * np.log(2 * np.pi)

    return sur, energy


def test_stratified_gradient_unbiased_and_lower_variance_than_anti():
    """Mean ELBO gradient equals the plain antithetic one within 4 standard
    errors; the per-key variance at S=8 is at most 1.05 times antithetic's
    (128 keys, JAX's test takes 256)."""
    sur, energy = _gaussian_problem()

    def grads(antithetic, n=128):
        out = []
        gen = torch.Generator().manual_seed(7)
        for _ in range(n):
            params = {k: {kk: t.clone().requires_grad_(True)
                          for kk, t in sub.items()}
                      for k, sub in sur.init().items()}
            samples, logq = sur.sample_and_log_prob(params, gen, (8,),
                                                    antithetic=antithetic)
            (-torch.mean(energy(samples) - logq)).backward()
            out.append(torch.cat([params["z"][k].grad.reshape(-1)
                                  for k in ("loc", "raw_scale")]))
        return torch.stack(out).numpy()

    g_anti, g_strat = grads(True), grads("stratified")
    se = np.sqrt(g_anti.var(0) / len(g_anti) + g_strat.var(0) / len(g_strat))
    assert np.all(np.abs(g_anti.mean(0) - g_strat.mean(0)) < 4 * se + 1e-12)
    assert g_strat.var(0).sum() < 1.05 * g_anti.var(0).sum()


def test_model_fit_forwards_stratified():
    X = np.random.default_rng(0).poisson(1.0, (128, 6)).astype(float)
    m = PoissonFactorization(latent_dim=2, feature_dim=6, u_tau_scale=0.1,
                             dtype="float64", device="cpu")
    losses = m.fit(batched_data_factory=ArrayDataset(
        {"counts": X, "indices": np.arange(128)}).batch(128), num_steps=3,
        learning_rate=0.05, sample_size=4, antithetic="stratified", seed=0,
        verbose=False, rel_tol=None)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("antithetic", [False, True, "stratified"])
def test_eps_form_logq_matches_per_variable_density(antithetic):
    """The eps-form log q of the Normal block against the per-variable
    Normal density at the values (log N(x; loc, scale) - fldj(x)), values,
    log q and parameter gradients at 1e-10."""
    sur = _mixed_surrogate()
    del sur.surrogates["t"]
    sur = tsur.SurrogatePosterior(sur.surrogates, gamma_sampler="fast")
    params = {k: {kk: t.clone().requires_grad_(True) for kk, t in sub.items()}
              for k, sub in sur.init().items()}
    values, lq = sur.sample_and_log_prob(
        params, torch.Generator().manual_seed(3), (4,), antithetic=antithetic)
    ref = 0.0
    for n, s in sur.surrogates.items():
        x = s.bijector.inverse(values[n])
        scale = torch.nn.functional.softplus(params[n]["raw_scale"])
        dens = torch.distributions.Normal(params[n]["loc"], scale).log_prob(x)
        ref = ref + (dens - s.bijector.forward_log_det_jacobian(x)).sum(
            tuple(range(1, x.dim())))
    np.testing.assert_allclose(lq.detach().numpy(), ref.detach().numpy(),
                               rtol=1e-10)
    g_eps = torch.autograd.grad(lq.sum(), [params[n]["raw_scale"]
                                           for n in params], retain_graph=True)
    g_ref = torch.autograd.grad(ref.sum(), [params[n]["raw_scale"]
                                            for n in params])
    for a, b in zip(g_eps, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10)


def test_kernel_digamma_recipe():
    """The digamma of csrc/fused_ig.cu's backward (recurrence to x >= 6, then
    the asymptotic series to 1/x^6), run in float32 on the CPU, against
    torch.digamma in float64: within 6e-7 of max(1, |digamma|) over a in
    [1e-3, 1e4] (5.3e-7 near its root; torch.digamma in float32 reads
    8.5e-7 there)."""
    a64 = torch.logspace(-3, 4, 20001, dtype=torch.float64)
    x = a64.float()
    acc = torch.zeros_like(x)
    for _ in range(6):
        low = x < 6.0
        acc = torch.where(low, acc - 1.0 / x, acc)
        x = torch.where(low, x + 1.0, x)
    r = 1.0 / x
    r2 = r * r
    psi = acc + torch.log(x) - 0.5 * r - r2 * (
        1.0 / 12 - r2 * (1.0 / 120 - r2 * (1.0 / 252)))
    ref = torch.digamma(a64.float().double())
    err = ((psi.double() - ref).abs() / ref.abs().clamp_min(1.0)).max()
    assert float(err) < 6e-7, float(err)
