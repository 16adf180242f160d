"""The fused Normal sampler's twin (the CPU side of kernel K6): its tile math
against spmf_tpu's, its replay backward against autograd, its output against
the plain Normal block of both packages fed the twin's own standard normals,
and the dispatch rules of the surrogate's opt-in seam.

The JAX kernel itself has no CPU lowering (it seeds the TPU's hardware
generator), so it is held through its tile math, as tests/test_fused_ig.py
holds it.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from spmf_tpu import bijectors as jtfb
from spmf_tpu.ops import fused_normal as jfn
from spmf_tpu.vi import surrogates as jsur

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.ops import fused_normal as tfn
from spmf_tpu_torch.vi import surrogates as tsur
from spmf_tpu_torch.vi.minibatch import elbo_loss

N = 400
#: the Gaussian family's Normal block: u, v, w Identity and s Softplus
SHAPES = {"v": (3, 20), "w": (1, 20), "u": (20, 3), "s": (2, 20)}
GAUSSIAN = {"v": "identity", "w": "identity", "u": "identity",
            "s": "softplus"}
POISSON = {n: "softplus" for n in SHAPES}
TOTAL = sum(int(np.prod(s)) for s in SHAPES.values())


def _flat(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 2.0, n), rng.normal(0.0, 1.5, n),
            (rng.random(n) < 0.5).astype(np.float64), rng.normal(size=n))


@pytest.mark.parametrize("mask_kind", ["identity", "softplus", "both"])
def test_tile_math_matches_jax(mask_kind):
    """_ntile_fwd / _ntile_bwd on the same loc, raw_scale, mask, eps in
    float64, 1e-12, for either bijector branch and a mix."""
    loc, rs, mask, eps = _flat()
    mask = {"identity": np.zeros(N), "softplus": np.ones(N),
            "both": mask}[mask_kind]
    scale = np.log1p(np.exp(rs))
    sig_rs = 1.0 / (1.0 + np.exp(-rs))
    J = lambda *v: [jnp.asarray(x) for x in v]  # noqa: E731
    T = lambda *v: [torch.tensor(x) for x in v]  # noqa: E731
    for j, t in zip(jfn._ntile_fwd(*J(loc, scale, np.log(scale), mask, eps)),
                    tfn._ntile_fwd(*T(loc, scale, np.log(scale), mask, eps))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    for j, t in zip(jfn._ntile_bwd(*J(loc, scale, sig_rs, mask, eps)),
                    tfn._ntile_bwd(*T(loc, scale, sig_rs, mask, eps))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-300)


def test_replay_backward_matches_autograd():
    """normal_twin_bwd, and the autograd.Function's replay backward (the twin
    path on the CPU), against torch.autograd through the twin forward on the
    same stream (1e-9)."""
    S = 4
    loc, rs, mask, _ = _flat(seed=3, n=300)
    rng = np.random.default_rng(4)
    gy = torch.tensor(rng.normal(size=(S, 300)))
    glq = torch.tensor(rng.normal(size=S))
    seed = torch.tensor([777], dtype=torch.int32)
    m = torch.tensor(mask)

    def run(fn):
        lt = torch.tensor(loc, requires_grad=True)
        rt = torch.tensor(rs, requires_grad=True)
        y, lq = fn(lt, rt, m, seed, S)
        ((y * gy).sum() + (lq * glq).sum()).backward()
        return y.detach(), lq.detach(), lt.grad, rt.grad

    out_ad = run(tfn.normal_twin_fwd)
    out_fn = run(tfn.fused_normal_sample_logq)
    for f, r in zip(out_fn, out_ad):
        np.testing.assert_allclose(f.numpy(), r.numpy(), rtol=1e-9,
                                   atol=1e-12)
    gl, gr = tfn.normal_twin_bwd(torch.tensor(loc), torch.tensor(rs), m, seed,
                                 S, gy, glq)
    np.testing.assert_allclose(gl.numpy(), out_ad[2].numpy(), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(gr.numpy(), out_ad[3].numpy(), rtol=1e-9,
                               atol=1e-12)
    # samples differ from one another, and from the IG sampler's stream
    assert not torch.equal(out_fn[0][0], out_fn[0][1])


def test_stream_is_standard_normal_on_its_own_key():
    """The draws are N(0, 1) on the half-ulp uniform grid, and key (seed, 1)
    never repeats the IG sampler's (seed, 0) uniform."""
    from spmf_tpu_torch.ops import fused_ig as tig

    eps = tfn.draw_eps(50000, 2, 99, torch.float64, "cpu")
    assert stats.kstest(eps.numpy(), "norm").pvalue > 1e-3
    u_ig = tig.uniforms(50000, 2, 99, torch.float64, "cpu")[0]
    eps_ig = 2.0 ** 0.5 * torch.erfinv(2.0 * u_ig - 1.0)
    assert float((eps == eps_ig).double().mean()) < 1e-3


@pytest.mark.parametrize("q", [0, 1, 5])
def test_draw_eps_takes_four_words_of_one_philox_call(q):
    """Samples 4q .. 4q+3 are the four words of the one Philox4x32-10 call
    at counter (i, q, 0, 0), key (seed, 1), bit for bit."""
    from spmf_tpu_torch.ops import fused_ig as tig

    total, seed = 1000, 2024
    idx = torch.arange(total, dtype=torch.int64)
    zero = torch.zeros_like(idx)
    words = tig.philox4x32(idx, zero + q, zero, zero, seed, 1)
    for k, w in enumerate(words):
        ref = 2.0 ** 0.5 * torch.erfinv(
            2.0 * tig.uniform_from_bits(w, torch.float64) - 1.0)
        assert torch.equal(
            tfn.draw_eps(total, 4 * q + k, seed, torch.float64, "cpu"), ref)


@pytest.mark.parametrize("s", [0, 1, 2])
def test_words_of_one_call_are_independent_normals(s):
    """Samples s and s+1, two words of one Philox call, over 50,000
    elements: uncorrelated (|r| < 0.02, 4.5 standard errors) and each
    N(0, 1) by KS."""
    a = tfn.draw_eps(50000, s, 31, torch.float64, "cpu").numpy()
    b = tfn.draw_eps(50000, s + 1, 31, torch.float64, "cpu").numpy()
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.02
    for x in (a, b):
        assert stats.kstest(x, "norm").pvalue > 1e-3


def _torch_surrogate(kinds, dtype, gamma_sampler="fused"):
    bij = {"identity": tfb.Identity, "softplus": tfb.Softplus}
    rng = np.random.default_rng(11)
    sur = {n: tsur.TransformedSurrogate(
        tsur.TrainableNormal(rng.normal(0, 1, s), rng.uniform(0.1, 1, s), 2,
                             dtype=dtype, device="cpu"), bij[kinds[n]]())
        for n, s in SHAPES.items()}
    return tsur.SurrogatePosterior(sur, gamma_sampler=gamma_sampler)


def _jax_surrogate(kinds, dtype):
    bij = {"identity": jtfb.Identity, "softplus": jtfb.Softplus}
    rng = np.random.default_rng(11)
    sur = {n: jsur.TransformedSurrogate(
        jsur.TrainableNormal(rng.normal(0, 1, s), rng.uniform(0.1, 1, s), 2,
                             dtype=dtype), bij[kinds[n]]())
        for n, s in SHAPES.items()}
    return jsur.SurrogatePosterior(sur, gamma_sampler="fast")


def _twin_eps(seed, S, dtype):
    return torch.stack([tfn.draw_eps(TOTAL, s, seed, dtype, "cpu")
                        for s in range(S)])


@pytest.mark.parametrize("kinds", [GAUSSIAN, POISSON],
                         ids=["gaussian_layout", "all_softplus"])
@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("float64", 1e-12)])
def test_seam_matches_plain_block_of_both_packages(kinds, dtype, rtol):
    """With the seam on, sample_and_log_prob equals the port's plain
    _sample_normals and JAX's, both fed the twin's own eps: float32 through
    the wrapper (1e-6 of the largest entry: two orders of f32 rounding),
    float64 through the twin directly (1e-12)."""
    S = 4
    tdt = getattr(torch, dtype)
    sur = _torch_surrogate(kinds, dtype)
    params = sur.init()
    names = sur._normal_names
    seed = int(torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(5)))
    eps = _twin_eps(seed, S, tdt)

    if dtype == "float32":
        sur.fused_normals = True
        values, logq = sur.sample_and_log_prob(
            params, torch.Generator().manual_seed(5), (S,))
        sur.fused_normals = False
    else:
        loc = torch.cat([params[n]["loc"].reshape(-1) for n in names])
        rs = torch.cat([params[n]["raw_scale"].reshape(-1) for n in names])
        mask = torch.cat([torch.full((sur._sizes[n],),
                                     float(kinds[n] == "softplus"), dtype=tdt)
                          for n in names])
        y, logq = tfn.normal_twin_fwd(loc, rs, mask, seed, S)
        values = sur._split_block(names, y, (S,))
    plain, logq_p = sur.sample_and_log_prob(params, None, (S,),
                                            draws={"normal_eps": eps})

    jsr = _jax_surrogate(kinds, dtype)
    jparams = jsr.init()
    with mock.patch.object(jax.random, "normal",
                           lambda key, shape, dt: jnp.asarray(eps.numpy())):
        jvalues, jlogq = jsr._sample_normals(jsr._normal_names, jparams,
                                             jax.random.PRNGKey(0), (S,))
    for n in names:
        for ref in (plain[n].numpy(), np.asarray(jvalues[n])):
            np.testing.assert_allclose(values[n].numpy(), ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max(),
                                       err_msg=n)
    np.testing.assert_allclose(logq.numpy(), logq_p.numpy(), rtol=rtol)
    np.testing.assert_allclose(logq.numpy(), np.asarray(jlogq), rtol=rtol)


def test_dispatch_rules():
    """Off by default; on only with the flag, gamma_sampler='fused',
    float32 and a 0/1-dim sample shape; antithetic sampling and injected
    eps take the plain path."""
    sur = _torch_surrogate(GAUSSIAN, "float32")
    names = sur._normal_names
    assert not sur.fused_normals and not sur._fused_normals_ok(names, (4,))
    sur.fused_normals = True
    assert sur._fused_normals_ok(names, (4,))
    assert sur._fused_normals_ok(names, ())
    assert not sur._fused_normals_ok(names, (2, 2))
    for other in (_torch_surrogate(GAUSSIAN, "float64"),
                  _torch_surrogate(GAUSSIAN, "float32", gamma_sampler="fast")):
        other.fused_normals = True
        assert not other._fused_normals_ok(names, (4,))

    params = sur.init()
    gen = torch.Generator().manual_seed(0)
    with mock.patch.object(sur, "_sample_normals_fused",
                           side_effect=AssertionError("fused path taken")):
        sur.sample_and_log_prob(params, gen, (4,), antithetic=True)
        sur.sample_and_log_prob(
            params, gen, (4,),
            draws={"normal_eps": np.zeros((4, TOTAL), np.float32)})
        with pytest.raises(AssertionError, match="fused path taken"):
            sur.sample_and_log_prob(params, gen, (4,))
    # a 0-dim sample shape goes through the sampler with S = 1
    values, logq = sur.sample_and_log_prob(params, gen, ())
    assert values["u"].shape == SHAPES["u"] and logq.shape == ()


def test_elbo_step_gradients_with_the_seam_on():
    """One ELBO step of a float32 model with the seam on against the plain
    Normal block on the same eps (the IG block fused, on the same seed)."""
    n, d, k, S = 48, 20, 3, 4
    X = np.random.default_rng(2).poisson(1.0, (n, d)).astype(np.float32)
    m = PoissonFactorization(
        latent_dim=k, feature_dim=d, dtype="float32", device="cpu",
        gamma_sampler="fused", u_tau_scale=0.1,
        data=ArrayDataset({"counts": X, "indices": np.arange(n)}).batch(n))
    batch = {"counts": torch.tensor(X)}
    sur = m._surrogate

    def step(fused):
        params = {v: {key: t.clone().requires_grad_(True)
                      for key, t in sub.items()}
                  for v, sub in m.surrogate_params.items()}
        gen = torch.Generator().manual_seed(9)
        sur.fused_normals = fused
        draws = None
        if not fused:
            # the seam draws the Normal block's seed first: take it here,
            # so that the IG block's seed is the same in both runs
            seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                                     dtype=torch.int32))
            tot = sum(sur._sizes[v] for v in sur._normal_names)
            draws = {"normal_eps": torch.stack(
                [tfn.draw_eps(tot, s, seed, torch.float32, "cpu")
                 for s in range(S)])}
        loss = elbo_loss(sur, m._energy, params, batch, gen, S, draws=draws)
        loss.backward()
        sur.fused_normals = False
        return float(loss.detach()), {
            f"{v}.{key}": t.grad.numpy() for v, sub in params.items()
            for key, t in sub.items()}

    loss_f, grads_f = step(True)
    loss_p, grads_p = step(False)
    np.testing.assert_allclose(loss_f, loss_p, rtol=1e-5)
    for key, g in grads_p.items():
        np.testing.assert_allclose(grads_f[key], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max(), err_msg=key)


def test_wrapper_rejects_bad_arguments():
    a = torch.ones(8)
    seed = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(ValueError, match="equal-shaped"):
        tfn.fused_normal_sample_logq(a, torch.ones(7), a, seed, 2)
    with pytest.raises(ValueError, match="equal-shaped"):
        tfn.normal_twin_fwd(a.reshape(2, 4), a.reshape(2, 4),
                            a.reshape(2, 4), 1, 2)
