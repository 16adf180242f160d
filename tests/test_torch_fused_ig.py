"""The fused IG sampler's twin: its tile math against spmf_tpu's, its output
against ig_sample_logq_reference on the same draws, its Philox stream, and
the RNG-replay backward of the autograd.Function (CPU, float64)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from spmf_tpu.ops import fused_ig as jig

from spmf_tpu_torch.ops import fused_ig as tig

RNG = np.random.default_rng(0)
N = 400


def _params(n=N, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.6, 6.0, n), rng.uniform(0.2, 4.0, n)


def _s1_s2(a, logu):
    w = 1.0 / (a[None] + np.arange(8.0)[:, None])
    return (logu * w).sum(0), (logu * w * w).sum(0)


def test_tile_math_matches_jax():
    """_tile_fwd/_tile_bwd at injected (eps, s1, s2), 1e-12."""
    a, b = _params()
    eps = RNG.normal(size=N)
    logu = np.log(RNG.uniform(1e-6, 1.0, (8, N)))
    s1, s2 = _s1_s2(a, logu)
    logb = np.log(b)
    t0 = a * logb - np.asarray(jax.lax.lgamma(jnp.asarray(a)))
    dg0 = logb - np.asarray(jax.lax.digamma(jnp.asarray(a)))
    J = lambda *v: [jnp.asarray(x) for x in v]  # noqa: E731
    T = lambda *v: [torch.tensor(x) for x in v]  # noqa: E731
    for j, t in zip(jig._tile_fwd(*J(a, b, logb, t0, eps, s1)),
                    tig._tile_fwd(*T(a, b, logb, t0, eps, s1))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    for j, t in zip(jig._tile_bwd(*J(a, b, logb, dg0, eps, s1, s2)),
                    tig._tile_bwd(*T(a, b, logb, dg0, eps, s1, s2))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-300)


def test_twin_tile_chain_matches_reference_sampler():
    """ig_sample_logq_reference draws threefry normals/uniforms exactly as
    wilson_hilferty_gamma does; fed those draws, the twin's tile chain
    gives the same y and per-sample lq (1e-12)."""
    S = 4
    a, b = _params()
    key = jax.random.PRNGKey(5)
    yj, lqj = jig.ig_sample_logq_reference(jnp.asarray(a), jnp.asarray(b),
                                           key, S)
    kn, ku = jax.random.split(key)
    eps = np.asarray(jax.random.normal(kn, (S, N), jnp.float64))
    u = np.asarray(jax.random.uniform(ku, (8, S, N), jnp.float64,
                                      minval=jnp.finfo(jnp.float64).tiny,
                                      maxval=1.0))
    at, bt = torch.tensor(a), torch.tensor(b)
    logb = torch.log(bt)
    t0 = at * logb - torch.lgamma(at)
    for s in range(S):
        s1, _ = _s1_s2(a, np.log(u[:, s]))
        y, lq = tig._tile_fwd(at, bt, logb, t0, torch.tensor(eps[s]),
                              torch.tensor(s1))
        np.testing.assert_allclose(y.numpy(), np.asarray(yj[s]), rtol=1e-12)
        np.testing.assert_allclose(float(lq.sum()), float(lqj[s]),
                                   rtol=1e-12)


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Random123's Philox4x32-10 known-answer vectors."""
    out = tig.philox4x32(*(torch.tensor([c], dtype=torch.int64)
                           for c in ctr), *key)
    assert tuple(int(o) for o in out) == expect


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_uniform_grid_and_exact_mirror(dtype):
    u = tig.uniforms(20000, 3, 1234, dtype, "cpu")
    assert float(u.min()) >= 2.0 ** -24 and float(u.max()) <= 1 - 2.0 ** -24
    # on the half-ulp grid: (2k+1) 2^-24 exactly
    k2 = u.double() * 2.0 ** 24
    assert torch.equal(k2, torch.round(k2)) and bool((k2 % 2 == 1).all())
    eps = torch.erfinv(2.0 * u[0] - 1.0)
    eps_m = torch.erfinv(2.0 * (1.0 - u[0]) - 1.0)
    assert torch.equal(eps_m, -eps)


def test_eps_is_standard_normal():
    a = torch.full((50000,), 2.0, dtype=torch.float64)
    eps, _, _ = tig._draw_eps_s1_s2(a, 99, 0, 1, False)
    assert stats.kstest(eps.numpy(), "norm").pvalue > 1e-3


@pytest.mark.parametrize("antithetic", [False, True, "stratified"])
def test_replay_backward_matches_autograd(antithetic):
    """The autograd.Function's RNG-replay backward (twin path on CPU)
    against torch.autograd through the twin forward with the same stream."""
    S = 4
    a, b = _params(300, seed=3)
    gy = torch.tensor(RNG.normal(size=(S, 300)))
    glq = torch.tensor(RNG.normal(size=S))
    seed = torch.tensor([777], dtype=torch.int32)

    def run(fn):
        at = torch.tensor(a, requires_grad=True)
        bt = torch.tensor(b, requires_grad=True)
        y, lq = fn(at, bt, seed, S, antithetic)
        ((y * gy).sum() + (lq * glq).sum()).backward()
        return y.detach(), lq.detach(), at.grad, bt.grad

    out_fn = run(tig.fused_ig_sample_logq)
    out_ad = run(tig.ig_twin_fwd)
    for f, r in zip(out_fn, out_ad):
        np.testing.assert_allclose(f.numpy(), r.numpy(), rtol=1e-10)
    if antithetic:
        # mirrored pairs: same |eps|, opposite sign -> different draws
        assert not torch.equal(out_fn[0][0], out_fn[0][S // 2])


def test_twin_rejects_bad_arguments():
    a, b = (torch.ones(8), torch.ones(8))
    with pytest.raises(ValueError):
        tig.ig_twin_fwd(a, b, 0, 3, antithetic=True)
    with pytest.raises(ValueError):
        tig.ig_twin_fwd(a, b, 0, 3, antithetic="stratified")
