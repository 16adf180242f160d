"""The likelihood selector of the fused decode kernels K1/K2 and K4, through
their twins (the CPU side): each of the five selectors and both links against
spmf_tpu's Pallas kernels run interpreted in float32, and against the plain
clip-then-sum references.

Tolerances: the float64 twin against the float32 interpreted kernel, 1e-5
relative on sums, finite minimum and combined value (f32 cells summed in
another order; another lgamma), counts exact, gradients rtol 5e-4 and atol
1e-7 (the JAX tests' own bounds for the fused energy's gradients); the row
sums 3e-5, the JAX tests' own bound for that kernel.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.ops import fused_poisson as jfp

from spmf_tpu_torch.ops import fused_poisson as tfp

S, B, K, D = 2, 24, 4, 40
OBS = 0.8
SELECTORS = {"poisson": "poisson", "bernoulli": "bernoulli",
             "normal": ("normal", OBS), "poisson_softplus": "poisson_softplus",
             "mixed": ("mixed", OBS)}


def _codes(rng):
    codes = np.asarray([[tfp.CODE_POISSON] * 16 + [tfp.CODE_BERNOULLI] * 14
                        + [tfp.CODE_NORMAL] * 10], np.float32)
    return codes[:, rng.permutation(D)]      # non-contiguous blocks


def _inputs(name, seed=0, rescue=False):
    """theta, v, phi, x, eta, codes for a selector: positive operands and
    counts for 'poisson'; signed operands elsewhere, with binary x for
    'bernoulli', real x for 'normal', counts for 'poisson_softplus' and the
    three column kinds for 'mixed'. ``rescue``: some cells leave the finite
    range (negative rates under 'poisson'; rates of -2000, whose softplus
    underflows to 0 in either precision, elsewhere)."""
    rng = np.random.default_rng(seed)
    codes = _codes(rng) if name == "mixed" else None
    x = rng.poisson(1.0, (B, D)).astype(np.float64)
    if name == "poisson":
        theta = rng.uniform(0.0, 0.5, (S, B, K))
        v = rng.uniform(0.0, 0.5, (S, K, D))
        phi = rng.uniform(0.05, 0.5, (S, 1, D))
    else:
        theta = rng.normal(0.0, 0.4, (S, B, K))
        v = rng.normal(0.0, 0.5, (S, K, D))
        phi = rng.normal(0.0, 0.3, (S, 1, D))
    if name == "bernoulli":
        x = rng.integers(0, 2, (B, D)).astype(np.float64)
    elif name == "normal":
        x = rng.normal(0.5, 1.0, (B, D))
    elif name == "mixed":
        is_b = codes[0] == tfp.CODE_BERNOULLI
        is_n = codes[0] == tfp.CODE_NORMAL
        x[:, is_b] %= 2
        x[:, is_n] = rng.normal(0.5, 1.0, (B, int(is_n.sum())))
    eta = rng.uniform(0.5, 2.0, (1, D))
    if rescue:
        phi[:, :, ::7] = -5.0 if name == "poisson" else -2000.0
        theta[:, ::5] = 0.0
    return theta, v, phi, x, eta, codes


def _jax_args(args):
    *dense, codes = args
    jargs = [jnp.asarray(a, jnp.float32) for a in dense]
    jcodes = (jnp.zeros((1, D), jnp.float32) if codes is None
              else jnp.asarray(codes))
    return jargs, jcodes


def _twin_args(args, dtype=torch.float64):
    *dense, codes = args
    t = [torch.tensor(a, dtype=dtype) for a in dense]
    return t, (None if codes is None else torch.tensor(codes))


def _combine(ssum, cnt, gmin):
    return ssum + cnt.to(ssum.dtype) * tfp._floor_min_val(gmin - 10.0)[0]


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", list(SELECTORS))
def test_stats_twin_matches_interpreted_kernel(name, log_transform):
    """Sums, counts, finite minimum, combined clipped value and the
    unit-cotangent gradients of K1, and K2's sums, against the Pallas
    kernels."""
    lik = SELECTORS[name]
    args = _inputs(name, seed=1)
    jargs, jcodes = _jax_args(args)
    t, codes = _twin_args(args)

    def stats(theta, v, phi):
        return jfp._fused_stats(theta, v, phi, jargs[3], jargs[4], jcodes,
                                log_transform, True, lik)

    ssum_j, cnt_j, gmin_j = stats(*jargs[:3])
    grads_j = jax.grad(lambda *a: jnp.sum(stats(*a)[0]),
                       argnums=(0, 1, 2))(*jargs[:3])

    ssum, cnt, gmin, dth, dv, dphi = tfp.stats_twin(
        *t, log_transform=log_transform, likelihood=lik, codes=codes)
    np.testing.assert_allclose(ssum.numpy(), np.asarray(ssum_j), rtol=1e-5)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(gmin.numpy(), np.asarray(gmin_j), rtol=1e-5)
    out_j = jfp.fused_poisson_loglik(*jargs, log_transform, True,
                                     likelihood=lik, codes=jcodes)
    np.testing.assert_allclose(_combine(ssum, cnt, gmin).numpy(),
                               np.asarray(out_j), rtol=1e-5)
    for g, gj, what in zip((dth, dv, dphi), grads_j, ("theta", "v", "phi")):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=5e-4,
                                   atol=1e-7,
                                   err_msg=what)

    static_j = jfp.fused_poisson_loglik(*jargs, log_transform, True,
                                        likelihood=lik, codes=jcodes,
                                        clip="static")
    static = tfp.stats_twin(*t, log_transform=log_transform, static=True,
                            likelihood=lik, codes=codes)
    np.testing.assert_allclose(static[0].numpy(), np.asarray(static_j),
                               rtol=1e-5)
    assert int(static[1].sum()) == 0 and float(static[2]) == 0.0


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", list(SELECTORS))
def test_row_twin_matches_interpreted_kernel(name, log_transform):
    lik = SELECTORS[name]
    args = _inputs(name, seed=2)
    jargs, jcodes = _jax_args(args)
    t, codes = _twin_args(args)
    out_j = jfp.fused_poisson_row_loglik(*jargs, log_transform, True,
                                         likelihood=lik, codes=jcodes)
    out = tfp.row_loglik_twin(*t, log_transform=log_transform,
                              likelihood=lik, codes=codes)
    assert out.shape == (S, B)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=3e-5)
    # the public entry casts to float32 and takes the twin on the CPU
    out32 = tfp.fused_poisson_row_loglik(*t, log_transform=log_transform,
                                         likelihood=lik, codes=args[-1])
    assert out32.dtype == torch.float32 and not out32.requires_grad
    np.testing.assert_allclose(out32.numpy(), np.asarray(out_j), rtol=3e-5)


@pytest.mark.parametrize("name", ["poisson", "poisson_softplus", "mixed"])
def test_rescue_batch_counts_and_nan_rows(name):
    """Cells that leave the finite range: K1's clipped-cell counts equal the
    kernel's exactly and the combined value agrees; K4's poisoned rows sit
    at the kernel's positions."""
    lik = SELECTORS[name]
    args = _inputs(name, seed=3, rescue=True)
    jargs, jcodes = _jax_args(args)
    t, codes = _twin_args(args)
    ssum_j, cnt_j, gmin_j = jfp._fused_stats(*jargs, jcodes, False, True, lik)
    ssum, cnt, gmin, *grads = tfp.stats_twin(*t, likelihood=lik, codes=codes)
    assert int(cnt.sum()) > 0
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(ssum.numpy(), np.asarray(ssum_j), rtol=1e-5)
    for g in grads:
        assert bool(torch.isfinite(g).all())
    rows_j = np.asarray(jfp.fused_poisson_row_loglik(
        *jargs, False, True, likelihood=lik, codes=jcodes))
    rows = tfp.row_loglik_twin(*t, likelihood=lik, codes=codes).numpy()
    bad = ~np.isfinite(rows)
    assert bad.any()
    np.testing.assert_array_equal(bad, ~np.isfinite(rows_j))
    np.testing.assert_allclose(rows[~bad], rows_j[~bad], rtol=3e-5)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name,obs_scale", [("bernoulli", None),
                                            ("normal", 0.8),
                                            ("normal", 0.25)])
def test_references_match_jax_and_the_twin(name, obs_scale, log_transform):
    """bernoulli_ / normal_loglik_reference against spmf_tpu's in float64
    (1e-10), and the twin combined through the clip decomposition against
    them. At obs_scale 0.25 some Normal cells have ll > 0: min(ll, 0) adds 0
    there and the cell is outside the gradients' active set."""
    args = _inputs(name, seed=4)[:5]
    j = [jnp.asarray(a) for a in args]
    t = [torch.tensor(a) for a in args]
    if name == "bernoulli":
        ref_j = jfp.bernoulli_loglik_reference(*j, log_transform)
        ref_t = tfp.bernoulli_loglik_reference(*t, log_transform)
        lik = "bernoulli"
    else:
        ref_j = jfp.normal_loglik_reference(*j, obs_scale, log_transform)
        ref_t = tfp.normal_loglik_reference(*t, obs_scale, log_transform)
        lik = ("normal", obs_scale)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), rtol=1e-10)
    ssum, cnt, gmin, dth, dv, dphi = tfp.stats_twin(
        *t, log_transform=log_transform, likelihood=lik)
    np.testing.assert_allclose(_combine(ssum, cnt, gmin).numpy(),
                               np.asarray(ref_j), rtol=1e-10)
    # the explicit gradients equal autograd through the plain reference
    # (healthy data: no cell sits on the clip bound)
    for a in t[:3]:
        a.requires_grad_(True)
    ref = (tfp.bernoulli_loglik_reference(*t, log_transform)
           if name == "bernoulli"
           else tfp.normal_loglik_reference(*t, obs_scale, log_transform))
    ref.sum().backward()
    for a, g in zip(t[:3], (dth, dv, dphi)):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), rtol=1e-9,
                                   atol=1e-12)
    if obs_scale == 0.25:
        rate = tfp._decode_rate(t[0].detach() @ t[1].detach(), t[4],
                                t[2].detach(), log_transform)
        r = (t[3] - rate) / obs_scale
        assert bool((-0.5 * r * r - np.log(obs_scale) - 0.9189385 > 0).any())


def test_mixed_equals_the_families_on_its_column_blocks():
    """('mixed', s) with a codes lane against each single-family twin on its
    own columns: sums and counts add, the minimum is the least, the column
    gradients are the blocks' and dtheta is their sum; rows add."""
    args = _inputs("mixed", seed=5)
    t, codes = _twin_args(args)
    theta, v, phi, x, eta = t
    mixed = tfp.stats_twin(*t, likelihood=("mixed", OBS), codes=codes)
    rows = tfp.row_loglik_twin(*t, likelihood=("mixed", OBS), codes=codes)
    ssum, cnt, gmin = 0.0, 0, torch.zeros(1, dtype=torch.float64)
    dth, row_sum = 0.0, 0.0
    for code, kind in ((tfp.CODE_POISSON, "poisson_softplus"),
                       (tfp.CODE_BERNOULLI, "bernoulli"),
                       (tfp.CODE_NORMAL, ("normal", OBS))):
        idx = torch.nonzero(codes[0] == code)[:, 0]
        block = (theta, v[:, :, idx], phi[:, :, idx], x[:, idx], eta[:, idx])
        s_b, c_b, m_b, dth_b, dv_b, dphi_b = tfp.stats_twin(
            *block, likelihood=kind)
        ssum, cnt, gmin = ssum + s_b, cnt + c_b, torch.minimum(gmin, m_b)
        dth = dth + dth_b
        np.testing.assert_allclose(mixed[4][:, :, idx].numpy(), dv_b.numpy(),
                                   rtol=1e-12)
        np.testing.assert_allclose(mixed[5][:, :, idx].numpy(),
                                   dphi_b.numpy(), rtol=1e-12)
        row_sum = row_sum + tfp.row_loglik_twin(*block, likelihood=kind)
    np.testing.assert_allclose(mixed[0].numpy(), ssum.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(mixed[1].numpy(), cnt.numpy())
    np.testing.assert_allclose(mixed[2].numpy(), gmin.numpy(), rtol=1e-12)
    np.testing.assert_allclose(mixed[3].numpy(), dth.numpy(), rtol=1e-10)
    np.testing.assert_allclose(rows.numpy(), row_sum.numpy(), rtol=1e-10)


@pytest.mark.parametrize("name", list(SELECTORS))
def test_static_clip_equals_reference_clip(name):
    """Equal values on healthy data; equal gradients always (a rescue batch
    too: both modes share the active set)."""
    lik = SELECTORS[name]
    for rescue in (False, True):
        args = _inputs(name, seed=6, rescue=rescue)
        grads = {}
        for clip in ("reference", "static"):
            t, _ = _twin_args(args, torch.float32)
            for a in t[:3]:
                a.requires_grad_(True)
            out = tfp.fused_poisson_loglik(*t, likelihood=lik, clip=clip,
                                           codes=args[-1])
            out.sum().backward()
            grads[clip] = (out.detach(), [a.grad for a in t[:3]])
        if not rescue:
            np.testing.assert_allclose(grads["static"][0].numpy(),
                                       grads["reference"][0].numpy(),
                                       rtol=1e-6)
        for a, b in zip(grads["static"][1], grads["reference"][1]):
            assert torch.equal(a, b)


def test_selector_validation():
    t, _ = _twin_args(_inputs("poisson"), torch.float32)
    for entry in (tfp.fused_poisson_loglik, tfp.fused_poisson_row_loglik,
                  tfp.stats_twin, tfp.row_loglik_twin):
        for bad in ("mixed", "normal", ("gamma", 1.0), ("normal", "1"), 7):
            with pytest.raises(ValueError, match="unknown likelihood"):
                entry(*t, likelihood=bad)
        with pytest.raises(ValueError, match="codes"):
            entry(*t, likelihood=("mixed", 1.0))
    assert (tfp.CODE_POISSON, tfp.CODE_BERNOULLI, tfp.CODE_NORMAL) == (
        jfp.CODE_POISSON, jfp.CODE_BERNOULLI, jfp.CODE_NORMAL)
    # codes may be anything broadcastable to (1, D); a scalar lane of
    # CODE_BERNOULLI is the Bernoulli likelihood
    tb, _ = _twin_args(_inputs("bernoulli"), torch.float32)
    np.testing.assert_allclose(
        tfp.fused_poisson_loglik(*tb, likelihood=("mixed", 1.0),
                                 codes=tfp.CODE_BERNOULLI).numpy(),
        tfp.fused_poisson_loglik(*tb, likelihood="bernoulli").numpy(),
        rtol=1e-6)


@pytest.mark.parametrize("latent", [20, 33])
@pytest.mark.parametrize("name,obs_scale", [("bernoulli", None),
                                            ("normal", 0.8)])
def test_twin_at_ragged_latent_dims_f64(name, obs_scale, latent):
    """K = 20 and K = 33 with B = 37, D = 130 (no multiple of the kernels'
    k-step or tiles): the twin's combined value against spmf_tpu's plain
    reference, and its explicit gradients against that reference's autodiff,
    in float64 at 1e-9."""
    rng = np.random.default_rng(latent)
    args = (rng.normal(0.0, 0.3, (S, 37, latent)),
            rng.normal(0.0, 0.3, (S, latent, 130)),
            rng.normal(0.0, 0.3, (S, 1, 130)),
            (rng.integers(0, 2, (37, 130)).astype(np.float64)
             if name == "bernoulli" else rng.normal(0.5, 1.0, (37, 130))),
            rng.uniform(0.5, 2.0, (1, 130)))
    j = [jnp.asarray(a) for a in args]
    if name == "bernoulli":
        lik = "bernoulli"

        def ref(theta, v, phi):
            return jfp.bernoulli_loglik_reference(theta, v, phi, j[3], j[4])
    else:
        lik = ("normal", obs_scale)

        def ref(theta, v, phi):
            return jfp.normal_loglik_reference(theta, v, phi, j[3], j[4],
                                               obs_scale)

    grads_j = jax.grad(lambda *a: jnp.sum(ref(*a)), argnums=(0, 1, 2))(*j[:3])
    ssum, cnt, gmin, *grads = tfp.stats_twin(
        *[torch.tensor(a) for a in args], likelihood=lik)
    np.testing.assert_allclose(_combine(ssum, cnt, gmin).numpy(),
                               np.asarray(ref(*j[:3])), rtol=1e-9)
    for g, gj in zip(grads, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-9,
                                   atol=1e-9 * np.abs(gj).max())
