"""The fused Poisson likelihood's twin (the CPU side of kernel K1/K2)
against spmf_tpu: the plain reference in float64 and the Pallas kernel run
interpreted in float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.ops import fused_poisson as jfp

from spmf_tpu_torch.ops import fused_poisson as tfp

S, B, K, D = 3, 40, 4, 300   # ragged: neither B nor D a tile multiple


def _inputs(seed=0, rescue=False):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, (S, B, K))
    v = rng.uniform(0.0, 0.5, (S, K, D))
    phi = rng.uniform(0.05, 0.5, (S, 1, D))
    x = rng.poisson(1.0, (B, D)).astype(float)
    eta = rng.uniform(0.5, 2.0, (1, D))
    if rescue:
        # negative rates in a few columns: NaN cells the clip replaces by m
        phi[:, :, ::37] = -5.0
        theta[:, ::7] = 0.0
    return theta, v, phi, x, eta


def _combine(ssum, cnt, gmin, dtype):
    m = tfp._floor_min_val(gmin - 10.0)
    return ssum + cnt.to(dtype) * m[0]


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("rescue", [False, True])
def test_twin_matches_reference_f64(log_transform, rescue):
    """Twin stats combined through the clip decomposition == the plain
    clip-then-sum reference (float64, 1e-10)."""
    args = _inputs(rescue=rescue)
    ref = jfp.poisson_loglik_reference(*map(jnp.asarray, args),
                                       log_transform=log_transform)
    t = [torch.tensor(a) for a in args]
    ssum, cnt, gmin, *_ = tfp.stats_twin(*t, log_transform=log_transform)
    np.testing.assert_allclose(_combine(ssum, cnt, gmin, torch.float64),
                               np.asarray(ref), rtol=1e-10)
    ref_t = tfp.poisson_loglik_reference(*t, log_transform=log_transform)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref), rtol=1e-10)


def _jax_kernel(args, log_transform, clip):
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    codes = jnp.zeros((1, D), jnp.float32)

    def f(theta, v, phi):
        return jfp.fused_poisson_loglik(theta, v, phi, jargs[3], jargs[4],
                                        log_transform, interpret=True,
                                        clip=clip)

    return f, jargs, codes


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("clip", ["reference", "static"])
def test_matches_interpreted_pallas_kernel_f32(log_transform, clip):
    """Values (1e-5 relative: f32 sums over the tile in another order and
    another lgamma) and the unit-cotangent gradients through the
    autograd.Function (1e-4 of the largest entry) vs jax.grad of the
    interpreted kernel."""
    args = _inputs(seed=1)
    f, jargs, codes = _jax_kernel(args, log_transform, clip)
    g = np.array([0.7, -1.3, 2.0], np.float32)
    val_j, vjp = jax.vjp(f, *jargs[:3])
    grads_j = vjp(jnp.asarray(g))

    t = [torch.tensor(a, dtype=torch.float32) for a in args]
    for a in t[:3]:
        a.requires_grad_(True)
    val_t = tfp.fused_poisson_loglik(*t, log_transform=log_transform,
                                     clip=clip)
    (val_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(val_t.detach().numpy(), np.asarray(val_j),
                               rtol=1e-5)
    for a, gj in zip(t[:3], grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(a.grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max())

    if clip == "reference":
        ssum_j, cnt_j, gmin_j = jfp._fused_stats(
            *jargs, codes, log_transform, True, "poisson")
        ssum_t, cnt_t, gmin_t, *_ = tfp.stats_twin(
            *[a.detach() for a in t], log_transform=log_transform)
        np.testing.assert_allclose(ssum_t.numpy(), np.asarray(ssum_j),
                                   rtol=1e-5)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_allclose(gmin_t.numpy(), np.asarray(gmin_j),
                                   rtol=1e-5)


def test_rescue_batch_counts_and_bound_f32():
    """Negative rates: the clipped-cell counts match the kernel's exactly,
    the clip bound m to f32 rounding, and the total to 1e-5."""
    args = _inputs(seed=2, rescue=True)
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    codes = jnp.zeros((1, D), jnp.float32)
    ssum_j, cnt_j, gmin_j = jfp._fused_stats(*jargs, codes, False, True,
                                             "poisson")
    t = [torch.tensor(a, dtype=torch.float32) for a in args]
    ssum_t, cnt_t, gmin_t, *_ = tfp.stats_twin(*t)
    assert int(cnt_t.sum()) > 0
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    m_j = np.asarray(jfp._floor_min_val(gmin_j - 10.0))
    m_t = tfp._floor_min_val(gmin_t - 10.0).numpy()
    np.testing.assert_allclose(m_t, m_j, rtol=1e-6)
    out_j = jfp.fused_poisson_loglik(*jargs, interpret=True)
    out_t = tfp.fused_poisson_loglik(*t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5)


def test_static_clip_equals_reference_on_healthy_data():
    t = [torch.tensor(a, dtype=torch.float32) for a in _inputs(seed=3)]
    np.testing.assert_allclose(
        tfp.fused_poisson_loglik(*t, clip="static").numpy(),
        tfp.fused_poisson_loglik(*t, clip="reference").numpy(), rtol=1e-6)


def test_other_likelihoods_and_clip_modes_raise():
    t = [torch.tensor(a, dtype=torch.float32) for a in _inputs()]
    with pytest.raises(NotImplementedError):
        tfp.fused_poisson_loglik(*t, likelihood="bernoulli")
    with pytest.raises(ValueError):
        tfp.fused_poisson_loglik(*t, clip="dynamic")
