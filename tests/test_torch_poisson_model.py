"""The port's dense PoissonFactorization against spmf_tpu's on the same
parameters and samples: the energy part by part (float64 plain path,
1e-9; float32 fused twin vs the interpreted Pallas kernel, 1e-5) and the
model parts (1e-12). Samples are random positive values of each
variable's shape (the samplers have their own tests)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ref import B, model_pair, random_samples, torch_params


def _jax_parts(jm, batch, samples):
    return jax.jit(lambda b, p: jm.unormalized_log_prob_parts(
        {"counts": b}, **p))(jnp.asarray(batch),
                             {k: jnp.asarray(v) for k, v in samples.items()})


@pytest.mark.parametrize("log_transform", [False, True])
def test_energy_parts_match_jax_f64(log_transform):
    jm, tm, X = model_pair("float64", log_transform=log_transform)
    assert not jm.fused_likelihood and not tm.fused_likelihood
    samples = random_samples(jm)
    batch = X[:B].astype(np.float64)
    jparts = _jax_parts(jm, batch, samples)
    tparts = tm.unormalized_log_prob_parts(
        {"counts": batch}, **torch_params(samples, torch.float64))
    assert set(tparts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-9, err_msg=k)
    total = tm.unormalized_log_prob({"counts": batch},
                                    **torch_params(samples, torch.float64))
    np.testing.assert_allclose(total.numpy(), sum(np.asarray(v)
                                                  for v in jparts.values()),
                               rtol=1e-9)


@pytest.mark.parametrize("log_transform", [False, True])
def test_energy_parts_match_jax_f64_at_k128(log_transform):
    """PoissonFactorization(latent_dim=128), a latent dimension past the
    whole-K tiles of the port's K1/K2 on the card, against the JAX model:
    every part of the energy at 1e-9 in float64 on the same samples,
    converted to the port with utils/convert.py (D = 64)."""
    jm, tm, X = model_pair("float64", k=128, log_transform=log_transform)
    assert jm.latent_dim == tm.latent_dim == 128
    samples = random_samples(jm)
    batch = X[:B].astype(np.float64)
    jparts = _jax_parts(jm, batch, samples)
    tparts = tm.unormalized_log_prob_parts(
        {"counts": batch}, **torch_params(samples, torch.float64))
    assert set(tparts) == set(jparts)
    for k in jparts:
        assert np.isfinite(np.asarray(jparts[k])).all(), k
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-9, err_msg=k)


@pytest.mark.parametrize("clip", ["reference", "static"])
def test_fused_x_part_matches_interpreted_kernel_f32(clip):
    jm, tm, X = model_pair("float32", fused_likelihood=True,
                           gamma_sampler="fast", likelihood_clip=clip)
    jm._fused_interpret = True
    samples = random_samples(jm)
    batch = X[:B].astype(np.float32)
    jparts = _jax_parts(jm, batch, samples)
    tparts = tm.unormalized_log_prob_parts(
        {"counts": batch}, **torch_params(samples, torch.float32))
    assert tm.fusion_active and tm.fusion_inactive_reason is None
    for k in jparts:
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-5, err_msg=k)


def test_model_parts_match_jax():
    jm, tm, X = model_pair("float64")
    p = random_samples(jm, 2)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = torch_params(p, torch.float64)
    x = X[:B].astype(np.float64)
    pairs = [
        (tm.encoding_matrix(pt["u"], pt["s"]), jm.encoding_matrix(pj["u"], pj["s"])),
        (tm.decoding_matrix(pt["v"]), jm.decoding_matrix(pj["v"])),
        (tm.intercept_matrix(pt["w"], pt["s"]), jm.intercept_matrix(pj["w"], pj["s"])),
        (tm.encode(x, pt["u"], pt["s"]), jm.encode(x, pj["u"], pj["s"])),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
    np.testing.assert_allclose(tm.eta_i.numpy(), np.asarray(jm.eta_i),
                               rtol=1e-15)
    np.testing.assert_allclose(tm.xi_u_global.numpy(),
                               np.asarray(jm.xi_u_global), rtol=1e-15)


def test_defaults_and_unported_options():
    from spmf_tpu_torch import PoissonFactorization

    m = PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu",
                             dtype="float32")
    # CPU: plain likelihood, WH 'fast' sampler (cuda would select the kernels)
    assert not m.fused_likelihood and m.gamma_sampler == "fast"
    assert m.fusion_inactive_reason is None and not m.fusion_active
    assert set(m.surrogate_params["u_eta"]) == {"raw_concentration",
                                                "raw_scale"}
    assert set(m.surrogate_params["u"]) == {"loc", "raw_scale"}
    # horshoe_plus=False is ported: AbsHorseshoe priors, no IG block
    nonplus = PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu",
                                   horshoe_plus=False)
    assert list(nonplus.surrogate_params) == ["v", "w", "s", "u"]
    # aux_broadcast and the exact sampler are ported; a mesh must be a
    # spmf_tpu_torch.parallel.Mesh
    bc = PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu",
                              aux_broadcast=True, gamma_sampler="exact")
    assert bc._surrogate.gamma_sampler == "exact"
    assert bc._surrogate.broadcast_names == {
        "u_eta", "u_tau", "s_eta", "s_tau", "u_eta_a", "u_tau_a", "s_eta_a",
        "s_tau_a"}
    with pytest.raises(TypeError, match="spmf_tpu_torch.parallel.Mesh"):
        PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu",
                             mesh=object())
    # COO batches are ported: on the CPU they take the COO energy
    parts = m.unormalized_log_prob_parts(
        {"coo_rows": np.array([0, 1, 1]), "coo_cols": np.array([0, 2, 4]),
         "coo_vals": np.ones(3), "indices": np.arange(2)},
        **m.calibrated_expectations)
    assert torch.isfinite(parts["x"])
    assert m.fusion_inactive_reason.startswith("sparse COO gather")
