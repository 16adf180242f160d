"""The port's fit engine: a short CPU fit through PoissonFactorization.fit,
the engine's control flow against spmf_tpu's on a scripted energy, and the
noise-config parity run of tests/test_parity.py through the port."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu import bijectors as jb
from spmf_tpu.vi import minibatch as jmb
from spmf_tpu.vi import surrogates as jsur

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.vi import minibatch as tmb
from spmf_tpu_torch.vi import surrogates as tsur

from torch_ref import B, D, K, N, S, counts


def test_short_fit_losses_finite_and_decreasing():
    X = counts()
    data = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(B)
    m = PoissonFactorization(latent_dim=K, feature_dim=D,
                             u_tau_scale=1.0 / np.sqrt(N * D),
                             dtype="float64", data=data, device="cpu")
    losses = m.fit(num_steps=5, learning_rate=0.05, sample_size=S,
                   verbose=False)
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert all(b < a for a, b in zip(losses[1:], losses[2:])), losses
    assert m.surrogate_params["u"]["loc"].device.type == "cpu"
    assert not m.surrogate_params["u"]["loc"].requires_grad
    assert set(m.calibrated_expectations) == set(m.surrogate_params)


# ------------------------------------------------------- scripted energy
# One one-row batch per epoch whose count IS the epoch's scripted loss
# level (the engine's first factory call is the initial-loss batch). The
# energy adds 1e-3 * z, so loc drifts deterministically under Adam and the
# restored best params are comparable across packages; the eps-form log q
# adds O(1) sampling noise, far below the scripted gaps.
SCRIPTS = {
    "plateau": dict(values=[100, 90, 80, 85, 86, 87, 70, 75, 76, 77, 60],
                    patience=2, decay_rate=0.5),
    "reference_decay": dict(values=[100, 90, 80, 85, 86, 87, 70, 75, 76],
                            patience=2, decay_schedule="reference"),
    "nan_epoch": dict(values=[100, 90, np.nan, 80, 70, 75, 76]),
    "rel_tol": dict(values=[100, 90, 80] + [60] * 12, rel_tol=5e-2,
                    convergence_window=4),
}


def _factory(values):
    calls = {"i": 0}

    def factory():
        v = values[min(calls["i"], len(values) - 1)]
        calls["i"] += 1
        return iter([{"counts": np.array([float(v)])}])

    return factory


def _run_jax(script, kw):
    sur = jsur.SurrogatePosterior({"z": jsur.TransformedSurrogate(
        jsur.TrainableNormal(np.zeros((1, 1)), 1e-3 * np.ones((1, 1)), 2),
        jb.Identity())})

    def energy(batch, samples, pw):
        return -(batch["counts"][0] + 1e-3 * samples["z"][..., 0, 0])

    r = jmb.fit_surrogate_posterior(
        energy, sur, sur.init(), _factory(script), sample_size=8,
        num_steps=len(script) - 1, learning_rate=0.1, dtype=jnp.float64,
        seed=0, **kw)
    return r.losses, r.learning_rate, r.converged, float(
        r.params["z"]["loc"][0, 0])


def _run_torch(script, kw):
    sur = tsur.SurrogatePosterior({"z": tsur.TransformedSurrogate(
        tsur.TrainableNormal(np.zeros((1, 1)), 1e-3 * np.ones((1, 1)), 2,
                             dtype=torch.float64, device="cpu"),
        tb.Identity())})

    def energy(batch, samples, pw):
        return -(batch["counts"][0] + 1e-3 * samples["z"][..., 0, 0])

    r = tmb.fit_surrogate_posterior(
        energy, sur, sur.init(), _factory(script), sample_size=8,
        num_steps=len(script) - 1, learning_rate=0.1, dtype=torch.float64,
        seed=0, **kw)
    return r.losses, r.learning_rate, r.converged, float(
        r.params["z"]["loc"][0, 0])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_engine_control_flow_matches_jax(name, capsys):
    cfg = dict(SCRIPTS[name])
    values = cfg.pop("values")
    kw = dict(dict(rel_tol=None, verbose=True), **cfg)
    lj, lrj, cj, locj = _run_jax(values, kw)
    out_j = capsys.readouterr().out
    lt, lrt, ct, loct = _run_torch(values, kw)
    out_t = capsys.readouterr().out
    assert len(lt) == len(lj)
    np.testing.assert_array_equal(np.isnan(lt), np.isnan(lj))
    np.testing.assert_allclose(lt, lj, atol=2.0)
    assert lrt == lrj and ct == cj
    np.testing.assert_allclose(loct, locj, rtol=1e-6)
    for msg in ("loss plateau", "Restoring from a checkpoint",
                "Non-finite loss", "Converged"):
        assert out_t.count(msg) == out_j.count(msg), msg
    expect = {"plateau": "loss plateau", "reference_decay": "loss plateau",
              "nan_epoch": "Non-finite loss", "rel_tol": "Converged"}[name]
    assert expect in out_t


def test_unported_fit_options_raise(tmp_path):
    """Every engine option runs: param_sharding='replicated' on a trivial
    mesh (tests/test_sharding.py:158 in one process; an unknown mode
    raises), remat_sampling, elbo_estimator='stl', profile_dir, prefetch
    and epoch_chunk=4."""
    from spmf_tpu_torch.parallel import make_mesh

    X = counts(32, 6)
    host = ArrayDataset({"counts": X}).batch(16)
    m = PoissonFactorization(latent_dim=2, feature_dim=6, dtype="float64",
                             device="cpu", data=host)
    meshed = PoissonFactorization(latent_dim=2, feature_dim=6,
                                  dtype="float64", device="cpu", data=host,
                                  mesh=make_mesh((1, 1), ("dp", "fp")))
    losses = meshed.fit(num_steps=2, sample_size=2, verbose=False,
                        rel_tol=None, param_sharding="replicated")
    assert np.isfinite(losses).all()
    assert tuple(meshed.surrogate_params["u"]["loc"].shape) == (6, 2)
    with pytest.raises(ValueError, match="param_sharding"):
        m.fit(num_steps=1, sample_size=2, verbose=False,
              param_sharding="columns")
    for kw in (dict(remat_sampling=True), dict(elbo_estimator="stl")):
        assert np.isfinite(m.fit(num_steps=1, sample_size=2, verbose=False,
                                 **kw)).all()
    # epoch_scan is ported: on a host source it raises spmf_tpu's ValueError
    with pytest.raises(ValueError, match="epoch_scan"):
        m.fit(num_steps=1, sample_size=2, verbose=False, epoch_scan=True)
    for kw in (dict(profile_dir=str(tmp_path / "prof")), dict(prefetch=2)):
        assert np.isfinite(m.fit(num_steps=1, sample_size=2, verbose=False,
                                 **kw)).all()
    # K epochs a dispatch on the scan path
    m.fit(batched_data_factory=host.to_device(device="cpu"), num_steps=4,
          sample_size=2, verbose=False, rel_tol=None, epoch_chunk=4)
    assert m.last_fit.extras["epoch_chunk"] == 4
    with pytest.raises(TypeError):
        m.fit(num_steps=1, resume_frm="x")


@pytest.mark.slow
@pytest.mark.skipif(bool(os.environ.get("SPMF_SKIP_PARITY")),
                    reason="skipped explicitly via SPMF_SKIP_PARITY=1")
def test_noise_config_reaches_reference_optimum():
    """tests/test_parity.py's settings through the port (float64, CPU):
    <= 40.60 within 80 epochs, and the encoding shrinks on noise. Marked
    slow: eager PyTorch on the CPU takes 46-128 s for it (one process vs six
    test workers), past the port's share of the default suite."""
    n, d, p = 50_000, 30, 4
    X = np.random.default_rng(0).poisson(1.0, size=(n, d))
    data = ArrayDataset({"counts": X, "indices": np.arange(n)}).batch(1000)
    m = PoissonFactorization(latent_dim=p, feature_dim=d,
                             u_tau_scale=1 / np.sqrt(n * d), dtype="float64",
                             data=data, device="cpu")
    losses = m.calibrate_advi(num_steps=80, learning_rate=0.05, rel_tol=1e-4,
                              clip_value=5.0, sample_size=8, seed=3,
                              verbose=False)
    assert losses[-1] <= 40.60, losses[-1]
    assert float(m.encoding_matrix().abs().max()) < 0.1
