"""The fifth model family against spmf_tpu's: ``DenseHorseshoe`` (prior
log-prob and the assembled network) and ``PoissonAutoencoder`` (energy and
gradient on JAX's draws, ``encode`` with its latent-width search, the
cases of tests/test_models.py and tests/test_antithetic.py, npz files in
both directions, ``load_model`` without ``data=``, and the scan path
against the general loop), in float64 on the CPU."""
import glob
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmf_tpu
from spmf_tpu.data import ArrayDataset as JaxDS

import spmf_tpu_torch
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.utils import params_from_numpy
from spmf_tpu_torch.vi.minibatch import elbo_loss

from torch_ref import jax_draws, to_np, torch_params

N, D, P, S = 48, 9, 3, 2
X = np.random.default_rng(11).poisson(1.0, (N, D)).astype(np.float64)


def _jax_model(latent_dim=P, **kw):
    """spmf_tpu's autoencoder with its calibration (a jitted 250-sample
    scan) skipped: the tests pass every parameter explicitly."""
    with mock.patch.object(spmf_tpu.PoissonAutoencoder,
                           "set_calibration_expectations",
                           lambda self, *a, **k: None):
        return spmf_tpu.PoissonAutoencoder(
            {"counts": X, "indices": np.arange(N)}, latent_dim=latent_dim,
            dtype="float64", **kw)


def _port_model(latent_dim=P, data=None, **kw):
    data = {"counts": X, "indices": np.arange(N)} if data is None else data
    return spmf_tpu_torch.PoissonAutoencoder(
        data, latent_dim=latent_dim, dtype="float64", device="cpu", **kw)


def _perturbed(jm, seed=2, scale=0.2):
    rng = np.random.default_rng(seed)
    return {n: {k: v + scale * rng.standard_normal(v.shape) * np.abs(v).max()
                for k, v in sub.items()}
            for n, sub in to_np(jm.surrogate_params).items()}


@pytest.fixture(scope="module")
def pair():
    jm = _jax_model()
    return jm, _port_model(), _perturbed(jm)


def test_exports():
    from spmf_tpu_torch import models, nn

    assert spmf_tpu_torch.PoissonAutoencoder is models.PoissonAutoencoder
    assert spmf_tpu_torch.DenseHorseshoe is nn.DenseHorseshoe
    with pytest.raises(TypeError, match="spmf_tpu_torch.parallel.Mesh"):
        _port_model(mesh=object())


def test_surrogate_converts_leaf_for_leaf(pair):
    """The JAX surrogate tree (w_l / b_l -> loc, raw_scale) becomes the
    port's: same names in the same order, shapes, initial values (the
    per-layer 0.1 weight_scale / sqrt(d_in) and 1e-3 scales) and the
    column norms of the first batch."""
    jm, tm, _ = pair
    tree = params_from_numpy(to_np(jm.surrogate_params), "cpu", "float64")
    assert list(tree) == list(tm.surrogate_params) == tm.var_list
    assert tm.var_list == [f"{v}_{l}" for l in range(4) for v in "wb"]
    for var, sub in tm.surrogate_params.items():
        for leaf, t in sub.items():
            np.testing.assert_allclose(tree[var][leaf].numpy(), t.numpy(),
                                       rtol=1e-12, err_msg=f"{var}.{leaf}")
    np.testing.assert_allclose(tm.column_norm_factor.numpy(),
                               np.asarray(jm.column_norm_factor), rtol=1e-15)
    assert tm._config() == jm._config()


def test_dense_horseshoe_matches_jax():
    """joint_prior.log_prob and assemble_networks(params)(x), with a
    leading sample dim, at 1e-10."""
    from spmf_tpu.nn import DenseHorseshoe as JaxDense

    sizes = [6, 2, 6, 5]
    jn = JaxDense(5, sizes, weight_scale=0.7, dtype=np.float64)
    tn = spmf_tpu_torch.DenseHorseshoe(5, sizes, weight_scale=0.7,
                                       dtype="float64", device="cpu")
    assert tn.var_list == jn.var_list
    rng = np.random.default_rng(3)
    dims = [5] + sizes
    params = {}
    for l, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w_{l}"] = rng.normal(0.0, 0.6, (3, a, b))
        params[f"b_{l}"] = rng.normal(0.0, 1.0, (3, 1, b))
    x = rng.poisson(1.0, (4, 5)).astype(np.float64)
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    pt = torch_params(params, torch.float64)
    np.testing.assert_allclose(tn.joint_prior.log_prob(pt).numpy(),
                               np.asarray(jn.joint_prior.log_prob(pj)),
                               rtol=1e-10)
    out_t = tn.assemble_networks(pt)(torch.as_tensor(x))
    out_j = jn.assemble_networks(pj)(jnp.asarray(x))
    assert out_t.shape == (3, 4, 5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-10)


def test_energy_and_gradient_match_jax(pair):
    """The energy parts on the same samples, and the ELBO of one S=2 draw
    (JAX's base draws, reproduced from its key) with its gradient in every
    surrogate parameter, at 1e-9."""
    jm, tm, p_np = pair
    key = jax.random.PRNGKey(5)
    batch = X[:16]

    def loss_j(p):
        samples, logq = jm._surrogate.sample_and_log_prob(p, key, (S,))
        lp = jm.unormalized_log_prob(data={"counts": jnp.asarray(batch)},
                                     **samples)
        return -jnp.mean(lp - logq) / batch.shape[0]

    l_j, g_j = jax.jit(jax.value_and_grad(loss_j))(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    params = torch_params(p_np, torch.float64)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_(True)
    l_t = elbo_loss(tm._surrogate, tm._energy, params,
                    {"counts": torch.as_tensor(batch)}, None, S,
                    draws=jax_draws(jm, key, S))
    l_t.backward()
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=1e-9)
    for n, sub in to_np(g_j).items():
        for k, ref in sub.items():
            np.testing.assert_allclose(
                params[n][k].grad.numpy(), ref, rtol=1e-9,
                atol=1e-9 * np.abs(ref).max(), err_msg=f"{n}.{k}")
    # the parts, the rates and the per-row log-likelihood on given samples
    samples = {n: sub["loc"][None] + 0.1 * np.random.default_rng(6)
               .standard_normal((S,) + sub["loc"].shape)
               for n, sub in p_np.items()}
    sj = {k: jnp.asarray(v) for k, v in samples.items()}
    st = torch_params(samples, torch.float64)
    parts_j = jm.unormalized_log_prob_parts({"counts": batch}, **sj)
    parts_t = tm.unormalized_log_prob_parts({"counts": batch}, **st)
    assert list(parts_t) == list(parts_j)
    for k in parts_j:
        np.testing.assert_allclose(parts_t[k].numpy(),
                                   np.asarray(parts_j[k]), rtol=1e-9,
                                   err_msg=k)
    pred_t = tm.predictive_distribution({"counts": batch}, **st)
    pred_j = jm.predictive_distribution({"counts": batch}, **sj)
    for k in ("log_likelihood", "rates"):
        np.testing.assert_allclose(pred_t[k].numpy(), np.asarray(pred_j[k]),
                                   rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(
        tm._row_log_likelihood({"counts": batch}, st).numpy(),
        np.asarray(jm._row_log_likelihood({"counts": batch}, sj)),
        rtol=1e-9)


@pytest.mark.parametrize("latent_dim", [P, None])
def test_encode_matches_jax(latent_dim):
    """encode on the same parameters. With latent_dim=None (the feature
    dimension) the search for the latent layer by width stops at encoder
    layer 0, as in spmf_tpu: the code is (rows, D)."""
    jm = _jax_model(latent_dim)
    tm = _port_model(latent_dim)
    p_np = _perturbed(jm)
    loc = {n: sub["loc"] for n, sub in p_np.items()}
    z_j = np.asarray(jm.encode(X[:6], {k: jnp.asarray(v)
                                       for k, v in loc.items()}))
    z_t = tm.encode(X[:6], torch_params(loc, torch.float64))
    assert z_t.shape == z_j.shape == (6, P if latent_dim else D)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=1e-12)


def test_autoencoder():
    """tests/test_models.py::test_autoencoder through the port: two epochs
    with finite losses, the code's shape, a finite WAIC."""
    data = ArrayDataset({"data": X, "indices": np.arange(N)}).batch(24)
    m = _port_model(data=data)
    losses = m.fit(batched_data_factory=data, num_steps=2,
                   learning_rate=0.05, sample_size=4, verbose=False)
    assert np.isfinite(losses).all()
    assert m.count_key == "data"
    assert tuple(m.encode(X[:6]).shape) == (6, P)
    w = m.waic(num_samples=5)
    assert np.isfinite([w[k] for k in ("waic", "se", "lppd", "pwaic")]).all()
    ll = m.log_likelihood(data, num_samples=5)
    assert ll["n_rows"] == N and np.isfinite(ll["total"])


def test_autoencoder_fit_antithetic():
    """tests/test_antithetic.py::test_autoencoder_fit_antithetic through
    the port: S=4 mirrored pairs over the pure Normal surrogate."""
    rng = np.random.default_rng(1)
    x = rng.poisson(1.0, size=(96, 10)).astype(float)
    model = spmf_tpu_torch.PoissonAutoencoder(
        {"counts": x, "indices": np.arange(96)}, latent_dim=3,
        dtype="float64", device="cpu")
    losses = model.fit(batch_size=48, num_steps=3, sample_size=4,
                       rel_tol=None, verbose=False, antithetic=True)
    assert len(losses) >= 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_round_trip_between_packages(tmp_path, writer):
    """A model saved by one package loads into the other with
    load_model(path, data=...): the same parameters, and encode on them
    equal at 1e-12. Twelve layers (encoder_layers=decoder_layers=5), so
    the file's leaf order has b_10 before b_2 (jax.tree_util's sorted
    keys, flatten_jax_order). The config stores no layer counts, so both
    packages' load_model take them, like data=, as overrides."""
    kw = dict(encoder_layers=5, decoder_layers=5)
    data = {"counts": X, "indices": np.arange(N)}
    jm = _jax_model(**kw)
    p_np = _perturbed(jm, seed=4)
    path = str(tmp_path / "ae.npz")
    if writer == "jax":
        jm.surrogate_params = jax.tree_util.tree_map(jnp.asarray, p_np)
        jm.save(path)
        tm = spmf_tpu_torch.load_model(path, data=data, device="cpu",
                                       dtype="float64", **kw)
        got = to_np(tm.surrogate_params)
    else:
        tm = _port_model(**kw)
        tm.surrogate_params = torch_params(p_np, torch.float64)
        tm.save(path)
        with mock.patch.object(spmf_tpu.PoissonAutoencoder,
                               "set_calibration_expectations",
                               lambda self, *a, **k: None):
            jm = spmf_tpu.models.load_model(path, data=data, **kw)
        got = to_np(jm.surrogate_params)
    with np.load(path) as zf:
        order = sorted(p_np)
        np.testing.assert_array_equal(zf["param_4"], p_np[order[2]]["loc"])
        assert order[2] == "b_10"
    assert len(tm.neural_network_model.layer_sizes) == 12
    for n, sub in p_np.items():
        for k, v in sub.items():
            np.testing.assert_array_equal(got[n][k], v, err_msg=f"{n}.{k}")
    loc = {n: sub["loc"] for n, sub in p_np.items()}
    np.testing.assert_allclose(
        tm.encode(X[:5], torch_params(loc, torch.float64)).numpy(),
        np.asarray(jm.encode(X[:5], {k: jnp.asarray(v)
                                     for k, v in loc.items()})),
        rtol=1e-12)


def test_load_model_without_data_raises_type_error(tmp_path):
    """The file holds no column norms and the config no data, so both
    packages' load_model need data= and fail alike without it."""
    path = str(tmp_path / "ae.npz")
    _port_model().save(path)
    with pytest.raises(TypeError, match="data"):
        spmf_tpu_torch.load_model(path, device="cpu")
    with pytest.raises(TypeError, match="data"):
        spmf_tpu.models.load_model(path)


def test_scan_path_equals_general_loop():
    """A fit over ArrayDataset.to_device() takes the scan path (run
    eagerly on the CPU) and gives the general loop's losses and
    parameters."""
    ds = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(16)
    runs = []
    for source in (ds, ds.to_device(device="cpu")):
        m = _port_model(data=ds)
        losses = m.fit(batched_data_factory=source, num_steps=2,
                       learning_rate=0.02, sample_size=S, verbose=False)
        runs.append((losses, m))
    (l_loop, m_loop), (l_scan, m_scan) = runs
    assert m_scan.last_fit.extras.get("epoch_scan")
    assert not m_loop.last_fit.extras.get("epoch_scan")
    np.testing.assert_array_equal(l_scan, l_loop)
    for n, sub in m_loop.surrogate_params.items():
        for k, t in sub.items():
            assert torch.equal(m_scan.surrogate_params[n][k], t), (n, k)


def test_calibrate_advi_checkpoint_and_resume(tmp_path):
    """calibrate_advi through the engine as it stands: a checkpoint_dir
    fit writes the autoencoder's parameters (w_l / b_l in JAX leaf order)
    with Adam's state, and a fit resumed from the directory starts from
    them: its initial loss is the loss at the checkpointed parameters."""
    from spmf_tpu_torch.utils import load_fit_state

    ds = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(24)
    m = _port_model(data=ds)
    kw = dict(num_steps=3, learning_rate=0.02, sample_size=S,
              rel_tol=None, verbose=False)
    m.calibrate_advi(checkpoint_dir=str(tmp_path), **kw)
    first = m.last_fit
    files = glob.glob(str(tmp_path / "**" / "*.npz"), recursive=True)
    assert files
    params, opt, meta = load_fit_state(max(files, key=os.path.getmtime),
                                       m.surrogate_params)
    assert opt is not None and meta is not None
    for n, sub in first.params.items():
        for k, t in sub.items():
            np.testing.assert_array_equal(params[n][k], t.numpy())
    resumed = _port_model(data=ds)
    resumed.calibrate_advi(resume_from=str(tmp_path), **dict(kw, num_steps=1))
    at_best = _port_model(data=ds)
    at_best.surrogate_params = first.params
    at_best.calibrate_advi(**dict(kw, num_steps=1))
    np.testing.assert_allclose(resumed.last_fit.losses[0],
                               at_best.last_fit.losses[0], rtol=1e-12)
