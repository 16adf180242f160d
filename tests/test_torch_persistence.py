"""Saved models move between spmf_tpu and the port: ``save`` /
``load_model`` / ``load_params`` / ``reconstitute`` in the JAX package's npz
format, with the parameters in JAX leaf order (``flatten_jax_order``), for
the Poisson, Bernoulli, Gaussian and Mixed families (float64, CPU)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmf_tpu
import spmf_tpu_torch
from spmf_tpu.data import ArrayDataset as JaxDS
from spmf_tpu.models.base import load_model as jax_load_model
from spmf_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from spmf_tpu.utils.checkpoint import save_pytree as jax_save_pytree

from spmf_tpu_torch.data import ArrayDataset as TorchDS
from spmf_tpu_torch.models.base import load_model
from spmf_tpu_torch.utils import (flatten_jax_order, load_pytree,
                                  params_from_numpy, save_pytree,
                                  unflatten_jax_order)
from spmf_tpu_torch.utils.checkpoint import treedef_string

from torch_ref import perturbed_params, to_np

N, D, K = 30, 13, 3
TYPES = ["poisson"] * 5 + ["bernoulli"] * 4 + ["normal"] * 4
#: family -> (class name in both packages, constructor options); Poisson
#: with row scaling so that xi_u_global travels with the file
FAMILIES = {
    "poisson": ("PoissonFactorization", dict(scale_rows=True)),
    "bernoulli": ("BernoulliFactorization", {}),
    "gaussian": ("GaussianFactorization", dict(observation_model="normal")),
    "mixed": ("MixedFactorization", dict(column_types=TYPES)),
}


def _counts():
    x = np.random.default_rng(0).poisson(1.5, (N, D)).astype(np.float64)
    x[:, 5:9] = np.minimum(x[:, 5:9], 1.0)
    return x


@functools.lru_cache(maxsize=None)
def _models(family):
    """(JAX model, port model) of one family bound to the same data, both
    holding the same perturbed parameters (shared by the module's tests:
    the JAX model's calibration is one jitted 250-sample scan)."""
    name, kw = FAMILIES[family]
    x = _counts()
    common = dict(latent_dim=K, feature_dim=D, dtype="float64", **kw)
    jm = getattr(spmf_tpu, name)(data=JaxDS({"counts": x}).batch(N),
                                 **common)
    tm = getattr(spmf_tpu_torch, name)(data=TorchDS({"counts": x}).batch(N),
                                       device="cpu", **common)
    p = perturbed_params(jm, seed=3)
    jm.surrogate_params = jax.tree_util.tree_map(jnp.asarray, p)
    tm.surrogate_params = params_from_numpy(p, device="cpu",
                                            dtype=torch.float64)
    return jm, tm


def _encode_inputs():
    rng = np.random.default_rng(5)
    return (_counts()[:7], rng.lognormal(-1.0, 0.5, (D, K)),
            rng.lognormal(-1.0, 0.5, (2, D)))


def _assert_same_model(jm, tm):
    """Parameter arrays bit-equal in JAX leaf order, the same
    normalization constants, and encode within rtol 1e-12."""
    ja = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jm.surrogate_params)]
    ta = [t.numpy() for t in flatten_jax_order(tm.surrogate_params)]
    assert len(ja) == len(ta)
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for name in ("eta_i", "xi_u_global"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name).numpy())
    x, u, s = _encode_inputs()
    np.testing.assert_allclose(
        tm.encode(x, torch.as_tensor(u), torch.as_tensor(s)).numpy(),
        np.asarray(jm.encode(x, jnp.asarray(u), jnp.asarray(s))),
        rtol=1e-12)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_save_loads_in_port(family, tmp_path):
    jm, _ = _models(family)
    path = str(tmp_path / "jax.npz")
    jm.save(path)
    tm = load_model(path, device="cpu", dtype="float64")
    assert type(tm).__name__ == FAMILIES[family][0]
    assert tm._config() == jm._config()
    _assert_same_model(jm, tm)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_port_save_loads_in_jax(family, tmp_path):
    _, tm = _models(family)
    path = str(tmp_path / "port.npz")
    tm.save(path)
    jm = jax_load_model(path, dtype="float64")
    assert type(jm).__name__ == FAMILIES[family][0]
    assert jm._config() == tm._config()
    _assert_same_model(jm, tm)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_both_packages_write_the_same_arrays(family, tmp_path):
    """W12: the port's dict is in insertion order, the file in JAX order;
    the two packages' files of the same parameters agree array for array
    (and on the meta, treedef string included)."""
    jm, tm = _models(family)
    jm.save(str(tmp_path / "jax.npz"))
    tm.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "port.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert zj["__meta__"] == zt["__meta__"]
        for key in zj.files:
            if key != "__meta__":
                assert zj[key].dtype == zt[key].dtype, key
                np.testing.assert_array_equal(zj[key], zt[key], err_msg=key)
    assert list(tm.surrogate_params) != sorted(tm.surrogate_params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reconstitute_from_jax_ordered_vars_and_from_a_dict(family):
    jm, tm = _models(family)
    flat = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jm.surrogate_params)]
    name, kw = FAMILIES[family]
    m = getattr(spmf_tpu_torch, name)(latent_dim=K, feature_dim=D,
                                      dtype="float64", device="cpu", **kw)
    calibrated = {k: v.clone() for k, v in m.calibrated_expectations.items()}
    m.reconstitute({"surrogate_vars": flat})
    for a, b in zip(flat, flatten_jax_order(m.surrogate_params)):
        np.testing.assert_array_equal(a, b.numpy())
    # W9: the calibrations are those of the rebuilt initial surrogate
    for k, v in calibrated.items():
        torch.testing.assert_close(m.calibrated_expectations[k], v, rtol=0,
                                   atol=0)
    m.reconstitute(to_np(tm.surrogate_params))
    for a, b in zip(flat, flatten_jax_order(m.surrogate_params)):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(ValueError, match="expected"):
        m.reconstitute({"surrogate_vars": flat[:-1]})


def test_legacy_load_params_matches_jax(tmp_path):
    """The verify skill's library check: a saved model's parameters loaded
    into the legacy constructor with explicit column norms."""
    x = _counts()[:, :10]
    norms = x.mean(0, keepdims=True)
    jm = spmf_tpu.PoissonMatrixFactorization(
        JaxDS({"counts": x}).batch(N), latent_dim=2, dtype="float64")
    jm.surrogate_params = jax.tree_util.tree_map(
        jnp.asarray, perturbed_params(jm, seed=8))
    path = str(tmp_path / "legacy.npz")
    jm.save(path)
    jl = spmf_tpu.PoissonMatrixFactorization(
        None, latent_dim=2, feature_dim=10, column_norms=norms,
        dtype="float64")
    jl.load_params(path)
    tl = spmf_tpu_torch.PoissonMatrixFactorization(
        None, latent_dim=2, feature_dim=10, column_norms=norms,
        dtype="float64", device="cpu")
    tl.load_params(path)
    for a, b in zip(jax.tree_util.tree_leaves(jm.surrogate_params),
                    flatten_jax_order(tl.surrogate_params)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    u = tl.calibrated_expectations["u"].numpy()
    s = tl.calibrated_expectations["s"].numpy()
    np.testing.assert_allclose(
        tl.encode(x[:5]).numpy(),
        np.asarray(jl.encode(x[:5], jnp.asarray(u), jnp.asarray(s))),
        rtol=1e-12)


def test_load_model_takes_device_dtype_and_config_overrides(tmp_path):
    _, tm = _models("poisson")
    path = str(tmp_path / "port.npz")
    tm.save(path)
    m = load_model(path, device="cpu", dtype="float32",
                   likelihood_clip="static")
    assert m.device == torch.device("cpu") and m.dtype == torch.float32
    assert m.likelihood_clip == "static"
    assert "device" not in m._config()
    for a, b in zip(flatten_jax_order(tm.surrogate_params),
                    flatten_jax_order(m.surrogate_params)):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy().astype(np.float32),
                                      b.numpy())
    assert m.eta_i.dtype == torch.float32


def test_flatten_order_treedef_and_pytree_files_match_jax(tmp_path):
    tree = {"w": {"raw_scale": np.arange(3.0), "loc": np.ones((2, 2))},
            "b": [np.zeros(1), (np.full(2, 7.0),)],
            "a": {"x": np.float64(2.5)}}
    jleaves, jdef = jax.tree_util.tree_flatten(tree)
    leaves = flatten_jax_order(tree)
    assert len(leaves) == len(jleaves)
    for a, b in zip(jleaves, leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert treedef_string(tree) == str(jdef)
    back = unflatten_jax_order(leaves, tree)
    assert list(back) == list(tree) and list(back["w"]) == ["raw_scale", "loc"]
    # a pytree file of either package loads in the other
    tt = {"z": {"raw_scale": torch.arange(3.0), "loc": torch.ones(2)}}
    save_pytree(str(tmp_path / "port.npz"), tt)
    got = jax_load_pytree(str(tmp_path / "port.npz"), to_np(tt))
    np.testing.assert_array_equal(got["z"]["raw_scale"], np.arange(3.0))
    jax_save_pytree(str(tmp_path / "jax.npz"), to_np(tt))
    with np.load(tmp_path / "jax.npz") as zj, \
            np.load(tmp_path / "port.npz") as zt:
        assert zj["__treedef__"] == zt["__treedef__"]
    got = load_pytree(str(tmp_path / "jax.npz"), tt)
    assert list(got["z"]) == ["raw_scale", "loc"]
    np.testing.assert_array_equal(got["z"]["loc"], np.ones(2))


def test_load_model_of_an_unported_class_raises_by_name(tmp_path):
    """A file naming a model class that neither package has is refused by
    name, not with a bare AttributeError."""
    name = "PoissonTransformer"
    assert not hasattr(spmf_tpu.models, name)
    assert not hasattr(spmf_tpu_torch.models, name)
    path = str(tmp_path / "other.npz")
    np.savez(path, __meta__=json.dumps({"class": name, "config": {},
                                        "treedef": "PyTreeDef({})"}))
    with pytest.raises(NotImplementedError, match=name):
        load_model(path, device="cpu")
