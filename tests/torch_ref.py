"""Shared helpers of the port's tests: paired JAX / PyTorch models, numpy
conversion, and the JAX draws of one ``sample_and_log_prob`` call
reproduced from its key, so both packages can be fed the same randomness.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from spmf_tpu_torch.utils.convert import params_from_numpy, params_to_numpy

#: the entry() size of __graft_entry__.py
N, D, K, B, S = 256, 64, 8, 64, 4


def to_np(tree):
    """JAX pytree or torch dict -> nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def counts(n=N, d=D, seed=0):
    return np.random.default_rng(seed).poisson(1.0, size=(n, d))


@functools.lru_cache(maxsize=None)
def _model_pair(dtype, n, d, k, kw):
    """(JAX model, port model, counts) with the same config and data stats.
    The JAX model's calibrated expectations (a jitted 250-sample scan, the
    bulk of its construction time) are skipped: the parity tests pass every
    parameter explicitly."""
    from unittest import mock

    from spmf_tpu import PoissonFactorization as JaxPF
    from spmf_tpu.data import ArrayDataset as JaxDS

    from spmf_tpu_torch import PoissonFactorization as TorchPF
    from spmf_tpu_torch.data import ArrayDataset as TorchDS

    X = counts(n, d)
    common = dict(latent_dim=k, feature_dim=d, u_tau_scale=1.0 / np.sqrt(n * d),
                  dtype=dtype, **dict(kw))
    with mock.patch.object(JaxPF, "set_calibration_expectations",
                           lambda self, *a, **kw: None):
        jm = JaxPF(data=JaxDS({"counts": X, "indices": np.arange(n)}).batch(B),
                   **common)
    tm = TorchPF(data=TorchDS({"counts": X, "indices": np.arange(n)}).batch(B),
                 device="cpu", **common)
    return jm, tm, X


def model_pair(dtype="float64", n=N, d=D, k=K, **kw):
    """Cached per process: tests only read the models (the JAX side's
    ``_fused_interpret`` is set on every fused use)."""
    return _model_pair(dtype, n, d, k, tuple(sorted(kw.items())))


def perturbed_params(model, seed=1, scale=0.3):
    """The JAX model's initial params moved off their init values (so a
    parity check does not sit on a symmetric point), as numpy."""
    rng = np.random.default_rng(seed)
    p = to_np(model.surrogate_params)
    return {n: {k: v + scale * rng.standard_normal(v.shape).astype(v.dtype)
                for k, v in sub.items()} for n, sub in p.items()}


def random_samples(model, sample_size=3, seed=4):
    """Positive values of every surrogate variable's shape, with a leading
    sample axis, as numpy: valid inputs to both packages' energies without
    running either sampler."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(str(np.dtype(model.dtype)))
    return {n: rng.lognormal(-1.0, 0.5, (sample_size,) + tuple(s.shape))
            .astype(dtype) for n, s in model._surrogate.surrogates.items()}


def jax_draws(model, key, sample_size, antithetic=False):
    """The base draws JAX's SurrogatePosterior.sample_and_log_prob makes from
    ``key`` with gamma_sampler='fast': the 5-way split, one flattened
    normal for the regular Normal block, and wilson_hilferty_gamma's normal
    and uniforms for the regular IG block (ops/gamma.py), in any antithetic
    mode; with broadcast names, the broadcast Normals' normal from ``kbn``
    and the broadcast IGs' WH draws from ``kbg``, at sample shape ()."""
    from spmf_tpu.ops.gamma import _mirror_base_draws

    sur = model._surrogate
    dtype = model.dtype
    bset = sur.broadcast_names
    kn, kg, _, kbn, kbg = jax.random.split(key, 5)

    def total(names, keep):
        return sum(sur._sizes[n] for n in names if (n in bset) == keep)

    tot_n = total(sur._normal_names, False)
    tot_g = total(sur._ig_names, False)
    shape = (sample_size, tot_g)
    if antithetic:
        if antithetic == "stratified":
            from jax.scipy.special import ndtri

            from spmf_tpu.ops.gamma import lattice_uniform

            eps_h = ndtri(lattice_uniform(kn, sample_size // 2, (tot_n,),
                                          dtype))
        else:
            eps_h = jax.random.normal(kn, (sample_size // 2, tot_n), dtype)
        normal_eps = jnp.concatenate([eps_h, -eps_h], axis=0)
        ig_eps, ig_u = _mirror_base_draws(
            kg, shape, dtype, 8, stratified=antithetic == "stratified")
    else:
        normal_eps = jax.random.normal(kn, (sample_size, tot_n), dtype)
        ig_eps, ig_u = _wh_draws(kg, shape, dtype)
    out = {"normal_eps": np.asarray(normal_eps), "ig_eps": np.asarray(ig_eps),
           "ig_u": np.asarray(ig_u)}
    if bset:
        out["bc_normal_eps"] = np.asarray(jax.random.normal(
            kbn, (total(sur._normal_names, True),), dtype))
        bc_eps, bc_u = _wh_draws(kbg, (total(sur._ig_names, True),), dtype)
        out["bc_ig_eps"], out["bc_ig_u"] = np.asarray(bc_eps), np.asarray(bc_u)
    return out


def _wh_draws(key, shape, dtype):
    """wilson_hilferty_gamma's normal and 8 boost uniforms from ``key``."""
    kn, ku = jax.random.split(key)
    return (jax.random.normal(kn, shape, dtype),
            jax.random.uniform(ku, (8,) + shape, dtype,
                               minval=jnp.finfo(dtype).tiny, maxval=1.0))


def torch_params(tree_np, dtype):
    return params_from_numpy(tree_np, "cpu", dtype)


__all__ = ["N", "D", "K", "B", "S", "counts", "jax_draws", "model_pair",
           "params_to_numpy", "perturbed_params", "random_samples", "to_np",
           "torch_params"]
