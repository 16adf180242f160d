"""BayesianModel base class (mirrors spmf_tpu/models/base.py: data binding,
the ``fit`` / ``calibrate_advi`` training entry points, the ``waic`` /
``log_likelihood`` scoring entry points, the calibrated expectations, the
bound surrogate view, and ``save`` / ``load_params`` / ``reconstitute`` /
``load_model`` in the JAX package's npz format). All trainable state is the
surrogate parameter dict ``self.surrogate_params``; the model holds
configuration, the device and the normalization constants."""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.data import as_data_factory
from spmf_tpu_torch.utils.checkpoint import (
    flatten_jax_order,
    to_numpy,
    treedef_string,
    unflatten_jax_order,
)
from spmf_tpu_torch.vi.minibatch import fit_surrogate_posterior
from spmf_tpu_torch.vi.waic import waic as _waic

__all__ = ["BayesianModel", "BoundSurrogate", "load_model"]

#: normalization constants a saved model carries beside its parameters
_EXTRAS = ("eta_i", "xi_u_global")


def load_model(path, **overrides):
    """Rebuild a model saved by ``save`` (of this package or of spmf_tpu)
    from its class name, config and parameters. ``overrides`` replace
    config entries and pass ``device=`` / ``dtype=``: the file stores no
    device, so with none given the model goes to the card."""
    with np.load(path, allow_pickle=False) as zf:
        meta = json.loads(str(zf["__meta__"]))
    import spmf_tpu_torch.models as _models

    cls = getattr(_models, meta["class"], None)
    if cls is None:
        raise NotImplementedError(
            f"{path} holds a {meta['class']}, a model class spmf_tpu_torch "
            "does not have")
    config = dict(meta.get("config", {}))
    config.update(overrides)
    model = cls(**config)
    model.load_params(path)
    return model


class BoundSurrogate:
    """View of (surrogate, current params) with the TFP-style ``sample``:
    ``model.surrogate_distribution.sample(250)``. ``seed``: None draws from
    a generator seeded ``1000 + n`` at the view's n-th call, an int seeds
    the generator, and a ``torch.Generator`` is used as given."""

    def __init__(self, model):
        self._model = model
        self._counter = 0

    def _generator(self, seed):
        if isinstance(seed, torch.Generator):
            return seed
        return torch.Generator(device=self._model.device).manual_seed(
            int(seed))

    def sample(self, sample_shape=(), seed=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        if seed is None:
            self._counter += 1
            seed = 1000 + self._counter
        return self._model._surrogate.sample(
            self._model.surrogate_params, self._generator(seed),
            tuple(sample_shape))

    def sample_and_log_prob(self, sample_shape=(), seed=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return self._model._surrogate.sample_and_log_prob(
            self._model.surrogate_params, self._generator(seed or 0),
            tuple(sample_shape))

    @property
    def variables(self):
        return self._model.surrogate_params


_ENGINE = ("convergence_window", "decay_schedule", "elbo_estimator",
           "antithetic", "opt_state", "resume_from", "checkpoint_full_state",
           "epoch_scan", "epoch_chunk", "prefetch", "profile_dir",
           "remat_sampling", "param_sharding")


class BayesianModel:
    def __init__(self, data=None, data_transform_fn=None, strategy=None,
                 mesh=None, dtype=None, device=None):
        """``mesh``: a ``spmf_tpu_torch.parallel.Mesh`` of the ranks this
        model trains on (rows over dp, the feature dim over fp), or None
        for one process."""
        from spmf_tpu_torch.parallel.mesh import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be a spmf_tpu_torch.parallel.Mesh (make_mesh, "
                "data_parallel_mesh, global_mesh, make_multislice_mesh), "
                f"got {type(mesh).__name__}")
        # ``strategy`` kept for reference API parity and ignored
        self.strategy = strategy
        self.mesh = mesh
        self.dtype = canonical_dtype(dtype)
        self.device = canonical_device(device)
        self.data = None
        self.data_transform_fn = data_transform_fn
        self._surrogate = None
        self.surrogate_params = None
        self.prior_distribution = None
        self.calibrated_expectations = {}
        self.var_list = []
        if data is not None:
            self.set_data(data, data_transform_fn)

    def set_data(self, data, data_transform_fn=None, n=None):
        self.data = as_data_factory(data)
        self.data_transform_fn = data_transform_fn

    def _const(self, value):
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    def create_distributions(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        raise NotImplementedError  # pragma: no cover - abstract

    @property
    def surrogate_distribution(self):
        return BoundSurrogate(self)

    @property
    def surrogate_vars(self):
        return self.surrogate_params

    def _energy(self, batch, samples, prior_weight):
        return self.unormalized_log_prob(data=batch,
                                         prior_weight=prior_weight, **samples)

    def fit(
        self,
        batched_data_factory=None,
        dataset_size: Optional[int] = None,
        batch_size: Optional[int] = None,
        sample_size: int = 8,
        sample_batches: int = 1,
        num_steps: int = 100,
        learning_rate: float = 0.1,
        decay_rate: float = 0.99,
        abs_tol: Optional[float] = None,
        rel_tol: Optional[float] = 1e-4,
        clip_value: float = 5.0,
        patience: int = 3,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        verbose: bool = True,
        **kwargs,
    ):
        """Minibatch ADVI fit; returns the loss trace."""
        factory = as_data_factory(batched_data_factory) or self.data
        if factory is None:
            raise ValueError(
                "No data bound: pass batched_data_factory or set_data()")
        unknown = set(kwargs) - set(_ENGINE)
        if unknown:
            raise TypeError(
                f"fit() got unknown keyword argument(s) {sorted(unknown)}; "
                f"engine options: {sorted(_ENGINE)}")
        engine_kwargs = {k: kwargs[k] for k in _ENGINE if k in kwargs}
        result = fit_surrogate_posterior(
            energy_fn=self._energy,
            surrogate=self._surrogate,
            params=self.surrogate_params,
            batched_data_factory=factory,
            dataset_size=dataset_size,
            batch_size=batch_size,
            sample_size=sample_size,
            sample_batches=sample_batches,
            num_steps=num_steps,
            learning_rate=learning_rate,
            decay_rate=decay_rate,
            abs_tol=abs_tol,
            rel_tol=rel_tol,
            clip_value=clip_value,
            patience=patience,
            seed=seed,
            dtype=self.dtype,
            device=self.device,
            mesh=self.mesh,
            checkpoint_dir=checkpoint_dir,
            verbose=verbose,
            **engine_kwargs,
        )
        self.surrogate_params = result.params
        self.last_fit = result
        self.set_calibration_expectations()
        return result.losses

    def calibrate_advi(
        self,
        num_steps: int = 100,
        learning_rate: float = 0.1,
        abs_tol: Optional[float] = None,
        rel_tol: Optional[float] = 1e-4,
        clip_value: float = 5.0,
        sample_size: int = 8,
        sample_batches: int = 1,
        seed: int = 0,
        verbose: bool = True,
        **kwargs,
    ):
        """Train against the data bound at construction."""
        return self.fit(
            batched_data_factory=self.data,
            num_steps=num_steps,
            learning_rate=learning_rate,
            abs_tol=abs_tol,
            rel_tol=rel_tol,
            clip_value=clip_value,
            sample_size=sample_size,
            sample_batches=sample_batches,
            seed=seed,
            verbose=verbose,
            **kwargs,
        )

    # ------------------------------------------------------------- reporting
    def waic(self, data=None, num_samples: int = 100, seed: int = 1,
             subsample=None, sample_chunk: int = 8):
        """{'waic', 'se', 'lppd', 'pwaic', 'n_rows'}, pointwise per row.

        ``subsample=None`` scans the whole bound (or given) dataset;
        ``subsample='batch'`` evaluates its FIRST batch only, the unit the
        reference engine's recorded WAIC outputs used."""
        factory = as_data_factory(data) or self.data
        if factory is None:
            raise ValueError("No data bound for waic()")
        if subsample == "batch":
            first = next(iter(factory()))
            factory = lambda: iter([first])  # noqa: E731
        elif subsample is not None:
            raise ValueError(f"unknown subsample mode {subsample!r}")
        return _waic(
            self._row_log_likelihood,
            self._surrogate,
            self.surrogate_params,
            factory,
            num_samples=num_samples,
            seed=seed,
            sample_chunk=sample_chunk,
            dtype=self.dtype,
            device=self.device,
            mesh=self.mesh,
        )

    def log_likelihood(self, data=None, num_samples: int = 100, seed: int = 1,
                       sample_chunk: int = 8):
        """Predictive log-likelihood of ``data`` under the posterior:
        {'total', 'per_row', 'n_rows'}, where ``total`` is the lppd
        (sum_i log mean_s exp(ll_is)). Pass held-out data to score
        generalization; with ``data=None`` it scores the bound data and
        ``total`` equals ``waic()['lppd']`` for the same draws."""
        out = self.waic(data=data, num_samples=num_samples, seed=seed,
                        sample_chunk=sample_chunk)
        return {
            "total": out["lppd"],
            "per_row": out["lppd"] / out["n_rows"],
            "n_rows": out["n_rows"],
        }

    def set_calibration_expectations(self, num_samples: int = 250,
                                     seed: int = 42):
        """Posterior means of every surrogate variable, from
        ``num_samples`` draws of a generator seeded with ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.calibrated_expectations = self._surrogate.mean(
            self.surrogate_params, generator, num_samples)

    # ----------------------------------------------------------- persistence
    def _config(self) -> dict:
        """Static config needed to rebuild the model; overridden by models."""
        return {}

    def save(self, path):
        """Write ``__meta__`` (class, config, the params' treedef string),
        the parameters as ``param_{i}`` in JAX leaf order and the
        normalization constants as ``extra_*``: the file spmf_tpu's
        ``save`` writes. On a mesh rank 0 alone writes (the parameters are
        whole on every rank after ``fit``)."""
        if self.mesh is not None and self.mesh.rank != 0:
            return
        arrays = {f"param_{i}": to_numpy(x) for i, x in
                  enumerate(flatten_jax_order(self.surrogate_params))}
        extras = {f"extra_{name}": to_numpy(getattr(self, name))
                  for name in _EXTRAS if hasattr(self, name)}
        meta = {"class": type(self).__name__, "config": self._config(),
                "treedef": treedef_string(self.surrogate_params)}
        np.savez(path, __meta__=json.dumps(meta), **arrays, **extras)

    def load_params(self, path):
        """Parameters and normalization constants from a saved npz, as
        tensors of the model's dtype on its device; then recalibrate."""
        with np.load(path, allow_pickle=False) as zf:
            flat = []
            while f"param_{len(flat)}" in zf:
                flat.append(self._const(zf[f"param_{len(flat)}"]))
            for name in _EXTRAS:
                if f"extra_{name}" in zf:
                    setattr(self, name, self._const(zf[f"extra_{name}"]))
        self.surrogate_params = unflatten_jax_order(flat,
                                                    self.surrogate_params)
        self.set_calibration_expectations()

    def reconstitute(self, state):
        """Parameters from a state dict: ``{"surrogate_vars": [...]}`` in
        JAX leaf order, or a parameter dict. Rebuilds the distributions
        first and, like the reference, does not recalibrate."""
        self.create_distributions()
        if isinstance(state, dict) and "surrogate_vars" in state:
            flat = [self._const(np.array(v)) for v in state["surrogate_vars"]]
            n_now = len(flatten_jax_order(self.surrogate_params))
            if len(flat) != n_now:
                raise ValueError(
                    f"State has {len(flat)} arrays, expected {n_now}")
            self.surrogate_params = unflatten_jax_order(
                flat, self.surrogate_params)
        elif isinstance(state, dict):
            self.surrogate_params = {
                n: {k: self._const(np.array(to_numpy(v)))
                    for k, v in sub.items()}
                for n, sub in state.items()}
