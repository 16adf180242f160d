"""BayesianModel base class (mirrors spmf_tpu/models/base.py: data binding,
the ``fit`` / ``calibrate_advi`` training entry points, the ``waic`` /
``log_likelihood`` scoring entry points and the calibrated expectations). All trainable state is the surrogate parameter dict
``self.surrogate_params``; the model holds configuration, the device and the
normalization constants."""
from __future__ import annotations

from typing import Optional

import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.data import as_data_factory
from spmf_tpu_torch.vi.minibatch import fit_surrogate_posterior
from spmf_tpu_torch.vi.waic import waic as _waic

__all__ = ["BayesianModel", "load_model"]

#: where the API that the port does not carry yet is queued
_API_ITEM = "ROADMAP.md section 1, item 1 (the rest of the models' API)"
_PERSISTENCE_ITEM = "ROADMAP.md section 1, item 2 (persistence and resume)"


def not_ported(name, item):
    """The refusal of an API name of spmf_tpu that the port lacks: a
    NotImplementedError naming the ROADMAP item that ports it."""
    return NotImplementedError(
        f"{name} is not ported to spmf_tpu_torch yet ({item})")


def load_model(path, **overrides):
    """Refused: reloading a saved model (spmf_tpu's ``load_model``)."""
    raise not_ported("load_model", _PERSISTENCE_ITEM)

#: fit() options of the JAX engine that this port does not carry yet
_NOT_PORTED = ("profile_dir", "remat_sampling", "opt_state", "param_sharding",
               "prefetch", "resume_from", "epoch_scan", "epoch_chunk",
               "checkpoint_full_state")
_ENGINE = ("convergence_window", "decay_schedule", "elbo_estimator",
           "antithetic")


class BayesianModel:
    def __init__(self, data=None, data_transform_fn=None, strategy=None,
                 mesh=None, dtype=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (multi-device) training is not ported to "
                "spmf_tpu_torch yet")
        # ``strategy`` kept for reference API parity and ignored
        self.strategy = strategy
        self.mesh = None
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

    def create_distributions(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        raise NotImplementedError  # pragma: no cover - abstract

    @property
    def surrogate_distribution(self):
        """Refused: the bound surrogate view with ``sample``."""
        raise not_ported("surrogate_distribution", _API_ITEM)

    @property
    def surrogate_vars(self):
        """Refused: the surrogate's variables."""
        raise not_ported("surrogate_vars", _API_ITEM)

    def save(self, path):
        """Refused: the npz of class, config and parameters."""
        raise not_ported("save", _PERSISTENCE_ITEM)

    def load_params(self, path):
        """Refused: parameters from a saved npz."""
        raise not_ported("load_params", _PERSISTENCE_ITEM)

    def reconstitute(self, state):
        """Refused: parameters from a state dict."""
        raise not_ported("reconstitute", _PERSISTENCE_ITEM)

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
        unknown = set(kwargs) - set(_NOT_PORTED) - set(_ENGINE)
        if unknown:
            raise TypeError(
                f"fit() got unknown keyword argument(s) {sorted(unknown)}; "
                f"engine options: {sorted(_ENGINE)}")
        given = sorted(k for k in _NOT_PORTED
                       if kwargs.get(k) not in (None, False))
        if given:
            raise NotImplementedError(
                f"fit() option(s) {given} are not ported to spmf_tpu_torch "
                "yet")
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
