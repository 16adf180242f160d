"""BayesianModel base class (mirrors spmf_tpu/models/base.py: data binding,
the ``fit`` / ``calibrate_advi`` training entry points and the calibrated
expectations). All trainable state is the surrogate parameter dict
``self.surrogate_params``; the model holds configuration, the device and the
normalization constants."""
from __future__ import annotations

from typing import Optional

import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.data import as_data_factory
from spmf_tpu_torch.vi.minibatch import fit_surrogate_posterior

__all__ = ["BayesianModel"]

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

    def set_calibration_expectations(self, num_samples: int = 250,
                                     seed: int = 42):
        """Posterior means of every surrogate variable, from
        ``num_samples`` draws of a generator seeded with ``seed``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.calibrated_expectations = self._surrogate.mean(
            self.surrogate_params, generator, num_samples)
