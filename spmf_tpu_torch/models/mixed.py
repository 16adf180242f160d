"""Mixed-type decoder factorization (mirrors spmf_tpu/models/mixed.py).

One shared sparse encoder (the horseshoe+ u/s machinery of
PoissonFactorization) with a per-column likelihood:

- 'poisson'   columns: x_ij ~ Poisson(softplus(rate_ij))
- 'bernoulli' columns: x_ij ~ Bernoulli(logits=rate_ij)
- 'normal'    columns: x_ij ~ Normal(rate_ij, obs_scale)

Bernoulli and Normal columns need signed natural parameters, so v and w get
real-valued Normal priors with Identity bijectors (as in the Bernoulli
model) and Poisson columns are kept positive through a softplus link. The
column types are static and ride a (1, D) code lane into one fused kernel
pass (ops.fused_poisson, likelihood=('mixed', obs_scale)): a per-column
select, no gather or scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.bijectors import softplus
from spmf_tpu_torch.models.bernoulli import BernoulliFactorization

__all__ = ["MixedFactorization"]

_TYPES = ("poisson", "bernoulli", "normal")


class MixedFactorization(BernoulliFactorization):
    """Shared sparse encoder, per-column-block decoder likelihoods."""

    def __init__(self, *args, column_types=None, obs_scale=1.0, **kwargs):
        if column_types is None:
            raise ValueError(
                "column_types is required: sequence of "
                "'poisson'|'bernoulli'|'normal' per feature column")
        column_types = list(column_types)
        for t in column_types:
            if t not in _TYPES:
                raise ValueError(f"Unknown column type {t!r}")
        self.column_types = column_types
        self.obs_scale = obs_scale
        self._masks = {
            t: np.asarray([ct == t for ct in column_types], np.bool_)[None, :]
            for t in _TYPES
        }
        kwargs.setdefault("feature_dim", len(column_types))
        if kwargs["feature_dim"] != len(column_types):
            raise ValueError("feature_dim must match len(column_types)")
        super().__init__(*args, **kwargs)

    def _fused_kind(self):
        return ("mixed", float(self.obs_scale))

    def _fused_codes(self):
        from spmf_tpu_torch.ops.fused_poisson import (
            CODE_BERNOULLI,
            CODE_NORMAL,
            CODE_POISSON,
        )

        code_of = {"poisson": CODE_POISSON, "bernoulli": CODE_BERNOULLI,
                   "normal": CODE_NORMAL}
        return np.asarray([[code_of[t] for t in self.column_types]],
                          np.float32)

    def log_likelihood_components(self, s, u, v, w, data, **kwargs):
        x = self._counts(data)
        theta_u = self.encode(x, u, s)
        phi = self.intercept_matrix(w, s)
        rate = self.decoder_function(
            torch.matmul(theta_u, self.decoding_matrix(v))) + phi

        ll = torch.zeros_like(rate)
        families = (
            ("poisson", lambda: tfd.Poisson(rate=softplus(rate))),
            ("bernoulli", lambda: tfd.Bernoulli(logits=rate)),
            ("normal", lambda: tfd.Normal(
                loc=rate, scale=float(self.obs_scale))),
        )
        if getattr(self, "_device_masks", None) is None:
            # made once on the device: the step copies nothing from the host
            self._device_masks = {
                t: torch.as_tensor(m, device=self.device)
                for t, m in self._masks.items() if m.any()}
        for name, dist in families:
            if name in self._device_masks:
                ll = torch.where(self._device_masks[name], dist().log_prob(x),
                                 ll)
        return {"log_likelihood": ll, "rate": rate}

    def _config(self):
        cfg = super()._config()
        cfg.update(column_types=self.column_types,
                   obs_scale=float(self.obs_scale))
        return cfg
