"""Gaussian-prior (signed-loadings) sparse factorization (mirrors
spmf_tpu/models/gaussian.py).

Differences from the Poisson model: real-valued priors (u, v, w ~ Normal
with Identity bijectors), a Normal(0, 1) prior on theta, and
``prior_weight`` forwarded to the energy parts. The observation model of the
reference is still Poisson ("Gaussian" names the prior structure): that is
the default here, and ``observation_model='normal'`` gives a true
Normal(rate, obs_scale) likelihood decoder.
"""
from __future__ import annotations

import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.models.poisson import PoissonFactorization

__all__ = ["GaussianFactorization"]


class GaussianFactorization(PoissonFactorization):
    """Signed-loadings factorization."""

    _u_signed = True

    def __init__(self, *args, observation_model="poisson", obs_scale=1.0,
                 **kwargs):
        self.observation_model = observation_model
        self.obs_scale = obs_scale
        super().__init__(*args, **kwargs)

    def _vw_bijectors(self):
        return {"v": tfb.Identity(), "w": tfb.Identity()}

    def _vw_priors(self, ones):
        D, K = self.feature_dim, self.latent_dim
        # v ~ Normal(0, 0.1), w ~ Normal(0, 1)
        return {
            "v": tfd.Independent(
                tfd.Normal(loc=0.0 * ones(K, D), scale=0.1 * ones(K, D)), 2),
            "w": tfd.Independent(
                tfd.Normal(loc=0.0 * ones(1, D), scale=ones(1, D)), 2),
        }

    def _vw_surrogates(self, ones):
        D, K = self.feature_dim, self.latent_dim
        # v loc -5 scale 5e-4; w loc 0.5 scale 1e-3
        return {
            "v": self._normal_surrogate(-5.0 * ones(K, D), 5e-4 * ones(K, D),
                                        "v"),
            "w": self._normal_surrogate(0.5 * ones(1, D), 1e-3 * ones(1, D),
                                        "w"),
        }

    def _theta_prior_log_prob(self, theta):
        # Normal(0, 1) instead of HalfNormal
        rv = tfd.Independent(tfd.Normal(loc=torch.zeros_like(theta),
                                        scale=torch.ones_like(theta)), 2)
        return rv.log_prob(theta)

    def _fused_kind(self):
        # the faithful Poisson-observation mode shares the Poisson kernel;
        # the normal-observation mode takes the ('normal', obs_scale) branch
        if self.observation_model == "poisson":
            return "poisson"
        if self.observation_model == "normal":
            return ("normal", float(self.obs_scale))
        return None

    def _observation_distribution(self, rate):
        if self.observation_model == "normal":
            return tfd.Normal(loc=rate, scale=float(self.obs_scale))
        return tfd.Poisson(rate=rate)

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        # unlike the Poisson / Bernoulli quirk, the Gaussian model forwards
        # prior_weight to the parts function
        parts = self.unormalized_log_prob_parts(
            data, prior_weight=prior_weight, **params)
        out = 0.0
        for v in parts.values():
            out = out + v
        return out

    def _config(self):
        cfg = super()._config()
        cfg.update(observation_model=self.observation_model,
                   obs_scale=float(self.obs_scale))
        return cfg
