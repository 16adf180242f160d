"""Bernoulli-decoder sparse factorization (mirrors
spmf_tpu/models/bernoulli.py).

Subclasses the Poisson model and swaps: the likelihood for
Bernoulli(logits=rate), the v/w priors for real-valued Normals with Identity
bijectors, and ``encode`` for one without the row-scaling branch.
"""
from __future__ import annotations

import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.models.poisson import PoissonFactorization

__all__ = ["BernoulliFactorization"]


class BernoulliFactorization(PoissonFactorization):
    """Sparse (horseshoe+) Bernoulli matrix factorization."""

    def __init__(
        self,
        latent_dim=None,
        feature_dim=None,
        u_tau_scale=0.01,
        s_tau_scale=1.0,
        symmetry_breaking_decay=0.99,
        strategy=None,
        mesh=None,
        encoder_function=None,
        decoder_function=None,
        log_transform=False,
        horshoe_plus=True,
        horseshoe_plus=None,
        column_norms=None,
        count_key="counts",
        dtype=None,
        data=None,
        **kwargs,
    ):
        # the reference Bernoulli constructor exposes no scale_rows /
        # scale_columns; row scaling is dropped in encode() regardless
        super().__init__(
            latent_dim=latent_dim,
            feature_dim=feature_dim,
            u_tau_scale=u_tau_scale,
            s_tau_scale=s_tau_scale,
            symmetry_breaking_decay=symmetry_breaking_decay,
            strategy=strategy,
            mesh=mesh,
            encoder_function=encoder_function,
            decoder_function=decoder_function,
            log_transform=log_transform,
            horshoe_plus=horshoe_plus,
            horseshoe_plus=horseshoe_plus,
            column_norms=column_norms,
            count_key=count_key,
            dtype=dtype,
            data=data,
            **kwargs,
        )

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

    def _fused_kind(self):
        return "bernoulli"

    def _observation_distribution(self, rate):
        """rate plays the role of logits."""
        return tfd.Bernoulli(logits=rate)

    def encode(self, x, u=None, s=None):
        """theta = g(x) @ A — no row-scaling branch."""
        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        return torch.matmul(self.encoder_function(x),
                            self.encoding_matrix(u, s))
