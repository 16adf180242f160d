"""Sparse (horseshoe+) Poisson matrix factorization, dense path (mirrors
spmf_tpu/models/poisson.py).

    encoder   theta_i = g(x_i) @ A,  A = w1 * u   (w = s / colsum(s), w1 = w[0])
    decoder   rate    = f(theta @ v) + phi,  phi = eta_i * w2 * w
    x_ij ~ Poisson(rate_ij)

with a horseshoe+ prior on the encoding loadings u and the split weights s.
On a CUDA device the decode and clipped Poisson log-likelihood run as one
fused kernel (spmf_tpu_torch.ops.fused_poisson) and the horseshoe+
auxiliaries are sampled by the fused IG kernel (ops.fused_ig).
"""
from __future__ import annotations

import numpy as np
import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.data import as_data_factory
from spmf_tpu_torch.models.base import BayesianModel
from spmf_tpu_torch.vi.surrogates import (
    SurrogatePosterior,
    TrainableInverseGamma,
    TrainableNormal,
    TransformedSurrogate,
)

__all__ = ["PoissonFactorization"]


def _def_depth(mro, name):
    """MRO index of the class that defines ``name`` (len(mro) if none)."""
    for i, c in enumerate(mro):
        if name in c.__dict__:
            return i
    return len(mro)


class PoissonFactorization(BayesianModel):
    """Sparse (horseshoe+) Poisson matrix factorization."""

    s_tau_scale = 1.0

    def _fused_kind(self):
        """The fused-kernel likelihood of this model's observation
        distribution (a subclass overriding ``_observation_distribution``
        must override this too)."""
        return "poisson"

    def encoder_function(self, x):
        """g(x)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        if self.log_transform:
            return torch.log(x / self.eta_i + 1.0)
        return x / self.eta_i

    def decoder_function(self, x):
        """f(x) = g^{-1}(x)."""
        if self.log_transform:
            return torch.exp(x * self.eta_i) - 1.0
        return x * self.eta_i

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
        scale_columns=True,
        scale_rows=True,
        log_transform=False,
        horshoe_plus=True,
        horseshoe_plus=None,
        column_norms=None,
        count_key="counts",
        initialize_distributions=True,
        dtype=None,
        data=None,
        fused_likelihood=None,
        gamma_sampler=None,
        aux_broadcast=False,
        sparse_dense_scatter=None,
        likelihood_clip="reference",
        device=None,
        **kwargs,
    ):
        """Mirrors the JAX constructor (including the ``horshoe_plus``
        spelling), plus ``device`` (default: cuda when present)."""
        super().__init__(data=None, data_transform_fn=None,
                         strategy=strategy, mesh=mesh, dtype=dtype,
                         device=device)
        self.scale_rows = scale_rows
        self.scale_columns = scale_columns
        self.horseshoe_plus = (horshoe_plus if horseshoe_plus is None
                               else horseshoe_plus)
        if not self.horseshoe_plus:
            raise NotImplementedError(
                "horshoe_plus=False (the AbsHorseshoe prior) is not ported "
                "to spmf_tpu_torch yet")
        if aux_broadcast:
            raise NotImplementedError(
                "aux_broadcast is not ported to spmf_tpu_torch yet")
        if sparse_dense_scatter is not None:
            raise NotImplementedError(
                "sparse (COO) batches are not ported to spmf_tpu_torch yet")
        self.eta_i = self._const(1.0)
        self.xi_u_global = self._const(1.0)
        self._column_norms_given = column_norms is not None
        if column_norms is not None:
            self.eta_i = self._const(column_norms)
        self.count_key = count_key
        if encoder_function is not None:
            self.encoder_function = encoder_function
        if decoder_function is not None:
            self.decoder_function = decoder_function
        self.symmetry_breaking_decay = symmetry_breaking_decay
        self.log_transform = log_transform
        self.feature_dim = feature_dim
        self.latent_dim = self.feature_dim if latent_dim is None else latent_dim
        self.u_tau_scale = u_tau_scale
        self.s_tau_scale = s_tau_scale
        if fused_likelihood is None:
            # the fused decode + likelihood kernel on the card; the CPU
            # keeps the plain autograd path
            fused_likelihood = self.device.type == "cuda"
        self.fused_likelihood = fused_likelihood
        if gamma_sampler is None:
            gamma_sampler = ("fused" if self.device.type == "cuda"
                             and self.dtype == torch.float32 else "fast")
        self.gamma_sampler = gamma_sampler
        if likelihood_clip not in ("reference", "static"):
            raise ValueError(
                f"likelihood_clip must be 'reference' or 'static', got "
                f"{likelihood_clip!r}")
        self.likelihood_clip = likelihood_clip
        self.fusion_inactive_reason = None
        self._fusion_warned = False

        if data is not None:
            self.set_data(data)
        if initialize_distributions:
            self.create_distributions()
        print(f"Feature dim: {self.feature_dim} -> Latent dim {self.latent_dim}")

    def _const(self, value):
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    # ------------------------------------------------------------------ data
    def _counts(self, data):
        """The count matrix of a batch dict ('counts' or legacy 'data'), as
        a tensor of the model's dtype on its device."""
        if isinstance(data, dict):
            if "coo_vals" in data or "coo_rowl" in data:
                raise NotImplementedError(
                    "sparse (COO) batches are not ported to spmf_tpu_torch "
                    "yet")
            for k in (self.count_key, "counts", "data"):
                if k in data:
                    data = data[k]
                    break
            else:
                raise KeyError(f"No count key in batch: {list(data)}")
        return torch.as_tensor(data, dtype=self.dtype, device=self.device)

    def _next_batch(self):
        if self.data is None:
            raise ValueError("No data bound and none passed to the energy")
        it = getattr(self, "_dataset_cycler", None)
        if it is None:
            from itertools import cycle

            self._dataset_cycler = it = cycle(self.data())
        return next(it)

    def compute_scales(self, data_factory=None, compute_normalization=True,
                       n=None):
        """One full pass for column stats -> eta_i, xi_u_global (see the
        JAX docstring: xi_u_global is computed even when explicit column
        norms are given, unlike the reference)."""
        factory = as_data_factory(data_factory) or self.data
        need_eta = self.scale_columns and compute_normalization
        need_xi = self.scale_columns and self.scale_rows and bool(
            np.all(self.xi_u_global.cpu().numpy() == 1.0))
        if not (need_eta or need_xi):
            return
        print("Looping through the entire dataset once to get some stats")
        colsums = None
        col_nonzero = None
        for batch in factory():
            x = batch
            if isinstance(batch, dict):
                x = next(batch[k] for k in (self.count_key, "counts", "data")
                         if k in batch)
            x = np.asarray(x, np.float64)
            colsums = x.sum(0, keepdims=True) + (0 if colsums is None
                                                 else colsums)
            nz = (x > 0).sum(0, keepdims=True)
            col_nonzero = nz + (0 if col_nonzero is None else col_nonzero)
        with np.errstate(divide="ignore", invalid="ignore"):
            colmeans_nonzero = colsums / col_nonzero
        rowmean_nonzero = np.nansum(colmeans_nonzero)
        if need_eta:
            self.eta_i = self._const(
                np.where(colmeans_nonzero > 1, colmeans_nonzero, 1.0))
        self.xi_u_global = self._const(rowmean_nonzero if self.scale_rows
                                       else 1.0)

    def set_data(self, data, data_transform_fn=None, n=None,
                 compute_normalization=None):
        super().set_data(data, data_transform_fn)
        if compute_normalization is None:
            compute_normalization = not self._column_norms_given
        self.compute_scales(self.data,
                            compute_normalization=compute_normalization)

    # ----------------------------------------------------------- model parts
    def encoding_matrix(self, u=None, s=None):
        """A = w1 * u."""
        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        weights = s / torch.sum(s, dim=-2, keepdim=True)
        return weights[..., 0, :, None] * u  # (..., D, K)

    def decoding_matrix(self, v=None):
        """B = v."""
        return self.calibrated_expectations["v"] if v is None else v

    def intercept_matrix(self, w=None, s=None):
        """phi = eta_i * w2 * w, shape (..., 1, D)."""
        w = self.calibrated_expectations["w"] if w is None else w
        s = self.calibrated_expectations["s"] if s is None else s
        weights = s / torch.sum(s, dim=-2, keepdim=True)
        return self.eta_i * weights[..., 1:2, :] * w

    def encode(self, x, u=None, s=None):
        """theta = g(x) @ A, with optional row scaling."""
        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        z = torch.matmul(self.encoder_function(x), self.encoding_matrix(u, s))
        if self.scale_rows:
            z = z * (torch.sum(x, dim=-1, keepdim=True) / self.xi_u_global)
        return z

    def _observation_distribution(self, rate):
        return tfd.Poisson(rate=rate)

    def _theta_prior_log_prob(self, theta):
        """HalfNormal(1) prior on the encoded representation ('z')."""
        rv = tfd.Independent(tfd.HalfNormal(scale=torch.ones_like(theta)), 2)
        return rv.log_prob(theta)

    def log_likelihood_components(self, s, u, v, w, data, **kwargs):
        """Pointwise decoder log-likelihood and rate."""
        x = self._counts(data)
        theta_u = self.encode(x, u, s)                       # (..., B, K)
        phi = self.intercept_matrix(w, s)                    # (..., 1, D)
        theta_beta = torch.matmul(theta_u, self.decoding_matrix(v))
        rate = self.decoder_function(theta_beta) + phi
        rv = self._observation_distribution(rate)
        return {"log_likelihood": rv.log_prob(x), "rate": rate}

    # ------------------------------------------------------------ prior etc.
    def create_distributions(self):
        """Build the horseshoe+ prior joint and the trainable surrogate."""
        D, K = self.feature_dim, self.latent_dim
        dt, dev = self.dtype, self.device
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)  # noqa
        np_dt = np.float64 if dt == torch.float64 else np.float32
        np_ones = lambda *shape: np.ones(shape, np_dt)  # noqa: E731

        self.bijectors = {k: tfb.Softplus() for k in (
            "u", "u_eta", "u_tau", "s", "s_eta", "s_tau", "v", "w",
            "u_eta_a", "u_tau_a", "s_eta_a", "s_tau_a")}
        decay = self._const(
            np.asarray(self.symmetry_breaking_decay, np_dt)
            ** np.arange(K, dtype=np_dt)[None, :])

        self.prior_distribution = tfd.JointDistributionNamed(dict(
            v=tfd.Independent(tfd.HalfNormal(scale=0.1 * ones(K, D)), 2),
            w=tfd.Independent(tfd.HalfNormal(scale=ones(1, D)), 2),
            u=lambda u_eta, u_tau: tfd.Independent(
                tfd.HalfNormal(scale=u_eta * u_tau * decay), 2),
            u_eta=lambda u_eta_a: tfd.Independent(
                tfd.SqrtInverseGamma(0.5 * ones(D, K), 1.0 / u_eta_a), 2),
            u_eta_a=tfd.Independent(
                tfd.InverseGamma(0.5 * ones(D, K), ones(D, K)), 2),
            u_tau=lambda u_tau_a: tfd.Independent(
                tfd.SqrtInverseGamma(0.5 * ones(1, K), 1.0 / u_tau_a), 2),
            u_tau_a=tfd.Independent(tfd.InverseGamma(
                0.5 * ones(1, K), ones(1, K) / self.u_tau_scale**2), 2),
            s=lambda s_eta, s_tau: tfd.Independent(
                tfd.HalfNormal(scale=s_eta * s_tau), 2),
            s_eta=lambda s_eta_a: tfd.Independent(
                tfd.SqrtInverseGamma(0.5 * ones(2, D), 1.0 / s_eta_a), 2),
            s_eta_a=tfd.Independent(
                tfd.InverseGamma(0.5 * ones(2, D), ones(2, D)), 2),
            s_tau=lambda s_tau_a: tfd.Independent(
                tfd.SqrtInverseGamma(0.5 * ones(1, D), 1.0 / s_tau_a), 2),
            s_tau_a=tfd.Independent(tfd.InverseGamma(
                0.5 * ones(1, D), ones(1, D) / self.s_tau_scale**2), 2),
        ))

        def normal(loc, scale, name):
            return TransformedSurrogate(
                TrainableNormal(loc, scale, 2, dtype=dt, device=dev),
                self.bijectors[name])

        def inv_gamma(conc, scale, name):
            return TransformedSurrogate(
                TrainableInverseGamma(conc, scale, 2, dtype=dt, device=dev),
                self.bijectors[name])

        sur = dict(
            v=normal(-6.0 * np_ones(K, D), 5e-4 * np_ones(K, D), "v"),
            w=normal(-6.0 * np_ones(1, D), 5e-4 * np_ones(1, D), "w"),
            u=normal(-6.0 * np_ones(D, K), 5e-4 * np_ones(D, K), "u"),
            u_eta=inv_gamma(3.0 * np_ones(D, K), np_ones(D, K), "u_eta"),
            u_tau=inv_gamma(3.0 * np_ones(1, K), np_ones(1, K), "u_tau"),
            s_eta=inv_gamma(np_ones(2, D), np_ones(2, D), "s_eta"),
            s_tau=inv_gamma(np_ones(1, D), np_ones(1, D), "s_tau"),
            s=normal(np_ones(2, D) * np.asarray([[-2.0], [-1.0]], np_dt),
                     1e-3 * np_ones(2, D), "s"),
            u_eta_a=inv_gamma(2.0 * np_ones(D, K), np_ones(D, K), "u_eta_a"),
            u_tau_a=inv_gamma(2.0 * np_ones(1, K),
                              np_ones(1, K) / self.u_tau_scale**2, "u_tau_a"),
            s_eta_a=inv_gamma(2.0 * np_ones(2, D), np_ones(2, D), "s_eta_a"),
            s_tau_a=inv_gamma(2.0 * np_ones(1, D),
                              np_ones(1, D) / self.s_tau_scale**2, "s_tau_a"),
        )
        self._surrogate = SurrogatePosterior(sur,
                                             gamma_sampler=self.gamma_sampler)
        self.surrogate_params = self._surrogate.init()
        self.var_list = list(sur.keys())
        self.set_calibration_expectations()

    # ---------------------------------------------------------------- energy
    def unormalized_log_prob_parts(self, data, prior_weight=1.0, **params):
        """Energy parts: weighted prior parts, the HalfNormal(1) prior on
        theta ('z'), and the finite-masked, clipped Poisson log-likelihood
        summed over features and rows ('x')."""
        if data is None:
            data = self._next_batch()
        prior_parts = self.prior_distribution.log_prob_parts(params)
        prior_parts = {k: v * prior_weight for k, v in prior_parts.items()}

        x = self._counts(data)
        theta = self.encode(x, params["u"], params["s"])
        prior_parts["z"] = self._theta_prior_log_prob(theta)

        if self._can_fuse(x.shape):
            phi = self.intercept_matrix(params["w"], params["s"])
            B = self.decoding_matrix(params["v"])
            squeeze = theta.dim() == 2
            out = self._fused_x_part(
                theta[None] if squeeze else theta,
                B[None] if squeeze else B,
                phi[None] if squeeze else phi,
                x,
            ).to(self.dtype)
            prior_parts["x"] = out[0] if squeeze else out
            return prior_parts

        ll = self.log_likelihood_components(data=x, **params)["log_likelihood"]
        finite = torch.where(torch.isfinite(ll), ll, torch.zeros_like(ll))
        min_val = torch.min(finite) - 10.0
        if self.dtype == torch.float32:
            # keep sum(clip(ll, min_val, 0)) representable
            min_val = torch.clamp_min(min_val, -1e27)
        ll = torch.minimum(torch.maximum(ll, min_val), torch.zeros_like(ll))
        ll = torch.where(torch.isfinite(ll), ll, min_val)
        prior_parts["x"] = torch.sum(ll, dim=(-1, -2))
        return prior_parts

    def _fused_x_part(self, theta, B, phi, x):
        """Fused-kernel 'x' energy part, (S,) float32. theta (S,B,K),
        B (S,K,D), phi (S,1,D), x (B,D)."""
        from spmf_tpu_torch.ops.fused_poisson import fused_poisson_loglik

        return fused_poisson_loglik(theta, B, phi, x, self.eta_i,
                                    self.log_transform, self._fused_kind(),
                                    self.likelihood_clip)

    def _can_fuse(self, batch_shape=None, record=True):
        """Fused kernel only for the stock Poisson decode path. A rejection
        lands in ``fusion_inactive_reason`` and, when the user asked for
        fusion, fires one UserWarning."""
        ok, reason = self._fusion_check(batch_shape)
        if record:
            self.fusion_inactive_reason = reason
            self._fusion_last_ok = ok
            if not ok and self.fused_likelihood and not self._fusion_warned:
                import warnings

                self._fusion_warned = True
                warnings.warn(
                    f"fused likelihood disabled, falling back to the plain "
                    f"path: {reason}", UserWarning, stacklevel=3)
        return ok

    @property
    def fusion_active(self):
        """Fusion state as of the last ``_can_fuse`` evaluation."""
        last = getattr(self, "_fusion_last_ok", None)
        if last is None:
            return self._can_fuse(record=False)
        return last

    def _fusion_check(self, batch_shape=None):
        """(ok, reason) for the fused-kernel eligibility rules."""
        if not self.fused_likelihood:
            return False, "fused_likelihood=False (CPU default)"
        if self._fused_kind() is None:
            return False, "model family has no fused-kernel likelihood"
        mro = type(self).__mro__
        kind_depth = _def_depth(mro, "_fused_kind")
        if _def_depth(mro, "_observation_distribution") < kind_depth:
            return False, ("subclass overrides _observation_distribution "
                           "without re-owning _fused_kind")
        if _def_depth(mro, "log_likelihood_components") < kind_depth:
            return False, ("subclass overrides log_likelihood_components "
                           "without re-owning _fused_kind")
        if "decoder_function" in self.__dict__ or (
            type(self).decoder_function
            is not PoissonFactorization.decoder_function
        ):
            return False, "custom decoder_function overrides the decode link"
        return True, None

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        # the reference hard-codes prior_weight=1. when forwarding to the
        # parts function — reproduced for loss parity
        parts = self.unormalized_log_prob_parts(data, prior_weight=1.0,
                                                **params)
        out = 0.0
        for v in parts.values():
            out = out + v
        return out
