"""Sparse (horseshoe(+)) Poisson matrix factorization (mirrors
spmf_tpu/models/poisson.py).

    encoder   theta_i = g(x_i) @ A,  A = w1 * u   (w = s / colsum(s), w1 = w[0])
    decoder   rate    = f(theta @ v) + phi,  phi = eta_i * w2 * w
    x_ij ~ Poisson(rate_ij)

with a horseshoe+ prior on the encoding loadings u and the split weights s
(or, with ``horshoe_plus=False``, the exact-E1 AbsHorseshoe).
On a CUDA device the decode and clipped Poisson log-likelihood run as one
fused kernel (spmf_tpu_torch.ops.fused_poisson) and the horseshoe+
auxiliaries are sampled by the fused IG kernel (ops.fused_ig).

Sparse count batches (``data.SparseCounts.as_coo()`` and
``DeviceSparseCounts``, flat or block-aligned) either densify into a
transient (B, D) slab for the fused kernel, or train through the COO
energy, which never materialises (B, D): a gather-dot over the nonzeros
plus the rate total over all cells, in closed form for the identity link
and through the exp-rate kernel (K5) for the log link. WAIC and held-out
scoring stream per-row log-likelihoods through the row kernel (K4).

On a rank mesh (``mesh=``, ``parallel.Mesh``) each rank evaluates the
energy of its tile: its rows of a dense batch and, with an fp axis that
divides the feature dim, its columns and its slices of the fp-split
variables. Every sum that crosses ranks is one collective (the encode's
contraction and row sums over fp, the theta prior over the row ranks, the
likelihood over the ranks of distinct tiles, the priors of the fp-split
variables over fp), so each part the energy returns is the whole batch's,
on every rank. Where fp does not divide the feature dim, every variable
and column stays whole and the fp ranks of a line compute the same tile,
which their sums leave out of fp and so count once (as spmf_tpu replicates
what does not divide); likewise a batch whose rows stay whole on every row
rank (``Mesh.whole_rows``, the scan's remainder) is summed over no row
rank. A sparse (COO) batch is the
whole batch on every rank: the COO energies take this rank's share of the
triplets and sum the partial segment sums over the mesh, and the dense
scatter builds this rank's tile.
"""
from __future__ import annotations

import math

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

    def _fused_codes(self):
        """Per-column type-code lane for the ('mixed', s) kernel
        likelihood, or None for single-family models
        (MixedFactorization overrides)."""
        return None

    def _codes_lane(self):
        """``_fused_codes()`` as a float32 (1, D) tensor on the model's
        device, made once: a training step copies nothing from the host
        (which a CUDA graph of it could not)."""
        codes = self._fused_codes()
        if codes is None:
            return None
        if getattr(self, "_codes_on_device", None) is None:
            self._codes_on_device = torch.as_tensor(
                codes, dtype=torch.float32, device=self.device)
        return self._codes_on_device

    def encoder_function(self, x):
        """g(x)."""
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        eta = self._lane(self.eta_i, x.shape[-1])
        if self.log_transform:
            return torch.log(x / eta + 1.0)
        return x / eta

    def decoder_function(self, x):
        """f(x) = g^{-1}(x)."""
        eta = self._lane(self.eta_i, x.shape[-1])
        if self.log_transform:
            return torch.exp(x * eta) - 1.0
        return x * eta

    # ----------------------------------------------------------- the mesh
    def _meshed(self):
        return self.mesh is not None and not self.mesh.trivial

    def _fp_split(self):
        """Whether the mesh splits the feature dim: an fp axis that divides
        it (one that does not leaves every variable and column whole)."""
        return self._meshed() and self.mesh.splits(self.feature_dim)

    def _tile_axes(self):
        """The mesh axes whose ranks hold distinct tiles of a dense batch:
        the row axes of the batch, and fp where it splits the feature dim.
        A sum over the tile completes over these, so a tile that ranks
        share is counted once."""
        fp = (self.mesh.fp_axis,) if self._fp_split() else ()
        return tuple(self.mesh.row_axes) + fp

    def _lane(self, lane, width):
        """A (1, D) per-column lane (eta_i, the mixed codes, a mask) at the
        column width of a tensor: its local columns where ``width`` is this
        rank's share of D."""
        if (lane is None or lane.dim() == 0 or lane.shape[-1] == width
                or not self._fp_split()):
            return lane
        c0, c1 = self.mesh.feature_slice(lane.shape[-1])
        return lane[..., c0:c1]

    def _local_cols(self, x):
        """This rank's columns of a full-width (.., D) tensor."""
        if self._fp_split() and x.shape[-1] == self.feature_dim:
            c0, c1 = self.mesh.feature_slice(self.feature_dim)
            return x[..., c0:c1]
        return x

    def _feature_sum(self, t, width):
        """A sum over features ``t`` completed over the fp line when it
        covered this rank's columns only (differentiable)."""
        if self._fp_split() and width != self.feature_dim:
            return self.mesh.all_sum(t, (self.mesh.fp_axis,))
        return t

    def _full_cols(self, t, dim):
        """A tensor of this rank's columns along ``dim`` gathered to the
        full feature dim over fp (differentiable; as it is when full)."""
        if self._fp_split() and t.shape[dim] != self.feature_dim:
            return self.mesh.gather(t, dim % t.dim(), (self.mesh.fp_axis,),
                                    grad=True)
        return t

    def _local_samples(self, params):
        """The samples with every fp-split variable at this rank's
        columns."""
        if not self._fp_split():
            return params
        return self._surrogate._local_values(params)

    def _local_prior(self):
        """The prior joint at this rank's share of D (its factors are
        elementwise along D, so the local slice's log-density is its part
        of the whole): built once per mesh."""
        if getattr(self, "_mesh_prior", None) is None:
            full = self.feature_dim
            c0, c1 = self.mesh.feature_slice(full)
            self.feature_dim = c1 - c0
            try:
                self._mesh_prior = self._prior_joint()
            finally:
                self.feature_dim = full
        return self._mesh_prior

    def _prior_parts(self, params, prior_weight):
        """The weighted prior parts of the whole variables on every rank:
        on an fp mesh the split variables' parts from this rank's slices,
        summed over the fp line in one collective."""
        if not self._fp_split():
            parts = self.prior_distribution.log_prob_parts(params)
        else:
            parts = self._fp_summed(self._local_prior().log_prob_parts(
                params))
        return {k: v * prior_weight for k, v in parts.items()}

    def _row_total(self, t):
        """A sum over this rank's rows completed over the row ranks."""
        if self._meshed() and self.mesh.row_axes:
            return self.mesh.all_sum(t, self.mesh.row_axes)
        return t

    def _coo_share(self, rows, cols, vals):
        """This rank's contiguous share of a padded triplet batch (the
        triplets split over every axis of the mesh larger than 1)."""
        n = self.mesh.size
        nnz = rows.shape[-1]
        if nnz % n:
            raise ValueError(
                f"padded nnz {nnz} must divide the mesh device count {n} "
                "(SparseCounts.as_coo pads to 1024-multiples, which covers "
                "any mesh up to 1024 devices)")
        per = nnz // n
        lo = per * self.mesh.index_of(self.mesh.live_axes)
        return rows[lo:lo + per], cols[lo:lo + per], vals[lo:lo + per]

    def _row_mesh_axes(self):
        """The mesh axes the batch rows shard over: ('dp',), or the joint
        ('dcn', 'dp') on a multi-slice mesh (the mesh's, whatever the batch
        being trained does)."""
        return self.mesh.data_axes if self.mesh is not None else ()

    def _global_shape(self, shape):
        """The (B, D) of the whole batch whose tile has ``shape``."""
        if not self._meshed():
            return tuple(shape)
        return (int(shape[-2]) * self.mesh.rows, int(self.feature_dim))

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
        *,
        device=None,
        **kwargs,
    ):
        """Mirrors the JAX constructor (including the ``horshoe_plus``
        spelling), plus ``device`` (default: cuda; on a host without a card
        pass ``device='cpu'``). ``sparse_dense_scatter``: None/'auto'
        densifies COO batches for the fused kernel where that pays (see
        ``_sparse_dense_scatter``), True/False force it."""
        super().__init__(data=None, data_transform_fn=None,
                         strategy=strategy, mesh=mesh, dtype=dtype,
                         device=device)
        self.scale_rows = scale_rows
        self.scale_columns = scale_columns
        self.horseshoe_plus = (horshoe_plus if horseshoe_plus is None
                               else horseshoe_plus)
        #: share one horseshoe-auxiliary draw (the ``_eta`` / ``_tau``
        #: surrogates) across the S ELBO samples: unbiased, with S-fold
        #: aux-gradient variance (spmf_tpu measured it costing ~1.5x more
        #: epochs); kept for API compatibility and small-batch regimes
        self.aux_broadcast = aux_broadcast
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
        self.sparse_dense_scatter = sparse_dense_scatter
        self.fusion_inactive_reason = None
        self._fusion_warned = False

        if data is not None:
            self.set_data(data)
        if initialize_distributions:
            self.create_distributions()
        print(f"Feature dim: {self.feature_dim} -> Latent dim {self.latent_dim}")

    # ------------------------------------------------------------------ data
    def _counts(self, data):
        """The count matrix of a batch dict ('counts' or legacy 'data'), as
        a tensor of the model's dtype on its device."""
        if isinstance(data, dict):
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
        src = getattr(factory, "source", None)
        if hasattr(src, "col_stats"):
            # sparse sources: one pass over the CSR nonzeros, no densifying
            colsums, col_nonzero = src.col_stats()
        else:
            colsums = None
            col_nonzero = None
            for batch in factory():
                x = batch
                if isinstance(batch, dict):
                    x = next(batch[k] for k in (self.count_key, "counts",
                                                "data") if k in batch)
                if isinstance(x, torch.Tensor):   # a device-resident batch
                    x = x.cpu().numpy()
                x = np.asarray(x, np.float64)
                colsums = x.sum(0, keepdims=True) + (0 if colsums is None
                                                     else colsums)
                nz = (x > 0).sum(0, keepdims=True)
                col_nonzero = nz + (0 if col_nonzero is None
                                    else col_nonzero)
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
        return self._lane(self.eta_i, w.shape[-1]) * weights[..., 1:2, :] * w

    def encode(self, x, u=None, s=None):
        """theta = g(x) @ A, with optional row scaling. On an fp mesh, with
        this rank's columns of x and slices of u, s: the contraction and
        the row sums are summed over the fp line."""
        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        x = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        width = x.shape[-1]
        z = self._feature_sum(torch.matmul(self.encoder_function(x),
                                           self.encoding_matrix(u, s)), width)
        if self.scale_rows:
            z = z * (self._feature_sum(torch.sum(x, dim=-1, keepdim=True),
                                       width) / self.xi_u_global)
        return z

    @torch.no_grad()
    def encode_batched(self, x, u=None, s=None, row_chunk=8192):
        """``encode`` of a host matrix streamed over ``row_chunk`` rows at a
        time, collected on the host: only one chunk of ``x`` is on the
        device at once. ``u`` / ``s`` are resolved once; each chunk goes
        through ``self.encode``, so a subclass's encode (Bernoulli's, with
        no row scaling) is honoured. Returns a numpy array."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[0] <= row_chunk:
            return self.encode(x, u, s).cpu().numpy()
        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        return np.concatenate([
            self.encode(x[lo:lo + row_chunk], u, s).cpu().numpy()
            for lo in range(0, x.shape[0], row_chunk)], axis=0)

    def encode_sparse(self, sparse_counts, u=None, s=None):
        """Encode a CSR ``SparseCounts`` without densifying
        (ops.sparse_encode; g(0) = 0 makes this exact)."""
        from spmf_tpu_torch.ops.sparse_encode import sparse_encode_coo

        u = self.calibrated_expectations["u"] if u is None else u
        s = self.calibrated_expectations["s"] if s is None else s
        sc = sparse_counts
        rows = np.repeat(np.arange(sc.num_rows), np.diff(sc.indptr))
        return sparse_encode_coo(
            rows, sc.indices, sc.data, sc.num_rows,
            self.encoding_matrix(u, s), self.eta_i, self.log_transform,
            xi_global=self.xi_u_global if self.scale_rows else None,
        )

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
    # --- model-family hooks (overridden by Bernoulli / Gaussian / Mixed) ---
    #: signed encoder loadings: a Normal prior and an Identity bijector on u
    #: instead of HalfNormal and Softplus
    _u_signed = False

    def _vw_bijectors(self):
        return {"v": tfb.Softplus(), "w": tfb.Softplus()}

    def _vw_priors(self, ones):
        """Priors of v and w; ``ones(*shape)`` gives a tensor of the
        model's dtype on its device."""
        D, K = self.feature_dim, self.latent_dim
        return {
            "v": tfd.Independent(tfd.HalfNormal(scale=0.1 * ones(K, D)), 2),
            "w": tfd.Independent(tfd.HalfNormal(scale=ones(1, D)), 2),
        }

    def _normal_surrogate(self, loc, scale, name):
        return TransformedSurrogate(
            TrainableNormal(loc, scale, 2, dtype=self.dtype,
                            device=self.device), self.bijectors[name])

    def _vw_surrogates(self, ones):
        """Surrogates of v and w; ``ones(*shape)`` gives a numpy array (the
        surrogates' initial values are built on the host)."""
        D, K = self.feature_dim, self.latent_dim
        return {
            "v": self._normal_surrogate(-6.0 * ones(K, D), 5e-4 * ones(K, D),
                                        "v"),
            "w": self._normal_surrogate(-6.0 * ones(1, D), 5e-4 * ones(1, D),
                                        "w"),
        }

    def _u_prior_plus(self, decay):
        if self._u_signed:
            return lambda u_eta, u_tau: tfd.Independent(
                tfd.Normal(loc=0.0 * u_eta, scale=u_eta * u_tau * decay), 2)
        return lambda u_eta, u_tau: tfd.Independent(
            tfd.HalfNormal(scale=u_eta * u_tau * decay), 2)

    def _prior_joint(self):
        """The prior joint at ``feature_dim``: horseshoe+ (InverseGamma
        auxiliaries) or, with ``horshoe_plus=False``, AbsHorseshoe priors on
        u and s."""
        D, K = self.feature_dim, self.latent_dim
        dt, dev = self.dtype, self.device
        ones = lambda *shape: torch.ones(shape, dtype=dt, device=dev)  # noqa
        np_dt = np.float64 if dt == torch.float64 else np.float32
        decay = self._const(
            np.asarray(self.symmetry_breaking_decay, np_dt)
            ** np.arange(K, dtype=np_dt)[None, :])

        dist = dict(self._vw_priors(ones))
        if self.horseshoe_plus:
            dist.update(
                u=self._u_prior_plus(decay),
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
            )
            self.bijectors.update({k: tfb.Softplus() for k in (
                "u_eta_a", "u_tau_a", "s_eta_a", "s_tau_a")})
        else:
            # AbsHorseshoe on u in every family, the signed ones included
            # (spmf_tpu runs this branch; its _u_prior_nonplus hook is
            # never called); the (1, D) s scale broadcasts over (2, D)
            dist.update(
                u=tfd.Independent(tfd.AbsHorseshoe(
                    scale=self.u_tau_scale * decay * ones(D, K)), 2),
                s=tfd.Independent(tfd.AbsHorseshoe(
                    scale=self.s_tau_scale * ones(1, D)), 2),
            )
        return tfd.JointDistributionNamed(dist)

    def create_distributions(self):
        """Build the prior joint and the trainable surrogate: the horseshoe+
        (InverseGamma auxiliaries) or, with ``horshoe_plus=False``,
        AbsHorseshoe priors on u and s and a Normal-only surrogate."""
        D, K = self.feature_dim, self.latent_dim
        dt, dev = self.dtype, self.device
        np_dt = np.float64 if dt == torch.float64 else np.float32
        np_ones = lambda *shape: np.ones(shape, np_dt)  # noqa: E731

        self.bijectors = {k: tfb.Softplus() for k in (
            "u", "u_eta", "u_tau", "s", "s_eta", "s_tau")}
        if self._u_signed:
            self.bijectors["u"] = tfb.Identity()
        self.bijectors.update(self._vw_bijectors())
        self.prior_distribution = self._prior_joint()
        self._mesh_prior = None

        def inv_gamma(conc, scale, name):
            return TransformedSurrogate(
                TrainableInverseGamma(conc, scale, 2, dtype=dt, device=dev),
                self.bijectors[name])

        s_sur = self._normal_surrogate(
            np_ones(2, D) * np.asarray([[-2.0], [-1.0]], np_dt),
            1e-3 * np_ones(2, D), "s")
        # v and w go through the hook so that a family controls their
        # initial values (GaussianFactorization: v loc -5, w loc +0.5)
        sur = dict(self._vw_surrogates(np_ones))
        if self.horseshoe_plus:
            sur.update(
                u=self._normal_surrogate(-6.0 * np_ones(D, K),
                                         5e-4 * np_ones(D, K), "u"),
                u_eta=inv_gamma(3.0 * np_ones(D, K), np_ones(D, K), "u_eta"),
                u_tau=inv_gamma(3.0 * np_ones(1, K), np_ones(1, K), "u_tau"),
                s_eta=inv_gamma(np_ones(2, D), np_ones(2, D), "s_eta"),
                s_tau=inv_gamma(np_ones(1, D), np_ones(1, D), "s_tau"),
                s=s_sur,
                u_eta_a=inv_gamma(2.0 * np_ones(D, K), np_ones(D, K),
                                  "u_eta_a"),
                u_tau_a=inv_gamma(2.0 * np_ones(1, K),
                                  np_ones(1, K) / self.u_tau_scale**2,
                                  "u_tau_a"),
                s_eta_a=inv_gamma(2.0 * np_ones(2, D), np_ones(2, D),
                                  "s_eta_a"),
                s_tau_a=inv_gamma(2.0 * np_ones(1, D),
                                  np_ones(1, D) / self.s_tau_scale**2,
                                  "s_tau_a"),
            )
        else:
            # s before u: the order of the Normal block K6 and the eps
            # draw flatten
            sur.update(s=s_sur, u=self._normal_surrogate(
                -9.0 * np_ones(D, K), 5e-4 * np_ones(D, K), "u"))
        aux_names = ()
        if self.aux_broadcast:
            aux_names = tuple(n for n in sur if "_eta" in n or "_tau" in n)
        from spmf_tpu_torch.parallel.mesh import _feature_axis_for

        self._surrogate = SurrogatePosterior(
            sur, gamma_sampler=self.gamma_sampler, broadcast_names=aux_names,
            mesh=self.mesh,
            feature_axes={n: _feature_axis_for(n) for n in sur})
        self.surrogate_params = self._surrogate.init()
        self.var_list = list(sur.keys())
        self.set_calibration_expectations()

    # ---------------------------------------------------------------- energy
    def unormalized_log_prob_parts(self, data, prior_weight=1.0, **params):
        """Energy parts: weighted prior parts, the HalfNormal(1) prior on
        theta ('z'), and the finite-masked, clipped Poisson log-likelihood
        summed over features and rows ('x'). COO batches take the dense
        scatter into the fused path or a COO energy (see below)."""
        if data is None:
            data = self._next_batch()
        params = self._local_samples(params)
        prior_parts = self._prior_parts(params, prior_weight)

        if isinstance(data, dict) and "coo_rowl" in data:
            # block-aligned batches (DeviceSparseCounts block_rows): the
            # blocked energy when this class's COO math is authoritative
            # and no mesh splits the batch; otherwise flatten to the
            # triplet format and dispatch below
            if self._coo_energy_supported() and not self._meshed():
                self._fusion_last_ok = False
                self.fusion_inactive_reason = (
                    "blocked COO energy dispatched (block-aligned batch)")
                return self._coo_log_prob_parts_blocked(
                    data, prior_parts, params)
            data = self._flatten_blocked_coo(data)

        if isinstance(data, dict) and "coo_vals" in data:
            # two energies, chosen per batch shape: scatter the triplets
            # into a transient dense (B, D) slab and take the fused path, or
            # the COO energy, which never materialises the slab (below the
            # density bound, or where the slab is too large)
            if self._sparse_dense_scatter(data["indices"].shape[0],
                                          data["coo_rows"].shape[-1]):
                data = self._densify_coo(data, enforce_slab_limit=False)
            elif self._coo_energy_supported():
                # the intended sparse path: record the dispatch without the
                # fallback warning, which would be false here
                self._fusion_last_ok = False
                self.fusion_inactive_reason = (
                    "sparse COO gather energy dispatched (dense-scatter "
                    "not engaged for this batch shape/slab)"
                )
                return self._coo_log_prob_parts(data, prior_parts, params)
            else:
                # a subclass swapped the observation model, so the COO
                # energy would train the wrong likelihood: densify (slab
                # checked) and take the generic dense path
                data = self._densify_coo(data)

        x = self._local_cols(self._counts(data))
        theta = self.encode(x, params["u"], params["s"])
        prior_parts["z"] = self._row_total(self._theta_prior_log_prob(theta))

        if self._can_fuse(self._global_shape(x.shape)):
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
        min_val = torch.min(finite)
        if self._meshed():
            min_val = self.mesh.all_min(min_val, self._tile_axes())
        min_val = min_val - 10.0
        if self.dtype == torch.float32:
            # keep sum(clip(ll, min_val, 0)) representable
            min_val = torch.clamp_min(min_val, -1e27)
        ll = torch.minimum(torch.maximum(ll, min_val), torch.zeros_like(ll))
        ll = torch.where(torch.isfinite(ll), ll, min_val)
        prior_parts["x"] = torch.sum(ll, dim=(-1, -2))
        if self._meshed():
            prior_parts["x"] = self.mesh.all_sum(prior_parts["x"],
                                                 self._tile_axes())
        return prior_parts

    def _fused_x_part(self, theta, B, phi, x):
        """Fused-kernel 'x' energy part, (S,) float32. theta (S,B,K),
        B (S,K,D), phi (S,1,D), x (B,D). The mixed family rides the same
        kernels through its per-column ``codes`` lane (_fused_codes)."""
        from spmf_tpu_torch.ops.fused_poisson import (
            fused_poisson_loglik,
            fused_poisson_loglik_sharded,
        )

        if not self._meshed():
            return fused_poisson_loglik(theta, B, phi, x, self.eta_i,
                                        self.log_transform,
                                        likelihood=self._fused_kind(),
                                        codes=self._codes_lane(),
                                        clip=self.likelihood_clip)
        width = x.shape[-1]
        return fused_poisson_loglik_sharded(
            theta, B, phi, x, self._lane(self.eta_i, width), self.mesh,
            self.log_transform, data_axis=self.mesh.row_axes,
            likelihood=self._fused_kind(),
            codes=self._lane(self._codes_lane(), width),
            clip=self.likelihood_clip)

    # ------------------------------------------------------ sparse energies
    def _coo_arrays(self, data):
        """(rows, cols, vals, B) of a triplet batch, on the model's device;
        vals in the model's dtype."""
        dev = self.device
        return (torch.as_tensor(data["coo_rows"], device=dev),
                torch.as_tensor(data["coo_cols"], device=dev),
                torch.as_tensor(data["coo_vals"], device=dev).to(self.dtype),
                data["indices"].shape[0])

    def _coo_encode_nz(self, rows, cols, vals, B, A, v, phi, eta,
                       per_row=False, mesh=None):
        """Shared COO math: theta encoded from the triplets, and the
        nonzero likelihood term sum_nz [x log(rate) - lgamma(x+1)] (zero
        padding is an exact no-op: x = 0 and the rate floored positive).
        With ``per_row`` the nonzero term keeps the row axis, lead + (B,),
        for the row scorer; otherwise it is summed over rows, lead. Sample
        dims are flattened into the gathered width: (B, L*K) and (D, L*K)
        tables. With ``mesh`` the triplets are this rank's share and the
        segment sums, row sums and nonzero sums are summed over the mesh
        (the row scaling after the sum, so each row's full triplet set
        counts whatever rank holds it)."""
        from spmf_tpu_torch.ops.sparse_encode import sparse_encode_coo

        theta = sparse_encode_coo(rows, cols, vals, B, A, self.eta_i,
                                  self.log_transform, xi_global=None)
        if mesh is not None:
            theta = mesh.all_sum(theta)
        if self.scale_rows:
            rowsums = torch.zeros(B, dtype=vals.dtype,
                                  device=vals.device).index_add(0, rows, vals)
            if mesh is not None:
                rowsums = mesh.all_sum_(rowsums)
            theta = theta * (rowsums / self.xi_u_global)[:, None]
        K = theta.shape[-1]
        lead = theta.shape[:-2]
        v = v.broadcast_to(lead + v.shape[-2:])              # lead + (K, D)
        phi = phi.broadcast_to(lead + phi.shape[-2:])        # lead + (1, D)
        L = math.prod(lead)
        D = v.shape[-1]
        th_flat = theta.reshape(L, B, K).movedim(0, 1).reshape(B, L * K)
        v_flat = v.reshape(L, K, D).permute(2, 0, 1).reshape(D, L * K)
        phi_flat = phi.reshape(L, D).T                       # (D, L)
        tv = (th_flat.index_select(0, rows) * v_flat.index_select(0, cols)
              ).reshape(-1, L, K).sum(-1)                    # (nnz, L)
        eta_c = eta[cols][:, None]
        phi_c = phi_flat.index_select(0, cols)
        if self.log_transform:
            rate_nz = torch.exp(tv * eta_c) - 1.0 + phi_c
        else:
            rate_nz = tv * eta_c + phi_c
        rate_nz = torch.clamp_min(rate_nz, torch.finfo(self.dtype).tiny)
        x_log_rate = vals[:, None] * torch.log(rate_nz)      # (nnz, L)
        lgx = torch.lgamma(vals + 1.0)
        if per_row:
            zeros = torch.zeros((B, L), dtype=vals.dtype, device=vals.device)
            nz_row = zeros.index_add(0, rows, x_log_rate) - zeros[:, 0] \
                .index_add(0, rows, lgx)[:, None]
            nz_term = nz_row.movedim(0, -1).reshape(lead + (B,))
        else:
            nz_term = (x_log_rate.sum(0) - lgx.sum()).reshape(lead)
        if mesh is not None:
            nz_term = mesh.all_sum(nz_term)
        return theta, nz_term

    def _coo_log_prob_parts(self, data, prior_parts, params):
        """Sparse (COO) energy: trains on padded triplet batches without
        materialising the dense (B, D) slab. The nonzero term is a
        gather-dot over the triplets; the rate total over all B x D cells
        collapses to sum_b(theta) . sum_d(v * eta) for the identity link
        and is the fused exp-rate sum (K5) for the log link. The exact
        Poisson log-likelihood is finite by construction here, so the
        reference's data-dependent clip is a no-op and is not applied (as in
        the JAX package)."""
        rows, cols, vals, B, A, v, phi, mesh = self._coo_operands(data,
                                                                  params)
        D = v.shape[-1]
        eta = self.eta_i.broadcast_to((1, D))[0]
        theta, nz_term = self._coo_encode_nz(rows, cols, vals, B, A, v, phi,
                                             eta, mesh=mesh)
        prior_parts["z"] = self._theta_prior_log_prob(theta)
        if self.log_transform:
            # rate = exp(tv*eta) - 1 + phi
            total_rate = self._exp_rate_total(theta, v) \
                - B * D + B * torch.sum(phi, dim=(-1, -2))
        else:
            # sum_ij (theta@v)*eta = sum_k [sum_b theta_bk][sum_d v_kd eta_d]
            v_eta = torch.sum(v * eta, dim=-1)               # (..., K)
            total_rate = torch.einsum(
                "...k,...k->...", torch.sum(theta, dim=-2), v_eta
            ) + B * torch.sum(phi, dim=(-1, -2))
        prior_parts["x"] = nz_term - total_rate
        return prior_parts

    def _coo_operands(self, data, params):
        """(rows, cols, vals, B, A, v, phi, mesh) of a triplet batch: on a
        mesh this rank's share of the triplets and the full-width A, v and
        phi (gathered over fp where the samples are slices), with the mesh
        the sums run over; else the batch and None."""
        rows, cols, vals, B = self._coo_arrays(data)
        A = self.encoding_matrix(params["u"], params["s"])   # (..., D, K)
        v = self.decoding_matrix(params["v"])                # (..., K, D)
        phi = self.intercept_matrix(params["w"], params["s"])  # (..., 1, D)
        if not self._meshed():
            return rows, cols, vals, B, A, v, phi, None
        rows, cols, vals = self._coo_share(rows, cols, vals)
        return (rows, cols, vals, B, self._full_cols(A, -2),
                self._full_cols(v, -1), self._full_cols(phi, -1), self.mesh)

    def _coo_log_prob_parts_blocked(self, data, prior_parts, params):
        """Blocked COO energy: the block-aligned layout (``coo_rowl`` /
        ``coo_cols`` / ``coo_vals`` of shape (Rb, NBLK), batch-local row
        j*R + rowl, pads exact no-ops) through the same math as
        ``_coo_log_prob_parts``. The JAX package contracts each 128-row
        block with one-hot matrices, a trick for the TPU's matrix unit; on
        the card, theta and the per-nnz theta rows are a scatter-add
        (``index_add``) and a gather over the rows j*R + rowl, which is the
        flat energy on the flattened batch."""
        return self._coo_log_prob_parts(self._flatten_blocked_coo(data),
                                        prior_parts, params)

    @staticmethod
    def _flatten_blocked_coo(data):
        """A block-aligned batch as the flat triplet batch (batch-local
        rows j*R + rowl; pads stay exact no-ops)."""
        rowl = torch.as_tensor(data["coo_rowl"])
        Rb = rowl.shape[0]
        R = data["indices"].shape[0] // Rb
        rows = (torch.arange(Rb, dtype=rowl.dtype, device=rowl.device)[:, None]
                * R + rowl).reshape(-1)
        out = {k: v for k, v in data.items() if k != "coo_rowl"}
        out["coo_rows"] = rows
        out["coo_cols"] = torch.as_tensor(data["coo_cols"]).reshape(-1)
        out["coo_vals"] = torch.as_tensor(data["coo_vals"]).reshape(-1)
        return out

    def _exp_rate_total(self, theta, v):
        """sum_ij exp((theta @ v) * eta) per sample, for the COO energies'
        log link: the fused exp-rate sum (K5 on the card, its twin on the
        CPU) in float32, never materialising (S, B, D); the direct sum in
        float64, as in the JAX package."""
        from spmf_tpu_torch.ops.fused_poisson import fused_exp_rate_sum

        if self.dtype == torch.float32:
            squeeze = theta.dim() == 2
            out = fused_exp_rate_sum(theta[None] if squeeze else theta,
                                     v[None] if squeeze else v, self.eta_i)
            return (out[0] if squeeze else out).to(self.dtype)
        return torch.sum(torch.exp(torch.matmul(theta, v) * self.eta_i),
                         dim=(-1, -2))

    #: auto-mode ceiling for the transient dense (B, D) slab, in bytes:
    #: beyond it, auto keeps the COO energy. The JAX package's value, set
    #: for a TPU v5e's 16 GB; kept so the dispatch matches it (retuning for
    #: the H100 is on the ROADMAP)
    _DENSE_SCATTER_MAX_SLAB_BYTES = 4 << 30

    #: auto-mode density bound for the COO energy: below it (padded nnz /
    #: (B*D), an upper bound on batch density) the COO energy is taken
    #: over the dense slab. The JAX package's crossover, measured on a TPU
    #: v5e (0.17%, kept with a margin at 0.15%); not measured on the H100
    _COO_ENERGY_MAX_DENSITY = 0.0015

    def _sparse_dense_scatter(self, batch_rows=None, pad_nnz=None):
        """Whether COO batches take the dense scatter into the fused path.
        None/'auto': yes when the fused kernel is active for the densified
        (B, D) shape, the slab stays under _DENSE_SCATTER_MAX_SLAB_BYTES
        and the batch is not so sparse that the COO energy is taken
        (_COO_ENERGY_MAX_DENSITY); True/False force it."""
        mode = self.sparse_dense_scatter
        if mode in (None, "auto"):
            shape = None
            if batch_rows is not None and self.feature_dim:
                slab = (int(batch_rows) * int(self.feature_dim)
                        * torch.finfo(self.dtype).bits // 8)
                if slab > self._DENSE_SCATTER_MAX_SLAB_BYTES:
                    return False
                shape = (int(batch_rows), int(self.feature_dim))
                if (pad_nnz is not None
                        and int(pad_nnz) < self._COO_ENERGY_MAX_DENSITY
                        * shape[0] * shape[1]
                        and self._coo_energy_supported()):
                    return False
            # record=False: a rejection routes to the COO energy (the
            # designed sparse path), not to the plain fallback, and the
            # caller records the dispatch itself
            return self._can_fuse(shape, record=False)
        return bool(mode)

    def _densify_coo(self, batch, enforce_slab_limit=True):
        """Scatter a COO batch's triplets into a transient dense (B, D) slab
        on the device (``ops.coo_scatter``: the kernel on the card, which
        skips zero slots, the twin on the CPU) and return a dense-count
        batch dict. Zero padding adds 0 into cell (0, 0): exact."""
        from spmf_tpu_torch.ops.coo_scatter import coo_scatter

        B = batch["indices"].shape[0]
        D = int(self.feature_dim)
        if enforce_slab_limit:
            slab = B * D * torch.finfo(self.dtype).bits // 8
            if slab > self._DENSE_SCATTER_MAX_SLAB_BYTES:
                raise ValueError(
                    f"this path needs a transient dense ({B}, {D}) slab "
                    f"({slab / 2**30:.1f} GiB > "
                    f"{self._DENSE_SCATTER_MAX_SLAB_BYTES / 2**30:.0f} GiB "
                    "ceiling) — use a smaller batch size (or raise "
                    "_DENSE_SCATTER_MAX_SLAB_BYTES)"
                )
        rows, cols, vals, _ = self._coo_arrays(batch)
        if self._meshed():
            # this rank's tile: triplets outside it add 0 into cell (0, 0)
            r0, r1 = self.mesh.local_rows(B)
            c0, c1 = self.mesh.feature_slice(D)
            keep = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
            rows = torch.where(keep, rows - r0, 0)
            cols = torch.where(keep, cols - c0, 0)
            vals = torch.where(keep, vals, 0.0)
            out = dict(batch, indices=batch["indices"][r0:r1])
            B, D = r1 - r0, c1 - c0
        else:
            out = dict(batch)
        out[self.count_key] = coo_scatter(rows, cols, vals, (B, D))
        return out

    def _coo_energy_supported(self):
        """Whether the COO energies compute this model's likelihood: their
        math is the stock Poisson observation model with the identity or
        log link baked in, so the class defining ``_coo_log_prob_parts``
        vouches only for observation machinery at or above it in the MRO
        (the rule of ``_fusion_check``), and encoder or decoder overrides
        invalidate it."""
        mro = type(self).__mro__
        coo_depth = _def_depth(mro, "_coo_log_prob_parts")
        for hook in ("_observation_distribution", "log_likelihood_components",
                     "_fused_x_part", "_fused_kind", "encode"):
            if _def_depth(mro, hook) < coo_depth:
                return False
        for fn in ("decoder_function", "encoder_function"):
            if fn in self.__dict__ or (
                getattr(type(self), fn)
                is not getattr(PoissonFactorization, fn)
            ):
                return False
        return True

    # ------------------------------------------------------------ scoring
    def _coo_row_log_likelihood(self, batch, samples):
        """Per-row Poisson log-likelihood over COO triplets without
        densifying (B, D). Identity link only: the per-row rate total
        collapses to theta_i . (v @ eta) + sum_j(phi_j), so each row's ll
        is [nonzero term] - [closed-form rate total] exactly."""
        rows, cols, vals, B, A, v, phi, mesh = self._coo_operands(batch,
                                                                  samples)
        eta = self.eta_i.broadcast_to((1, v.shape[-1]))[0]
        theta, nz_row = self._coo_encode_nz(rows, cols, vals, B, A, v, phi,
                                            eta, per_row=True, mesh=mesh)
        v_eta = torch.sum(v * eta, dim=-1)                   # (..., K)
        row_rate = torch.einsum("...bk,...k->...b", theta, v_eta) \
            + torch.sum(phi, dim=(-1, -2))[..., None]
        return nz_row - row_rate                             # (..., B)

    def _row_log_likelihood(self, batch, samples):
        """Per-row log-likelihood, (S, B): the WAIC pointwise unit. COO
        batches take the COO row scorer where the training dispatch would
        not densify (identity link), else densify; dense batches stream the
        row kernel (K4) when fusion is active. Query only: the fusion
        record of the last training dispatch is left as it is. On a mesh
        the rows are this rank's (a dense batch's tile; a COO batch's share
        of its rows), each summed over every feature."""
        samples = self._local_samples(samples)
        if isinstance(batch, dict) and "coo_rowl" in batch:
            batch = self._flatten_blocked_coo(batch)
        if isinstance(batch, dict) and "coo_vals" in batch:
            if (not self._sparse_dense_scatter(
                    batch["indices"].shape[0],
                    batch["coo_rows"].shape[-1])
                    and not self.log_transform
                    and self._coo_energy_supported()):
                out = self._coo_row_log_likelihood(batch, samples)
                if self._meshed():
                    r0, r1 = self.mesh.local_rows(out.shape[-1])
                    out = out[..., r0:r1]
                return out
            batch = self._densify_coo(batch)
        x = self._local_cols(self._counts(batch))
        if self._can_fuse(self._global_shape(x.shape), record=False):
            from spmf_tpu_torch.ops.fused_poisson import (
                fused_poisson_row_loglik,
                fused_poisson_row_loglik_sharded,
            )

            theta = self.encode(x, samples["u"], samples["s"])
            phi = self.intercept_matrix(samples["w"], samples["s"])
            B = self.decoding_matrix(samples["v"])
            squeeze = theta.dim() == 2
            args = (theta[None] if squeeze else theta,
                    B[None] if squeeze else B,
                    phi[None] if squeeze else phi, x,
                    self._lane(self.eta_i, x.shape[-1]))
            kw = dict(log_transform=self.log_transform,
                      likelihood=self._fused_kind(),
                      codes=self._lane(self._codes_lane(), x.shape[-1]))
            if self._meshed():
                out = fused_poisson_row_loglik_sharded(
                    *args, self.mesh, data_axis=self.mesh.row_axes, **kw)
            else:
                out = fused_poisson_row_loglik(*args, **kw)
            out = out.to(self.dtype)
            return out[0] if squeeze else out
        ll = self.log_likelihood_components(data=x, **samples)[
            "log_likelihood"]
        return self._feature_sum(torch.sum(ll, dim=-1), x.shape[-1])

    def _can_fuse(self, batch_shape=None, record=True):
        """Fused kernel only for the stock decode path. A rejection
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
        if batch_shape is not None and self._meshed():
            for dim, ax in zip(batch_shape[-2:], (self._row_mesh_axes(),
                                                  ("fp",))):
                nsh = self.mesh.size_of([a for a in ax
                                         if a in self.mesh.axis_names])
                if dim % nsh:
                    return False, (
                        f"batch dim {dim} does not divide mesh axes "
                        f"{ax!r} (total {nsh} shards) — pad the "
                        "batch/feature dim to a multiple")
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

    def predictive_distribution(self, s, u, v, w, data, **kwargs):
        """``log_likelihood_components`` with the log-likelihood summed over
        the sample dims of ``u`` (the JAX package's repair of the
        reference, which reduced a key ``'ll'`` that is never set)."""
        prediction = self.log_likelihood_components(s=s, u=u, v=v, w=w,
                                                    data=data)
        reduce_dim = u.dim() - 2
        if reduce_dim > 0:
            prediction["log_likelihood"] = torch.sum(
                prediction["log_likelihood"], dim=tuple(range(reduce_dim)))
        return prediction

    def unormalized_log_prob_list(self, *x):
        """``unormalized_log_prob`` with the variables given positionally,
        in ``var_list`` order."""
        return self.unormalized_log_prob(**dict(zip(self.var_list, x)))

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        # the reference hard-codes prior_weight=1. when forwarding to the
        # parts function — reproduced for loss parity
        parts = self.unormalized_log_prob_parts(data, prior_weight=1.0,
                                                **params)
        out = 0.0
        for v in parts.values():
            out = out + v
        return out

    def _config(self):
        return {
            "latent_dim": self.latent_dim,
            "feature_dim": self.feature_dim,
            "u_tau_scale": float(self.u_tau_scale),
            "s_tau_scale": float(self.s_tau_scale),
            "symmetry_breaking_decay": float(self.symmetry_breaking_decay),
            "scale_columns": bool(self.scale_columns),
            "scale_rows": bool(self.scale_rows),
            "log_transform": bool(self.log_transform),
            "horseshoe_plus": bool(self.horseshoe_plus),
            "count_key": self.count_key,
            "likelihood_clip": self.likelihood_clip,
        }
