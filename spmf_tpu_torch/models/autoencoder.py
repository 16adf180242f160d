"""Deep Bayesian Poisson autoencoder (mirrors
spmf_tpu/models/autoencoder.py): a DenseHorseshoe MLP
[D]*encoder_layers + [K] + [D]*decoder_layers + [D] with rates
``exp(net(x / colnorm)) * colnorm`` and a Poisson likelihood, trained by the
same ADVI engine over a mean-field Normal surrogate of every weight and
bias. On a rank mesh each rank's batch holds its rows (dp, dcn) and, where
fp divides the feature dim, its count columns. Each weight ``w_l`` holds
its fp slice of its output axis where fp divides that width (axis 1, as
``shard_params_feature_dim`` lays it out in both packages), and stays
whole otherwise; the biases stay whole. The forward runs column-parallel
(``DenseHorseshoe.assemble_networks(mesh=)``): a split layer computes its
local output columns and gathers them to full width before the next layer,
and the last layer's local columns give the rates of the rank's count
columns. The likelihood is summed over the row ranks and, where the
columns split, over fp; each split weight's horseshoe log-prob is summed
over fp. There is no kernel of its own: the network is ``torch.matmul``,
the weight prior the exact-E1 Horseshoe, and with
``surrogate.fused_normals`` (and ``gamma_sampler='fused'``) the Normal
block is drawn by the fused Normal sampler, whole on every rank of an fp
mesh and then sliced."""
from __future__ import annotations

import math

import numpy as np
import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.models.base import BayesianModel
from spmf_tpu_torch.nn.dense import DenseHorseshoe
from spmf_tpu_torch.parallel.mesh import _feature_axis_for
from spmf_tpu_torch.utils.checkpoint import to_numpy
from spmf_tpu_torch.utils.spans import span
from spmf_tpu_torch.vi.surrogates import build_surrogate_posterior

__all__ = ["PoissonAutoencoder"]


class PoissonAutoencoder(BayesianModel):
    """``data`` is required, as in spmf_tpu: the column norms (with
    ``scale_columns`` and no ``column_norms``, the first batch's column
    means) and the feature dimension come from it, so ``load_model`` of a
    saved autoencoder takes ``data=`` too. ``latent_dim=None`` means the
    feature dimension."""

    def __init__(
        self,
        data,
        data_transform_fn=None,
        latent_dim=None,
        scale_columns=True,
        column_norms=None,
        encoder_layers=1,
        decoder_layers=1,
        activation_function=tfb.softplus,
        strategy=None,
        mesh=None,
        count_key=None,
        dtype=None,
        *,
        device=None,
        **kwargs,
    ):
        super().__init__(data=data, data_transform_fn=data_transform_fn,
                         strategy=strategy, mesh=mesh, dtype=dtype,
                         device=device)
        record = next(iter(self.data()))
        if count_key is None:
            count_key = "data" if "data" in record else "counts"
        self.count_key = count_key
        x = np.asarray(to_numpy(record[self.count_key]), np.float64)

        norms = np.ones((1, x.shape[-1]))
        if scale_columns:
            if column_norms is not None:
                norms = np.asarray(to_numpy(column_norms),
                                   np.float64).reshape(1, -1)
            else:
                norms = x.mean(axis=0, keepdims=True)
        # a device tensor made once: the training step copies nothing from
        # the host (the scan path captures it in a CUDA graph)
        self.column_norm_factor = self._const(norms)

        self.feature_dim = x.shape[-1]
        self.latent_dim = (self.feature_dim if latent_dim is None
                           else latent_dim)

        self.neural_network_model = nn = DenseHorseshoe(
            self.feature_dim,
            [self.feature_dim] * encoder_layers
            + [self.latent_dim]
            + [self.feature_dim] * decoder_layers
            + [self.feature_dim],
            activation=activation_function,
            dtype=self.dtype,
            device=self.device,
        )
        self.joint_prior = nn.joint_prior
        # per weight layer the surrogate's scale tracks the prior's
        # 1/sqrt(fan_in), so each layer's sampled-weight noise adds O(0.1)
        # pre-activation std whatever its width; biases keep 1e-3
        dims = [nn.input_size] + nn.layer_sizes
        init_scale = {}
        for l, d_in in enumerate(dims[:-1]):
            init_scale[f"w_{l}"] = 0.1 * nn.weight_scale / math.sqrt(d_in)
            init_scale[f"b_{l}"] = 1e-3
        self._surrogate = build_surrogate_posterior(
            self.joint_prior, nn.bijectors, dtype=self.dtype,
            init_scale=init_scale)
        # the weights' output axes split over fp where it divides them
        self._surrogate.mesh = self.mesh
        self._surrogate.feature_axes = {
            n: _feature_axis_for(n) for n in self._surrogate.names}
        self._mesh_prior = None
        self.surrogate_params = self._surrogate.init()
        self.var_list = list(self._surrogate.names)
        self.set_calibration_expectations()

    def _counts(self, data):
        for k in (self.count_key, "data", "counts"):
            if k in data:
                return torch.as_tensor(data[k], dtype=self.dtype,
                                       device=self.device)
        raise KeyError(f"No count key in batch: {list(data)}")

    # ----------------------------------------------------------- the mesh
    def _fp_mesh(self):
        return (self.mesh is not None and not self.mesh.trivial
                and self.mesh.fp_axis is not None)

    def _fp_cols(self):
        """Whether the mesh splits the count columns (fp divides D)."""
        return self._fp_mesh() and self.mesh.splits(self.feature_dim)

    def _local_samples(self, params):
        """The samples with every fp-split weight at this rank's
        columns."""
        if not self._fp_mesh():
            return params
        return self._surrogate._local_values(params)

    def _local_prior(self):
        """The joint prior at this rank's slices of the split weights:
        built once per mesh."""
        if self._mesh_prior is None:
            nn = self.neural_network_model
            widths = []
            for d in nn.layer_sizes:
                c0, c1 = self.mesh.feature_slice(d)
                widths.append(c1 - c0)
            self._mesh_prior = nn.prior_at(widths)
        return self._mesh_prior

    def _prior_parts(self, params):
        """The prior parts of the whole variables on every rank: on an fp
        mesh the split weights' parts from this rank's slices, summed over
        the fp line."""
        if not self._fp_mesh():
            return self.joint_prior.log_prob_parts(params)
        return self._fp_summed(self._local_prior().log_prob_parts(params))

    # ---------------------------------------------------------- the model
    def _tile_counts(self, data):
        """The batch's counts at this rank's columns where fp splits them
        (a batch given whole is cut to them)."""
        x = self._counts(data)
        if self._fp_cols() and x.shape[-1] == self.feature_dim:
            c0, c1 = self.mesh.feature_slice(self.feature_dim)
            x = x[..., c0:c1]
        return x

    def _rates(self, x, params):
        """The rates of the count columns ``x`` holds (this rank's, where
        fp splits them) from samples whose split weights hold this rank's
        columns. The network's input is the whole row: a rank's columns
        are gathered over fp first."""
        norms = self.column_norm_factor
        if x.shape[-1] != self.feature_dim:
            c0, c1 = self.mesh.feature_slice(self.feature_dim)
            norms = norms[..., c0:c1]
            h = self.mesh.gather(x / norms, x.dim() - 1,
                                 (self.mesh.fp_axis,))
        else:
            h = x / norms
        net = self.neural_network_model.assemble_networks(params,
                                                          mesh=self.mesh)
        return torch.exp(net(h)) * norms

    def _tile_axes(self):
        """The mesh axes whose ranks hold distinct tiles of the batch: the
        row axes, and fp where it splits the count columns."""
        if self.mesh is None or self.mesh.trivial:
            return ()
        fp = (self.mesh.fp_axis,) if self._fp_cols() else ()
        return tuple(self.mesh.row_axes) + fp

    def log_likelihood_components(self, data, **params):
        """The pointwise log-likelihood and the rates of the batch's
        columns (this rank's tile on a mesh)."""
        with span("ae network"):
            x = self._tile_counts(data)
            rates = self._rates(x, self._local_samples(params))
            return {"log_likelihood": tfd.Poisson(rate=rates).log_prob(x),
                    "rates": rates}

    def predictive_distribution(self, data, **params):
        """The rates and the log-likelihood summed over rows and
        features."""
        comp = self.log_likelihood_components(data, **params)
        ll = torch.sum(comp["log_likelihood"], dim=(-1, -2))
        return {"log_likelihood": ll, "rates": comp["rates"]}

    def unormalized_log_prob_parts(self, data=None, prior_weight=1.0,
                                   **params):
        """The weighted prior parts and the likelihood 'x', each the whole
        batch's on every rank of a mesh (its tile's sum completed over the
        ranks of distinct tiles)."""
        params = self._local_samples(params)
        with span("ae prior"):
            prior_parts = self._prior_parts(params)
        prior_parts = {k: v * prior_weight for k, v in prior_parts.items()}
        ll = self.log_likelihood_components(data, **params)["log_likelihood"]
        prior_parts["x"] = torch.sum(ll, dim=(-1, -2))
        axes = self._tile_axes()
        if axes:
            prior_parts["x"] = self.mesh.all_sum(prior_parts["x"], axes)
        return prior_parts

    def unormalized_log_prob(self, data=None, prior_weight=1.0, **params):
        parts = self.unormalized_log_prob_parts(
            data, prior_weight=prior_weight, **params)
        out = 0.0
        for v in parts.values():
            out = out + v
        return out

    def _row_log_likelihood(self, batch, samples):
        """Per-row log-likelihood of this rank's rows, summed over every
        column (over the fp line where it splits them)."""
        ll = self.log_likelihood_components(batch, **samples)["log_likelihood"]
        out = torch.sum(ll, dim=-1)
        if self._fp_cols():
            out = self.mesh.all_sum(out, (self.mesh.fp_axis,))
        return out

    def encode(self, x, params=None):
        """Deterministic encoder pass of the calibrated network (or
        ``params``) up to the latent layer, which is the first layer whose
        width is ``latent_dim``: with ``latent_dim == feature_dim`` (the
        default) that is encoder layer 0, as in spmf_tpu."""
        params = params or self.calibrated_expectations
        h = (torch.as_tensor(x, dtype=self.dtype, device=self.device)
             / self.column_norm_factor)
        nn = self.neural_network_model
        latent = nn.layer_sizes.index(self.latent_dim)
        for l in range(latent + 1):
            h = torch.matmul(h, params[f"w_{l}"]) + params[f"b_{l}"]
            if l < latent:
                h = nn.activation(h)
        return h

    def _config(self):
        return {
            "latent_dim": self.latent_dim,
            "feature_dim": self.feature_dim,
            "count_key": self.count_key,
        }
