"""Bayesian dense networks with horseshoe weight priors (mirrors
spmf_tpu/nn/dense.py).

Per layer l, weights ``w_l ~ Horseshoe(weight_scale / sqrt(d_in))``
elementwise (the exact-E1 marginal, ``distributions.Horseshoe``) and biases
``b_l ~ Normal(0, 1)`` of shape (1, d_out), both under Identity bijectors.
Sampled parameters may carry leading sample dims: ``assemble_networks``
broadcasts them through ``torch.matmul``. On a rank mesh whose fp axis
splits a weight's output axis the network runs column-parallel
(``assemble_networks(mesh=)``), and ``prior_at`` gives the prior of such
slices.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from spmf_tpu_torch import bijectors as tfb
from spmf_tpu_torch import distributions as tfd
from spmf_tpu_torch.config import canonical_device, canonical_dtype

__all__ = ["DenseHorseshoe"]


class DenseHorseshoe:
    """An MLP ``input_size -> layer_sizes`` with a horseshoe prior on every
    weight. The prior's scale tensors are made once, on ``device`` (None
    means the card)."""

    def __init__(
        self,
        input_size: int,
        layer_sizes: List[int],
        activation=tfb.softplus,
        weight_scale: float = 1.0,
        dtype=None,
        *,
        device=None,
    ):
        self.input_size = int(input_size)
        self.layer_sizes = [int(s) for s in layer_sizes]
        self.activation = activation
        self.dtype = canonical_dtype(dtype)
        self.device = canonical_device(device)
        self.weight_scale = float(weight_scale)

        self.bijectors: Dict[str, tfb.Bijector] = {}
        for l in range(len(self.layer_sizes)):
            self.bijectors[f"w_{l}"] = tfb.Identity()
            self.bijectors[f"b_{l}"] = tfb.Identity()
        self.joint_prior = self.prior_at(self.layer_sizes)
        self.var_list = list(self.joint_prior.model.keys())
        self.num_layers = len(self.layer_sizes)

    def prior_at(self, widths):
        """The joint prior with weight l's output axis ``widths[l]`` wide
        (the biases whole): at the layer sizes the model's prior, at a
        rank's fp slices the prior of its slices, whose log-densities are
        their parts of the whole (the horseshoe is elementwise)."""
        dims = [self.input_size] + self.layer_sizes
        full = lambda shape, value: torch.full(  # noqa: E731
            shape, value, dtype=self.dtype, device=self.device)
        prior = {}
        for l, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            # 1/sqrt(fan_in) keeps the pre-activations O(1)
            scale = self.weight_scale / math.sqrt(d_in)
            prior[f"w_{l}"] = tfd.Independent(
                tfd.Horseshoe(scale=full((d_in, widths[l]), scale)), 2)
            prior[f"b_{l}"] = tfd.Independent(
                tfd.Normal(loc=full((1, d_out), 0.0),
                           scale=full((1, d_out), 1.0)), 2)
        return tfd.JointDistributionNamed(prior)

    def assemble_networks(self, params: Dict[str, torch.Tensor],
                          activation=None, *, mesh=None):
        """``net(x)`` applying the sampled layers, the activation after
        every layer but the last; sample dims broadcast (x: (B, D_in), w_l:
        (..., d_in, d_out) -> out (..., B, d_out)).

        With ``mesh`` (a ``parallel.Mesh`` with an fp axis) a weight may
        hold this rank's fp slice of its output axis. Such a layer computes
        its local output columns, with its bias's columns, and all but the
        last gather them to full width over fp (differentiable: the
        backward keeps this rank's block of the summed cotangent) before
        the next layer; a whole weight computes every column on each rank.
        ``x`` is full width; the output is the last layer's local columns
        where its weight is a slice."""
        act = activation or self.activation

        def net(x):
            h = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            for l in range(self.num_layers):
                w, b = params[f"w_{l}"], params[f"b_{l}"]
                local = w.shape[-1] != self.layer_sizes[l]
                if local:
                    c0, c1 = mesh.feature_slice(self.layer_sizes[l])
                    b = b[..., c0:c1]
                h = torch.matmul(h, w) + b
                if l < self.num_layers - 1:
                    h = act(h)
                    if local:
                        h = mesh.gather(h, h.dim() - 1, (mesh.fp_axis,),
                                        grad=True)
            return h

        return net

    def log_prob(self, params):
        return self.joint_prior.log_prob(params)

    def sample(self, generator, sample_shape=()):
        return self.joint_prior.sample(generator, sample_shape)
