"""Legacy API shim (mirrors spmf_tpu/models/legacy.py).

The reference's packaged CLI and notebooks use the older class name and
constructor shape ``PoissonMatrixFactorization(data, latent_dim=...,
strategy=..., scale_rates=..., with_s=..., ...)``; this wrapper keeps those
call sites running against the current model.
"""
from __future__ import annotations

import numpy as np

from spmf_tpu_torch.models.poisson import PoissonFactorization

__all__ = ["PoissonMatrixFactorization"]


class PoissonMatrixFactorization(PoissonFactorization):
    """Data-first legacy constructor; kwarg renames:
    ``scale_rates`` -> ``scale_rows``, ``encoder``/``decoder`` ->
    ``encoder_function``/``decoder_function``; ``with_s`` accepted and
    ignored (the s-split is always on in the current model)."""

    def __init__(
        self,
        data=None,
        latent_dim=None,
        strategy=None,
        mesh=None,
        scale_columns=True,
        scale_rates=None,
        scale_rows=True,
        with_s=True,
        encoder=None,
        decoder=None,
        column_norms=None,
        u_tau_scale=0.01,
        s_tau_scale=1.0,
        log_transform=False,
        dtype=None,
        feature_dim=None,
        **kwargs,
    ):
        del with_s
        if scale_rates is not None:
            scale_rows = scale_rates
        if feature_dim is None and data is not None:
            from spmf_tpu_torch.data import as_data_factory

            if hasattr(data, "shape") and not hasattr(data, "__array__"):
                # a SparseCounts-style dataset: COO batches carry no dense
                # count array to probe, but the dataset knows its shape
                feature_dim = int(data.shape[-1])
            else:
                probe = next(iter(as_data_factory(data)()))
                for key in ("counts", "data"):
                    if key in probe:
                        feature_dim = int(np.asarray(probe[key]).shape[-1])
                        break
        super().__init__(
            latent_dim=latent_dim,
            feature_dim=feature_dim,
            u_tau_scale=u_tau_scale,
            s_tau_scale=s_tau_scale,
            strategy=strategy,
            mesh=mesh,
            encoder_function=encoder,
            decoder_function=decoder,
            scale_columns=scale_columns,
            scale_rows=scale_rows,
            log_transform=log_transform,
            column_norms=column_norms,
            dtype=dtype,
            data=data,
            **kwargs,
        )

    @property
    def column_norm_factor(self):
        """Legacy attribute (the rnaseq notebook): the column normalization."""
        return self.eta_i
