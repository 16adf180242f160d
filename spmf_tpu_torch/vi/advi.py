"""API-parity alias module (mirrors spmf_tpu/vi/advi.py)."""
from spmf_tpu_torch.vi.surrogates import (  # noqa: F401
    SurrogatePosterior,
    TrainableInverseGamma,
    TrainableNormal,
    TransformedSurrogate,
    build_surrogate_posterior,
    build_trainable_InverseGamma_dist,
    build_trainable_normal_dist,
)

__all__ = [
    "build_trainable_normal_dist",
    "build_trainable_InverseGamma_dist",
    "build_surrogate_posterior",
    "TrainableNormal",
    "TrainableInverseGamma",
    "TransformedSurrogate",
    "SurrogatePosterior",
]
