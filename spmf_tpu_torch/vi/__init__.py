from .minibatch import FitResult, fit_surrogate_posterior
from .surrogates import (
    SurrogatePosterior,
    TrainableInverseGamma,
    TrainableNormal,
    TransformedSurrogate,
    build_trainable_InverseGamma_dist,
    build_trainable_normal_dist,
)

__all__ = [
    "SurrogatePosterior",
    "TrainableNormal",
    "TrainableInverseGamma",
    "TransformedSurrogate",
    "build_trainable_normal_dist",
    "build_trainable_InverseGamma_dist",
    "fit_surrogate_posterior",
    "FitResult",
]
