from .minibatch import FitResult, fit_surrogate_posterior
from .surrogates import (
    SurrogatePosterior,
    TrainableInverseGamma,
    TrainableNormal,
    TransformedSurrogate,
    build_surrogate_posterior,
    build_trainable_InverseGamma_dist,
    build_trainable_normal_dist,
)
from .waic import waic

__all__ = [
    "SurrogatePosterior",
    "TrainableNormal",
    "TrainableInverseGamma",
    "TransformedSurrogate",
    "build_trainable_normal_dist",
    "build_trainable_InverseGamma_dist",
    "build_surrogate_posterior",
    "fit_surrogate_posterior",
    "FitResult",
    "waic",
]
