from .base import Distribution, Independent
from .continuous import (AbsHorseshoe, Cauchy, Gamma, HalfCauchy, HalfNormal,
                         Horseshoe, InverseGamma, LogNormal, Normal,
                         SqrtInverseGamma, standard_gamma)
from .discrete import Bernoulli, Poisson
from .joint import JointDistributionNamed
from .special import exp1, log_exp1

__all__ = [
    "Distribution",
    "Independent",
    "Normal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "Gamma",
    "InverseGamma",
    "SqrtInverseGamma",
    "LogNormal",
    "Horseshoe",
    "AbsHorseshoe",
    "Poisson",
    "Bernoulli",
    "JointDistributionNamed",
    "exp1",
    "log_exp1",
    "standard_gamma",
]
