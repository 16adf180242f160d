from .base import Distribution, Independent
from .continuous import (HalfNormal, InverseGamma, Normal, SqrtInverseGamma,
                         standard_gamma)
from .discrete import Bernoulli, Poisson
from .joint import JointDistributionNamed

__all__ = [
    "Distribution",
    "Independent",
    "Normal",
    "HalfNormal",
    "InverseGamma",
    "SqrtInverseGamma",
    "Poisson",
    "Bernoulli",
    "JointDistributionNamed",
    "standard_gamma",
]
