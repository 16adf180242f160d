from .base import Distribution, Independent
from .continuous import HalfNormal, InverseGamma, Normal, SqrtInverseGamma
from .discrete import Poisson
from .joint import JointDistributionNamed

__all__ = [
    "Distribution",
    "Independent",
    "Normal",
    "HalfNormal",
    "InverseGamma",
    "SqrtInverseGamma",
    "Poisson",
    "JointDistributionNamed",
]
