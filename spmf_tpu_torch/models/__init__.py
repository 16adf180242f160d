from .base import BayesianModel
from .poisson import PoissonFactorization

__all__ = ["BayesianModel", "PoissonFactorization"]
