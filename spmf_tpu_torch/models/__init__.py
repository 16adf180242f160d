from .base import BayesianModel
from .bernoulli import BernoulliFactorization
from .gaussian import GaussianFactorization
from .legacy import PoissonMatrixFactorization
from .mixed import MixedFactorization
from .poisson import PoissonFactorization

__all__ = ["BayesianModel", "PoissonFactorization", "BernoulliFactorization",
           "GaussianFactorization", "MixedFactorization",
           "PoissonMatrixFactorization"]
