from .autoencoder import PoissonAutoencoder
from .base import BayesianModel, load_model
from .bernoulli import BernoulliFactorization
from .gaussian import GaussianFactorization
from .legacy import PoissonMatrixFactorization
from .mixed import MixedFactorization
from .poisson import PoissonFactorization

__all__ = ["BayesianModel", "load_model", "PoissonFactorization",
           "PoissonAutoencoder", "BernoulliFactorization",
           "GaussianFactorization", "MixedFactorization",
           "PoissonMatrixFactorization"]
