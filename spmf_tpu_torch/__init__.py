"""spmf_tpu_torch — the PyTorch / CUDA port of spmf_tpu.

Sparse probabilistic matrix factorization trained by minibatch ADVI (four
factorization families and the deep PoissonAutoencoder), with
the hot path in CUDA kernels written by hand for NVIDIA Hopper (sm_90a):
the fused decode + clipped log-likelihood (Poisson, Bernoulli, Normal and
mixed-type decoders) and the fused InverseGamma- and Normal-surrogate
samplers. Every kernel has a plain PyTorch twin,
which is what runs for CPU tensors. This package imports no JAX.
"""

__version__ = "0.1.0"

from spmf_tpu_torch import bijectors, distributions, nn  # noqa: F401
from spmf_tpu_torch.models import (  # noqa: F401
    BayesianModel,
    BernoulliFactorization,
    GaussianFactorization,
    MixedFactorization,
    PoissonAutoencoder,
    PoissonFactorization,
    PoissonMatrixFactorization,
    load_model,
)
from spmf_tpu_torch.nn import DenseHorseshoe  # noqa: F401

__all__ = ["distributions", "bijectors", "nn", "BayesianModel",
           "PoissonFactorization", "PoissonAutoencoder", "DenseHorseshoe",
           "BernoulliFactorization",
           "GaussianFactorization", "MixedFactorization",
           "PoissonMatrixFactorization", "load_model", "__version__"]
