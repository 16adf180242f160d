"""spmf_tpu_torch — the PyTorch / CUDA port of spmf_tpu.

Sparse probabilistic matrix factorization trained by minibatch ADVI, with
the hot path in CUDA kernels written by hand for NVIDIA Hopper (sm_90a):
the fused decode + clipped Poisson log-likelihood and the fused
InverseGamma-surrogate sampler. Every kernel has a plain PyTorch twin,
which is what runs for CPU tensors. This package imports no JAX.
"""

__version__ = "0.1.0"

from spmf_tpu_torch import bijectors, distributions  # noqa: F401
from spmf_tpu_torch.models import BayesianModel, PoissonFactorization  # noqa: F401

__all__ = ["distributions", "bijectors", "BayesianModel",
           "PoissonFactorization", "__version__"]
