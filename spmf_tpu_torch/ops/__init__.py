"""Kernels of the port and their plain PyTorch twins. The CUDA sources live
in ``spmf_tpu_torch/csrc`` and are built on first use (``_build``), so
importing this package needs no CUDA. Exports the names of
``spmf_tpu.ops``."""
from .fused_poisson import (
    bernoulli_loglik_reference,
    fused_exp_rate_sum,
    fused_poisson_loglik,
    fused_poisson_loglik_sharded,
    fused_poisson_row_loglik,
    fused_poisson_row_loglik_sharded,
    normal_loglik_reference,
    poisson_loglik_reference,
)
from .sparse_encode import sparse_encode_coo

__all__ = [
    "bernoulli_loglik_reference",
    "fused_exp_rate_sum",
    "fused_poisson_loglik",
    "fused_poisson_loglik_sharded",
    "fused_poisson_row_loglik",
    "fused_poisson_row_loglik_sharded",
    "normal_loglik_reference",
    "poisson_loglik_reference",
    "sparse_encode_coo",
]
