"""Parameter-tree conversion between numpy and the port.

The JAX package's ``surrogate_params`` pytree, fetched as numpy
(``jax.tree_util.tree_map(np.asarray, params)``), and the port's parameter
dict share their structure and leaf names, so a tree converts leaf for leaf
in both directions. The CPU tests use this to make both packages compute
the same thing.
"""
from __future__ import annotations

import numpy as np
import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), dtype=canonical_dtype(dtype),
                           device=canonical_device(device))


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
