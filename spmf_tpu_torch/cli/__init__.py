"""Command-line entry points of the port, one module each, run as
``python -m spmf_tpu_torch.cli.<name>``. Each keeps the flags, outputs and
file names of its ``bin/`` counterpart of spmf_tpu and adds ``--device``
(default ``cuda``; on a host without a card pass ``--device cpu``):

- ``factorize_csv``: PoissonMatrixFactorization on a headerless CSV count
  matrix (the native CSV parser, ``data/native.py``);
- ``preprocess_scrnaseq_counts``: a 10x MatrixMarket directory to the npy
  triplet (the native MatrixMarket parser);
- ``factorize_scrnaseq_counts``: the triplet factorized, with U / V / W / Z
  and the derived scores saved as .npy.

On the card the dense fits train over a device-resident dataset, so they
take the engine's captured scan path.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_numpy"]


def resolve_device(name: str) -> torch.device:
    """``--device`` as a torch.device; 'cuda' on a host without a card
    raises and names ``--device cpu`` (the port never moves to the CPU on
    its own)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found: spmf_tpu_torch runs on the card by "
            "default; pass --device cpu to run on the CPU")
    return device


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
