"""Factorize counts with planted nonlinear-manifold structure.

The port of examples/factorize_nonlinear_structure.py (the reference
notebook factorize_nonlinear_structure.ipynb): the planted data of
factorize_linear_structure with Z ~ |N(0.5, 1)| and the signal rate warped
(ZV exp(ZV / mean / 10) + (ZV / mean / 10)^2), batches of 10,000,
``calibrate_advi(num_steps=450, rel_tol=3e-5, learning_rate=0.05)``. The
model is the stock identity-link factorizer, as in the notebook ("nonlinear"
names the data). spmf_tpu on a TPU converged at 47.11 after 442 epochs
(examples/artifacts/factorize_nonlinear_structure.log; the README's table
records 49.036 at epoch 140). Writes the encoding and the loss trace as
.npy, and factorize_nonlinear_structure.png where matplotlib is installed.

    python -m spmf_tpu_torch.examples.factorize_nonlinear_structure [--device cpu]
"""
import numpy as np

from spmf_tpu_torch.examples import _common
from spmf_tpu_torch.examples.factorize_linear_structure import fit_planted

BATCH, STEPS, REL_TOL = 10_000, 450, 3e-5
NAME = "factorize_nonlinear_structure"


def counts(rows):
    """The JAX script's planted matrix at ``rows`` rows."""
    return _common.planted_counts(np.random.default_rng(0), rows, 0.5,
                                  nonlinear=True)


def main(argv=None):
    return fit_planted(argv, __doc__, counts, BATCH, STEPS, REL_TOL, NAME)


if __name__ == "__main__":
    main()
