"""Factorize pure Poisson noise: the model should shrink the encoding to ~0.

The port of examples/factorizing_random_noise.py (the reference notebook
factorizing_random_noise.ipynb): N=50,000 x D=30 Poisson(1) counts, P=4,
batches of 1000, ``calibrate_advi(num_steps=200, rel_tol=1e-4,
learning_rate=0.05)``, then the WAIC and the largest |encoding| entry
(spmf_tpu on a TPU: converged 40.4938, max |A| 0.029,
examples/artifacts/README.md). Writes noise_encoding.npy and
noise_losses.npy, and noise_encoding.png where matplotlib is installed.

    python -m spmf_tpu_torch.examples.factorizing_random_noise [--device cpu]
"""
import numpy as np

from spmf_tpu_torch import PoissonMatrixFactorization
from spmf_tpu_torch.cli import to_numpy
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.examples import _common

D, P, BATCH = 30, 4, 1000


def counts(rows):
    """The JAX script's noise matrix at ``rows`` rows."""
    return np.random.default_rng(0).poisson(1.0, size=(rows, D))


def main(argv=None):
    args = _common.parser(__doc__, rows=50_000, steps=200).parse_args(argv)
    run = _common.Run(args.device)
    n = args.rows
    data = ArrayDataset.from_tensor_slices(
        {"counts": counts(n), "indices": np.arange(n)}).batch(BATCH)
    factor = PoissonMatrixFactorization(
        data, latent_dim=P, strategy=None, u_tau_scale=1.0 / np.sqrt(D * n),
        device=run.device)
    factor.calibrate_advi(num_steps=args.steps, rel_tol=1e-4,
                          learning_rate=0.05)
    losses = run.record(factor, len(data))

    waic = factor.waic()
    print(waic)
    A = to_numpy(factor.encoding_matrix())
    print("max |encoding| (should be ~0 for noise):", np.abs(A).max())

    def draw(plt):
        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(A.T, vmin=0, cmap="Blues")
        ax.set_xlabel("item")
        ax.set_ylabel("dimension")
        fig.colorbar(im, orientation="horizontal")

    arrays = _common.save_arrays(args.outdir, noise_encoding=A,
                                 noise_losses=losses)
    figure = _common.save_figure(args.outdir, "noise_encoding.png", draw)
    return run.summary(waic=float(waic["waic"]),
                       max_abs_encoding=float(np.abs(A).max()),
                       artifacts=arrays + [figure], losses=losses)


if __name__ == "__main__":
    main()
