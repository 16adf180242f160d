"""Factorize counts with planted linear factor structure: the encoding
should recover the planted support (every third column carries signal).

The port of examples/factorize_linear_structure.py (the reference notebook
factorize_linear_structure.ipynb): N=50,000 rows, 10 signal columns (every
third) among 20 of Poisson(1) noise, P=3, batches of 1000,
``calibrate_advi(num_steps=200, rel_tol=1e-4, learning_rate=0.05)``, then
the WAIC and the signal and noise columns' mass of the encoding (spmf_tpu
on a TPU: converged 47.120, mass 0.151 against 0.0037, 41x;
examples/artifacts/README.md). Writes factorize_linear_structure_encoding.npy
and _losses.npy, and factorize_linear_structure.png where matplotlib is
installed.

    python -m spmf_tpu_torch.examples.factorize_linear_structure [--device cpu]
"""
import numpy as np

from spmf_tpu_torch import PoissonMatrixFactorization
from spmf_tpu_torch.cli import to_numpy
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.examples import _common

BATCH, STEPS, REL_TOL = 1000, 200, 1e-4
NAME = "factorize_linear_structure"


def counts(rows):
    """The JAX script's planted matrix at ``rows`` rows."""
    return _common.planted_counts(np.random.default_rng(0), rows, 0.0,
                                  nonlinear=False)


def fit_planted(argv, doc, counts_fn, batch, steps, rel_tol, name):
    """The planted-structure examples: fit, WAIC, column mass, figure."""
    args = _common.parser(doc, rows=50_000, steps=steps).parse_args(argv)
    run = _common.Run(args.device)
    n = args.rows
    X = counts_fn(n)
    D = X.shape[1]
    data = ArrayDataset({"counts": X, "indices": np.arange(n)}).batch(batch)
    factor = PoissonMatrixFactorization(
        data, latent_dim=_common.P_PLANTED, strategy=None,
        u_tau_scale=1.0 / np.sqrt(D * n), device=run.device)
    factor.calibrate_advi(num_steps=args.steps, rel_tol=rel_tol,
                          learning_rate=0.05)
    losses = run.record(factor, len(data))
    waic = factor.waic()
    print(waic)

    A = to_numpy(factor.encoding_matrix())
    signal, noise = _common.column_mass(A)
    print("signal col mass:", signal, "noise col mass:", noise)

    def draw(plt):
        fig, ax = plt.subplots(1, 2, figsize=(12, 4))
        im = ax[0].imshow(A.T, vmin=0, cmap="Blues", aspect="auto")
        ax[0].set_xlabel("item")
        ax[0].set_ylabel("dimension")
        fig.colorbar(im, ax=ax[0], orientation="horizontal")
        ax[1].plot(losses)
        ax[1].set_xlabel("epoch")
        ax[1].set_ylabel("avg-batch loss")

    arrays = _common.save_arrays(args.outdir, **{name + "_encoding": A,
                                                 name + "_losses": losses})
    figure = _common.save_figure(args.outdir, name + ".png", draw)
    return run.summary(waic=float(waic["waic"]), signal_mass=signal,
                       noise_mass=noise, artifacts=arrays + [figure],
                       losses=losses)


def main(argv=None):
    return fit_planted(argv, __doc__, counts, BATCH, STEPS, REL_TOL, NAME)


if __name__ == "__main__":
    main()
