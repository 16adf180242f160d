"""Three-model comparison figure: noise against linear against nonlinear
structure.

The port of examples/simulation_figure.py (the reference notebook
simulation_figure.ipynb): one numpy stream draws the linear, nonlinear and
noise matrices (N=50,000 x 30), and each is fitted with
``scale_rates=True`` at P=3 and batches of 1000 for up to ``--steps``
epochs (the JAX script's ``SIM_STEPS``, default 100), then the three
encodings are saved as simulation_figure_<label>_encoding.npy and drawn
side by side into simulation_figure.png where matplotlib is installed.

    python -m spmf_tpu_torch.examples.simulation_figure [--device cpu]
"""
import numpy as np

from spmf_tpu_torch import PoissonMatrixFactorization
from spmf_tpu_torch.cli import to_numpy
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.examples import _common

BATCH = 1000


def matrices(rows):
    """The JAX script's (noise, linear, nonlinear) matrices at ``rows``
    rows, drawn in its order from one stream."""
    rng = np.random.default_rng(0)
    d = _common.D_FACTOR + _common.D_NOISE
    V = np.abs(rng.normal(1.5, 0.5, size=(_common.P_PLANTED,
                                          _common.D_FACTOR)))
    Z = np.abs(rng.normal(0, 1, size=(rows, _common.P_PLANTED)))
    ZV = Z.dot(V)
    X_lin = rng.poisson(1.0, size=(rows, d))
    X_lin[:, ::3] = rng.poisson(ZV)
    X_nonlin = rng.poisson(1.0, size=(rows, d))
    X_nonlin[:, ::3] = rng.poisson(_common.warp(ZV))
    X_noise = rng.poisson(1.0, size=(rows, d))
    return {"noise": X_noise, "linear": X_lin, "nonlinear": X_nonlin}


def main(argv=None):
    args = _common.parser(__doc__, rows=50_000, steps=100).parse_args(argv)
    run = _common.Run(args.device)
    n = args.rows
    results, losses = {}, {}
    for label, X in matrices(n).items():
        data = ArrayDataset({"data": X, "indices": np.arange(n),
                             "normalization": np.ones(n)}).batch(BATCH)
        factor = PoissonMatrixFactorization(
            data, latent_dim=_common.P_PLANTED, strategy=None,
            scale_rates=True, with_s=True,
            u_tau_scale=1.0 / np.sqrt(X.shape[1] * n), device=run.device)
        factor.calibrate_advi(num_steps=args.steps, rel_tol=1e-4,
                              learning_rate=0.05)
        losses[label] = run.record(factor, len(data))
        results[label] = to_numpy(factor.encoding_matrix())

    def draw(plt):
        fig, axes = plt.subplots(1, 3, figsize=(15, 5))
        for ax, (label, A) in zip(axes, results.items()):
            im = ax.imshow(A, vmin=0, cmap="Blues", aspect="auto")
            ax.set_title(label)
            ax.set_xlabel("factor dimension")
            ax.set_ylabel("item")
            fig.colorbar(im, ax=ax)

    arrays = _common.save_arrays(args.outdir, **{
        f"simulation_figure_{label}_encoding": A
        for label, A in results.items()})
    figure = _common.save_figure(args.outdir, "simulation_figure.png", draw)
    for label, A in results.items():
        print(label, "encoding col mass:", np.abs(A).sum(1).round(3))
    return run.summary(artifacts=arrays + [figure], losses=losses,
                       column_mass={k: _common.column_mass(A)
                                    for k, A in results.items()})


if __name__ == "__main__":
    main()
