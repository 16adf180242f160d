"""Train PMF on a CSV-formatted count matrix (the port of spmf_tpu's
bin/factorize_csv.py: the same flags and outputs — the encoding CSV, the
saved model, the PDF figure and the per-row representation CSV — plus
``--device``).

    python -m spmf_tpu_torch.cli.factorize_csv -f counts.csv -d 2 -e 300
    python -m spmf_tpu_torch.cli.factorize_csv -f counts.csv --device cpu
"""
import argparse
import csv
import os
import sys

import numpy as np

from spmf_tpu_torch.cli import resolve_device, to_numpy


def main(argv=None):
    """Run the command line ``argv`` (None: ``sys.argv``); returns the
    fitted model."""
    parser = argparse.ArgumentParser(
        description="Train PMF on CSV-formatted count matrix")
    parser.add_argument("-f", "--csv-file", nargs="?", type=str,
                        help="Enter the CSV file")
    parser.add_argument("-e", "--epoch", nargs="?", type=int, default=300,
                        help="Enter Epoch value: Default: 300")
    parser.add_argument("-d", "--dimension", nargs="?", type=int, default=2,
                        help="Enter embedding dimension. Default: 2")
    parser.add_argument("-b", "--batch-size", nargs="?", type=int,
                        default=5000, help="Enter batch size. Default: 5000")
    parser.add_argument("-lr", "--learning-rate", nargs="?", type=float,
                        default=0.01, help="Enter float. Default: 0.01")
    parser.add_argument("-c", "--clip-value", nargs="?", type=float,
                        default=3.0, help="Gradient clip value. Default: 3.0")
    parser.add_argument("-lt", "--log-transform", action="store_true",
                        help="Log-transform?")
    parser.add_argument("-rn", "--row-normalize", action="store_true",
                        help="Row normalize based on counts?")
    parser.add_argument("-s", "--sample-size", nargs="?", type=int, default=8,
                        help="ELBO samples per step. Default: 8")
    parser.add_argument("--antithetic", action="store_true",
                        help="mirrored-pair ELBO sampling; needs even -s")
    parser.add_argument("--checkpoint-dir", nargs="?", type=str, default=None,
                        help="Write full-state engine checkpoints here "
                             "(per improving epoch)")
    parser.add_argument("--resume-from", nargs="?", type=str, default=None,
                        help="Resume from an engine checkpoint (.npz path "
                             "or a directory; newest restored)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda; on a host "
                             "without a card pass --device cpu)")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)

    if args.csv_file is None:
        sys.exit("You need to specify a csv file")
    elif not os.path.exists(args.csv_file):
        sys.exit("File doesn't exist")
    device = resolve_device(args.device)

    from spmf_tpu_torch import PoissonMatrixFactorization
    from spmf_tpu_torch.data import ArrayDataset, load_csv_counts

    X = load_csv_counts(args.csv_file)
    N, columns = X.shape
    colmeans = X.mean(axis=0, keepdims=True)
    rowmean = colmeans.sum()

    tensors = {"indices": np.arange(N), "counts": X}
    if args.row_normalize:
        tensors["normalization"] = np.maximum(X.sum(axis=1), 1.0) / rowmean
    data = ArrayDataset(tensors).batch(args.batch_size, drop_remainder=True)
    if device.type == "cuda":
        # the matrix resident on the card: fit() takes the scan path, each
        # batch's gather and step replayed from a CUDA graph
        data = data.to_device(device=device)

    factor = PoissonMatrixFactorization(
        data,
        latent_dim=args.dimension,
        feature_dim=columns,
        strategy=None,
        scale_columns=True,
        log_transform=args.log_transform,
        column_norms=colmeans,
        u_tau_scale=1.0 / np.sqrt(columns * N),
        device=device,
    )

    fit_kwargs = {}
    if args.checkpoint_dir is not None:
        fit_kwargs["checkpoint_dir"] = args.checkpoint_dir
    if args.resume_from is not None:
        fit_kwargs["resume_from"] = args.resume_from
    factor.calibrate_advi(
        num_steps=args.epoch,
        rel_tol=1e-4,
        clip_value=args.clip_value,
        learning_rate=args.learning_rate,
        sample_size=args.sample_size,
        antithetic=args.antithetic,
        **fit_kwargs,
    )

    base = f"{args.csv_file}_{args.dimension}D"
    suffix = f"lt_{args.log_transform}_rn_{args.row_normalize}"

    print("Saving the encoding matrix")
    encoding = to_numpy(factor.encoding_matrix())
    with open(f"{base}_encoding_{suffix}.csv", "w") as f:
        writer = csv.writer(f)
        for row in encoding.T:
            writer.writerow(row)

    print("Saving the trained model object")
    factor.save(f"{base}_model_{suffix}.npz")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; skipping figure")
    else:
        print("Saving figure with the encodings")
        _figure(plt, factor, encoding, columns,
                f"{base}_encoding_{suffix}.pdf")

    print("Generating representations")
    with open(f"{base}_representation_{suffix}.csv", "w") as f:
        writer = csv.writer(f)
        for record in ArrayDataset(tensors).batch(args.batch_size):
            z = to_numpy(factor.encode(record["counts"]))
            if args.row_normalize:
                z = z * record["normalization"][:, None]
            ind = record["indices"]
            for row in range(z.shape[0]):
                writer.writerow(np.concatenate([[ind[row]], z[row, :]]))
    return factor


def _figure(plt, factor, encoding, columns, path):
    """The encoding matrix and a forest plot of the intercept posteriors
    (bin/factorize_csv.py's figure; arviz's plot_forest where it runs,
    else the same panel by hand)."""
    fig, ax = plt.subplots(1, 2, figsize=(14, 8))
    pcm = ax[0].imshow(encoding[::-1, :], vmin=0, cmap="Blues")
    ax[0].set_ylabel("item")
    ax[0].set_xlabel("factor dimension")
    fig.colorbar(pcm, ax=ax[0], orientation="vertical")

    samples = factor.surrogate_distribution.sample(250)
    s = to_numpy(samples["s"])
    weights = s / s.sum(-2, keepdims=True)
    intercept = (np.squeeze(to_numpy(samples["w"]), -2) * weights[:, -1, :]
                 * to_numpy(factor.eta_i).reshape(1, -1))

    def manual_forest():
        lo94, lo50, mid, hi50, hi94 = np.percentile(
            intercept, [3.0, 25.0, 50.0, 75.0, 97.0], axis=0)
        ys = np.arange(columns)
        ax[1].hlines(ys, lo94, hi94, color="C0", linewidth=1)
        ax[1].hlines(ys, lo50, hi50, color="C0", linewidth=3.5)
        ax[1].plot(mid, ys, "o", color="white", markersize=3.5,
                   markeredgecolor="C0", zorder=3)
        ax[1].set_yticks(ys)
        ax[1].set_yticklabels([f"feature {i}" for i in ys])
        ax[1].set_xlabel("background rate")
        ax[1].axvline(1.0, linestyle="dashed", color="black")
        ax[1].set_title("intercept posterior (94% / 50% intervals)")
        ax[1].invert_yaxis()

    try:
        import arviz as az

        az.plot_forest({"background rate": intercept[None]}, ax=ax[1],
                       combined=True)
        ax[1].axvline(1.0, linestyle="dashed", color="black")
    except Exception:  # noqa: BLE001 - arviz absent or its API refuses:
        # the figure is cosmetic and must not end a finished fit
        manual_forest()
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
