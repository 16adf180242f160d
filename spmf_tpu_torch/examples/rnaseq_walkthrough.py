"""scRNA-seq (pbmc3k-style) walkthrough at the library level.

The port of examples/rnaseq_walkthrough.py (the reference notebook
rnaseq.ipynb): a preprocessed count matrix (``--datapath`` with the
``<dataset>_counts.npy`` / ``_genenames.npy`` pair that
``spmf_tpu_torch.cli.preprocess_scrnaseq_counts`` writes) or, when there
is none, the JAX script's synthetic stand-in (2,638 cells x 1,000 genes of
Poisson counts on 5 gamma factors; ``--rows`` sets its cells). Row size
factors, column means as norms, the log link, ``scale_rates``, batches of
256 shuffled with the remainder dropped, ``calibrate_advi(num_steps=100,
learning_rate=0.01, abs_tol=1e-3, rel_tol=1e-3, clip_value=10)``; then the
gene scores (``decoding_matrix`` times the column norms), the cell scores
(``encode`` times the size factors) and the top genes per factor. Writes
rnaseq_genescore.npy and rnaseq_cellscore.npy.

    python -m spmf_tpu_torch.examples.rnaseq_walkthrough [--device cpu]
"""
import os

import numpy as np

from spmf_tpu_torch import PoissonMatrixFactorization
from spmf_tpu_torch.cli import to_numpy
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.examples import _common

BATCH_SIZE = 256


def synthetic(rows):
    """The JAX script's stand-in matrix and gene names at ``rows`` cells."""
    rng = np.random.default_rng(0)
    N, D, P_true = rows, 1000, 5
    lib = rng.lognormal(0, 0.5, size=(N, 1))
    loadings = rng.gamma(0.3, 1.0, size=(P_true, D))
    z = rng.gamma(0.5, 1.0, size=(N, P_true))
    X = rng.poisson(lib * (z @ loadings) / 5.0)
    return X, np.array([f"GENE{i}" for i in range(D)])


def main(argv=None):
    ap = _common.parser(__doc__, rows=2638, steps=100)
    ap.add_argument("--datapath", default=None)
    ap.add_argument("--dataset", default="pbmc3k")
    ap.add_argument("-d", "--dimension", type=int, default=3)
    args = ap.parse_args(argv)
    run = _common.Run(args.device)

    if args.datapath and os.path.exists(
            os.path.join(args.datapath, args.dataset + "_counts.npy")):
        X = np.load(os.path.join(args.datapath, args.dataset + "_counts.npy"))
        gene_names = np.load(
            os.path.join(args.datapath, args.dataset + "_genenames.npy"),
            allow_pickle=True)
    else:
        print("no real data found — generating a synthetic sparse count "
              "matrix")
        X, gene_names = synthetic(args.rows)

    P = args.dimension
    N, D = X.shape
    after = np.median(X.sum(1))
    row_size_factors = X.sum(1) / after
    col_norm = X.mean(0)

    data = (ArrayDataset({"data": X, "indices": np.arange(N),
                          "normalization": row_size_factors})
            .shuffle(buffer_size=N)
            .batch(BATCH_SIZE, drop_remainder=True))
    factor = PoissonMatrixFactorization(
        data, latent_dim=P, strategy=None, scale_rates=True,
        column_norms=col_norm, log_transform=True,
        u_tau_scale=1.0 / np.sqrt(D * N), device=run.device)
    factor.calibrate_advi(num_steps=args.steps, learning_rate=0.01,
                          abs_tol=1e-3, rel_tol=1e-3, clip_value=10.0)
    losses = run.record(factor, len(data))

    gene_score = to_numpy(factor.decoding_matrix()) * col_norm[None, :]
    cell_score = to_numpy(factor.encode(X)) * row_size_factors[:, None]
    print("top genes per factor:")
    for j in range(P):
        top = np.argsort(-gene_score[j])[:8]
        print(f"  factor {j}:", ", ".join(str(g) for g in gene_names[top]))
    print("cell score shape:", cell_score.shape)
    os.makedirs(args.outdir, exist_ok=True)
    artifacts = []
    for name, arr in (("genescore", gene_score), ("cellscore", cell_score)):
        path = os.path.join(args.outdir, f"rnaseq_{name}.npy")
        np.save(path, arr)
        artifacts.append(path)
    return run.summary(artifacts=artifacts, losses=losses)


if __name__ == "__main__":
    main()
