"""Factorize a preprocessed scRNA-seq count matrix (the port of spmf_tpu's
bin/factorize_scrnaseq_counts.py: the same flags, outputs and file names,
plus ``--device``).

    python -m spmf_tpu_torch.cli.factorize_scrnaseq_counts \\
        --datapath DIR --dataset NAME -d 3 -b 256 -e 500 [--sparse]

Loads the ``<name>_counts.npy`` / ``<name>_genenames.npy`` /
``<name>_UMAP_scanpy.npy`` or ``<name>_PCA.npy`` triplet that
``preprocess_scrnaseq_counts`` writes, fits PoissonMatrixFactorization
(log link, column means as norms, u_tau_scale = 1/sqrt(D N)), and saves
U / V / W / Z, the cell, gene and intercept scores and the loss trace as
.npy, then the figures (skipped without matplotlib).

``--data-parallel`` trains on a dp mesh over every rank of the process
group: under ``torchrun --nproc_per_node=N`` each rank feeds its rows of
every batch (NCCL, one card a rank; ``--backend gloo`` lets several ranks
share one card) and rank 0 writes the outputs. In one process the mesh is
trivial and the fit is the plain one.
"""
import argparse
import os

import numpy as np

from spmf_tpu_torch.cli import resolve_device, to_numpy


def main(argv=None):
    """Run the command line ``argv`` (None: ``sys.argv``); returns the
    fitted model."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--datapath", default=".",
                    help="directory with the npy triplet")
    ap.add_argument("--dataset", default="pbmc3k")
    ap.add_argument("-d", "--dimension", type=int, default=3)
    ap.add_argument("-b", "--batch-size", type=int, default=256)
    ap.add_argument("-e", "--num-steps", type=int, default=500)
    ap.add_argument("-lr", "--learning-rate", type=float, default=0.01)
    ap.add_argument("-c", "--clip-value", type=float, default=10.0)
    ap.add_argument("--no-figures", action="store_true")
    ap.add_argument("--sparse", action="store_true",
                    help="train on padded COO triplets (the sparse energy; "
                         "never densifies row slabs)")
    ap.add_argument("--block-rows", type=int, default=None,
                    help="with --sparse on the card: the block-aligned "
                         "device layout (e.g. 128; the batch size must be a "
                         "multiple); epochs shuffle row BLOCKS, so shuffle "
                         "a structured cell order once beforehand")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard minibatch rows over the ranks of the "
                         "process group (launch with torchrun; one process: "
                         "a trivial mesh)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="with --data-parallel: the torch.distributed "
                         "backend (default nccl with --device cuda, gloo "
                         "with --device cpu; gloo for several ranks on one "
                         "card)")
    ap.add_argument("-s", "--sample-size", type=int, default=8,
                    help="ELBO samples per step (default 8)")
    ap.add_argument("--antithetic", action="store_true",
                    help="mirrored-pair ELBO sampling; the sample size must "
                         "be even")
    ap.add_argument("--likelihood-clip", default="reference",
                    choices=["reference", "static"],
                    help="'static' drops the fused kernel's data-dependent "
                         "clip bound (identical gradients)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save a checkpoint per improving epoch here")
    ap.add_argument("--resume-from", default=None,
                    help="restore surrogate params from an engine "
                         "checkpoint (.npz, or a directory: newest inside) "
                         "before training")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; on a host without a "
                         "card pass --device cpu)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if args.data_parallel:
        from spmf_tpu_torch.parallel import (
            data_parallel_mesh,
            initialize_distributed,
        )

        initialize_distributed(backend=args.backend, device=device)
        mesh = data_parallel_mesh()
        print(f"data-parallel mesh: {mesh.size} ranks")
    writes = mesh is None or mesh.rank == 0

    from spmf_tpu_torch import PoissonMatrixFactorization
    from spmf_tpu_torch.data import ArrayDataset, SparseCounts

    datapath = os.path.join(args.datapath, "")
    name = args.dataset
    X = np.load(datapath + name + "_counts.npy")
    gene_names = np.load(datapath + name + "_genenames.npy",
                         allow_pickle=True)
    # the scanpy backend's UMAP, or the numpy backend's PCA stand-in: the
    # figures are labelled by what was found
    UMAP, emb_label = None, "UMAP"
    for path, label in ((datapath + name + "_UMAP_scanpy.npy", "UMAP"),
                        (datapath + name + "_PCA.npy", "PCA")):
        if os.path.exists(path):
            UMAP, emb_label = np.load(path), label
            break

    P = args.dimension
    N, D = X.shape
    BATCH_SIZE = args.batch_size
    print(X.shape)
    print(f"Total observations={N}, Batch size={BATCH_SIZE}: "
          f"dropping {N % BATCH_SIZE} observations.")

    # row / column size factors from median-normalized sums; an all-zero
    # gene's norm is 1 (a zero norm would divide by zero in the encoder)
    row_size_factors = X.sum(1) / np.median(np.asarray(X.sum(1)))
    col_norm = X.mean(0)
    col_norm = np.where(col_norm > 0, col_norm, 1.0)
    row_norm = row_size_factors

    if args.sparse:
        data = (SparseCounts.from_dense(
                    X, extras={"normalization": row_size_factors})
                .shuffle(seed=0)
                .batch(BATCH_SIZE, drop_remainder=True)
                .as_coo())
        if args.block_rows:
            # the block-aligned device layout: one 2-D gather per batch
            data = data.to_device(block_rows=args.block_rows, device=device)
    else:
        data = (ArrayDataset({"data": X, "indices": np.arange(N),
                              "normalization": row_size_factors})
                .shuffle(buffer_size=N)
                .batch(BATCH_SIZE, drop_remainder=True))
        if device.type == "cuda":
            # the matrix resident on the card: fit() takes the scan path,
            # each batch's gather and step replayed from a CUDA graph
            data = data.to_device(device=device)

    factor = PoissonMatrixFactorization(
        data,
        latent_dim=P,
        feature_dim=D,
        strategy=None,
        scale_rates=True,
        column_norms=col_norm,
        log_transform=True,
        u_tau_scale=1.0 / np.sqrt(D * N),
        likelihood_clip=args.likelihood_clip,
        device=device,
        mesh=mesh,
    )

    losses = factor.calibrate_advi(
        num_steps=args.num_steps,
        learning_rate=args.learning_rate,
        abs_tol=1e-3,
        rel_tol=1e-3,
        clip_value=args.clip_value,
        sample_size=args.sample_size,
        antithetic=args.antithetic,
        checkpoint_dir=args.checkpoint_dir,
        resume_from=args.resume_from,
    )

    U = to_numpy(factor.encoding_matrix())
    W = to_numpy(factor.intercept_matrix())
    intercept_score = W * col_norm[np.newaxis, :]
    # the full-matrix encode streamed in row chunks: one chunk on the
    # device at a time
    Z = factor.encode_batched(X, row_chunk=max(BATCH_SIZE, 8192))
    cell_score = Z * row_norm[:, np.newaxis]
    V = to_numpy(factor.decoding_matrix())
    gene_score = V * col_norm[np.newaxis, :]
    if not writes:
        return factor

    for tag, arr in (("U", U), ("V", V), ("W", W), ("Z", Z),
                     ("cellscore", cell_score), ("genescore", gene_score),
                     ("interceptscore", intercept_score),
                     ("losses", np.asarray(losses))):
        np.save(datapath + name + f"_{tag}_{P}.npy", arr)

    if args.no_figures:
        return factor
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping figures")
        return factor

    # gene-score heatmap of the top genes per factor
    top = min(25, D)
    order = np.argsort(-gene_score.max(0))[:top]
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(gene_score[:, order], aspect="auto", cmap="Blues")
    ax.set_xticks(np.arange(top))
    ax.set_xticklabels([str(g) for g in gene_names[order]], rotation=90,
                       fontsize=6)
    ax.set_ylabel("factor")
    fig.colorbar(im, ax=ax)
    plt.savefig(datapath + name + f"_genescores_{P}.pdf",
                bbox_inches="tight")
    plt.close(fig)

    if UMAP is not None:
        fig, axes = plt.subplots(1, P, figsize=(4 * P, 4))
        axes = np.atleast_1d(axes)
        for j in range(P):
            sc = axes[j].scatter(UMAP[:, 0], UMAP[:, 1], c=cell_score[:, j],
                                 s=2, cmap="viridis")
            axes[j].set_title(f"factor {j} ({emb_label})")
            fig.colorbar(sc, ax=axes[j])
        plt.savefig(datapath + name + f"_{emb_label}_scores_{P}.pdf",
                    bbox_inches="tight")
        plt.close(fig)

    fig, ax = plt.subplots()
    ax.plot(losses)
    ax.set_xlabel("epoch")
    ax.set_ylabel("avg batch loss")
    plt.savefig(datapath + name + f"_losses_{P}.pdf", bbox_inches="tight")
    plt.close(fig)
    return factor


if __name__ == "__main__":
    main()
