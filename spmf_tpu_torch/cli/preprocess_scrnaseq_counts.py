"""Preprocess 10x scRNA-seq data into the npy triplet that
``factorize_scrnaseq_counts`` reads (the port of spmf_tpu's
bin/preprocess_scrnaseq_counts.py: the same flags, QC thresholds and
files, plus ``--device``).

    python -m spmf_tpu_torch.cli.preprocess_scrnaseq_counts \\
        --datapath DIR --dataset NAME --n-top-genes 1000 --backend numpy

QC filtering (min_genes=200, min_cells=3, mito% < 5, genes < 2500), HVG
ranking by normalized dispersion, a 2-D embedding; saves
``<name>_counts.npy``, ``<name>_genenames.npy`` and the embedding.
Backends:
- ``--backend scanpy``: scanpy / leiden / paga / UMAP, saved as
  ``<name>_UMAP_scanpy.npy`` (needs scanpy);
- ``--backend numpy`` (``auto`` without scanpy): the native MatrixMarket
  parser (``data/native.py``), the same QC, dispersion-based HVG ranking,
  and a PCA embedding saved as ``<name>_PCA.npy`` (not a UMAP).
Preprocessing runs on the host; ``--device`` is checked as the other
entry points check it.
"""
import argparse
import gzip
import os
import shutil
import sys
import tempfile

import numpy as np

from spmf_tpu_torch.cli import resolve_device


def _read_counts(datapath):
    """The cells x genes matrix of ``datapath``'s matrix.mtx (or .mtx.gz),
    densified, and the gene names of its features / genes file."""
    from spmf_tpu_torch.data.sparse import SparseCounts

    mtx = next((os.path.join(datapath, c)
                for c in ("matrix.mtx", "matrix.mtx.gz")
                if os.path.exists(os.path.join(datapath, c))), None)
    if mtx is None:
        sys.exit(f"no matrix.mtx under {datapath}")
    if mtx.endswith(".gz"):
        with tempfile.TemporaryDirectory() as tmp:
            plain = os.path.join(tmp, "matrix.mtx")
            with gzip.open(mtx, "rb") as src, open(plain, "wb") as dst:
                shutil.copyfileobj(src, dst)
            # 10x stores genes x cells; transpose to cells x genes
            sp = SparseCounts.from_mtx(plain, transpose=True)
    else:
        sp = SparseCounts.from_mtx(mtx, transpose=True)
    genes_file = next((os.path.join(datapath, c)
                       for c in ("features.tsv", "genes.tsv",
                                 "features.tsv.gz", "genes.tsv.gz")
                       if os.path.exists(os.path.join(datapath, c))), None)
    if genes_file:
        opener = gzip.open if genes_file.endswith(".gz") else open
        with opener(genes_file, "rt") as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        gene_names = np.array([r[1] if len(r) > 1 else r[0] for r in rows])
    else:
        gene_names = np.array([f"G{i}" for i in range(sp.shape[1])])
    return sp.row_slab(np.arange(sp.shape[0])), gene_names


def _numpy_backend(datapath, name, n_top_genes):
    X, gene_names = _read_counts(datapath)

    # QC (the reference thresholds)
    keep_cells = (X > 0).sum(1) >= 200
    keep_genes = (X > 0).sum(0) >= 3
    X = X[keep_cells][:, keep_genes]
    gene_names = gene_names[keep_genes]
    is_mt = np.char.startswith(np.char.upper(gene_names.astype(str)), "MT-")
    counts_per_cell = X.sum(1)
    with np.errstate(invalid="ignore", divide="ignore"):
        pct_mt = 100.0 * X[:, is_mt].sum(1) / np.maximum(counts_per_cell, 1)
    keep = (pct_mt < 5.0) & ((X > 0).sum(1) < 2500)
    X = X[keep]

    # HVG: normalized dispersion on the normalize_total + log1p view
    lib = np.maximum(X.sum(1, keepdims=True), 1.0)
    view = np.log1p(X / lib * 1e4)
    mean = view.mean(0)
    var = view.var(0)
    with np.errstate(invalid="ignore", divide="ignore"):
        dispersion = np.where(mean > 0, var / np.maximum(mean, 1e-12), 0.0)
    # z-scored within mean bins (scanpy's normalized dispersion)
    bins = np.digitize(mean, np.quantile(mean, np.linspace(0, 1, 21)[1:-1]))
    disp_norm = np.zeros_like(dispersion)
    for b in np.unique(bins):
        m = bins == b
        mu, sd = dispersion[m].mean(), dispersion[m].std() + 1e-12
        disp_norm[m] = (dispersion[m] - mu) / sd
    order = np.argsort(-disp_norm)
    X = X[:, order]
    gene_names = gene_names[order]

    # embedding: the top-2 PCs of the scaled log view (a UMAP stand-in)
    v = view[:, order[: min(2000, view.shape[1])]]
    v = np.clip((v - v.mean(0)) / (v.std(0) + 1e-8), -10, 10)
    u_svd, s_svd, _ = np.linalg.svd(v, full_matrices=False)
    embedding = u_svd[:, :2] * s_svd[:2]

    np.save(os.path.join(datapath, name + "_counts.npy"), X[:, :n_top_genes])
    np.save(os.path.join(datapath, name + "_genenames.npy"),
            gene_names[:n_top_genes])
    # named for what it is: a PCA scatter, not a UMAP
    np.save(os.path.join(datapath, name + "_PCA.npy"), embedding)
    print(f"Saved {name}_counts.npy {X[:, :n_top_genes].shape}, genenames, "
          f"PCA embedding ({name}_PCA.npy) to {datapath} (numpy backend)")


def _scanpy_backend(datapath, name, n_top_genes):
    import scanpy as sc

    adata = sc.read_10x_mtx(datapath, var_names="gene_symbols", cache=True)
    adata.var_names_make_unique()
    sc.pp.filter_cells(adata, min_genes=200)
    sc.pp.filter_genes(adata, min_cells=3)
    adata.var["mt"] = adata.var_names.str.startswith("MT-")
    sc.pp.calculate_qc_metrics(adata, qc_vars=["mt"], percent_top=None,
                               log1p=False, inplace=True)
    adata = adata[adata.obs.pct_counts_mt < 5, :]
    adata = adata[adata.obs.n_genes_by_counts < 2500, :]
    counts = (adata.X.toarray() if hasattr(adata.X, "toarray")
              else np.asarray(adata.X))

    view = adata.copy()
    sc.pp.normalize_total(view, target_sum=1e4)
    sc.pp.log1p(view)
    sc.pp.highly_variable_genes(view, n_top_genes=n_top_genes)
    order = np.argsort(-view.var["dispersions_norm"].values)
    counts = counts[:, order]
    gene_names = np.asarray(adata.var_names)[order]

    sc.pp.scale(view, max_value=10)
    sc.tl.pca(view, svd_solver="arpack")
    sc.pp.neighbors(view, n_neighbors=10, n_pcs=40)
    try:
        sc.tl.leiden(view)
        sc.tl.paga(view)
        sc.pl.paga(view, plot=False)
        sc.tl.umap(view, init_pos="paga")
    except Exception:  # noqa: BLE001 - leiden / paga are optional extras
        sc.tl.umap(view)

    np.save(os.path.join(datapath, name + "_counts.npy"), counts)
    np.save(os.path.join(datapath, name + "_genenames.npy"), gene_names)
    np.save(os.path.join(datapath, name + "_UMAP_scanpy.npy"),
            view.obsm["X_umap"])
    print(f"Saved {name}_counts.npy {counts.shape}, genenames, UMAP to "
          f"{datapath}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--datapath", required=True,
                    help="directory containing the 10x mtx data")
    ap.add_argument("--dataset", default="pbmc3k")
    ap.add_argument("--n-top-genes", type=int, default=1000)
    ap.add_argument("--backend", choices=("auto", "scanpy", "numpy"),
                    default="auto")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; on a host without a "
                         "card pass --device cpu)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    backend = args.backend
    if backend == "auto":
        try:
            import scanpy  # noqa: F401

            backend = "scanpy"
        except ImportError:
            backend = "numpy"

    datapath = args.datapath.rstrip("/")
    if backend == "scanpy":
        _scanpy_backend(datapath + "/", args.dataset, args.n_top_genes)
    else:
        _numpy_backend(datapath, args.dataset, args.n_top_genes)


if __name__ == "__main__":
    main()
