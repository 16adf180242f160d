"""The port's command-line entry points (``python -m spmf_tpu_torch.cli.*``)
and its native ingest, against spmf_tpu's bin/ scripts and data/native.py
(CPU, ``--device cpu``).

The cases of tests/test_cli.py run through the port: every artifact with
its name, shape and finiteness. Model files cross between the packages in
both directions with their parameters bit for bit; the calibrated
expectations are Monte Carlo means drawn by each package's own generator,
so ``encoding_matrix`` is compared at the same u and s (1e-6). The native
parsers equal spmf_tpu's on the same files bit for bit."""
import _torch_threads  # first: one torch thread

import csv
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spmf_tpu.data import native as jnative
from spmf_tpu.models.base import load_model as jax_load_model

from spmf_tpu_torch import load_model
from spmf_tpu_torch.cli import factorize_csv, factorize_scrnaseq_counts
from spmf_tpu_torch.cli import preprocess_scrnaseq_counts
from spmf_tpu_torch.data import load_csv_counts
from spmf_tpu_torch.data import native as tnative
from spmf_tpu_torch.data.sparse import SparseCounts
from spmf_tpu_torch.utils.checkpoint import flatten_jax_order

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(ROOT, "bin")


def _load_bin(name):
    spec = importlib.util.spec_from_file_location(
        f"bin_{name}", os.path.join(BIN, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_bin(name, argv, monkeypatch):
    mod = _load_bin(name)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()


def _write_csv(path, seed=0, shape=(30, 6)):
    X = np.random.default_rng(seed).poisson(2.0, size=shape)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(X.tolist())
    return X


def _write_10x(tmp_path, genes=300, cells=50, seed=1):
    """tests/test_cli.py's synthetic 10x directory."""
    M = np.random.default_rng(seed).poisson(3.0, size=(genes, cells))
    M[0, :] = 0  # dropped by min_cells >= 3
    r, c = np.nonzero(M)
    with open(tmp_path / "matrix.mtx", "w") as f:
        f.write("%%MatrixMarket matrix coordinate integer general\n")
        f.write(f"{genes} {cells} {len(r)}\n")
        for i, j in zip(r, c):
            f.write(f"{i + 1} {j + 1} {M[i, j]}\n")
    with open(tmp_path / "features.tsv", "w") as f:
        for g in range(genes):
            f.write(f"ENSG{g:05d}\tGENE{g}\tGene Expression\n")


def _params_np(params):
    return [np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                       else t) for t in flatten_jax_order(params)]


def test_factorize_csv_cli(tmp_path):
    """tests/test_cli.py:37 through the port: the encoding CSV (latent_dim
    x columns), the model file, the PDF figure and the representation CSV
    (index + coordinates per row), with the -lt / -rn branches; the model
    reloads through the port's load_model with the CSV's encoding."""
    csv_file = tmp_path / "counts.csv"
    _write_csv(csv_file)
    factorize_csv.main(["-f", str(csv_file), "-e", "2", "-d", "2", "-b",
                        "10", "-lr", "0.05", "-lt", "-rn", "--device", "cpu"])
    base, suffix = f"{csv_file}_2D", "lt_True_rn_True"
    enc = np.loadtxt(f"{base}_encoding_{suffix}.csv", delimiter=",")
    assert enc.shape == (2, 6) and np.isfinite(enc).all()
    restored = load_model(f"{base}_model_{suffix}.npz", device="cpu")
    np.testing.assert_allclose(restored.encoding_matrix().numpy().T, enc,
                               rtol=1e-6)
    rep = np.loadtxt(f"{base}_representation_{suffix}.csv", delimiter=",")
    assert rep.shape == (30, 3) and np.isfinite(rep).all()
    assert os.path.exists(f"{base}_encoding_{suffix}.pdf")


def test_model_files_cross_between_the_packages(tmp_path, monkeypatch):
    """A model written by the port's factorize_csv loads in spmf_tpu's
    load_model, and one written by bin/factorize_csv.py loads in the
    port's: the same parameters bit for bit, and encoding_matrix at the
    same u and s within 1e-6 (spmf_tpu's of the model it loaded)."""
    jm = None
    for writer in ("port", "jax"):
        csv_file = tmp_path / f"{writer}.csv"
        _write_csv(csv_file, seed=3)
        argv = ["-f", str(csv_file), "-e", "1", "-d", "2", "-b", "10",
                "-lr", "0.05"]
        if writer == "port":
            factorize_csv.main(argv + ["--device", "cpu"])
        else:
            _run_bin("factorize_csv", argv, monkeypatch)
        path = f"{csv_file}_2D_model_lt_False_rn_False.npz"
        with np.load(path) as zf:      # float64 where JAX runs in x64
            dtype = str(zf["param_0"].dtype)
            saved = [zf[f"param_{i}"] for i in range(len(zf.files))
                     if f"param_{i}" in zf]
        port = load_model(path, device="cpu", dtype=dtype)
        if jm is None:
            jm = jax_load_model(path)
            for a, b in zip(saved, _params_np(jm.surrogate_params)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(saved, _params_np(port.surrogate_params)):
            np.testing.assert_array_equal(a, b)
        u = port.calibrated_expectations["u"].numpy()
        s = port.calibrated_expectations["s"].numpy()
        np.testing.assert_allclose(
            port.encoding_matrix().numpy(),
            np.asarray(jm.encoding_matrix(u, s)), rtol=1e-6)


def test_scrnaseq_pipeline_cli(tmp_path, monkeypatch):
    """tests/test_cli.py:70 through the port: preprocess (the native
    MatrixMarket parser; the same files as spmf_tpu's script writes, bit
    for bit), factorize, and bin/plot_scrnaseq_figures.py on the port's
    artifacts where matplotlib exists."""
    _write_10x(tmp_path)
    preprocess_scrnaseq_counts.main([
        "--datapath", str(tmp_path), "--dataset", "toy", "--n-top-genes",
        "64", "--backend", "numpy", "--device", "cpu"])
    _run_bin("preprocess_scrnaseq_counts", [
        "--datapath", str(tmp_path), "--dataset", "ref", "--n-top-genes",
        "64", "--backend", "numpy"], monkeypatch)
    for tag in ("counts", "genenames", "PCA"):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"toy_{tag}.npy", allow_pickle=True),
            np.load(tmp_path / f"ref_{tag}.npy", allow_pickle=True))
    counts = np.load(tmp_path / "toy_counts.npy")
    names = np.load(tmp_path / "toy_genenames.npy", allow_pickle=True)
    assert not os.path.exists(tmp_path / "toy_UMAP_scanpy.npy")
    assert counts.shape[1] == 64 and counts.shape[0] <= 50
    assert names.shape == (64,) and str(names[0]).startswith("GENE")
    assert "GENE0" not in set(map(str, names))
    assert np.load(tmp_path / "toy_PCA.npy").shape == (counts.shape[0], 2)

    factorize_scrnaseq_counts.main([
        "--datapath", str(tmp_path), "--dataset", "toy", "-d", "2", "-b",
        "16", "-e", "2", "--no-figures", "--device", "cpu"])
    N = counts.shape[0]
    for artifact, shape in (
            ("toy_U_2.npy", (64, 2)), ("toy_V_2.npy", (2, 64)),
            ("toy_W_2.npy", (1, 64)), ("toy_Z_2.npy", (N, 2)),
            ("toy_cellscore_2.npy", (N, 2)),
            ("toy_genescore_2.npy", (2, 64)),
            ("toy_interceptscore_2.npy", (1, 64))):
        arr = np.load(tmp_path / artifact)
        assert arr.shape == shape, (artifact, arr.shape)
        assert np.isfinite(arr).all(), artifact
    losses = np.load(tmp_path / "toy_losses_2.npy")
    assert losses.size >= 1 and np.isfinite(losses).all()

    pytest.importorskip("matplotlib")
    _run_bin("plot_scrnaseq_figures", [
        "--datapath", str(tmp_path), "--dataset", "toy", "-d", "2"],
        monkeypatch)
    assert os.path.exists(tmp_path / "toy_genescores_replot_2.pdf")
    assert os.path.exists(tmp_path / "toy_PCA_replot_2.pdf")


def test_factorize_scrnaseq_sparse_flag(tmp_path):
    """tests/test_cli.py:131 through the port: --sparse trains on COO
    triplets and writes the same artifact set."""
    rng = np.random.default_rng(2)
    X = (rng.poisson(0.3, size=(48, 40)) *
         (rng.random((48, 40)) < 0.3)).astype(np.int64)
    X[:, 0] += 1
    np.save(tmp_path / "sp_counts.npy", X)
    np.save(tmp_path / "sp_genenames.npy",
            np.array([f"G{i}" for i in range(40)]))
    factorize_scrnaseq_counts.main([
        "--datapath", str(tmp_path), "--dataset", "sp", "-d", "2", "-b",
        "16", "-e", "2", "--no-figures", "--sparse", "--device", "cpu"])
    Z = np.load(tmp_path / "sp_Z_2.npy")
    assert Z.shape == (48, 2) and np.isfinite(Z).all()


def test_refusals_name_the_flag(tmp_path, monkeypatch):
    """--data-parallel in one CPU process trains on a trivial dp mesh and
    writes tests/test_cli.py's artifacts; with no card, the default
    --device cuda raises and names --device cpu, in every entry point."""
    rng = np.random.default_rng(3)
    X = rng.poisson(0.8, size=(32, 12)).astype(np.int64)
    X[:, 0] += 1
    np.save(tmp_path / "dp_counts.npy", X)
    np.save(tmp_path / "dp_genenames.npy",
            np.array([f"G{i}" for i in range(12)]))
    model = factorize_scrnaseq_counts.main([
        "--datapath", str(tmp_path), "--dataset", "dp", "-d", "2", "-b",
        "16", "-e", "2", "--no-figures", "--data-parallel", "--device",
        "cpu"])
    assert model.mesh is not None and model.mesh.trivial
    for artifact, shape in (
            ("dp_U_2.npy", (12, 2)), ("dp_V_2.npy", (2, 12)),
            ("dp_W_2.npy", (1, 12)), ("dp_Z_2.npy", (32, 2)),
            ("dp_cellscore_2.npy", (32, 2)),
            ("dp_genescore_2.npy", (2, 12)),
            ("dp_interceptscore_2.npy", (1, 12))):
        arr = np.load(tmp_path / artifact)
        assert arr.shape == shape and np.isfinite(arr).all(), artifact
    assert np.isfinite(np.load(tmp_path / "dp_losses_2.npy")).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csv_file = tmp_path / "c.csv"
    _write_csv(csv_file)
    for run in (
            lambda: factorize_csv.main(["-f", str(csv_file)]),
            lambda: preprocess_scrnaseq_counts.main(
                ["--datapath", str(tmp_path)]),
            lambda: factorize_scrnaseq_counts.main(
                ["--datapath", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            run()


def test_cli_modules_run_with_python_m(capsys):
    """``python -m spmf_tpu_torch.cli.factorize_csv --help`` runs the entry
    point as a module; every entry point's --help lists --device."""
    out = subprocess.run(
        [sys.executable, "-m", "spmf_tpu_torch.cli.factorize_csv", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=_torch_threads.ENV)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    for mod in (factorize_csv, preprocess_scrnaseq_counts,
                factorize_scrnaseq_counts):
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        assert "--device" in capsys.readouterr().out


# ------------------------------------------------------------ native ingest
def test_native_csv_equals_spmf_tpu(tmp_path):
    """The port's native CSV parser (built into spmf_tpu_torch/_build/)
    equals spmf_tpu's and numpy's on the same file, bit for bit, with no
    trailing newline and CRLF line ends; a header row falls back to numpy,
    which raises."""
    path = tmp_path / "m.csv"
    X = np.random.default_rng(5).poisson(3.0, (40, 7)).astype(float)
    X[3, 2] = 0.125
    text = "\r\n".join(",".join(repr(float(v)) for v in row) for row in X)
    path.write_text(text)
    assert tnative.native_available()
    so = tnative._so_path()
    assert os.path.dirname(so).endswith(os.path.join("spmf_tpu_torch",
                                                     "_build"))
    assert os.path.exists(so)
    out = tnative.load_csv(str(path))
    np.testing.assert_array_equal(out, jnative.load_csv(str(path)))
    np.testing.assert_array_equal(out, np.loadtxt(path, delimiter=","))
    np.testing.assert_array_equal(load_csv_counts(str(path)), out)
    bad = tmp_path / "h.csv"
    bad.write_text("g1,g2\n1,2\n")
    with pytest.raises(ValueError):
        tnative.load_csv(str(bad))


def test_native_mtx_equals_spmf_tpu(tmp_path):
    """The native MatrixMarket parser equals spmf_tpu's and scipy's on an
    integer and a real file bit for bit; a pattern file (no value column)
    goes to scipy; SparseCounts.from_mtx reads through it."""
    _write_10x(tmp_path)
    path = str(tmp_path / "matrix.mtx")
    got, ref = tnative.load_mtx_coo(path), jnative.load_mtx_coo(path)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3]
    np.testing.assert_array_equal(_dense(got),
                                  _dense(tnative._mmread_coo(path)))
    real = tmp_path / "real.mtx"
    real.write_text("%%MatrixMarket matrix coordinate real general\n"
                    "% a comment\n3 4 3\n1 1 0.5\n3 4 -2.25e3\n2 2 7\n")
    for a, b in zip(tnative.load_mtx_coo(str(real))[:3],
                    jnative.load_mtx_coo(str(real))[:3]):
        np.testing.assert_array_equal(a, b)
    pattern = tmp_path / "pattern.mtx"
    pattern.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                       "2 2 2\n1 1\n2 2\n")
    r, c, v, shape = tnative.load_mtx_coo(str(pattern))
    assert shape == (2, 2) and v.tolist() == [1.0, 1.0]
    spc = SparseCounts.from_mtx(path, transpose=True)
    assert spc.shape == (50, 300)
    np.testing.assert_array_equal(spc.row_slab(np.arange(50)).T,
                                  _dense(ref))


def _dense(coo):
    rows, cols, vals, shape = coo
    out = np.zeros(shape)
    out[rows, cols] = vals
    return out


def test_native_build_failure_falls_back(tmp_path, monkeypatch):
    """Without a working g++ build the loaders take numpy / scipy."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "_SRC", str(tmp_path / "missing.cpp"))
    path = tmp_path / "m.csv"
    X = _write_csv(path)
    assert not tnative.native_available()
    np.testing.assert_array_equal(tnative.load_csv(str(path)), X)
