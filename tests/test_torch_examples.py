"""The six example modules of ``spmf_tpu_torch.examples`` on the CPU at a
small size: each runs through ``main(argv)`` as ``python -m`` runs it,
writes its artifacts, and its losses stay finite and fall. Each module's
data equals its JAX script's at the same size and seed: the JAX scripts'
data lines are written out again below (the scripts fit at import, so they
are not imported). The JAX examples themselves have no tests; their
recorded runs are examples/artifacts/*.log."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest

from spmf_tpu_torch.examples import (_common, corpus_walkthrough,
                                     factorize_linear_structure,
                                     factorize_nonlinear_structure,
                                     factorizing_random_noise,
                                     rnaseq_walkthrough, simulation_figure)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2000


def _falls(losses):
    """Finite, and some epoch after the first below the first."""
    losses = np.asarray(losses, dtype=np.float64)
    return bool(np.all(np.isfinite(losses)) and losses[2:].min() < losses[1])


def _ran(out, n_fits=1):
    assert len(out["fits"]) == n_fits
    for fit in out["fits"]:
        assert _falls(fit["losses"]), fit["losses"]
        assert fit["steps"] > 0 and fit["ms_per_step"] > 0
    assert out["device"] == "cpu" and out["peak_gb"] is None
    # the twins run on the CPU: no kernel is launched
    assert not any(out["launches"].values())
    for path in out["artifacts"]:
        assert os.path.getsize(path) > 0, path


# ------------------------------------------------ the JAX scripts' data lines
def _jax_noise(N, D=30):
    return np.random.default_rng(0).poisson(1.0, size=(N, D))


def _jax_planted(N, nonlinear):
    D_factor, D_noise, P = 10, 20, 3
    D = D_factor + D_noise
    rng = np.random.default_rng(0)
    V = np.abs(rng.normal(1.5, 0.5, size=(P, D_factor)))
    if nonlinear:
        Z = np.abs(rng.normal(0.5, 1.0, size=(N, P)))
    else:
        Z = np.abs(rng.normal(0, 1, size=(N, P)))
    ZV = Z.dot(V)
    X = rng.poisson(1.0, size=(N, D))
    if nonlinear:
        X[:, ::3] = rng.poisson(ZV * np.exp(ZV / ZV.mean() / 10)
                                + (ZV / ZV.mean() / 10) ** 2)
    else:
        X[:, ::3] = rng.poisson(ZV)
    return X


def _jax_simulation(N):
    D_factor, D_noise, P = 10, 20, 3
    D = D_factor + D_noise
    rng = np.random.default_rng(0)
    V = np.abs(rng.normal(1.5, 0.5, size=(P, D_factor)))
    Z = np.abs(rng.normal(0, 1, size=(N, P)))
    ZV = Z.dot(V)
    X_lin = rng.poisson(1.0, size=(N, D))
    X_lin[:, ::3] = rng.poisson(ZV)
    X_nonlin = rng.poisson(1.0, size=(N, D))
    X_nonlin[:, ::3] = rng.poisson(
        ZV * np.exp(ZV / ZV.mean() / 10) + (ZV / ZV.mean() / 10) ** 2
    )
    X_noise = rng.poisson(1.0, size=(N, D))
    return {"noise": X_noise, "linear": X_lin, "nonlinear": X_nonlin}


def _jax_rnaseq(N):
    rng = np.random.default_rng(0)
    N, D, P_true = N, 1000, 5
    lib = rng.lognormal(0, 0.5, size=(N, 1))
    loadings = rng.gamma(0.3, 1.0, size=(P_true, D))
    z = rng.gamma(0.5, 1.0, size=(N, P_true))
    X = rng.poisson(lib * (z @ loadings) / 5.0)
    return X, np.array([f"GENE{i}" for i in range(D)])


@pytest.mark.parametrize("n", [ROWS, 50_000])
def test_example_data_equal_the_jax_scripts(n):
    np.testing.assert_array_equal(factorizing_random_noise.counts(n),
                                  _jax_noise(n))
    np.testing.assert_array_equal(factorize_linear_structure.counts(n),
                                  _jax_planted(n, nonlinear=False))
    np.testing.assert_array_equal(factorize_nonlinear_structure.counts(n),
                                  _jax_planted(n, nonlinear=True))
    got, want = simulation_figure.matrices(n), _jax_simulation(n)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    X, names = rnaseq_walkthrough.synthetic(min(n, 2638))
    jX, jnames = _jax_rnaseq(min(n, 2638))
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(names, jnames)


# ---------------------------------------------------------------- the runs
def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--outdir", str(tmp_path), *extra]


def test_factorizing_random_noise(tmp_path):
    out = factorizing_random_noise.main(
        _argv(tmp_path, "--rows", str(ROWS), "--steps", "3"))
    _ran(out)
    assert out["artifacts"] == [str(tmp_path / f) for f in (
        "noise_encoding.npy", "noise_losses.npy", "noise_encoding.png")]
    assert np.load(tmp_path / "noise_encoding.npy").shape == (30, 4)
    np.testing.assert_array_equal(np.load(tmp_path / "noise_losses.npy"),
                                  out["losses"])
    assert np.isfinite(out["waic"]) and out["max_abs_encoding"] < 0.1
    # 2 batches of 1000 an epoch
    assert out["fits"][0]["steps"] == 2 * out["fits"][0]["epochs"]


@pytest.mark.parametrize("module", [factorize_linear_structure,
                                    factorize_nonlinear_structure],
                         ids=["linear", "nonlinear"])
def test_planted_structure(module, tmp_path):
    out = module.main(_argv(tmp_path, "--rows", str(ROWS), "--steps", "3"))
    _ran(out)
    assert out["artifacts"] == [str(tmp_path / (module.NAME + f)) for f in (
        "_encoding.npy", "_losses.npy", ".png")]
    assert np.load(tmp_path / (module.NAME + "_encoding.npy")).shape \
        == (30, 3)
    assert np.isfinite(out["waic"])
    assert np.isfinite([out["signal_mass"], out["noise_mass"]]).all()


def test_simulation_figure(tmp_path):
    out = simulation_figure.main(
        _argv(tmp_path, "--rows", str(ROWS), "--steps", "3"))
    _ran(out, n_fits=3)
    assert out["artifacts"] == [str(tmp_path / f) for f in (
        "simulation_figure_noise_encoding.npy",
        "simulation_figure_linear_encoding.npy",
        "simulation_figure_nonlinear_encoding.npy", "simulation_figure.png")]
    assert list(out["losses"]) == ["noise", "linear", "nonlinear"]


def test_figures_are_skipped_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed (the card's machine), a figure is
    skipped, as the JAX scripts skip it; the .npy artifacts still land."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert _common.save_figure(str(tmp_path), "f.png", lambda plt: None) \
        is None
    assert not (tmp_path / "f.png").exists()
    paths = _common.save_arrays(str(tmp_path / "sub"), a=np.ones(3))
    np.testing.assert_array_equal(np.load(paths[0]), np.ones(3))


def test_rnaseq_walkthrough(tmp_path, capsys):
    out = rnaseq_walkthrough.main(
        _argv(tmp_path, "--rows", "1000", "--steps", "4"))
    _ran(out)
    gene = np.load(tmp_path / "rnaseq_genescore.npy")
    cell = np.load(tmp_path / "rnaseq_cellscore.npy")
    assert gene.shape == (3, 1000) and cell.shape == (1000, 3)
    assert np.isfinite(gene).all() and np.isfinite(cell).all()
    assert "factor 2: GENE" in capsys.readouterr().out
    # 1000 rows in batches of 256, the remainder dropped
    assert out["fits"][0]["steps"] == 3 * out["fits"][0]["epochs"]


def test_rnaseq_walkthrough_reads_a_preprocessed_matrix(tmp_path):
    X, names = _jax_rnaseq(1000)
    np.save(tmp_path / "toy_counts.npy", X[:, :200])
    np.save(tmp_path / "toy_genenames.npy", names[:200])
    out = rnaseq_walkthrough.main(_argv(
        tmp_path, "--datapath", str(tmp_path), "--dataset", "toy",
        "--steps", "4", "-d", "2"))
    _ran(out)
    assert np.load(tmp_path / "rnaseq_genescore.npy").shape == (2, 200)


def test_corpus_walkthrough(tmp_path, monkeypatch):
    """The corpus of the installed packages' sources through the two CLIs
    and the plot script; the matrix it factorizes equals what spmf_tpu's
    preprocessing makes of the same corpus."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = corpus_walkthrough.main(_argv(
        tmp_path, "--max-docs", "200", "--vocab", "300", "--steps", "3",
        "-b", "16"))
    _ran(out)
    work = tmp_path / "corpus_walkthrough"
    names = {os.path.basename(p) for p in out["artifacts"]}
    for f in ("corpus_counts.npy", "corpus_genenames.npy", "corpus_PCA.npy",
              "corpus_U_10.npy", "corpus_genescore_10.npy",
              "corpus_cellscore_10.npy", "corpus_losses_10.npy",
              "corpus_genescores_replot_10.pdf"):
        assert f in names, f
    assert len(out["top_terms"]) == 10
    X = np.load(work / "corpus_counts.npy")
    assert X.shape == (out["cells"], 300)
    assert out["fits"][0]["steps"] == (out["cells"] // 16) \
        * out["fits"][0]["epochs"]

    # spmf_tpu's numpy preprocessing of the same 10x directory
    ref = tmp_path / "jax"
    ref.mkdir()
    for f in ("matrix.mtx", "features.tsv"):
        shutil.copy(work / f, ref / f)
    spec = importlib.util.spec_from_file_location(
        "jax_preprocess", os.path.join(ROOT, "bin",
                                       "preprocess_scrnaseq_counts.py"))
    jax_preprocess = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_preprocess)
    jax_preprocess._numpy_backend(str(ref), "corpus", 2000)
    np.testing.assert_array_equal(X, np.load(ref / "corpus_counts.npy"))
    np.testing.assert_array_equal(
        np.load(work / "corpus_genenames.npy", allow_pickle=True),
        np.load(ref / "corpus_genenames.npy", allow_pickle=True))
