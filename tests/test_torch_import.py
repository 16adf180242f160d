"""The port imports no JAX, its kernels build only when launched, and its
entry points run on the card unless the caller asks for the CPU."""
import _torch_threads  # first: one torch thread

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "spmf_tpu_torch")
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(PKG) if "_build" not in d.split(os.sep)
    for f in files if f.endswith(".py")
) + ["chip_smoke.py"]


def test_import_leaves_jax_out_and_builds_nothing():
    code = (
        "import sys\n"
        "import spmf_tpu_torch\n"
        "import spmf_tpu_torch.ops.fused_ig, spmf_tpu_torch.ops.fused_poisson\n"
        "import spmf_tpu_torch.ops.fused_normal\n"
        "import spmf_tpu_torch.models.bernoulli, spmf_tpu_torch.models.mixed\n"
        "import spmf_tpu_torch.models.gaussian, spmf_tpu_torch.models.legacy\n"
        "import spmf_tpu_torch.ops.sparse_encode, spmf_tpu_torch.data.sparse\n"
        "import spmf_tpu_torch.vi, spmf_tpu_torch.vi.waic, spmf_tpu_torch.utils\n"
        "import spmf_tpu_torch.vi.remat, spmf_tpu_torch.data.native\n"
        "import spmf_tpu_torch.cli.factorize_csv\n"
        "import spmf_tpu_torch.cli.preprocess_scrnaseq_counts\n"
        "import spmf_tpu_torch.cli.factorize_scrnaseq_counts\n"
        "import spmf_tpu_torch.ops, spmf_tpu_torch.utils.debug\n"
        "import spmf_tpu_torch.examples.factorizing_random_noise\n"
        "import spmf_tpu_torch.examples.factorize_linear_structure\n"
        "import spmf_tpu_torch.examples.factorize_nonlinear_structure\n"
        "import spmf_tpu_torch.examples.simulation_figure\n"
        "import spmf_tpu_torch.examples.rnaseq_walkthrough\n"
        "import spmf_tpu_torch.examples.corpus_walkthrough\n"
        "from spmf_tpu_torch.data import native\n"
        "from spmf_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'spmf_tpu'))\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS and not _build.BUILD_SECONDS\n"
        "assert native._lib is None and not native.BUILD_SECONDS\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=_torch_threads.ENV)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_jax(path):
    with open(os.path.join(ROOT, path)) as f:
        lines = [ln.strip() for ln in f]
    bad = [ln for ln in lines
           if ln.startswith(("import ", "from "))
           and ln.split()[1].split(".")[0] in ("jax", "jaxlib", "spmf_tpu",
                                               "optax")]
    assert not bad, bad


def test_entry_points_without_device_raise_without_a_card(monkeypatch):
    """With no card, an entry point given no device= raises and names
    device='cpu'; it never carries on on the CPU by itself."""
    import numpy as np
    import torch

    from spmf_tpu_torch import (BernoulliFactorization, GaussianFactorization,
                                MixedFactorization, PoissonFactorization,
                                PoissonMatrixFactorization)
    from spmf_tpu_torch.config import default_device
    from spmf_tpu_torch.data import SparseCounts
    from spmf_tpu_torch.utils import params_from_numpy
    from spmf_tpu_torch.vi import TrainableNormal

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device() == torch.device("cuda")
    sp = SparseCounts.from_dense(np.eye(4))
    for entry in (lambda: PoissonFactorization(latent_dim=2, feature_dim=5),
                  lambda: BernoulliFactorization(latent_dim=2, feature_dim=5),
                  lambda: GaussianFactorization(latent_dim=2, feature_dim=5),
                  lambda: MixedFactorization(column_types=["normal"] * 5,
                                             latent_dim=2),
                  lambda: PoissonMatrixFactorization(latent_dim=2,
                                                     feature_dim=5),
                  lambda: params_from_numpy({"a": np.ones(2)}),
                  lambda: sp.batch(2).to_device(),
                  lambda: TrainableNormal(np.zeros(2), np.ones(2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    m = PoissonFactorization(latent_dim=2, feature_dim=5, device="cpu")
    assert m.device.type == "cpu"


def test_build_hash_covers_included_headers(tmp_path):
    """A library's hash covers its source and every header it includes with
    quotes, followed through the headers, so an edited shared header
    rebuilds every library that includes it (no compiler needed here)."""
    from spmf_tpu_torch.ops import _build

    (tmp_path / "inner.cuh").write_text("// inner\n")
    (tmp_path / "shared.cuh").write_text(
        '#pragma once\n#include <stdint.h>\n# include "inner.cuh"\n')
    for name in ("a", "b"):
        (tmp_path / f"{name}.cu").write_text(
            f'#include "shared.cuh"\n// kernel {name}\n')
    (tmp_path / "alone.cu").write_text("#include <cuda_runtime.h>\n")
    srcs = {n: str(tmp_path / f"{n}.cu") for n in ("a", "b", "alone")}
    assert [p.rsplit("/", 1)[1] for p in _build._source_files(srcs["a"])] == [
        "a.cu", "shared.cuh", "inner.cuh"]
    before = {n: _build._source_hash(p) for n, p in srcs.items()}
    assert before["a"] != before["b"]
    (tmp_path / "inner.cuh").write_text("// inner, edited\n")
    after = {n: _build._source_hash(p) for n, p in srcs.items()}
    assert after["a"] != before["a"] and after["b"] != before["b"]
    assert after["alone"] == before["alone"]
    # the port's two samplers share csrc/philox.cuh
    for lib in ("fused_ig", "fused_normal"):
        files = _build._source_files(
            os.path.join(_build.CSRC_DIR, f"{lib}.cu"))
        assert os.path.join(_build.CSRC_DIR, "philox.cuh") in files
