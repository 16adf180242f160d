"""The port imports no JAX, and its kernels build only when launched."""
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
)


def test_import_leaves_jax_out_and_builds_nothing():
    code = (
        "import sys\n"
        "import spmf_tpu_torch\n"
        "import spmf_tpu_torch.ops.fused_ig, spmf_tpu_torch.ops.fused_poisson\n"
        "import spmf_tpu_torch.vi, spmf_tpu_torch.utils\n"
        "from spmf_tpu_torch.ops import _build\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'spmf_tpu'))\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS and not _build.BUILD_SECONDS\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
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
