"""The import guard, and that nothing of the benchmark imports JAX, the JAX
package or the repository's older benchmark scripts."""
import ast
import os

import pytest

from _tiny import BENCH
from harness import guard


@pytest.mark.parametrize("modules, found", [
    (["spmf_tpu_torch", "spmf_tpu_torch.ops.fused_poisson", "torch"], []),
    (["spmf_tpu", "spmf_tpu.models"], ["spmf_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["spmf_tpu_torchx", "jaxtyping", "flaxen"], []),
])
def test_top_level_names_compared_whole(modules, found):
    assert guard.forbidden_loaded(modules) == found


def test_guard_stops_a_run():
    with pytest.raises(SystemExit) as exc:
        guard.check_imports(["spmf_tpu_torch", "spmf_tpu.ops"])
    assert exc.value.code != 0
    guard.check_imports(["spmf_tpu_torch", "numpy"])


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_source_imports_what_it_may_not():
    banned = set(guard.FORBIDDEN) | {"benchmarks", "bench", "chip_smoke"}
    seen = []
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                for mod in _imports(path):
                    if mod.split(".", 1)[0] in banned:
                        seen.append((path, mod))
                with open(path) as f:
                    text = f.read()
                for word in ("chip_smoke", "bench.py", "benchmarks/"):
                    if word in text and name != os.path.basename(__file__):
                        seen.append((path, word))
    assert seen == []


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "counts.py", "datagen.py", "judge.py"):
        mods = set(_imports(os.path.join(BENCH, "harness", name)))
        assert not any(m.split(".", 1)[0] == "spmf_tpu_torch" for m in mods)
