"""The run's last line, and that a run without a card fails and prints no
result: the measuring path never falls back to the CPU."""
import json
import os
import subprocess
import sys
import types

import pytest

from _tiny import BENCH, REPO, copy_benchmark


def _no_card_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("where", ["checkout", "benchmark_alone"])
def test_no_card_no_result(tmp_path, where):
    cwd = REPO if where == "checkout" else copy_benchmark(tmp_path)
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload", "k32_train_dense",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=_no_card_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert not line.startswith("{")


def test_last_line(monkeypatch, capsys):
    import torch

    sys.path.insert(0, BENCH)
    import run
    from harness import registry

    canned = {"correct": True, "attempted": 400, "failed": 0,
              "peak": 123456789,
              "metrics": {"train_rows_per_s": {"value": 2.5e5,
                                               "unit": "rows/s"},
                          "setup_s": {"value": 20.0, "unit": "s"}},
              "checks": {"loss": {"value": 1e-7, "limit": 1e-5},
                         "grad": {"value": 2e-6, "limit": 1e-4}}}
    load = registry.load_cell

    def canned_cell(*a, **k):
        cell = load(*a, **k)
        cell.driver = types.SimpleNamespace(run=lambda *a, **k: dict(canned))
        return cell
    monkeypatch.setattr(registry, "load_cell", canned_cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert run.main(["--workload", "k32_train_dense", "--seed", "7",
                     "--seconds", "1", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["device"] == {"platform": "gpu",
                                "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                                "memory_peak_bytes": 123456789}
    assert result["metrics"] == canned["metrics"]
    tail = err.strip().splitlines()[-2:]
    assert tail == ["h100bench check loss: 1e-07 limit 1e-05",
                    "h100bench check grad: 2e-06 limit 0.0001"]
