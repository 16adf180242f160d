"""A copy of the benchmark at a size the CPU runs in seconds, for the CPU
tests: the same files, with every configuration cut to D = 48 genes and
every traffic mix to batches of 64 rows."""
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, REPO) if p not in sys.path]


def copy_benchmark(dest):
    """BENCHMARK.json and the benchmark's folder, as they are, under
    ``dest``."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(BENCH, os.path.join(dest, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "_out", "tests"))
    return str(dest)


def tiny_root(dest):
    root = copy_benchmark(dest)
    bench = os.path.join(root, "h100bench")
    for name in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", name)
        with open(path) as f:
            c = json.load(f)
        c["model"]["feature_dim"] = 48
        c["model"]["latent_dim"] = 3 if c["model"]["latent_dim"] <= 32 else 5
        c["data"]["rows"] = 256
        c["data"]["log_mean"] = 0.5
        with open(path, "w") as f:
            json.dump(c, f)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            t = json.load(f)
        t["batch_size"] = 64
        t["epochs"] = {"lead": 0, "step": 1, "min": 1}
        t["warmup_epochs"] = 1
        if t["kind"] == "score":
            t.update(pool_blocks=4, num_samples=12)
        with open(path, "w") as f:
            json.dump(t, f)
    return root


def run_cell(root, name, seed=20241018, seconds=0.05):
    """A run of ``name`` on the CPU, the look for a card left out: the
    result's fields (metrics, checks, correct, ...)."""
    import torch

    from harness import registry

    cell = registry.load_cell(name, root=root)
    t0 = time.time()
    return cell.driver.run(cell, seed, seconds, False, torch.device("cpu"),
               lambda: time.time() - t0, lambda msg: None)
