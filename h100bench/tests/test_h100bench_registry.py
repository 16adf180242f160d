"""BENCHMARK.json against the contract's shapes, and the discovery of a
cell's parts by name: a new configuration, traffic mix, metric and cell
arrive as new files and entries, and no file that exists changes."""
import hashlib
import json
import os
import re

import pytest

from _tiny import BENCH, REPO, copy_benchmark
from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["h100bench"]
    assert bench["command"][1].startswith("h100bench/")
    assert 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100bench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_metric_file_agrees_with_its_entry(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        reader = registry.load_reader(
            os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
            (m["unit"], m["layer"], m["moves"])
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)


def test_every_cell_loads_with_its_parts(bench):
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert callable(cell.driver.run) and callable(cell.driver.readings)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert cell.config["reduced"] == []


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_a_new_cell_arrives_as_new_files(tmp_path):
    root = copy_benchmark(tmp_path)
    bench_dir = os.path.join(root, "h100bench")
    before = _digest(bench_dir)
    with open(os.path.join(bench_dir, "configs",
                           "pmf_scrna_d20k_k32.json")) as f:
        config = json.load(f)
    config["model"]["latent_dim"] = 64
    with open(os.path.join(bench_dir, "configs", "pmf_new_k64.json"),
              "w") as f:
        json.dump(config, f)
    with open(os.path.join(bench_dir, "traffic",
                           "train_dense_b4096.json")) as f:
        traffic = json.load(f)
    traffic["batch_size"] = 8192
    with open(os.path.join(bench_dir, "traffic", "train_dense_b8192.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "metrics", "new_metric.py"),
              "w") as f:
        f.write('UNIT = "ms"\nLAYER = "kernels"\n'
                'MOVES = "train_rows_per_s"\n\n\ndef read(ctx):\n'
                '    return None\n')
    with open(os.path.join(bench_dir, "limits", "k64_train_b8192.json"),
              "w") as f:
        json.dump({"loss": 1e-4, "grad": 1e-3, "step": 1e-3}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "pmf_new_k64", "source": "x",
                             "file": "h100bench/configs/pmf_new_k64.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "k64_train_b8192",
                               "config": "pmf_new_k64",
                               "traffic": "train_dense_b8192", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_rows_per_s":
            m["workloads"].append("k64_train_b8192")
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "kernels",
                               "moves": "train_rows_per_s",
                               "workloads": ["k64_train_b8192"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.load_cell("k64_train_b8192", root=root)
    assert cell.config["model"]["latent_dim"] == 64
    assert cell.traffic["batch_size"] == 8192
    assert "new_metric" in [m["name"] for m, _ in cell.per_layer]
    assert cell.limits["loss"] == 1e-4
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
    # a cell that was there before does not take the new cell's metric
    old = registry.load_cell("k32_train_dense", root=root)
    assert "new_metric" not in [m["name"] for m, _ in old.per_layer]


def test_a_new_kind_arrives_as_a_new_file(tmp_path):
    root = copy_benchmark(tmp_path)
    bench_dir = os.path.join(root, "h100bench")
    before = _digest(bench_dir)
    with open(os.path.join(bench_dir, "kinds", "replay.py"), "w") as f:
        f.write('def run(*a):\n    return "replayed"\n\n\n'
                'def readings(*a):\n    return []\n')
    with open(os.path.join(bench_dir, "traffic",
                           "train_dense_b4096.json")) as f:
        traffic = json.load(f)
    traffic["kind"] = "replay"
    with open(os.path.join(bench_dir, "traffic", "replay_b4096.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "limits", "k32_replay.json"),
              "w") as f:
        json.dump({"loss": 1e-4}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "k32_replay",
                               "config": "pmf_scrna_d20k_k32",
                               "traffic": "replay_b4096", "chips": 1,
                               "why": "x"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    cell = registry.load_cell("k32_replay", root=root)
    assert cell.driver.run() == "replayed"
    after = _digest(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("change, named", [
    ({"class": "PoissonAutoencoder"}, "model class"),
    ({"kwargs": {"likelihood_clip": "static"}}, "likelihood_clip"),
    ({"fit": {"antithetic": True}}, "antithetic"),
])
def test_what_the_reference_does_not_follow_is_refused(change, named):
    from harness import reference

    with open(os.path.join(BENCH, "configs",
                           "pmf_scrna_d20k_k32.json")) as f:
        config = json.load(f)
    assert reference.unfollowed(config) == []
    for key, value in change.items():
        group = config if key == "fit" else config["model"]
        if isinstance(value, dict):
            group[key] = dict(group.get(key, {}), **value)
        else:
            group[key] = value
    with pytest.raises(ValueError, match=named):
        reference.require_followed(config)
