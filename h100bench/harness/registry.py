"""Finds a cell's parts by name. ``BENCHMARK.json`` (at the checkout's
root) names each cell's configuration and traffic mix; each of those is a
file of its own (``configs/<name>.json``, ``traffic/<name>.json``), each
per-layer metric a reader of its own (``metrics/<name>.py``), each kind
of cell a driver of its own (``kinds/<kind>.py``, named by the mix's
``kind``), and each cell's limits for ``correct`` a file of its own
(``limits/<cell>.json``). A later change adds a cell, a configuration, a
mix, a metric or a kind as new files and entries, without editing a file
that exists."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: the cell's end-to-end metrics (their BENCHMARK.json entries)
    end_to_end: list = field(default_factory=list)
    #: the cell's per-layer metrics: (entry, reader module)
    per_layer: list = field(default_factory=list)
    #: the driver of the mix's kind (``kinds/<kind>.py``): ``run`` and
    #: ``readings``
    driver: object = None


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_reader(path, prefix="h100bench_metric_"):
    """A per-layer metric's reader module, or a kind's driver, loaded from
    its file (a metric's name may hold dots, so it is not imported by
    name)."""
    spec = importlib.util.spec_from_file_location(
        prefix + os.path.basename(path)[:-3].replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(entry, cell_name, cell_e2e):
    """Whether a metric entry is reported in a cell: its ``workloads``
    list, or, without one, every cell that reports what it moves."""
    if "workloads" in entry:
        return cell_name in entry["workloads"]
    if "moves" in entry:
        return entry["moves"] in cell_e2e
    return True


def load_benchmark(root=ROOT):
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(name, root=ROOT):
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files."""
    bench = load_benchmark(root)
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [(m, load_reader(os.path.join(bench_dir, "metrics",
                                              m["name"] + ".py")))
                 for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    driver = load_reader(os.path.join(bench_dir, "kinds",
                                      traffic["kind"] + ".py"),
                         prefix="h100bench_kind_")
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic, limits=limits,
                end_to_end=e2e, per_layer=per_layer, driver=driver)
