"""The reference against the port's plain path at a tiny size on the CPU,
through the harness's own run (the look for a card left out); the control
and the planted faults, which must come out not correct; and, on the card,
the control at each cell's own size."""
import json

import pytest
import torch

from _tiny import REPO, run_cell, tiny_root
from harness import judge, registry

CELLS = [w["name"] for w in json.load(open(f"{REPO}/BENCHMARK.json"))[
    "workloads"]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct(root, name):
    out = run_cell(root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    for c in out["checks"].values():
        assert c["value"] < 1e-4


def _unchanged(monkeypatch):
    from spmf_tpu_torch.vi import minibatch

    monkeypatch.setattr(minibatch, "clip_and_step", lambda opt, clip: None)


def _half_batch(monkeypatch):
    from spmf_tpu_torch.models.poisson import PoissonFactorization
    from spmf_tpu_torch.vi import minibatch

    rows = minibatch._batch_rows
    counts = PoissonFactorization._counts
    monkeypatch.setattr(minibatch, "_batch_rows", lambda b: rows(b) // 2)
    monkeypatch.setattr(
        PoissonFactorization, "_counts",
        lambda self, data: counts(self, data)[:rows(data) // 2]
        if isinstance(data, dict) else counts(self, data))


def _altered_row_ll(monkeypatch):
    from spmf_tpu_torch.models.poisson import PoissonFactorization

    comps = PoissonFactorization.log_likelihood_components

    def altered(self, *a, **k):
        out = comps(self, *a, **k)
        ll = out["log_likelihood"].clone()
        ll[..., 0, :] *= 2.0
        return dict(out, log_likelihood=ll)
    monkeypatch.setattr(PoissonFactorization, "log_likelihood_components",
                        altered)


def _altered_row(monkeypatch):
    from spmf_tpu_torch.models.poisson import PoissonFactorization

    rows = PoissonFactorization._row_log_likelihood

    def altered(self, batch, samples):
        out = rows(self, batch, samples).clone()
        out[..., 0] = out[..., 1]
        return out
    monkeypatch.setattr(PoissonFactorization, "_row_log_likelihood", altered)


def _half_rows(monkeypatch):
    from spmf_tpu_torch.models.poisson import PoissonFactorization

    rows = PoissonFactorization._row_log_likelihood

    def halved(self, batch, samples):
        out = rows(self, batch, samples).clone()
        half = out.shape[-1] // 2
        out[..., half:] = out[..., :half]
        return out
    monkeypatch.setattr(PoissonFactorization, "_row_log_likelihood", halved)


@pytest.mark.parametrize("name, fault", [
    ("k32_train_dense", _unchanged), ("k32_train_dense", _half_batch),
    ("k32_train_dense", _altered_row_ll), ("k32_train_sparse", _unchanged),
    ("k32_train_sparse", _half_batch), ("k32_score", _altered_row),
    ("k32_score", _half_rows)])
def test_a_planted_fault_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    out = run_cell(root, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["k32_train_dense", "k32_score"])
def test_the_control_reads_far_above_the_program(root, name):
    cell = registry.load_cell(name, root=root)
    rows = {r["reading"]: r for r in cell.driver.readings(
        cell, 99, True, torch.device("cpu"))}
    prog, ctrl = rows["program"], rows["control"]
    numbers = ("lppd", "row_lppd") if name == "k32_score" \
        else ("grad_diff",)
    assert max(ctrl[n] / prog[n] for n in numbers) >= 10
    limits = registry.load_cell(name, root=root).limits
    for fault in [r for k, r in rows.items() if k.startswith("fault")]:
        gaps = {n: (fault[n], "") for n in limits if n in fault}
        assert not judge.verdict(gaps, {n: limits[n] for n in gaps})[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    cell = registry.load_cell(name)
    rows = {r["reading"]: r for r in cell.driver.readings(
        cell, 31337, True, torch.device("cuda", 0))}
    for reading in ("program", "control"):
        gaps = {n: (rows[reading][n], "") for n in cell.limits}
        assert judge.verdict(gaps, cell.limits)[1] == (reading == "program")
