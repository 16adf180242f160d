"""The autoencoder's cell (``kinds/ae_train.py``, ``harness/ae_reference.py``,
``harness/ae_counts.py``, ``harness/ae_spans.py`` and its four metrics) at a
tiny size on the CPU, the look for a card left out: a run is correct and the
planted faults are not, the control reads far above the program, the
yardstick against a hand count, the step spans' attribution on made-up
events and on a real profile, and the readers on a context that lacks what
they read (a program without the spans)."""
import types

import numpy as np
import pytest
import torch

from _tiny import run_cell, tiny_root
from harness import ae_counts, ae_spans, judge, registry

CELL = "ae_train_dense"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def test_a_run_is_correct_and_reports_its_metrics(root):
    out = run_cell(root, CELL)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"train_rows_per_s", "setup_s"}
    assert set(out["checks"]) == {"loss", "grad", "step", "grad_diff"}


def _unchanged(monkeypatch):
    from spmf_tpu_torch.vi import minibatch

    monkeypatch.setattr(minibatch, "clip_and_step", lambda opt, clip: None)


def _half_batch(monkeypatch):
    from spmf_tpu_torch.models.autoencoder import PoissonAutoencoder
    from spmf_tpu_torch.vi import minibatch

    rows = minibatch._batch_rows
    counts = PoissonAutoencoder._tile_counts
    monkeypatch.setattr(minibatch, "_batch_rows", lambda b: rows(b) // 2)
    monkeypatch.setattr(PoissonAutoencoder, "_tile_counts",
                        lambda self, data: counts(self, data)[
                            :rows(data) // 2])


def _no_prior(monkeypatch):
    from spmf_tpu_torch.models.autoencoder import PoissonAutoencoder

    parts = PoissonAutoencoder._prior_parts
    monkeypatch.setattr(PoissonAutoencoder, "_prior_parts", lambda self, p: {
        k: 0.0 * v for k, v in parts(self, p).items()})


def _forgets(monkeypatch):
    """Adam's state is not carried from one step into the next: each step
    is a first step, which the one-step check cannot tell apart."""
    from spmf_tpu_torch.vi import minibatch

    step = minibatch.clip_and_step

    def forget(opt, clip):
        opt.state.clear()
        step(opt, clip)
    monkeypatch.setattr(minibatch, "clip_and_step", forget)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_prior,
                                   _forgets])
def test_a_planted_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(root, CELL)
    assert not out["correct"], out["checks"]


def test_the_control_reads_far_above_the_program(root):
    cell = registry.load_cell(CELL, root=root)
    rows = {r["reading"]: r for r in cell.driver.readings(
        cell, 99, True, torch.device("cpu"))}
    assert set(rows) == {"program", "program_pole", "control",
                         "fault_half_batch"}
    assert set(rows["program_pole"]["where"]) == {
        "grad_all", "grad_diff_all", "top_share", "flips"}
    assert 0 < rows["program_pole"]["top_share"] <= 1
    assert rows["control"]["grad_diff"] >= 10 * rows["program"]["grad_diff"]
    for reading in ("control", "fault_half_batch"):
        gaps = {n: (rows[reading][n], "") for n in cell.limits}
        assert not judge.verdict(gaps, cell.limits)[1], reading
    gaps = {n: (rows["program"][n], "") for n in cell.limits}
    assert judge.verdict(gaps, cell.limits)[1]


def test_the_yardstick_by_hand():
    # widths 4 -> 4 -> 2 -> 4 -> 4, one sample, one row: the forward 2 (16 +
    # 8 + 8 + 16) = 96, the weights' gradients 96, the inputs' gradients
    # but the first layer's 2 (8 + 8 + 16) = 64
    dims = [4, 4, 2, 4, 4]
    assert ae_counts.network_flops(1, 1, dims) == 96 + 96 + 64
    assert ae_counts.network_flops(8, 4096, dims) == 8 * 4096 * 256
    # weights 16 + 8 + 8 + 16, biases 4 + 2 + 4 + 4
    assert ae_counts.prior_elements(dims) == 48 + 14
    assert ae_counts.prior_bytes(3, dims) == 2 * 4 * 3 * 62


def test_the_yardstick_at_the_cells_size():
    D, K, S, B = 2000, 32, 8, 4096
    dims = [D, D, K, D, D]
    assert ae_counts.network_flops(S, B, dims) == S * B * (
        10 * D * D + 12 * D * K) == 1_335_885_824_000
    assert ae_counts.prior_elements(dims) == 8_134_032
    assert ae_counts.prior_bytes(S, dims) == 520_578_048
    assert ae_counts.prior_seconds(S, dims) == pytest.approx(
        520_578_048 / 3.35e12)


B = ae_spans.BACKWARD


def _made_up():
    """A span on thread 1 whose two operations make nodes 5 and 6 and whose
    last one reads 7, which an operation after the span makes; the backward
    on thread 2; each launch call issues one device event."""
    H = ae_spans.HostEvent
    host = [H("ae prior", 100, 200, 1, -1, 0),
            H("aten::mul", 110, 130, 1, 5, 0),
            H("cudaLaunchKernel", 115, 116, 1, -1, 0, corr=1),
            H("aten::div", 140, 160, 1, 6, 0),
            H("cudaLaunchKernel", 145, 146, 1, -1, 0, corr=2),
            H("aten::to", 170, 180, 1, 7, 0),
            H("aten::add", 210, 220, 1, 7, 0),
            H("cudaLaunchKernel", 212, 213, 1, -1, 0, corr=3),
            H(B + "AddBackward0", 300, 310, 2, 7, 1),
            H("cudaLaunchKernel", 301, 302, 2, -1, 0, corr=4),
            H(B + "DivBackward0", 320, 330, 2, 6, 1),
            H("cudaLaunchKernel", 321, 322, 2, -1, 0, corr=5),
            H(B + "MulBackward0", 340, 350, 2, 5, 1),
            H("cudaLaunchKernel", 341, 342, 2, -1, 0, corr=6),
            # a span whose forward issued nothing (a capture)
            H("ae prior", 400, 500, 1, -1, 0),
            H("aten::mul", 410, 430, 1, 8, 0),
            H(B + "MulBackward0", 600, 610, 2, 8, 1),
            H("cudaLaunchKernel", 601, 602, 2, -1, 0, corr=7)]
    D = ae_spans.DeviceEvent
    dev = [D("k1", 120, 1120, 1), D("k2", 150, 2150, 2), D("k3", 230, 330, 3),
           D("k4", 303, 10303, 4), D("k5", 323, 20323, 5),
           D("k6", 343, 40343, 6), D("k7", 603, 903, 7),
           # a mirror of the span on the device
           D("ae prior", 100, 99100, 2)]
    return host, dev


def test_step_spans_on_made_up_events():
    st = ae_spans.StepSpans(*_made_up())
    span = st.host[0]
    assert [e.name for e in st.backward_ranges(span)] == [
        B + "MulBackward0", B + "DivBackward0"]
    # forward k1 + k2, backward k6 + k5; not k3 and k4 (node 7, made after
    # the span), not the mirror, not the second span (nothing ran forward)
    assert st.step_ns("ae prior") == [1000 + 2000 + 40000 + 20000]
    assert st.ms_per_step("ae prior") == 63000 / 1e6
    assert st.ms_per_step("ae network") is None


def test_step_spans_on_a_cpu_profile():
    """A profiled CPU fit of one epoch: each span's backward ranges are its
    own nodes' (the prior's E1, the network's batched products)."""
    from torch.profiler import ProfilerActivity, profile

    from spmf_tpu_torch import PoissonAutoencoder
    from spmf_tpu_torch.data import DeviceArrayDataset

    x = np.random.default_rng(4).poisson(1.0, (32, 6)).astype(float)
    ds = DeviceArrayDataset({"data": x}, batch_size=16, shuffle=True,
                            device="cpu")
    m = PoissonAutoencoder(ds, latent_dim=2, column_norms=x.mean(0) + 0.1,
                           dtype="float64", device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.fit(batched_data_factory=ds, num_steps=1, learning_rate=0.01,
              sample_size=2, verbose=False, rel_tol=None, seed=0)
    st = ae_spans.StepSpans(*ae_spans.from_profiler(prof))
    names = {}
    for span in st.host:
        if span.name in ("ae prior", "ae network"):
            names.setdefault(span.name, []).append(
                {e.name[len(B):] for e in st.backward_ranges(span)})
    # the initial loss (no gradient), then the two steps
    assert [len(n) for n in names["ae prior"]] [0] == 0
    assert len(names["ae prior"]) == len(names["ae network"]) == 3
    for prior, network in zip(names["ae prior"][1:], names["ae network"][1:]):
        assert "_LogExp1Backward" in prior and "BmmBackward0" not in prior
        assert "BmmBackward0" in network and "_LogExp1Backward" not in network
    # no device on the CPU: nothing counted
    assert st.ms_per_step("ae prior") is None


def _reader(name):
    return dict((m["name"], r) for m, r in registry.load_cell(CELL).per_layer)[
        name]


NEW = ("ae_train_mfu", "weight_prior_ms_per_step", "weight_prior_roofline",
       "network_ms_per_step")


def _ctx(step_spans=None, dims=True):
    from harness import cells

    shape = {"S": 8, "B": 4096, "D": 2000, "K": 32, "nnz": None}
    if dims:
        shape["dims"] = [2000, 2000, 32, 2000, 2000]
    trace = types.SimpleNamespace(steady_wall_s=16 * 0.1)
    ctx = cells.Context("train", trace, shape, steps=16)
    if step_spans is not None:
        ctx.step_spans = step_spans
    return ctx


def test_the_readers():
    spans = types.SimpleNamespace(ms_per_step=lambda name: {
        "ae prior": 60.0, "ae network": 35.0}[name])
    ctx = _ctx(spans)
    got = {n: _reader(n).read(ctx) for n in NEW}
    assert got["weight_prior_ms_per_step"] == 60.0
    assert got["network_ms_per_step"] == 35.0
    assert got["weight_prior_roofline"] == pytest.approx(
        100 * 520_578_048 / 3.35e12 / 0.060)
    assert got["ae_train_mfu"] == pytest.approx(
        100 * 1_335_885_824_000 / 0.1 / 494.7e12)


def test_the_readers_without_what_they_read():
    """A program without the spans (the parent of the spans) or a context of
    another cell: each reader gives None and does not raise."""
    none = types.SimpleNamespace(ms_per_step=lambda name: None)
    for ctx in (_ctx(), _ctx(none), _ctx(dims=False)):
        for n in NEW[1:]:
            assert _reader(n).read(ctx) is None
    assert _reader("ae_train_mfu").read(_ctx(dims=False)) is None
