"""The port's profiler spans (``spmf_tpu_torch/utils/spans.py``): which
spans ``log_likelihood`` and ``fit`` emit under ``torch.profiler``, in what
order and how often; that with no profiler recording ``span`` is one
shared no-op and no ``record_function`` is entered; that the spans change
nothing the program computes; and that no span name is mistaken for a
kernel by the benchmark's per-layer metrics."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spmf_tpu_torch import (PoissonAutoencoder, PoissonFactorization,
                            PoissonMatrixFactorization)
from spmf_tpu_torch.data import DeviceArrayDataset, SparseCounts
from spmf_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "h100bench")
WAIC_SPANS = ("waic draw", "waic row_ll", "waic fetch", "waic reduce")


def _events(prof):
    """(name, start ns, end ns) of the profiler's host events named after
    a span or ``test call``, in start order."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans.SPANS or e.name() == "test call":
            out.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
    return sorted(out, key=lambda t: t[1])


def _counts(events):
    names = [n for n, _, _ in events]
    return {n: names.count(n) for n in set(names)}


def _scorer():
    X = np.random.default_rng(5).poisson(1.0, (48, 7)).astype(float)
    m = PoissonMatrixFactorization(None, latent_dim=2, feature_dim=7,
                                   column_norms=X.mean(0, keepdims=True),
                                   dtype="float32", device="cpu")
    blocks = DeviceArrayDataset({"counts": X}, batch_size=24, device="cpu")
    return m, blocks


def _dense_fit(num_steps=3, **kw):
    X = np.random.default_rng(2).poisson(1.0, (60, 5)).astype(float)
    ds = DeviceArrayDataset({"counts": X, "indices": np.arange(60)},
                            batch_size=20, shuffle=True, device="cpu")
    m = PoissonFactorization(latent_dim=2, feature_dim=5, u_tau_scale=0.1,
                             dtype="float64", device="cpu", data=ds)
    losses = m.fit(batched_data_factory=ds, num_steps=num_steps,
                   learning_rate=0.05, sample_size=2, verbose=False,
                   rel_tol=None, seed=0, **kw)
    return m, losses


def _sparse_fit(num_steps=3):
    rng = np.random.default_rng(3)
    X = (rng.random((64, 9)) < 0.4) * rng.poisson(2.0, (64, 9))
    m = PoissonFactorization(latent_dim=2, feature_dim=9, u_tau_scale=0.1,
                             dtype="float64", scale_columns=False,
                             device="cpu")
    ds = SparseCounts.from_dense(X).shuffle(seed=0).batch(
        32, drop_remainder=True).to_device(device="cpu", dtype="float64")
    losses = m.fit(batched_data_factory=ds, num_steps=num_steps,
                   learning_rate=0.05, sample_size=2, verbose=False,
                   rel_tol=None, seed=0)
    return m, losses


def _autoencoder():
    X = np.random.default_rng(4).poisson(1.0, (32, 6)).astype(float)
    ds = DeviceArrayDataset({"data": X}, batch_size=16, shuffle=True,
                            device="cpu")
    m = PoissonAutoencoder(ds, latent_dim=2, column_norms=X.mean(0) + 0.1,
                           dtype="float64", device="cpu")
    return m, ds


def _ae_fit(m, ds, num_steps=2):
    return m.fit(batched_data_factory=ds, num_steps=num_steps,
                 learning_rate=0.01, sample_size=2, verbose=False,
                 rel_tol=None, seed=0)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test call"):
            out = fn()
    return out, _events(prof)


def test_log_likelihood_spans_each_chunk_in_order():
    """100 samples in chunks of 8: 13 chunks a batch, each drawn, scored,
    fetched and reduced in that order, inside the call; two batches."""
    m, blocks = _scorer()
    out, events = _profiled(lambda: m.log_likelihood(
        data=blocks, num_samples=100, sample_chunk=8))
    assert out["n_rows"] == 48
    call = [e for e in events if e[0] == "test call"]
    assert len(call) == 1
    _, lo, hi = call[0]
    waic = [e for e in events if e[0] in WAIC_SPANS]
    assert _counts(waic) == {n: 2 * 13 for n in WAIC_SPANS}
    assert all(lo <= a and b <= hi for _, a, b in waic)
    assert [n for n, _, _ in waic] == list(WAIC_SPANS) * 26
    for (_, _, end), (_, start, _) in zip(waic, waic[1:]):
        assert end <= start


def test_dense_fit_spans_each_epoch():
    """Single epochs over a DeviceArrayDataset: one epoch range, one
    permutation and one bookkeeping span an epoch, no capture on the
    CPU."""
    _, events = _profiled(lambda: _dense_fit(num_steps=3))
    assert _counts(events) == {"test call": 1, "fit epoch": 3,
                               "epoch permutation": 3, "fit bookkeep": 3}
    order = [n for n, _, _ in events if n != "test call"]
    assert order == ["fit epoch", "epoch permutation", "fit bookkeep"] * 3


def test_chunked_fit_spans_each_chunk():
    """Chunks of 2 epochs: a chunk range and one bookkeeping span a chunk
    (its replay, checkpoint and convergence test), a permutation an
    epoch."""
    _, events = _profiled(lambda: _dense_fit(num_steps=4, epoch_chunk=2))
    assert _counts(events) == {"test call": 1, "fit chunk": 2,
                               "epoch permutation": 4, "fit bookkeep": 2}
    assert [n for n, _, _ in events if n in ("fit chunk", "fit bookkeep")] \
        == ["fit chunk", "fit bookkeep"] * 2


def test_sparse_fit_spans_the_epoch_decode():
    """The flat CSR layout also decodes each epoch, inside its range, after
    its permutation; the dataset's own iterator decodes under the same
    name."""
    _, events = _profiled(lambda: _sparse_fit(num_steps=3))
    assert _counts(events) == {"test call": 1, "fit epoch": 3,
                               "epoch permutation": 3, "epoch decode": 3,
                               "fit bookkeep": 3}
    order = [n for n, _, _ in events if n != "test call"]
    assert order == ["fit epoch", "epoch permutation", "epoch decode",
                     "fit bookkeep"] * 3
    ds = SparseCounts.from_dense(np.eye(8)).batch(4).to_device(device="cpu")
    batches, events = _profiled(lambda: list(ds))
    assert len(batches) == 2
    assert _counts(events) == {"test call": 1, "epoch decode": 1}


def test_autoencoder_spans_each_energy():
    """An autoencoder fit evaluates its energy once for the initial loss
    and once a step (2 epochs of 2 batches): each time ``ae prior`` and
    then ``ae network``, inside the call and never overlapping;
    ``log_likelihood`` runs ``ae network`` once a chunk (2 chunks of 2
    batches) and no prior."""
    m, ds = _autoencoder()
    _, events = _profiled(lambda: _ae_fit(m, ds))
    ae = [(n, a, b) for n, a, b in events if n.startswith("ae ")]
    assert [n for n, _, _ in ae] == ["ae prior", "ae network"] * 5
    for (_, _, end), (_, start, _) in zip(ae, ae[1:]):
        assert end <= start
    _, events = _profiled(lambda: m.log_likelihood(data=ds, num_samples=12,
                                                   sample_chunk=8))
    assert _counts([e for e in events if e[0].startswith("ae ")]) == {
        "ae network": 4}


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler recording, ``span`` hands out the one shared no-op,
    and a fit (single epochs and chunks) and a scoring call enter no
    ``record_function``."""
    assert spans.span("fit epoch") is spans.span("waic draw")
    assert isinstance(spans.span("fit epoch"), type(spans._OFF))
    entered = []

    def counting(name, *a, **k):
        entered.append(name)
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _dense_fit(num_steps=2)
    _dense_fit(num_steps=4, epoch_chunk=2)
    _sparse_fit(num_steps=1)
    m, blocks = _scorer()
    m.log_likelihood(data=blocks, num_samples=12, sample_chunk=8)
    ae, ds = _autoencoder()
    _ae_fit(ae, ds, num_steps=1)
    ae.log_likelihood(data=ds, num_samples=12, sample_chunk=8)
    assert entered == []


def _annotations(prof):
    """The names of the host ranges a profile recorded, torch's own
    optimizer ranges left out."""
    return {e.name() for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()
            and not e.name().startswith("Optimizer.")}


def test_every_name_seen_is_listed():
    """Each range a profiled fit and scoring call emit (the
    factorizations' and the autoencoder's), and the card's ``graph
    capture``, is in ``SPANS``, and ``SPANS`` holds nothing else."""
    seen = set()
    m, blocks = _scorer()
    ae, ds = _autoencoder()
    for fn in (lambda: _dense_fit(num_steps=4, epoch_chunk=2),
               lambda: _dense_fit(num_steps=1), lambda: _sparse_fit(1),
               lambda: m.log_likelihood(data=blocks, num_samples=12,
                                        sample_chunk=8),
               lambda: _ae_fit(ae, ds, num_steps=1),
               lambda: ae.log_likelihood(data=ds, num_samples=12,
                                         sample_chunk=8)):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        seen |= _annotations(prof)
    assert seen | {"graph capture"} == set(spans.SPANS)


def test_spans_change_nothing_computed():
    """``waic`` and ``fit`` give the same bits with a profiler recording
    and without."""
    m, blocks = _scorer()

    def score():
        return m.waic(data=blocks, num_samples=20, sample_chunk=8, seed=3)

    plain = score()
    traced, _ = _profiled(score)
    assert plain == traced
    fit_plain = _dense_fit(num_steps=4, epoch_chunk=2)
    fit_traced, _ = _profiled(lambda: _dense_fit(num_steps=4, epoch_chunk=2))
    assert fit_plain[1] == fit_traced[1]
    for name, sub in fit_plain[0].surrogate_params.items():
        for k, t in sub.items():
            assert torch.equal(t, fit_traced[0].surrogate_params[name][k])


def _kernel_patterns():
    """The ``KERNELS`` regex of each of the benchmark's metric readers that
    has one, each reader loaded from its file."""
    import importlib.util
    import sys

    sys.path.insert(0, BENCH)
    loaded = set(sys.modules)
    try:
        out = {}
        for path in sorted(glob.glob(os.path.join(BENCH, "metrics",
                                                  "*.py"))):
            spec = importlib.util.spec_from_file_location(
                "metric_" + os.path.basename(path)[:-3].replace(".", "_"),
                path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            if hasattr(module, "KERNELS"):
                out[os.path.basename(path)] = module.KERNELS
        return out
    finally:
        sys.path.remove(BENCH)
        for name in set(sys.modules) - loaded:
            del sys.modules[name]


@pytest.mark.parametrize("name", spans.SPANS)
def test_no_span_reads_as_a_kernel(name):
    """A span's mirrored device event must match no metric's kernel
    pattern, were it to enter the trace's device events."""
    patterns = _kernel_patterns()
    assert patterns
    hits = [f for f, rx in patterns.items() if rx.search(name)]
    assert not hits, (name, hits)
