"""The reading of the program's spans (``harness/spans.py``) on a trace
made of synthetic host, runtime and device events: the idle inside spans,
the launches, the device time by correlation id, the clock check and the
mirrors of host ranges on the device left out, and the device clock's
drift against the host's put right; and, on the card, that a captured fit
emits one ``graph capture`` per graph and that what the spans read leaves
out the mirrors of the program's spans."""
import pytest
import torch

import _tiny  # noqa: F401  (the benchmark's folder on the path)
from harness import spans
from harness.trace import Trace, _merge

SCORE_RANGES = ("h100bench scoring", ("h100bench score call",))


class _Event:
    def __init__(self, name, start, end, corr=0, device=False):
        self._name, self._start, self._dur = name, start, end - start
        self._corr, self._device = corr, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._device else DeviceType.CPU


class _Prof:
    """What ``Trace`` reads of a ``torch.profiler.profile``."""

    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _trace(extra=(), skew=0):
    """Two scoring calls, the first left out. The second: a draw that
    launches two kernels, a fetch (a synchronous copy) and a reduce. The
    first: a reduce with a kernel in it. A mirror of the fetch span sits on
    the device with a launch's correlation id. The kernels start 100 ns
    after their launch, the least delay: the clock's offset is taken as
    100 ns and every attributed device event read 100 ns earlier.
    ``skew``: how far the copy starts before its launch."""
    cpu = [("h100bench scoring", 0, 10_000), ("h100bench score call", 0,
                                               4_000),
           ("h100bench score call", 5_000, 9_000),
           ("waic reduce", 1_000, 2_000), ("waic draw", 5_000, 5_600),
           ("waic fetch", 5_600, 7_000), ("waic reduce", 7_000, 8_000)]
    runtime = [("cudaLaunchKernel", 1_500, 1_520, 14),
               ("cudaLaunchKernel", 5_100, 5_120, 11),
               ("cudaGraphLaunch", 5_300, 5_320, 12),
               ("cudaMemcpyAsync", 5_700, 6_700, 13)]
    device = [("k3", 1_600, 1_700, 14), ("k1", 5_200, 5_800, 11),
              ("k2", 5_800, 6_500, 12),
              (spans.SYNC_COPY, 6_500 - skew, 6_600 - skew, 13),
              ("waic fetch", 5_600, 7_000, 11),
              ("h100bench score call", 5_200, 6_600, 2)]
    events = [_Event(n, a, b) for n, a, b in cpu]
    events += [_Event(n, a, b, c) for n, a, b, c in runtime]
    events += [_Event(n, a, b, c, device=True) for n, a, b, c in device]
    events += [_Event(*e) for e in extra]
    return Trace(_Prof(events), *SCORE_RANGES, skip=1)


def test_idle_inside_spans():
    t = _trace()
    # the draw: k1, read at 5,100-5,700, covers 5,100-5,600 of 5,000-5,600
    assert spans.idle_s(t, ("waic draw",), "steady") == pytest.approx(100e-9)
    # the fetch: k1, k2 and the copy cover 5,600-6,500 of 5,600-7,000; its
    # mirror, which the trace keeps, is no device work
    assert any(e.name == "waic fetch" for e in t.outer_device)
    assert spans.idle_s(t, ("waic fetch",), "steady") == pytest.approx(500e-9)
    assert spans.idle_s(t, ("waic draw", "waic fetch"), "steady") == \
        pytest.approx(600e-9)
    # the first call's reduce is not steady; over the whole region it is
    assert spans.idle_s(t, ("waic reduce",), "steady") == pytest.approx(1e-6)
    assert spans.idle_s(t, ("waic reduce",), "outer") == \
        pytest.approx(1.9e-6)
    assert spans.idle_s(t, ("waic reduce",), "after") == pytest.approx(1e-6)
    assert spans.wall_s(t, ("waic reduce",), "outer") == pytest.approx(2e-6)


def test_launches_and_device_time_by_correlation():
    t = _trace()
    # a kernel and a graph launch in the draw; a copy is no launch
    assert spans.launches(t, ("waic draw",), "steady") == 2
    assert spans.launches(t, ("waic fetch",), "steady") == 0
    assert spans.launches(t, ("waic reduce",), "outer") == 1
    # k1 and k2 were launched in the draw, wherever they ran
    assert spans.device_s(t, ("waic draw",), "steady") == \
        pytest.approx(1.3e-6)
    assert spans.device_s(t, ("waic fetch",), "steady") == \
        pytest.approx(100e-9)
    assert spans.device_s(t, ("waic reduce",), "steady") == 0


def test_clock_check():
    # every device event starts after its launch: k3 and k1 100 ns after
    t = _trace()
    assert spans.clock_skew_ns(t) == -100
    # the copy, read 100 ns earlier, ends 200 ns before its call returns
    assert spans.copy_overrun_ns(t) == -200
    # a copy that reads as starting 60 us before its launch: the clock's
    # offset near it is taken as -60 us, and every device event there read
    # 60 us later: the copy at 5,700-5,800, k1 and k2 past the call's end
    bad = _trace(skew=60_800)
    assert spans.clock_skew_ns(bad) == 60_000
    assert spans.copy_overrun_ns(bad) == -900
    assert spans.idle_s(bad, ("waic draw",), "steady") == \
        pytest.approx(600e-9)
    assert spans.idle_s(bad, ("waic fetch",), "steady") == \
        pytest.approx(1.3e-6)
    assert spans.launches(bad, ("waic draw",), "steady") == 2
    assert spans.device_s(bad, ("waic draw",), "steady") == \
        pytest.approx(1.3e-6)


def _drifting_trace(offset):
    """2 s of calls, one every 10 ms: a ``waic draw`` span (0-3 ms) whose
    kernel is launched at 1 ms and starts 3 us after its call, on the
    host's clock, for 4 ms; a ``waic reduce`` span (5-9 ms) in which the
    device idles but for the kernel's last 3 us. The device's timestamps
    read ``offset(t)`` ns off the host's."""
    ms = 1_000_000
    ev = [_Event("h100bench scoring", 0, 2_000 * ms),
          _Event("h100bench score call", 0, 1_000 * ms),
          _Event("h100bench score call", 1_000 * ms, 2_000 * ms)]
    for i in range(200):
        t = i * 10 * ms
        launch = t + ms
        ev += [_Event("waic draw", t, t + 3 * ms),
               _Event("waic reduce", t + 5 * ms, t + 9 * ms),
               _Event("cudaLaunchKernel", launch, launch + 5_000, 10 + i)]
        start = launch + 3_000 + offset(launch)
        ev.append(_Event("k", start, start + 4 * ms, 10 + i, device=True))
    return Trace(_Prof(ev), *SCORE_RANGES, skip=1)


@pytest.mark.parametrize("offset", [
    # the device's clock falls behind the host's by 0.4%, as read on the
    # H100, and is set 19 ms late in the middle of the steady calls
    lambda t: -t // 250 + (19_000_000 if t > 1_500_000_000 else 0),
    # it gains 0.1% and is set 3 ms early
    lambda t: t // 1_000 - (3_000_000 if t > 1_500_000_000 else 0)],
    ids=["falls_behind_then_late", "gains_then_early"])
def test_a_drifting_device_clock_is_put_right(offset):
    """The idle inside the spans reads as on one clock, where the raw
    device timestamps, milliseconds off, would put the kernels in the
    reduces."""
    t = _drifting_trace(offset)
    assert abs(spans.clock_skew_ns(t)) > 1_000_000
    # 100 steady reduces, each idle 3.997 ms, and 100 draws, each idle
    # 1.003 ms; the drift over the estimate's window (8 us at most) and
    # the call beside the jump read a little off
    assert spans.idle_s(t, ("waic reduce",), "steady") == \
        pytest.approx(0.3997, rel=0.03)
    assert spans.idle_s(t, ("waic draw",), "steady") == \
        pytest.approx(0.1003, rel=0.03)


def test_mirrors_are_left_out():
    """A device event named like a host range is the profiler's mirror of
    it: no device work, wherever its correlation id lands it."""
    # torch's own optimizer range, mirrored over the idle reduce with a
    # launch's correlation id: the trace keeps it, the spans leave it out
    t = _trace(extra=[("Optimizer.step#Adam.step", 7_000, 7_100),
                      ("Optimizer.step#Adam.step", 7_000, 8_000, 11,
                       True)])
    assert any(e.name.startswith("Optimizer") for e in t.steady_device)
    assert spans.idle_s(t, ("waic reduce",), "steady") == pytest.approx(1e-6)
    assert spans.device_s(t, ("waic draw",), "steady") == \
        pytest.approx(1.3e-6)
    assert spans.clock_skew_ns(t) == -100


def test_a_program_without_spans_reads_none():
    t = Trace(_Prof([_Event("h100bench scoring", 0, 100),
                     _Event("h100bench score call", 0, 50),
                     _Event("h100bench score call", 50, 100),
                     _Event("cudaLaunchKernel", 60, 70, 1),
                     _Event("k", 75, 90, 1, device=True)]),
              *SCORE_RANGES, skip=1)
    for fn in (spans.idle_s, spans.launches, spans.device_s, spans.wall_s):
        assert fn(t, ("waic draw",), "steady") is None
    with pytest.raises(ValueError, match="unknown part"):
        spans.wall_s(t, ("waic draw",), "everywhere")


@pytest.mark.gpu
def test_captured_fit_spans_on_the_card():
    """A fit in chunks on the captured scan: one ``graph capture`` for the
    step and one for the decisions; the spans' mirrors on the device are
    left out of what the spans read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan's graphs")
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset

    dev = torch.device("cuda", 0)
    x = np.random.default_rng(0).poisson(1.0, (256, 40)).astype(float)
    ds = DeviceArrayDataset({"counts": x, "indices": np.arange(256)},
                            batch_size=64, shuffle=True, device=dev)
    m = PoissonFactorization(latent_dim=3, feature_dim=40, dtype="float64",
                             device=dev, data=ds)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("h100bench fit"):
            m.fit(batched_data_factory=ds, num_steps=6, epoch_chunk=2,
                  learning_rate=0.01, sample_size=2, verbose=False,
                  rel_tol=None, seed=0)
            torch.cuda.synchronize(dev)
    assert m.last_fit.extras["captured"] is True
    t = Trace(prof, "h100bench fit", ("fit epoch", "fit chunk"), skip=1)
    host = [e.name for e in t.cpu]
    assert host.count("graph capture") == 2 and host.count("fit chunk") == 3
    assert spans.wall_s(t, ("graph capture",), "outer") > 0
    # the profiler mirrors the spans on the device; a mirror that enters
    # the trace's device events does so by sharing a runtime call's
    # correlation id (trace.py keeps it: PERF.md's open questions); the
    # spans' readings count none of them
    mirrors = [e for e in t.device if e.name in spans.PROGRAM_SPANS]
    assert mirrors
    issued = {e.corr for e in t.runtime}
    assert all(e.corr in issued for e in t.outer_device
               if e.name in spans.PROGRAM_SPANS)
    idx = spans._index(t)
    assert all(e.name in idx.host_names for e in mirrors)
    assert len(idx.intervals) == sum(1 for e in t.device
                                     if e.name not in idx.host_names)
    assert idx.busy == _merge(idx.intervals)
    # the fetches, corrected for the clock, end before their calls return
    assert spans.copy_overrun_ns(t) < spans.EARLY_NS
