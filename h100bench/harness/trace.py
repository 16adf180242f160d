"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read. It reads the profiler's raw kineto events: building its
``key_averages()`` takes minutes at the 10^5 kernels of a traced fit.

A device event belongs to a host range when the CUDA runtime call that
issued it (kernel, graph or copy launch: the two share a correlation id)
started inside the range. That attribution is immune to an offset between
the host's and the device's clocks; graph-replayed kernels carry their
graph launch's id."""
from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass


def _ns(e, what):
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


@dataclass
class Event:
    name: str
    start: int          # ns
    end: int            # ns
    corr: int


def _merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _clipped_length(merged, lo, hi):
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in merged)


class Trace:
    """The events of one profiled region. ``outer``: the name of the
    benchmark's own range around all of it; ``steady``: the names of the
    ranges whose device work the steady metrics read, of which the first
    ``skip`` are left out (the first holds a capture)."""

    def __init__(self, prof, outer, steady, skip=0):
        from torch.autograd import DeviceType

        cpu, dev = [], []
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, "start")
            ev = Event(e.name(), start, start + _ns(e, "duration"),
                       int(e.correlation_id() or 0))
            (dev if e.device_type() == DeviceType.CUDA else cpu).append(ev)
        range_names = set(steady) | {outer}
        # the profiler mirrors host ranges on the device timeline
        self.device = [e for e in dev if e.name not in range_names]
        self.cpu = cpu
        outers = sorted((e.start, e.end) for e in cpu if e.name == outer)
        if not outers:
            raise ValueError(f"no {outer!r} range in the trace")
        self.outer = (outers[0][0], outers[-1][1])
        self.windows = sorted((e.start, e.end) for e in cpu
                              if e.name in steady)[skip:]
        self.runtime = [e for e in cpu if e.name.startswith("cu")
                        and e.start >= self.outer[0]
                        and e.start < self.outer[1]]
        self._starts = [a for a, _ in self.windows]
        issued_in = {e.corr: e.start for e in self.runtime if e.corr}
        self.outer_device = [e for e in self.device if e.corr in issued_in]
        self.steady_device = [e for e in self.outer_device
                              if self.in_windows(issued_in[e.corr])]

    def in_windows(self, t):
        i = bisect.bisect_right(self._starts, t) - 1
        return i >= 0 and t < self.windows[i][1]

    # ----------------------------------------------------------- steady
    @property
    def steady_wall_s(self):
        return sum(b - a for a, b in self.windows) / 1e9

    def steady_busy_s(self):
        merged = _merge((e.start, e.end) for e in self.steady_device)
        return sum(b - a for a, b in merged) / 1e9

    def steady_launches(self):
        """The CUDA runtime's kernel and graph launches issued inside the
        steady ranges."""
        return sum(1 for e in self.runtime if "Launch" in e.name
                   and self.in_windows(e.start))

    def steady_kernels(self, match):
        """(name, seconds) of the steady device events whose name
        ``match`` accepts."""
        return [(e.name, (e.end - e.start) / 1e9) for e in self.steady_device
                if match(e.name)]

    def steady_kernels_by_window(self, match):
        """``steady_kernels`` split by steady range, each in launch
        order."""
        issued = {e.corr: e.start for e in self.runtime if e.corr}
        out = [[] for _ in self.windows]
        for e in sorted(self.steady_device, key=lambda e: e.start):
            if match(e.name):
                i = bisect.bisect_right(self._starts, issued[e.corr]) - 1
                out[i].append((e.name, (e.end - e.start) / 1e9))
        return out

    # ------------------------------------------------------------ outer
    @property
    def window_s(self):
        return (self.outer[1] - self.outer[0]) / 1e9

    def busy_s(self):
        merged = _merge((e.start, e.end) for e in self.outer_device)
        return _clipped_length(merged, *self.outer) / 1e9

    def breakdown(self, top=10):
        """The device operations that took most time, and the longest idle
        stretches of the device summed by the innermost host operation
        running when each began: each list of (name, seconds), at most
        ``top`` long."""
        ops = Counter()
        for e in self.outer_device:
            ops[e.name[:160]] += (e.end - e.start) / 1e9
        lo, hi = self.outer
        merged = _merge((max(e.start, lo), min(e.end, hi))
                        for e in self.outer_device)
        gaps, t = [], lo
        for a, b in merged:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        host = sorted((e.start, e.end, e.name) for e in self.cpu
                      if e.end > lo and e.start < hi)
        starts = [h[0] for h in host]
        idle = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:5000]:
            i = bisect.bisect_right(starts, a) - 1
            name = "(no host operation)"
            # the innermost operation covering a: the latest-starting one
            # among the recent ones that has not ended
            for j in range(i, max(i - 400, -1), -1):
                if host[j][1] > a:
                    name = host[j][2]
                    break
            idle[name[:160]] += (b - a) / 1e9
        order = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops.most_common(top)],
                "idle_gaps": [[k, v] for k, v in order]}
