"""The program's own spans in a trace, read against the device's events.

The port marks its host-side layer boundaries with
``torch.profiler.record_function`` ranges (``spmf_tpu_torch/utils/
spans.py``), so they share the profiler's clock with the device's events.
For a set of span names and a part of the trace (``where``):

- ``wall_s``: the spans' host wall (the union of their intervals);
- ``idle_s``: the device's idle inside the spans: their union less the
  union of the device's kernels, copies and memsets;
- ``launches``: the CUDA runtime's kernel and graph launches issued inside
  the spans;
- ``device_s``: the device time of the operations whose launch call began
  inside the spans (by correlation id, as ``trace.py`` attributes them:
  graph-replayed kernels carry their graph launch's id).

``where``: 'steady' (spans that begin inside the steady ranges), 'after'
(spans that begin once the first steady range has begun: the host's work
between ranges) or 'outer' (every span in the traced region).

The profiler mirrors each host range (a ``record_function``: the
program's spans, the benchmark's ranges, torch's own optimizer ranges) on
the device's timeline as an event of the same name, whose correlation id
may equal a runtime call's. A device event named like a host event is such
a mirror, no device work, and is left out here.

``idle_s`` intersects host and device times. The profiler's device
timestamps drift against the host's: on the H100 by up to 4 ms a second,
with jumps of up to 19 ms where they are set again, early or late, so that
device events may read as starting milliseconds before the call that
launched them. Before ``idle_s`` reads them, each device event attributed
to a launch is moved by the clock's offset at its launch, estimated as the
least (device start - launch start) over the launches within
``OFFSET_WINDOW_NS`` to ``2 * OFFSET_WINDOW_NS`` of it: a launch onto an
idle device starts a few us after its call, so the least delay near a time
is the offset there, to within those us and the drift over the window.
Where the device stays behind its launches for longer than the window (a
queue of graph replays) the estimate is the queue's delay too, and moves
that work back towards its launch; no span whose idle a metric reads lies
in such a stretch. ``clock_skew_ns`` is the most by which a device event
starts before its launch before the correction. A synchronous copy ends on
the device before its call returns; ``copy_overrun_ns`` is the most by
which a corrected one does not, the size of any offset the correction
missed. Each function gives None where the trace holds none of the spans
(a program without them)."""
from __future__ import annotations

import bisect
import sys
from collections import Counter
from itertools import accumulate

from harness.trace import _merge

#: the names of the program's spans (``SPANS`` in the program's
#: ``utils/spans.py``)
PROGRAM_SPANS = frozenset({
    "fit epoch", "fit chunk", "fit bookkeep", "graph capture",
    "epoch permutation", "epoch decode",
    "waic draw", "waic row_ll", "waic fetch", "waic reduce"})
#: the width of the buckets over which the clock's offset is estimated
OFFSET_WINDOW_NS = 2_000_000
#: the name of a synchronous copy's device event: a device-to-pageable one,
#: whose call returns once the copy has ended
SYNC_COPY = "Memcpy DtoH (Device -> Pageable)"
#: how far before its launch a device event reads as early in the report
EARLY_NS = 50_000


class _Index:
    """What the functions share, built once a trace."""

    def __init__(self, trace):
        lo, hi = trace.outer
        self.by_name = {}
        for e in trace.cpu:
            if e.name in PROGRAM_SPANS and lo <= e.start < hi:
                self.by_name.setdefault(e.name, []).append((e.start, e.end))
        self.host_names = {e.name for e in trace.cpu}
        dev = [e for e in trace.device if e.name not in self.host_names]
        self.launch_starts = sorted(e.start for e in trace.runtime
                                    if "Launch" in e.name)
        issued = {e.corr: e for e in trace.runtime if e.corr}
        owned = sorted(((issued[e.corr], e) for e in dev
                        if e.corr in issued), key=lambda o: o[0].start)
        self.issue_starts = [r.start for r, _ in owned]
        self.issue_cum = [0] + list(accumulate(e.end - e.start
                                               for _, e in owned))
        worst = max(owned, key=lambda o: o[0].start - o[1].start,
                    default=None)
        self.clock_skew_ns = None if worst is None else \
            worst[0].start - worst[1].start
        self.late = sum(1 for r, e in owned if r.start - e.start > EARLY_NS)
        offsets = _offsets(owned)
        self.offset_range = (min(offsets), max(offsets)) if offsets \
            else None
        moved = [(e.start - o, e.end - o)
                 for (_, e), o in zip(owned, offsets)]
        self.copy_overrun_ns = max(
            (b - r.end for (r, e), (_, b) in zip(owned, moved)
             if e.name == SYNC_COPY), default=None)
        ids = {id(e) for _, e in owned}
        #: every device event but the mirrors, as read after the correction
        self.intervals = moved + [(e.start, e.end) for e in dev
                                  if id(e) not in ids]
        self.busy = _merge(self.intervals)
        self.busy_starts = [a for a, _ in self.busy]
        self.report(trace, worst)

    def report(self, trace, worst):
        """The clock check, the mirrors of host ranges and where they
        landed, and each span's totals over the traced region, on standard
        error."""
        def say(msg):
            print(f"h100bench spans: {msg}", file=sys.stderr)

        def busy(events):
            return _length(_merge((e.start, e.end) for e in events))

        if worst is None:
            say("clock: no device event attributed to a launch")
        else:
            r, e = worst
            say(f"clock: device events start at most "
                f"{self.clock_skew_ns / 1e3:.3f} us before their launch "
                f"({e.name[:80]!r} of {r.name!r}), {self.late} of "
                f"{len(self.issue_starts)} over {EARLY_NS / 1e3:g} us; "
                f"offset estimated from {self.offset_range[0] / 1e3:.3f} to "
                f"{self.offset_range[1] / 1e3:.3f} us; corrected "
                "synchronous copies end at most "
                + ("(none)" if self.copy_overrun_ns is None else
                   f"{self.copy_overrun_ns / 1e3:.3f} us")
                + " after their call returns")
        named = [e for e in trace.device if e.name in self.host_names]
        own = sum(1 for e in named if e.name in PROGRAM_SPANS)
        outer = [e for e in trace.outer_device if e.name in self.host_names]
        steady = [e for e in trace.steady_device
                  if e.name in self.host_names]
        added = [busy(d) - busy([e for e in d if e.name not in
                                 self.host_names])
                 for d in (trace.outer_device, trace.steady_device)]
        say(f"mirrors: {len(named)} device events named like a host range "
            f"({own} like a program span); {len(outer)} in the trace's "
            f"outer device events, {len(steady)} in its steady ones, adding "
            f"{added[0] / 1e6:.4f} ms to the outer busy time and "
            f"{added[1] / 1e6:.4f} ms to the steady busy time; by name "
            + ", ".join(f"{n!r} {c}" for n, c in sorted(Counter(
                e.name for e in outer).items())))
        for name, found in sorted(self.by_name.items()):
            s = _merge(found)
            say(f"{name!r}: {len(found)} spans, wall {_length(s) / 1e6:.3f} "
                f"ms, idle {self._idle(s) / 1e6:.3f} ms, "
                f"{self._launches(s)} launches, device "
                f"{self._device(s) / 1e6:.3f} ms")
        region = [trace.outer]
        windows = _merge(trace.windows)
        inner = _spans(trace, PROGRAM_SPANS - {"fit epoch", "fit chunk"},
                       "steady", self)
        say(f"traced region: wall {_length(region) / 1e6:.3f} ms, device "
            f"idle {self._idle(region) / 1e6:.3f} ms; steady ranges: wall "
            f"{_length(windows) / 1e6:.3f} ms, idle "
            f"{self._idle(windows) / 1e6:.3f} ms, of it inside the program's "
            f"spans there {self._idle(inner) / 1e6:.3f} ms")

    def _idle(self, spans):
        busy = 0
        for a, b in spans:
            j = max(bisect.bisect_right(self.busy_starts, a) - 1, 0)
            while j < len(self.busy) and self.busy[j][0] < b:
                lo, hi = self.busy[j]
                busy += max(0, min(hi, b) - max(lo, a))
                j += 1
        return _length(spans) - busy

    def _launches(self, spans):
        return sum(bisect.bisect_left(self.launch_starts, b)
                   - bisect.bisect_left(self.launch_starts, a)
                   for a, b in spans)

    def _device(self, spans):
        total = 0
        for a, b in spans:
            i = bisect.bisect_left(self.issue_starts, a)
            j = bisect.bisect_left(self.issue_starts, b)
            total += self.issue_cum[j] - self.issue_cum[i]
        return total


def _index(trace):
    idx = getattr(trace, "_program_span_index", None)
    if idx is None:
        idx = trace._program_span_index = _Index(trace)
    return idx


def _offsets(owned):
    """The device clock's offset against the host's at each of ``owned``'s
    (launch, device event) pairs, sorted by launch: the least delay from
    launch to start in the pair's bucket of ``OFFSET_WINDOW_NS`` and the
    two beside it."""
    least = {}
    for r, e in owned:
        k = r.start // OFFSET_WINDOW_NS
        least[k] = min(least.get(k, e.start - r.start), e.start - r.start)
    big = float("inf")
    return [min(least.get(k - 1, big), least[k], least.get(k + 1, big))
            for k in (r.start // OFFSET_WINDOW_NS for r, _ in owned)]


def _length(spans):
    return sum(b - a for a, b in spans)


def _spans(trace, names, where, idx=None):
    """The merged intervals of the host spans named in ``names`` in
    ``where``."""
    if where == "steady":
        keep = trace.in_windows
    elif where == "after":
        first = trace.windows[0][0] if trace.windows else trace.outer[1]

        def keep(t):
            return t >= first
    elif where == "outer":
        def keep(t):
            return True
    else:
        raise ValueError(f"unknown part of the trace {where!r}")
    by_name = (idx or _index(trace)).by_name
    return _merge(iv for name in names for iv in by_name.get(name, ())
                  if keep(iv[0]))


def clock_skew_ns(trace):
    """The most by which a device event starts before its launch call
    began, in ns, before the clock's correction (None where no device
    event is attributed)."""
    return _index(trace).clock_skew_ns


def copy_overrun_ns(trace):
    """The most by which a synchronous copy, corrected, ends after its call
    returned, in ns (None where the trace holds none)."""
    return _index(trace).copy_overrun_ns


def wall_s(trace, names, where):
    spans = _spans(trace, names, where)
    return _length(spans) / 1e9 if spans else None


def idle_s(trace, names, where):
    spans = _spans(trace, names, where)
    if not spans:
        return None
    return _index(trace)._idle(spans) / 1e9


def launches(trace, names, where):
    spans = _spans(trace, names, where)
    return _index(trace)._launches(spans) if spans else None


def device_s(trace, names, where):
    spans = _spans(trace, names, where)
    return _index(trace)._device(spans) / 1e9 if spans else None
