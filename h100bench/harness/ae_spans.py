"""The device time a training step spends under one of the program's spans
that lie inside the step (``ae prior``, ``ae network`` in
``models/autoencoder.py``), forward and backward.

In a captured step such a span records the capture's eager warm-up and the
capture: a replay's kernels carry the graph launch's correlation id and no
span. The warm-up runs the same step, kernel for kernel, eagerly, so it is
read there:

- the forward: the device time of the operations whose launch call began
  inside the span, on the span's thread (by correlation id, as
  ``trace.py`` attributes them);
- the backward: autograd records each node's backward as a range
  ``autograd::engine::evaluate_function: <Node>`` carrying the sequence
  number of the forward operation that made the node and that operation's
  thread. The backward ranges whose (forward thread, sequence number) is
  one of the span's operations' are the span's backward; the device time
  of what their launches issued, on their own thread, is added.

A sequence number that an operation inside the span merely reads (an
operation that makes no node reports the next node's number) and that an
operation after the span takes is left out. Only the spans whose forward
and backward both issued device work are counted: the fit's initial loss
(no gradient) and the capture (nothing runs) are not steps. Device events
named like a host event (the profiler's mirrors of host ranges) are left
out, as ``spans.py`` leaves them out. A program without the span reads
None."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from itertools import accumulate

from harness.trace import _ns

BACKWARD = "autograd::engine::evaluate_function: "


@dataclass
class HostEvent:
    name: str
    start: int          # ns
    end: int            # ns
    thread: int
    seq: int            # autograd sequence number, -1 for none
    fwd_thread: int     # a backward range's forward thread
    corr: int = 0


@dataclass
class DeviceEvent:
    name: str
    start: int
    end: int
    corr: int


def from_profiler(prof):
    """(host events, device events) of a ``torch.profiler`` profile."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        corr = int(e.correlation_id() or 0)
        if e.device_type() == DeviceType.CUDA:
            dev.append(DeviceEvent(e.name(), start, end, corr))
        else:
            host.append(HostEvent(e.name(), start, end,
                                  int(e.start_thread_id()),
                                  int(e.sequence_nr()),
                                  int(e.fwd_thread_id()), corr))
    return host, dev


class StepSpans:
    """The host and device events of one profile, indexed once."""

    def __init__(self, host, dev):
        self.host = host
        names = {e.name for e in host}
        seconds = defaultdict(int)
        for e in dev:
            if e.name not in names:
                seconds[e.corr] += e.end - e.start
        # each thread's launch calls in start order, with the device time
        # each issued, summed
        calls = defaultdict(list)
        for e in host:
            if e.corr and e.name.startswith("cu"):
                calls[e.thread].append((e.start, seconds.get(e.corr, 0)))
        self._starts, self._cum = {}, {}
        for thread, found in calls.items():
            found.sort()
            self._starts[thread] = [s for s, _ in found]
            self._cum[thread] = [0] + list(accumulate(d for _, d in found))
        self._by_thread = defaultdict(list)
        for e in host:
            if e.seq >= 0 and not e.name.startswith(BACKWARD):
                self._by_thread[e.thread].append(e)
        for found in self._by_thread.values():
            found.sort(key=lambda e: e.start)
        self._backward = defaultdict(list)
        for e in host:
            if e.name.startswith(BACKWARD) and e.seq >= 0:
                self._backward[e.fwd_thread, e.seq].append(e)

    def _device_ns(self, thread, lo, hi):
        starts = self._starts.get(thread)
        if not starts:
            return 0
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
        return self._cum[thread][j] - self._cum[thread][i]

    def _span_ops(self, span):
        """The sequence numbers of the nodes the operations inside
        ``span`` made."""
        ops = self._by_thread.get(span.thread, [])
        i = bisect.bisect_left([e.start for e in ops], span.start)
        inside, after = set(), set()
        for e in ops[i:]:
            if e.start >= span.end:
                after.add(e.seq)
                if len(after) > 4:
                    break
            elif e.end <= span.end:
                inside.add(e.seq)
        return inside - after

    def backward_ranges(self, span):
        """The backward ranges of the nodes the operations inside
        ``span`` made."""
        return [e for seq in sorted(self._span_ops(span))
                for e in self._backward.get((span.thread, seq), ())]

    def step_ns(self, name):
        """Each counted span's forward and backward device time, in ns."""
        out = []
        for span in self.host:
            if span.name != name:
                continue
            fwd = self._device_ns(span.thread, span.start, span.end)
            found = self.backward_ranges(span)
            bwd = sum(self._device_ns(e.thread, e.start, e.end)
                      for e in found)
            if found and fwd > 0 and bwd > 0:
                out.append(fwd + bwd)
        return out

    def ms_per_step(self, name):
        """The mean over the counted spans, in ms, or None."""
        found = self.step_ns(name)
        return sum(found) / len(found) / 1e6 if found else None
