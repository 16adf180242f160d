"""Background-thread batch prefetch (double-buffering; a copy of
spmf_tpu/data/prefetch.py, which uses only the standard library).

A daemon thread assembles batch N+1, and moves it to the device, while the
device runs step N. The fit engine's transform copies each batch onto the
card on the current (shared) stream, so the step that reads it is ordered
after the copy without an event, and the caching allocator sees the tensor
on the stream that uses it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional

__all__ = ["prefetch_batches"]

_SENTINEL = object()


def prefetch_batches(iterable: Iterable, size: int = 2,
                     transform: Optional[Callable] = None):
    """Yield items from ``iterable``, produced ``size`` ahead in a daemon
    thread; ``transform`` (e.g. the host->device placement) runs in the
    worker. ``size=0`` disables threading (synchronous passthrough).

    Worker exceptions re-raise at the consuming ``next()`` call; an
    abandoned generator unblocks and joins the worker on close/GC.
    """
    if size <= 0:
        for item in iterable:
            yield transform(item) if transform is not None else item
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        """Bounded put that gives up when the consumer is gone; True when
        the item was enqueued (every put must go through here: an
        unconditional q.put would block a worker forever if the consumer
        abandoned the generator with the queue full)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in iterable:
                if transform is not None:
                    item = transform(item)
                if not put_or_stop(item):
                    return
            put_or_stop(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - propagate to consumer
            put_or_stop(e)

    worker = threading.Thread(target=work, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join(timeout=5.0)
