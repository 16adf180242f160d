"""The general loop's options: ``prefetch`` (batches assembled and moved to
the device ahead in a worker thread, ``data/prefetch.py``, the port of
tests/test_data.py:328) and ``profile_dir`` (a torch.profiler trace of the
epochs), on the CPU."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os
import threading
import time

import numpy as np
import pytest

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.data import ArrayDataset, prefetch_batches

from torch_ref import B, D, K, N, S, counts


def test_prefetch_batches_order_transform_and_errors():
    """tests/test_data.py:328: items come in order through the transform,
    size=0 passes through in line, and a worker's error re-raises at the
    consumer after the items before it."""
    items = list(range(20))
    out = list(prefetch_batches(iter(items), size=3,
                                transform=lambda x: x * 2))
    assert out == [x * 2 for x in items]
    assert list(prefetch_batches(iter(items), size=0)) == items

    def boom():
        yield 1
        raise RuntimeError("worker failed")

    gen = prefetch_batches(boom(), size=2)
    assert next(gen) == 1
    with pytest.raises(RuntimeError, match="worker failed"):
        list(gen)


def test_abandoned_prefetch_joins_its_worker():
    """A consumer that stops early (the queue full, the worker blocked on a
    put) closes the generator: the worker stops and is joined."""
    before = set(threading.enumerate())
    gen = prefetch_batches(iter(range(1000)), size=2)
    assert next(gen) == 0
    workers = set(threading.enumerate()) - before
    assert len(workers) == 1
    gen.close()
    worker = workers.pop()
    worker.join(timeout=5.0)
    assert not worker.is_alive()


def _model(data):
    return PoissonFactorization(latent_dim=K, feature_dim=D,
                                u_tau_scale=1.0 / np.sqrt(N * D),
                                dtype="float64", data=data, device="cpu")


def test_prefetch_fit_equals_inline_fit():
    """A float64 fit with prefetch=2 (the default) is prefetch=0's bit for
    bit: the same batches in the same order, the draws all on the main
    thread."""
    runs = []
    for prefetch in (2, 0):
        # a dataset each: its shuffle moves on with every pass
        m = _model(ArrayDataset({"counts": counts(), "indices": np.arange(N)}
                                ).shuffle(seed=1).batch(B))
        losses = m.fit(num_steps=2, learning_rate=0.05, sample_size=S,
                       rel_tol=None, verbose=False, prefetch=prefetch)
        runs.append((losses, m.surrogate_params))
    (l2, p2), (l0, p0) = runs
    assert l2 == l0
    for name, sub in p2.items():
        for leaf, t in sub.items():
            np.testing.assert_array_equal(t.numpy(), p0[name][leaf].numpy())


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_dir: the loop's torch.profiler trace is written there when
    the fit ends, and names the engine's epoch range."""
    data = ArrayDataset({"counts": counts(), "indices": np.arange(N)}
                        ).batch(B)
    m = _model(data)
    t0 = time.time()
    m.fit(num_steps=2, sample_size=S, verbose=False,
          profile_dir=str(tmp_path / "prof"))
    traces = glob.glob(os.path.join(str(tmp_path / "prof"), "*.json"))
    assert len(traces) == 1 and os.path.getmtime(traces[0]) >= t0 - 1
    with open(traces[0]) as f:
        assert '"fit epoch"' in f.read()
