"""The COO-to-dense scatter (``ops.coo_scatter``) on the CPU: the wrapper's
twin (``torch.zeros`` + ``index_put_(accumulate=True)``) gives numpy's
``add.at`` slab bit for bit on every kind of batch the dense-scatter path
densifies, the wrapper refuses what the kernel does not take before it
looks at the device, and ``_densify_coo`` on the CPU launches nothing. The
kernel itself is held to the twin's slab on the card in
``tests/test_torch_gpu.py``. Imports no JAX."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.data import SparseCounts
from spmf_tpu_torch.ops import coo_scatter as cs


def _counts(n=40, d=13, seed=0, lam=0.6):
    return np.random.default_rng(seed).poisson(lam, (n, d)).astype(float)


def _device_decode_batch():
    """The first batch of a shuffled epoch of the flat device layout, with
    its pad (DeviceSparseCounts' epoch decode and take)."""
    X = _counts()
    ds = SparseCounts.from_dense(X).shuffle(seed=4).batch(
        16, drop_remainder=True).to_device(device="cpu")
    b = next(iter(ds))
    assert int(b["coo_vals"].shape[0]) > int(ds._pending_nnz[-1])
    return b["coo_rows"], b["coo_cols"], b["coo_vals"], (16, X.shape[1])


def _host_coo_batch():
    """A host ``SparseCounts.as_coo()`` batch (numpy int32 and float64)."""
    X = _counts(seed=1)
    b = next(iter(SparseCounts.from_dense(X).batch(16).as_coo()))
    return (torch.as_tensor(b["coo_rows"]), torch.as_tensor(b["coo_cols"]),
            torch.as_tensor(b["coo_vals"]), (16, X.shape[1]))


def _entry_at_origin_then_pad():
    rows = torch.tensor([0, 2, 0, 0, 0], dtype=torch.int32)
    cols = torch.tensor([0, 5, 0, 0, 0], dtype=torch.int32)
    vals = torch.tensor([3.0, 1.0, 0.0, 0.0, 0.0])
    return rows, cols, vals, (3, 7)


def _duplicates():
    rows = torch.tensor([1, 1, 1, 0, 2, 1, 0], dtype=torch.int64)
    cols = torch.tensor([4, 4, 2, 0, 6, 4, 0], dtype=torch.int64)
    vals = torch.tensor([2.0, 5.0, 1.0, 7.0, 1.0, 0.5, 0.0])
    return rows, cols, vals, (3, 7)


def _mesh_remap():
    """``_densify_coo``'s tile remap on a (rows 4..8, cols 3..9) tile: the
    slots outside it become (0, 0, 0)."""
    g = np.random.default_rng(2)
    rows = torch.as_tensor(g.integers(0, 12, 60), dtype=torch.int32)
    cols = torch.as_tensor(g.integers(0, 11, 60), dtype=torch.int32)
    vals = torch.as_tensor(g.integers(1, 9, 60).astype(np.float32))
    keep = (rows >= 4) & (rows < 8) & (cols >= 3) & (cols < 9)
    return (torch.where(keep, rows - 4, 0), torch.where(keep, cols - 3, 0),
            torch.where(keep, vals, 0.0), (4, 6))


def _float64():
    g = np.random.default_rng(3)
    rows = torch.as_tensor(g.integers(0, 5, 30))
    cols = torch.as_tensor(g.integers(0, 9, 30), dtype=torch.int32)
    vals = torch.as_tensor(g.standard_normal(30))
    return rows, cols, vals, (5, 9)


def _all_pad():
    z = torch.zeros(64, dtype=torch.int32)
    return z, z.clone(), torch.zeros(64), (8, 10)


def _empty():
    z = torch.zeros(0, dtype=torch.int64)
    return z, z.clone(), torch.zeros(0, dtype=torch.float64), (4, 6)


CASES = {"device_decode_with_pad": _device_decode_batch,
         "host_as_coo": _host_coo_batch,
         "origin_entry_then_pad": _entry_at_origin_then_pad,
         "duplicates": _duplicates, "mesh_remap": _mesh_remap,
         "float64": _float64, "all_pad": _all_pad, "empty": _empty}


@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_equals_zeros_and_index_put(case):
    """The slab of the old ``zeros`` + ``index_put_`` pair, held to an
    independent reference: numpy's unbuffered ``add.at`` in ``vals``'
    dtype, bit for bit (integer counts, and float64 values whose repeats
    both sum in slot order)."""
    rows, cols, vals, shape = CASES[case]()
    before = cs.LAUNCHES["coo_scatter"]
    out = cs.coo_scatter(rows, cols, vals, shape)
    assert cs.LAUNCHES["coo_scatter"] == before
    assert out.dtype == vals.dtype and out.shape == shape
    dense = np.zeros(shape, dtype=vals.numpy().dtype)
    np.add.at(dense, (rows.numpy(), cols.numpy()), vals.numpy())
    np.testing.assert_array_equal(out.numpy(), dense)


def _refused(kind):
    r = torch.zeros(6, dtype=torch.int32)
    v = torch.ones(6)
    return {
        "length": (r, r[:5], v, (2, 2)),
        "two_d_rows": (r.reshape(2, 3), r.reshape(2, 3), v.reshape(2, 3),
                       (2, 2)),
        "two_d_cols": (r, r.reshape(2, 3), v, (2, 2)),
        "half_vals": (r, r, v.half(), (2, 2)),
        "integer_vals": (r, r, v.long(), (2, 2)),
        "float_index": (r.float(), r, v, (2, 2)),
        "int16_index": (r, r.short(), v, (2, 2)),
        "shape_rank": (r, r, v, (2, 2, 2)),
        "negative_shape": (r, r, v, (-1, 2)),
    }[kind]


@pytest.mark.parametrize("kind", ["length", "two_d_rows", "two_d_cols",
                                  "half_vals", "integer_vals", "float_index",
                                  "int16_index", "shape_rank",
                                  "negative_shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError):
        cs.coo_scatter(*_refused(kind))


def _model(X, dtype, **kw):
    return PoissonFactorization(latent_dim=3, feature_dim=X.shape[1],
                                u_tau_scale=0.1, dtype=dtype, device="cpu",
                                **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_densify_coo_on_the_cpu_launches_nothing(dtype):
    """``_densify_coo`` takes the twin on CPU tensors: the slab is the
    batch's rows, and the kernel's counter stays where it was."""
    X = _counts(seed=5)
    b = next(iter(SparseCounts.from_dense(X).batch(16).as_coo()))
    before = cs.LAUNCHES["coo_scatter"]
    out = _model(X, dtype)._densify_coo(b)
    assert cs.LAUNCHES["coo_scatter"] == before
    x = out["counts"]
    assert x.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(x.numpy(), X[b["indices"]])


def test_dense_scatter_scan_fit_on_the_cpu_launches_nothing():
    """A fit over the flat device layout with the dense scatter forced runs
    the scan path's densify through the twin: the loss falls and the
    kernel's counter stays where it was."""
    X = _counts(96, 16, seed=6)
    ds = SparseCounts.from_dense(X).shuffle(seed=3).batch(
        32, drop_remainder=True).to_device(device="cpu")
    m = _model(X, "float32", data=ds, sparse_dense_scatter=True)
    before = cs.LAUNCHES["coo_scatter"]
    losses = m.fit(num_steps=3, learning_rate=0.1, sample_size=2,
                   verbose=False, rel_tol=None)
    assert m.last_fit.extras["epoch_scan"] is True
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert cs.LAUNCHES["coo_scatter"] == before
