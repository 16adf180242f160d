"""The port's device-resident datasets and whole-epoch scan path against
spmf_tpu (float64, CPU, where the scan runs its step eagerly):
``DeviceArrayDataset`` / ``ArrayDataset.to_device`` against
tests/test_data.py's device-dataset cases, ``DeviceSparseCounts.peek_batch``,
and the scan path against tests/test_engine.py's epoch_scan cases (auto
engagement, convergence to the general loop's optimum, determinism,
eligibility, epoch_chunk, the sparse layouts and their overflow audit), the
scan's control flow against spmf_tpu's scan on a scripted energy, and a
checkpoint / resume through the scan with Adam's state restored in place."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu import bijectors as jb
from spmf_tpu.data import DeviceArrayDataset as JaxDAD
from spmf_tpu.data import as_data_factory as jax_factory
from spmf_tpu.vi import minibatch as jmb
from spmf_tpu.vi import surrogates as jsur

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch.data import (ArrayDataset, DeviceArrayDataset,
                                 SparseCounts, as_data_factory)
from spmf_tpu_torch.vi import epoch_scan as tscan
from spmf_tpu_torch.vi import minibatch as tmb
from spmf_tpu_torch.vi import surrogates as tsur

from test_engine import _gaussian_problem
from test_torch_resume import _problem
from torch_ref import to_np

RNG = np.random.default_rng(11)


def _device(tensors, **kw):
    return DeviceArrayDataset(tensors, device="cpu", **kw)


# ------------------------------------------------------------- datasets
def test_device_dataset_matches_host():
    """tests/test_data.py:96: unshuffled batches of the device dataset are
    the host dataset's and spmf_tpu's, to 0 difference."""
    x = RNG.poisson(1.0, (23, 5)).astype(np.float64)
    t = {"counts": x, "indices": np.arange(23)}
    host = ArrayDataset(t).batch(10)
    dev = _device(t).batch(10)
    jdev = JaxDAD(t).batch(10)
    via = ArrayDataset(t).batch(10).to_device(device="cpu")
    for ds in (dev, via):
        tb_ = list(ds)
        assert len(tb_) == len(list(host)) == 3
        for a, h, j in zip(tb_, host, jdev):
            for k in t:
                np.testing.assert_array_equal(to_np(a[k]), h[k])
                np.testing.assert_array_equal(to_np(a[k]), np.asarray(j[k]))
    # dtype casts floating arrays only; misaligned leading dims raise
    d32 = ArrayDataset(t).to_device(dtype="float32", device="cpu")
    assert d32.tensors["counts"].dtype == torch.float32
    assert d32.tensors["indices"].dtype == torch.int64
    with pytest.raises(ValueError, match="Misaligned"):
        _device({"counts": x, "indices": np.arange(4)})


def test_device_dataset_shuffles_and_feeds_fit():
    """tests/test_data.py:109: each iteration reshuffles, every epoch
    covers the rows spmf_tpu's epoch covers (the orders differ: numpy's
    stream here, jax.random there), and the dataset feeds a fit."""
    x = RNG.poisson(1.0, (120, 6)).astype(np.float64)
    t = {"counts": x, "indices": np.arange(120)}
    dev = _device(t, batch_size=40, shuffle=True)
    jdev = JaxDAD(t, batch_size=40, shuffle=True)
    epochs = [[to_np(b["indices"]) for b in dev] for _ in range(2)]
    assert not np.array_equal(epochs[0][0], epochs[1][0])
    for ep in epochs:
        jep = [np.asarray(b["indices"]) for b in jdev]
        assert [len(b) for b in ep] == [len(b) for b in jep]
        assert sorted(np.concatenate(ep)) == sorted(np.concatenate(jep))
        for b in dev:
            np.testing.assert_array_equal(to_np(b["counts"]),
                                          x[to_np(b["indices"])])
    m = PoissonFactorization(latent_dim=2, feature_dim=6, u_tau_scale=0.1,
                             dtype="float64", device="cpu", data=dev)
    losses = m.fit(batched_data_factory=dev, num_steps=2, learning_rate=0.1,
                   sample_size=4, verbose=False)
    assert np.isfinite(losses).all()
    assert m.last_fit.extras["epoch_scan"] is True


def test_device_dataset_peek_batch_is_contiguous_slice():
    """tests/test_data.py:126: peek_batch is rows [0:bs) as views and uses
    up no shuffle epoch; DeviceSparseCounts peeks its first rows too, with
    no shuffle and no epoch decode (flat: the host batch's triplets at the
    training pad; blocked: the first bs / R blocks)."""
    x = RNG.poisson(1.0, (50, 4)).astype(np.float64)
    t = {"counts": x, "indices": np.arange(50)}
    dev = _device(t, batch_size=20, shuffle=True, seed=7)
    peek = dev.peek_batch()
    jpeek = JaxDAD(t, batch_size=20, shuffle=True, seed=7).peek_batch()
    for k in t:
        np.testing.assert_array_equal(to_np(peek[k]), np.asarray(jpeek[k]))
    np.testing.assert_array_equal(to_np(peek["counts"]), x[:20])
    assert peek["counts"].data_ptr() == dev.tensors["counts"].data_ptr()
    fresh = _device(t, batch_size=20, shuffle=True, seed=7)
    np.testing.assert_array_equal(to_np(next(iter(dev))["indices"]),
                                  to_np(next(iter(fresh))["indices"]))

    xs = (RNG.random((64, 9)) < 0.3) * RNG.poisson(2.0, (64, 9))
    host = SparseCounts.from_dense(xs)
    flat = SparseCounts.from_dense(xs).shuffle(seed=1).batch(
        16, drop_remainder=True).to_device(device="cpu", dtype="float64")
    pf = flat.peek_batch()
    want = host._coo_batch(np.arange(16), flat._pad(16))
    for k in want:
        np.testing.assert_array_equal(to_np(pf[k]), want[k], err_msg=k)
    assert flat._epoch == 0
    blocked = SparseCounts.from_dense(xs).shuffle(seed=1).batch(16).to_device(
        device="cpu", dtype="float64", block_rows=8)
    pb = blocked.peek_batch()
    first = next(iter(SparseCounts.from_dense(xs).batch(16).to_device(
        device="cpu", dtype="float64", block_rows=8)))
    for k in first:
        np.testing.assert_array_equal(to_np(pb[k]), to_np(first[k]),
                                      err_msg=k)
    assert blocked._epoch == 0


# --------------------------------------------------------------- engine
def _gaussian_run(**kw):
    surrogate, energy, _ = _problem()
    x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
    # 64 rows: 2 full batches of 24 and a 16-row remainder batch
    ds = _device({"counts": x}, batch_size=24, shuffle=True, seed=0)
    return tmb.fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), as_data_factory(ds),
        sample_size=32, num_steps=300, learning_rate=0.05, rel_tol=None,
        verbose=False, dtype=torch.float64, seed=0, **kw)


def test_epoch_scan_fast_path_converges_and_is_deterministic():
    """tests/test_engine.py:467: auto engages the scan on a device dataset
    (remainder batch included), it reaches the general loop's optimum at
    spmf_tpu's tolerances (independent shuffle streams), two runs give equal
    losses, and the converged loc lies within the same 0.15 of spmf_tpu's
    scan path."""
    result = _gaussian_run()
    assert result.extras["epoch_scan"] is True
    # the default engages chunks of 8 after two fast single epochs
    assert result.extras["epoch_chunk"] == 8
    loc = float(result.params["z"]["loc"][0, 0])
    sd = float(torch.nn.functional.softplus(
        result.params["z"]["raw_scale"][0, 0]))
    general = _gaussian_run(epoch_scan=False)
    assert general.extras["epoch_scan"] is False
    np.testing.assert_allclose(loc, float(general.params["z"]["loc"][0, 0]),
                               atol=0.15)
    np.testing.assert_allclose(sd, float(torch.nn.functional.softplus(
        general.params["z"]["raw_scale"][0, 0])), rtol=0.25)
    assert _gaussian_run().losses == result.losses

    x, surrogate, energy = _gaussian_problem()
    ds = JaxDAD({"counts": x}, batch_size=24, shuffle=True, seed=0)
    jres = jmb.fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), jax_factory(ds),
        sample_size=32, num_steps=300, learning_rate=0.05, rel_tol=None,
        verbose=False, dtype=jnp.float64, seed=0)
    assert jres.extras["epoch_scan"] is True
    np.testing.assert_allclose(loc, float(jres.params["z"]["loc"][0, 0]),
                               atol=0.15)


def test_epoch_scan_validates_eligibility():
    """tests/test_engine.py:517: epoch_scan=True on a host-streamed source
    raises spmf_tpu's ValueError; the general loop reports False."""
    surrogate, energy, factory = _problem()
    kw = dict(verbose=False, dtype=torch.float64)
    with pytest.raises(ValueError, match="epoch_scan"):
        tmb.fit_surrogate_posterior(energy, surrogate, surrogate.init(),
                                    factory, num_steps=1, epoch_scan=True,
                                    **kw)
    result = tmb.fit_surrogate_posterior(energy, surrogate, surrogate.init(),
                                         factory, num_steps=2, **kw)
    assert result.extras["epoch_scan"] is False


@pytest.mark.parametrize("source, chunk, error", [
    ("host", 4, ValueError), ("device", 4, None),
    ("device", 0, ValueError), ("device", 1, None), ("device", None, None)])
def test_epoch_chunk_requires_scan_path(source, chunk, error):
    """tests/test_engine.py:621: epoch_chunk > 1 needs the scan path
    (spmf_tpu's ValueError on a host source); on the scan path K > 1 runs
    one chunk, clamped to the 2 epochs; 1 and None run single epochs; < 1
    raises."""
    surrogate, energy, factory = _problem()
    if source == "device":
        x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
        factory = as_data_factory(_device({"counts": x}, batch_size=32))
    kw = dict(num_steps=2, verbose=False, dtype=torch.float64,
              epoch_chunk=chunk)
    if error is not None:
        with pytest.raises(error, match="epoch_chunk"):
            tmb.fit_surrogate_posterior(energy, surrogate, surrogate.init(),
                                        factory, **kw)
        return
    result = tmb.fit_surrogate_posterior(energy, surrogate, surrogate.init(),
                                         factory, **kw)
    assert result.extras["epoch_scan"] is True
    assert result.extras["epoch_chunk"] == (2 if chunk == 4 else 0)
    assert len(result.losses) == 3


def _sparse_run(max_nnz=None, block_rows=None, **kw):
    rng = np.random.default_rng(3)
    X = (rng.random((96, 12)) < 0.4) * rng.poisson(2.0, (96, 12))
    m = PoissonFactorization(latent_dim=2, feature_dim=12, u_tau_scale=0.1,
                             dtype="float64", scale_columns=False,
                             device="cpu")
    dev = SparseCounts.from_dense(X).shuffle(seed=0).batch(
        32, drop_remainder=True).to_device(max_nnz=max_nnz, device="cpu",
                                           dtype="float64",
                                           block_rows=block_rows)
    losses = m.fit(batched_data_factory=dev, num_steps=8, learning_rate=0.05,
                   sample_size=4, verbose=False, rel_tol=None, seed=0, **kw)
    return m, losses


def test_sparse_epoch_scan_path():
    """The port's half of tests/test_engine.py:567: auto engages the scan
    on a DeviceSparseCounts (flat and blocked layouts), epoch_scan=False
    opts out, the losses are finite and fall, the final loss lies within
    rtol 0.1 of the general loop's, and an undersized pad overflows."""
    m, losses = _sparse_run(epoch_scan=True)
    assert m.last_fit.extras["epoch_scan"] is True
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    m_auto, losses_auto = _sparse_run()
    assert m_auto.last_fit.extras["epoch_scan"] is True
    assert losses_auto == losses
    m_off, losses_off = _sparse_run(epoch_scan=False)
    assert m_off.last_fit.extras["epoch_scan"] is False
    np.testing.assert_allclose(losses[-1], losses_off[-1], rtol=0.1)
    m_b, losses_b = _sparse_run(block_rows=16)
    assert m_b.last_fit.extras["epoch_scan"] is True
    assert np.isfinite(losses_b).all() and losses_b[-1] < losses_b[0]
    with pytest.raises(ValueError, match="overflowed"):
        _sparse_run(max_nnz=64, epoch_scan=True)


# ------------------------------------------- control flow against spmf_tpu
#: The scripted energy: its level is a step function of the sampled z
#: (zero gradient), so the loss of each batch is set by where loc stands.
#: The energy's 1e-3 * z moves loc by exactly -lr a step under Adam, the
#: tiny surrogate scale keeps every draw inside loc's cell of width CELL
#: (positions sit a third of a cell from the edges for up to three halvings
#: of the learning rate), and the levels differ by far more than the
#: eps-form log q's sampling noise, so both packages take the same
#: improve / plateau decisions. It restores three times in 12 epochs.
CELL = 0.0125


def _level(z, floor, mod):
    q = floor(-z / CELL + 1.0 / 3.0)
    return 10.0 * mod(4.0 * q, 17.0) + 0.37 * q


def _scripted_jax():
    sur = jsur.SurrogatePosterior({"z": jsur.TransformedSurrogate(
        jsur.TrainableNormal(np.zeros((1, 1)), 1e-4 * np.ones((1, 1)), 2),
        jb.Identity())})

    def energy(batch, samples, pw):
        z = samples["z"][..., 0, 0]
        return -(_level(z, jnp.floor, jnp.mod) + 1e-3 * z)

    ds = JaxDAD({"counts": np.zeros((2, 1))}, batch_size=1)
    return sur, energy, jax_factory(ds)


def _scripted_torch():
    sur = tsur.SurrogatePosterior({"z": tsur.TransformedSurrogate(
        tsur.TrainableNormal(np.zeros((1, 1)), 1e-4 * np.ones((1, 1)), 2,
                             dtype=torch.float64, device="cpu"),
        tb.Identity())})

    def energy(batch, samples, pw):
        z = samples["z"][..., 0, 0]
        return -(_level(z, torch.floor, torch.remainder) + 1e-3 * z)

    ds = _device({"counts": np.zeros((2, 1))}, batch_size=1)
    return sur, energy, as_data_factory(ds)


def test_scan_control_flow_matches_jax(capsys):
    """spmf_tpu's scan (epoch_scan=True) and the port's on the scripted
    energy with patience=2: restores happen, the loss traces agree within
    2.0, the learning rates exactly, the final loc within rtol 1e-6, and
    the same plateau and restore lines are printed."""
    kw = dict(sample_size=8, num_steps=12, learning_rate=0.1, patience=2,
              decay_rate=0.5, rel_tol=None, seed=0, epoch_scan=True,
              epoch_chunk=1, verbose=True)
    sur, energy, factory = _scripted_jax()
    rj = jmb.fit_surrogate_posterior(energy, sur, sur.init(), factory,
                                     dtype=jnp.float64, **kw)
    out_j = capsys.readouterr().out
    sur, energy, factory = _scripted_torch()
    rt = tmb.fit_surrogate_posterior(energy, sur, sur.init(), factory,
                                     dtype=torch.float64, **kw)
    out_t = capsys.readouterr().out
    assert rj.extras["epoch_scan"] and rt.extras["epoch_scan"]
    assert out_t.count("loss plateau") == out_j.count("loss plateau") == 3
    assert out_t.count("Restoring") == out_j.count("Restoring")
    assert len(rt.losses) == len(rj.losses) == 13
    np.testing.assert_allclose(rt.losses, rj.losses, atol=2.0)
    # three halvings of 0.1, each rounded to float32 (optax's lr)
    assert rt.learning_rate == rj.learning_rate == float(np.float32(0.0125))
    np.testing.assert_allclose(float(rt.params["z"]["loc"][0, 0]),
                               float(rj.params["z"]["loc"][0, 0]), rtol=1e-6)


# ------------------------------------------------- checkpoints and resume
def test_scan_checkpoint_resume_restores_adam_in_place(tmp_path,
                                                       monkeypatch):
    """A fit through the scan writes full-state checkpoints; a resume
    through the scan continues Adam's count from the file's; and across
    the load, a plateau restore and every epoch, the Adam state and the
    parameters the step updates keep their storage (restores copy in
    place, as a captured step needs)."""
    ptrs = []
    run_epoch = tscan.EpochScan.run_epoch

    def spy(self):
        ptrs.append([t.data_ptr() for t in self.state()])
        return run_epoch(self)

    monkeypatch.setattr(tscan.EpochScan, "run_epoch", spy)
    surrogate, energy, _ = _problem()
    x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
    kw = dict(sample_size=8, learning_rate=0.5, rel_tol=None, verbose=False,
              dtype=torch.float64, seed=0, patience=1)

    def factory():
        return as_data_factory(_device({"counts": x}, batch_size=24,
                                       shuffle=True, seed=0))

    first = tmb.fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), factory(), num_steps=6,
        checkpoint_dir=str(tmp_path), **kw)
    assert first.extras["epoch_scan"] is True
    assert first.learning_rate < 0.5          # a plateau restore happened
    assert len(ptrs) == 6 and all(p == ptrs[0] for p in ptrs)
    files = glob.glob(os.path.join(str(tmp_path), "**", "*.npz"),
                      recursive=True)
    newest = max(files, key=os.path.getmtime)
    with np.load(newest) as z:
        count = int(z["opt_2"])           # optax's Adam count
    ptrs.clear()
    # no plateau restore in the resumed run (it would put the count back)
    second = tmb.fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), factory(), num_steps=2,
        resume_from=newest, **dict(kw, patience=10))
    assert len(ptrs) == 2 and ptrs[0] == ptrs[1]
    # the moments continued: 2 epochs of 3 batches on the file's count
    assert count > 0
    assert int(second.opt_state["state"][0]["step"]) == count + 2 * 3
