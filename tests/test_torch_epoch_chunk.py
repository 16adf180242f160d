"""The port's chunk path (``epoch_chunk``: K epochs run with the best /
plateau / divergence decisions made on the device, one fetch a chunk)
against its single-epoch path and spmf_tpu's chunk path, on the CPU, where
the same decisions run eagerly. Float64 unless stated, at the sizes of
tests/test_torch_epoch_scan.py; each test names the case of
tests/test_engine.py it repeats."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.vi import minibatch as jmb

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.data import DeviceArrayDataset, SparseCounts, \
    as_data_factory
from spmf_tpu_torch.utils.checkpoint import load_fit_state, load_pytree
from spmf_tpu_torch.vi import epoch_scan as tscan
from spmf_tpu_torch.vi import minibatch as tmb

from test_torch_epoch_scan import _scripted_jax, _scripted_torch
from test_torch_resume import _problem

X = np.random.default_rng(0).normal(1.5, 1.0, size=64)


def _fit(dtype=torch.float64, energy=None, **kw):
    """The conjugate problem over a DeviceArrayDataset: 2 batches of 32."""
    surrogate, energy0, _ = _problem()
    ds = DeviceArrayDataset({"counts": X}, batch_size=32, shuffle=True,
                            seed=0, dtype=dtype, device="cpu")
    kw = dict(dict(sample_size=8, learning_rate=0.05, rel_tol=None,
                   verbose=False, seed=0), **kw)
    return tmb.fit_surrogate_posterior(
        energy or energy0, surrogate, surrogate.init(), as_data_factory(ds),
        dtype=dtype, **kw)


def _assert_same(a, b):
    np.testing.assert_array_equal(a.losses, b.losses)
    assert a.learning_rate == b.learning_rate
    for name, sub in a.params.items():
        for leaf, t in sub.items():
            assert torch.equal(t, b.params[name][leaf]), (name, leaf)


def _files(root):
    return glob.glob(os.path.join(str(root), "**", "*.npz"), recursive=True)


def test_chunked_equals_single_epoch_bit_for_bit():
    """tests/test_engine.py:537: chunks of 5 reproduce the single-epoch
    trajectory exactly (losses, the best parameters, lr) across the plateau
    restores that patience=2 forces; the device decisions keep the storage
    of the parameters and Adam's state."""
    single = _fit(num_steps=60, patience=2, epoch_chunk=1)
    chunked = _fit(num_steps=60, patience=2, epoch_chunk=5)
    assert single.extras["epoch_chunk"] == 0
    assert chunked.extras["epoch_chunk"] == 5
    assert chunked.extras["epoch_scan"] is True
    _assert_same(chunked, single)
    assert single.learning_rate < 0.05       # several plateaus happened
    assert len(chunked.extras["epoch_seconds"]) == 60


def test_nonfinite_epoch_inside_a_chunk():
    """A non-finite epoch inside a chunk halves the lr and restores the
    best state on the device, as the single-epoch path does on the host:
    the two runs are equal, the NaN epoch included."""
    def run(chunk):
        surrogate, energy, _ = _problem()
        calls = {"n": 0}

        def scripted(batch, samples, pw):
            calls["n"] += 1
            lp = energy(batch, samples, pw)
            # the initial loss is call 1: epoch 6's second batch
            return lp * float("nan") if calls["n"] == 1 + 2 * 5 + 2 else lp

        return _fit(energy=scripted, num_steps=12, epoch_chunk=chunk,
                    verbose=True)

    single = run(1)
    chunked = run(4)
    _assert_same(chunked, single)
    assert np.isnan(chunked.losses[6]) and np.isfinite(
        np.delete(chunked.losses, 6)).all()
    assert chunked.learning_rate == float(np.float32(0.05) * np.float32(0.5))


def test_chunk_checkpoints_and_resume(tmp_path):
    """tests/test_engine.py:633: one checkpoint a chunk (1 to 3 files over
    12 epochs in chunks of 4), the newest holding the returned best
    parameters, and a resume from it runs through the chunk path."""
    result = _fit(num_steps=12, epoch_chunk=4, checkpoint_dir=str(tmp_path))
    files = _files(tmp_path)
    assert 1 <= len(files) <= 3
    assert len(result.extras["checkpoint_seconds"]) == len(files)
    newest = max(files, key=os.path.getmtime)
    loaded = load_pytree(newest, like=result.params)
    for name, sub in result.params.items():
        for leaf, t in sub.items():
            np.testing.assert_array_equal(np.asarray(loaded[name][leaf]),
                                          t.numpy())
    r2 = _fit(num_steps=4, epoch_chunk=4, resume_from=str(tmp_path))
    assert r2.extras["epoch_chunk"] == 4
    assert r2.losses[-1] <= result.losses[-1] + 1e-6


def test_chunk_clamps_and_reports():
    """tests/test_engine.py:674: an explicit K=16 at 12 epochs runs one
    chunk of 12 (13 losses with the initial one), equal to single epochs."""
    clamped = _fit(num_steps=12, epoch_chunk=16)
    assert clamped.extras["epoch_chunk"] == 12
    assert len(clamped.losses) == 13
    _assert_same(clamped, _fit(num_steps=12, epoch_chunk=1))


def test_default_engages_on_fast_dense_epochs_only():
    """tests/test_engine.py:701: the default runs 2 single epochs, 3 chunks
    of 8 and a 3-epoch single tail at num_steps=29 (30 losses); on a
    DeviceSparseCounts source it never chunks (26 epochs, the fewest the
    dense source would chunk)."""
    result = _fit(num_steps=29)
    assert result.extras["epoch_chunk"] == 8
    assert len(result.losses) == 30
    rng = np.random.default_rng(3)
    xs = (rng.random((64, 12)) < 0.4) * rng.poisson(2.0, (64, 12))
    m = PoissonFactorization(latent_dim=2, feature_dim=12, u_tau_scale=0.1,
                             dtype="float64", scale_columns=False,
                             device="cpu")
    dev = SparseCounts.from_dense(xs).shuffle(seed=0).batch(
        32, drop_remainder=True).to_device(device="cpu", dtype="float64")
    losses = m.fit(batched_data_factory=dev, num_steps=26, sample_size=2,
                   learning_rate=0.05, rel_tol=None, verbose=False)
    assert m.last_fit.extras["epoch_scan"] is True
    assert m.last_fit.extras["epoch_chunk"] == 0
    assert len(losses) == 27


def test_chunk_f32_stays_on_track():
    """tests/test_engine.py:722: in float32 the decisions are made in the
    compute dtype on the device (a 1-ulp tie may differ from the host's
    float64 mean), and the trajectory stays within rtol 1e-4."""
    single = _fit(torch.float32, num_steps=20, epoch_chunk=1)
    chunked = _fit(torch.float32, num_steps=20, epoch_chunk=5)
    assert chunked.extras["epoch_chunk"] == 5
    np.testing.assert_allclose(chunked.losses, single.losses, rtol=1e-4)
    assert chunked.losses[-1] < chunked.losses[1]


def test_full_state_resume_through_chunk_path(tmp_path):
    """tests/test_engine.py:873: the restored control state rides into the
    device carry: a chunked resume keeps the checkpoint's lr, not the
    argument."""
    _fit(num_steps=8, learning_rate=0.07, epoch_chunk=4,
         checkpoint_dir=str(tmp_path))
    newest = max(_files(tmp_path), key=os.path.getmtime)
    surrogate, _, _ = _problem()
    _, opt_leaves, meta = load_fit_state(newest, surrogate.init())
    assert opt_leaves is not None and meta is not None
    r2 = _fit(num_steps=4, learning_rate=0.5, seed=5, epoch_chunk=4,
              resume_from=str(tmp_path))
    assert r2.extras["epoch_chunk"] == 4
    assert r2.learning_rate == meta["lr"]


def test_f32_chunk_checkpoint_holds_the_device_carry(tmp_path):
    """tests/test_engine.py:1025: in float32 the checkpoint's best_loss is
    the device carry's float32 mean (the best of the epoch means), and a
    chunked resume continues its lr."""
    r1 = _fit(torch.float32, num_steps=8, epoch_chunk=4,
              checkpoint_dir=str(tmp_path))
    assert r1.extras["epoch_chunk"] == 4
    newest = max(_files(tmp_path), key=os.path.getmtime)
    _, opt_leaves, meta = load_fit_state(newest, r1.params)
    assert opt_leaves is not None
    assert np.float32(meta["best_loss"]) == np.float32(min(r1.losses[1:]))
    r2 = _fit(torch.float32, num_steps=4, learning_rate=0.5, seed=2,
              epoch_chunk=4, resume_from=str(tmp_path))
    assert r2.learning_rate == meta["lr"]
    assert np.isfinite(r2.losses).all()


def test_chunk_control_flow_matches_jax(capsys):
    """The scripted energy of test_scan_control_flow_matches_jax in chunks
    of 4, against spmf_tpu's chunk path: the same plateau and restore
    lines, the same lr, the loss traces within 2.0 and the final loc
    within rtol 1e-6."""
    kw = dict(sample_size=8, num_steps=12, learning_rate=0.1, patience=2,
              decay_rate=0.5, rel_tol=None, seed=0, epoch_scan=True,
              epoch_chunk=4, verbose=True)
    sur, energy, factory = _scripted_jax()
    rj = jmb.fit_surrogate_posterior(energy, sur, sur.init(), factory,
                                     dtype=jnp.float64, **kw)
    out_j = capsys.readouterr().out
    sur, energy, factory = _scripted_torch()
    rt = tmb.fit_surrogate_posterior(energy, sur, sur.init(), factory,
                                     dtype=torch.float64, **kw)
    out_t = capsys.readouterr().out
    assert rj.extras["epoch_chunk"] == rt.extras["epoch_chunk"] == 4
    assert out_t.count("loss plateau") == out_j.count("loss plateau") == 3
    assert out_t.count("Restoring") == out_j.count("Restoring")
    assert len(rt.losses) == len(rj.losses) == 13
    np.testing.assert_allclose(rt.losses, rj.losses, atol=2.0)
    assert rt.learning_rate == rj.learning_rate == float(np.float32(0.0125))
    np.testing.assert_allclose(float(rt.params["z"]["loc"][0, 0]),
                               float(rj.params["z"]["loc"][0, 0]), rtol=1e-6)


def test_decisions_write_in_place(monkeypatch):
    """Across chunks and their restores, the parameters, Adam's state and
    the best buffers keep their storage: the decisions copy in place, as a
    captured decision needs."""
    ptrs = []
    call = tscan.EpochDecisions.__call__

    def spy(self, losses):
        ptrs.append([t.data_ptr() for t in self.tensors()])
        return call(self, losses)

    monkeypatch.setattr(tscan.EpochDecisions, "__call__", spy)
    result = _fit(num_steps=12, learning_rate=0.5, patience=1,
                  epoch_chunk=4)
    assert result.learning_rate < 0.5
    assert len(ptrs) == 12 and all(p == ptrs[0] for p in ptrs)


def test_interrupt_inside_a_chunk_returns_the_last_decisions_best():
    """A KeyboardInterrupt in epoch 6 (the second chunk of 4) returns the
    best state as epoch 5's decision left it: a 5-epoch fit's, with only
    the first chunk's epochs replayed into the loss trace."""
    def run(num_steps, stop_at=None):
        surrogate, energy, _ = _problem()
        calls = {"n": 0}

        def scripted(batch, samples, pw):
            calls["n"] += 1
            if calls["n"] == stop_at:
                raise KeyboardInterrupt
            return energy(batch, samples, pw)

        return _fit(energy=scripted, num_steps=num_steps, patience=1,
                    learning_rate=0.5, epoch_chunk=4)

    # the initial loss is call 1: epoch 6's first batch is call 12
    cut = run(12, stop_at=1 + 2 * 5 + 1)
    five = run(5)
    assert cut.extras["interrupted"] is True
    assert cut.losses == five.losses[:5]
    for name, sub in cut.params.items():
        for leaf, t in sub.items():
            assert torch.equal(t, five.params[name][leaf]), (name, leaf)
