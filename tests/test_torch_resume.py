"""Checkpoints and resume of the port's fit engine: the cases of
tests/test_engine.py's checkpoint and resume tests on the same conjugate
problem, the KeyboardInterrupt return, and full-state files that carry an
Adam state between the port and optax in both directions (float64, CPU)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os
import re
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spmf_tpu.utils.checkpoint import load_fit_state as jax_load_fit_state
from spmf_tpu.utils.checkpoint import save_fit_state as jax_save_fit_state

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch import bijectors as tb
from spmf_tpu_torch.data import ArrayDataset
from spmf_tpu_torch.utils import (adam_state_from_numpy, adam_state_to_numpy,
                                  flatten_jax_order, load_fit_state,
                                  load_pytree, save_fit_state)
from spmf_tpu_torch.vi.minibatch import (clip_and_step,
                                         fit_surrogate_posterior,
                                         make_optimizer)
from spmf_tpu_torch.vi.surrogates import (SurrogatePosterior, TrainableNormal,
                                          TransformedSurrogate)

from torch_ref import to_np


def _problem():
    """z ~ N(0, 1), x_i ~ N(z, 1), 64 observations in one batch (the
    conjugate problem of tests/test_engine.py, constants dropped)."""
    x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
    surrogate = SurrogatePosterior({"z": TransformedSurrogate(
        TrainableNormal(np.zeros((1, 1)), 0.5 * np.ones((1, 1)), 2,
                        dtype=torch.float64, device="cpu"), tb.Identity())})

    def energy(batch, samples, prior_weight):
        z = samples["z"][..., 0, 0]
        obs = batch["counts"]
        return -0.5 * z * z - 0.5 * torch.sum(
            (obs[None, :] - z[..., None]) ** 2, dim=-1)

    data = ArrayDataset({"counts": x}).batch(64)
    return surrogate, energy, lambda: iter(data)


def _fit(params=None, **kw):
    surrogate, energy, factory = _problem()
    kw = dict(dict(sample_size=8, learning_rate=0.1, rel_tol=None,
                   verbose=False, dtype=torch.float64, seed=0), **kw)
    return fit_surrogate_posterior(
        energy, surrogate, surrogate.init() if params is None else params,
        factory, **kw)


def _files(root):
    return set(glob.glob(os.path.join(str(root), "**", "*.npz"),
                         recursive=True))


def _tag(path):
    return int(re.search(r"-(\d+)\.npz$", os.path.basename(path)).group(1))


def _newest(root):
    return max(_files(root), key=os.path.getmtime)


def _adam_count(opt_state):
    return int(opt_state["state"][0]["step"])


def test_checkpoint_dir_writes_files(tmp_path):
    r = _fit(num_steps=3, learning_rate=0.05, sample_size=4,
             checkpoint_dir=str(tmp_path))
    files = glob.glob(os.path.join(str(tmp_path), "*", "*.npz"))
    assert files, "no checkpoints written"
    assert r.checkpoint_path == os.path.dirname(files[0])
    run_id = os.path.basename(r.checkpoint_path)
    assert all(os.path.basename(f).startswith(run_id + "-") for f in files)


def test_resumed_fit_advances_params():
    r1 = _fit(num_steps=3, learning_rate=0.05)
    before = [t.clone() for t in flatten_jax_order(r1.params)]
    r2 = _fit(params=r1.params, num_steps=3, learning_rate=0.05, seed=1,
              opt_state=r1.opt_state)
    assert any(not torch.equal(a, b) for a, b in
               zip(before, flatten_jax_order(r2.params)))
    assert _adam_count(r2.opt_state) == _adam_count(r1.opt_state) + 3


def test_resume_from_checkpoint(tmp_path):
    r1 = _fit(num_steps=4, checkpoint_dir=str(tmp_path))
    assert r1.checkpoint_path is not None
    loaded = load_pytree(_newest(tmp_path), like=r1.params)
    for a, b in zip(flatten_jax_order(r1.params), flatten_jax_order(loaded)):
        np.testing.assert_array_equal(a.numpy(), b)
    # a directory resolves to its newest file; the same seed and params
    # give the same initial loss as an eval at r1's best params
    r2 = _fit(num_steps=1, resume_from=str(tmp_path))
    r1_eval = _fit(params=r1.params, num_steps=1)
    np.testing.assert_allclose(r2.losses[0], r1_eval.losses[0], rtol=1e-12)


def test_resume_checkpoint_tags_continue_monotonic(tmp_path):
    # params-only files: run 2 starts from best_loss = inf, so its first
    # epoch improves and writes
    _fit(num_steps=3, checkpoint_dir=str(tmp_path),
         checkpoint_full_state=False)
    first = _files(tmp_path)
    hi = max(_tag(p) for p in first)
    _fit(num_steps=2, seed=1, checkpoint_dir=str(tmp_path),
         resume_from=str(tmp_path))
    new = _files(tmp_path) - first
    assert new and min(_tag(p) for p in new) > hi


def test_full_state_checkpoint_and_resume(tmp_path):
    r1 = _fit(num_steps=5, learning_rate=0.07, checkpoint_dir=str(tmp_path))
    newest = _newest(tmp_path)
    like = r1.params
    for a, b in zip(flatten_jax_order(like),
                    flatten_jax_order(load_pytree(newest, like=like))):
        np.testing.assert_array_equal(a.numpy(), b)
    _, opt_leaves, meta = load_fit_state(newest, params_like=like)
    assert len(opt_leaves) == 3 + 2 * len(flatten_jax_order(like))
    assert set(meta) >= {"lr", "best_loss", "stall", "epoch"}
    assert meta["best_loss"] == min(r1.losses[1:])
    # the JAX reader takes the file as it is
    _, jopt, jmeta = jax_load_fit_state(newest, params_like=to_np(like))
    assert len(jopt) == len(opt_leaves) and jmeta == meta
    r2 = _fit(num_steps=1, learning_rate=0.5, seed=3,
              resume_from=str(tmp_path))
    assert r2.learning_rate == meta["lr"]
    assert r2.opt_state["param_groups"][0]["lr"] == meta["lr"]
    # one single-batch epoch continues the saved Adam count
    assert _adam_count(r2.opt_state) == meta["epoch"] + 1


def test_params_only_checkpoint_opt_out_and_legacy_resume(tmp_path):
    _fit(num_steps=3, checkpoint_dir=str(tmp_path),
         checkpoint_full_state=False)
    with np.load(_newest(tmp_path)) as zf:
        assert "opt_0" not in zf and "__fit_state__" not in zf
    r2 = _fit(num_steps=1, learning_rate=0.3, seed=1,
              resume_from=str(tmp_path), checkpoint_dir=str(tmp_path))
    assert r2.learning_rate == np.float32(0.3)
    assert _adam_count(r2.opt_state) == 1
    assert len(_files(tmp_path)) >= 2


def test_explicit_opt_state_wins_over_full_checkpoint(tmp_path):
    _fit(num_steps=3, learning_rate=0.07, checkpoint_dir=str(tmp_path))
    fresh = _fit(num_steps=1, learning_rate=0.3, sample_size=2,
                 seed=2).opt_state
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r = _fit(num_steps=1, learning_rate=0.3, seed=1,
                 resume_from=str(tmp_path), opt_state=fresh)
    assert any(issubclass(x.category, RuntimeWarning)
               and "opt_state" in str(x.message) for x in w)
    assert r.learning_rate == np.float32(0.3)
    assert _adam_count(r.opt_state) == 2


def test_optimizer_leaf_count_mismatch_restores_params_only(tmp_path):
    r1 = _fit(num_steps=2, checkpoint_dir=str(tmp_path))
    path = _newest(tmp_path)
    params, opt, meta = load_fit_state(path, params_like=r1.params)
    save_fit_state(str(tmp_path / "other.npz"), params, opt[:-1], meta)
    with pytest.warns(RuntimeWarning, match="optimizer leaves"):
        r2 = _fit(num_steps=1, learning_rate=0.3,
                  resume_from=str(tmp_path / "other.npz"))
    assert r2.learning_rate == np.float32(0.3)
    assert _adam_count(r2.opt_state) == 1


def test_renamed_full_checkpoint_keeps_epoch_numbering(tmp_path, capsys):
    _fit(num_steps=4, checkpoint_dir=str(tmp_path / "run1"))
    newest = _newest(tmp_path / "run1")
    hi = _tag(newest)
    renamed = tmp_path / "best.npz"
    shutil.copy(newest, renamed)
    capsys.readouterr()
    # the copied file's name has no epoch tag: its meta carries the epoch
    _fit(num_steps=2, seed=7, resume_from=str(renamed), verbose=True,
         checkpoint_dir=str(tmp_path / "run2"), checkpoint_full_state=False)
    out = capsys.readouterr().out
    assert re.search(rf"Restored optimizer/control state: .*epoch={hi}\b",
                     out), out
    new = _files(tmp_path / "run2")
    if new:  # written only if an epoch improved on the restored best
        assert min(_tag(p) for p in new) > hi


def test_resume_stream_is_deterministic_and_not_replayed(tmp_path):
    r1 = _fit(num_steps=3, learning_rate=0.05, checkpoint_dir=str(tmp_path))

    def resumed():
        return _fit(num_steps=2, learning_rate=0.05,
                    resume_from=str(tmp_path))

    a, b = resumed(), resumed()
    np.testing.assert_array_equal(a.losses, b.losses)
    fresh = _fit(params=r1.params, num_steps=2, learning_rate=0.05)
    np.testing.assert_allclose(a.losses[0], fresh.losses[0], rtol=1e-12)
    assert a.losses[1] != fresh.losses[1]


def test_keyboard_interrupt_returns_best_so_far(capsys):
    surrogate, energy, factory = _problem()
    calls = {"n": 0}

    def interrupting():
        calls["n"] += 1
        if calls["n"] == 4:  # the first call is the initial-loss batch
            raise KeyboardInterrupt
        return factory()

    r = fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), interrupting, sample_size=8,
        num_steps=50, learning_rate=0.05, rel_tol=None, verbose=True,
        dtype=torch.float64, seed=0)
    assert r.extras["interrupted"]
    assert len(r.losses) == 3    # the initial loss and 2 complete epochs
    # the best of the two epochs: an uninterrupted 2-epoch fit returns it
    ref = _fit(num_steps=2, learning_rate=0.05)
    for a, b in zip(flatten_jax_order(r.params),
                    flatten_jax_order(ref.params)):
        assert torch.equal(a, b)
    assert "Interrupted at epoch" in capsys.readouterr().out


def test_model_fit_forwards_checkpoint_full_state(tmp_path):
    X = np.random.default_rng(0).poisson(1.0, (40, 5))
    data = ArrayDataset({"counts": X, "indices": np.arange(40)}).batch(40)
    m = PoissonFactorization(latent_dim=2, feature_dim=5, u_tau_scale=0.1,
                             dtype="float64", data=data, device="cpu")
    m.fit(num_steps=2, learning_rate=0.1, rel_tol=None, sample_size=2,
          verbose=False, checkpoint_dir=str(tmp_path),
          checkpoint_full_state=False)
    with np.load(_newest(tmp_path)) as zf:
        assert "opt_0" not in zf and "leaf_0" in zf
    assert m.last_fit.checkpoint_path.startswith(str(tmp_path))
    with pytest.raises(TypeError, match="unknown keyword"):
        m.fit(num_steps=1, verbose=False, checkpoint_full_stat=True)


# ------------------------------------------ the Adam state across packages
def _tree(rng):
    """A parameter tree whose insertion order is not JAX's sorted one."""
    return {"w": {"raw_scale": rng.standard_normal((3, 2)),
                  "loc": rng.standard_normal((3, 2))},
            "a": {"raw_scale": rng.standard_normal(4),
                  "loc": rng.standard_normal(4)}}


def _grads(seed):
    # some entries beyond the clip at 5, so the clip takes part
    return {n: {k: 4.0 * v for k, v in sub.items()}
            for n, sub in _tree(np.random.default_rng(seed)).items()}


def _optax():
    return optax.inject_hyperparams(
        lambda lr: optax.chain(optax.clip(5.0), optax.adam(lr)),
        hyperparam_dtype=jnp.float32)(lr=0.1)


def _torch_params(tree):
    return {n: {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
                for k, v in sub.items()} for n, sub in tree.items()}


def _torch_step(params, optimizer, grads):
    for n, sub in params.items():
        for k, t in sub.items():
            t.grad = torch.tensor(grads[n][k])
    clip_and_step(optimizer, 5.0)


def _optax_step(opt, state, params, grads):
    updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                state, params)
    return optax.apply_updates(params, updates), state


def test_jax_full_state_takes_the_same_next_step_in_the_port(tmp_path):
    opt = _optax()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    _tree(np.random.default_rng(0)))
    state = opt.init(params)
    for seed in (1, 2):
        params, state = _optax_step(opt, state, params, _grads(seed))
    path = str(tmp_path / "jax.npz")
    jax_save_fit_state(path, params, state,
                       meta={"lr": 0.1, "best_loss": 1.0, "stall": 0,
                             "epoch": 2})
    p3, _ = _optax_step(opt, state, params, _grads(3))

    like = _tree(np.random.default_rng(9))
    loaded, leaves, meta = load_fit_state(path, params_like=like)
    tp = _torch_params(loaded)
    optimizer = make_optimizer(tp, 0.5)
    adam_state_from_numpy(leaves, optimizer, tp)
    assert optimizer.param_groups[0]["lr"] == float(np.float32(0.1))
    _torch_step(tp, optimizer, _grads(3))
    assert int(optimizer.state[tp["a"]["loc"]]["step"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(p3), flatten_jax_order(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-12, atol=1e-14)


def test_port_full_state_takes_the_same_next_step_in_optax(tmp_path):
    tp = _torch_params(_tree(np.random.default_rng(0)))
    optimizer = make_optimizer(tp, float(np.float32(0.1)))
    # a fresh optimizer has no state: zero moments and count 0
    fresh = adam_state_to_numpy(optimizer, tp)
    assert int(fresh[0]) == 0 and not np.any(fresh[3])
    for seed in (1, 2):
        _torch_step(tp, optimizer, _grads(seed))
    path = str(tmp_path / "port.npz")
    save_fit_state(path, tp, adam_state_to_numpy(optimizer, tp),
                   meta={"lr": 0.1, "best_loss": 1.0, "stall": 0, "epoch": 2})
    _torch_step(tp, optimizer, _grads(3))

    opt = _optax()
    like = jax.tree_util.tree_map(jnp.asarray, _tree(np.random.default_rng(9)))
    params, leaves, meta = jax_load_fit_state(path, params_like=like)
    treedef = jax.tree_util.tree_structure(opt.init(like))
    init = jax.tree_util.tree_leaves(opt.init(like))
    assert [np.asarray(x).dtype for x in leaves] == \
        [np.asarray(x).dtype for x in init]
    state = jax.tree_util.tree_unflatten(treedef,
                                         [jnp.asarray(x) for x in leaves])
    p3, state = _optax_step(opt, state, jax.tree_util.tree_map(
        jnp.asarray, params), _grads(3))
    assert int(state.count) == 3
    for a, b in zip(jax.tree_util.tree_leaves(p3), flatten_jax_order(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-12, atol=1e-14)
