"""The sparse training path against spmf_tpu: SparseCounts and
DeviceSparseCounts batches (the same seed gives the same batches, element
for element), the sparse encoder, the flat, blocked and dense-scatter COO
energies (float64, 1e-10; the log link's float32 rate total through the K5
twin against the interpreted Pallas kernel, 1e-5), and one ELBO step on a
blocked batch (1e-9)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.data import DeviceSparseCounts as JaxDSC
from spmf_tpu.data import SparseCounts as JaxSC
from spmf_tpu.ops import sparse_encode_coo as jax_encode

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.data import DeviceSparseCounts, SparseCounts
from spmf_tpu_torch.ops.sparse_encode import sparse_encode_coo

from test_torch_step import _assert_tree_close, _jax_step, _torch_step
from torch_ref import B, S, counts, jax_draws, model_pair, perturbed_params
from torch_ref import random_samples, to_np, torch_params

def _dense(n=50, d=14, lam=0.5, seed=0):
    return np.random.default_rng(seed).poisson(lam, (n, d)).astype(float)


def _assert_batches_equal(tb, jb):
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(to_np(tb[k]), np.asarray(jb[k]),
                                      err_msg=k)


# ------------------------------------------------------------------ data
def test_host_sparse_counts_match_jax(tmp_path):
    """Builders, accessors and both batch kinds of the host CSR dataset."""
    from scipy.io import mmwrite
    from scipy.sparse import coo_matrix

    dense = _dense(seed=1)
    t, j = SparseCounts.from_dense(dense), JaxSC.from_dense(dense)
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    ids = np.array([4, 0, 17, 9])
    np.testing.assert_array_equal(t.row_slab(ids), j.row_slab(ids))
    for a, b in zip(t.batch_coo(ids), j.batch_coo(ids)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.col_stats(), j.col_stats()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.row_sums(), j.row_sums())
    assert t.density == j.density
    rows, cols = np.nonzero(dense)
    t2 = SparseCounts.from_coo(rows[::-1], cols[::-1], dense[rows, cols][::-1],
                               dense.shape)
    np.testing.assert_array_equal(t2.row_slab(np.arange(50)), dense)
    path = str(tmp_path / "m.mtx")
    mmwrite(path, coo_matrix(dense.T))
    t3, j3 = (cls.from_mtx(path, transpose=True)
              for cls in (SparseCounts, JaxSC))
    np.testing.assert_array_equal(t3.row_slab(np.arange(50)), dense)
    np.testing.assert_array_equal(t3.indptr, j3.indptr)
    for coo in (False, True):
        t, j = (cls.from_dense(dense).shuffle(seed=4).batch(16)
                for cls in (SparseCounts, JaxSC))
        if coo:
            t, j = t.as_coo(), j.as_coo()
        for _ in range(2):  # two epochs: the permutation advances alike
            tbs, jbs = list(t), list(j)
            assert len(tbs) == len(jbs) == 4
            for tb, jb in zip(tbs, jbs):
                _assert_batches_equal(tb, jb)


@pytest.mark.parametrize("block_rows", [None, 8])
def test_device_sparse_batches_equal_jax(block_rows):
    """Same seed, same batches (padding included), over two shuffled
    epochs, for the flat epoch decode and the block-aligned layout."""
    dense = _dense(64, 12, seed=2)
    kw = dict(batch_size=16, shuffle=True, seed=3, drop_remainder=True,
              block_rows=block_rows)
    t = DeviceSparseCounts(SparseCounts.from_dense(dense), dtype="float64",
                           device="cpu", **kw)
    j = JaxDSC(JaxSC.from_dense(dense), dtype=jnp.float64, **kw)
    if block_rows:
        assert (t.n_blocks, t.block_nnz) == (j.n_blocks, j.block_nnz)
    for _ in range(2):
        tbs, jbs = list(t), list(j)
        assert len(tbs) == len(jbs) == 4
        for tb, jb in zip(tbs, jbs):
            _assert_batches_equal(tb, jb)


def test_device_sparse_dropped_remainder_decodes_like_jax():
    """With a dropped remainder the epoch decode covers fewer nonzeros than
    the dataset holds; the batches still equal the JAX package's."""
    dense = _dense(50, 14, seed=3)
    kw = dict(batch_size=16, shuffle=True, seed=1, drop_remainder=True)
    t = DeviceSparseCounts(SparseCounts.from_dense(dense), dtype="float64",
                           device="cpu", **kw)
    j = JaxDSC(JaxSC.from_dense(dense), dtype=jnp.float64, **kw)
    for tb, jb in zip(list(t), list(j)):
        _assert_batches_equal(tb, jb)


def test_device_sparse_refusals():
    """Overflow raises at the epoch end, and a silently dropped remainder
    is refused (flat and blocked), with the JAX package's messages."""
    over = DeviceSparseCounts(SparseCounts.from_dense(_dense(12, 10, 2.0)),
                              batch_size=6, max_nnz=4, device="cpu")
    with pytest.raises(ValueError, match="overflowed the static pad"):
        list(over)
    sp = SparseCounts.from_dense(_dense(50, 8))
    with pytest.raises(ValueError, match="drops the 10-row remainder"):
        next(iter(DeviceSparseCounts(sp, batch_size=20, device="cpu")))
    with pytest.raises(ValueError, match="drops the 2-row remainder"):
        next(iter(sp.batch(16).to_device(block_rows=8, device="cpu")))
    with pytest.raises(ValueError, match="multiple of block_rows"):
        next(iter(SparseCounts.from_dense(_dense(50, 8)).batch(
            12, drop_remainder=True).to_device(block_rows=8, device="cpu")))


def test_coo_pad_tracks_batch_size():
    """An auto pad recomputes for another batch size, a user max_nnz is
    authoritative for any, and to_device() does not forward a host auto pad
    as if the user had chosen it (host and device datasets)."""
    dense = _dense(60, 9)
    sp = SparseCounts.from_dense(dense)
    assert sp._coo_pad_size(8) == JaxSC.from_dense(dense)._coo_pad_size(8)
    assert sp._coo_pad_size(32) == JaxSC.from_dense(dense)._coo_pad_size(32)
    sp2 = SparseCounts.from_dense(dense).batch(8).as_coo(max_nnz=4096)
    assert sp2._coo_pad_size(8) == sp2._coo_pad_size(32) == 4096
    sp3 = SparseCounts.from_dense(dense).batch(8).as_coo()
    sp3._coo_pad_size(8)
    sp3.as_coo(max_nnz=65536).batch(32)
    assert sp3._coo_pad_size(32) == sp3._coo_pad_size(8) == 65536

    sp4 = SparseCounts.from_dense(dense).batch(8).as_coo()
    sp4._coo_pad_size(8)
    dev = sp4.to_device(device="cpu")
    assert dev._max_nnz is None
    assert dev._pad(8) <= dev._pad(32) == JaxSC.from_dense(
        dense)._coo_pad_size(32)
    dev_u = SparseCounts.from_dense(dense).batch(8).as_coo(
        max_nnz=4096).to_device(device="cpu")
    assert dev_u._pad(8) == dev_u._pad(32) == 4096
    dev_kw = DeviceSparseCounts(SparseCounts.from_dense(dense), batch_size=8,
                                max_nnz=2048, device="cpu")
    assert dev_kw._pad(8) == dev_kw._pad(32) == 2048


# ---------------------------------------------------------------- encode
@pytest.mark.parametrize("log_transform", [False, True])
def test_sparse_encode_matches_jax_f64(log_transform):
    """sparse_encode_coo (with and without row scaling) and the model's
    encode_sparse, 1e-12 in float64."""
    jm, tm, X = model_pair("float64", log_transform=log_transform)
    dense = X[:40].astype(float)
    rows, cols = np.nonzero(dense)
    vals = dense[rows, cols]
    p = random_samples(jm, 2)
    A_j = jm.encoding_matrix(jnp.asarray(p["u"]), jnp.asarray(p["s"]))
    A_t = tm.encoding_matrix(*(torch.tensor(p[k]) for k in ("u", "s")))
    for xi in (None, 3.7):
        zj = jax_encode(rows, cols, vals, 40, A_j, jm.eta_i, log_transform,
                        xi_global=xi)
        zt = sparse_encode_coo(rows, cols, vals, 40, A_t, tm.eta_i,
                               log_transform, xi_global=xi)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-12)
    sc = SparseCounts.from_dense(dense)
    ej = jm.encode_sparse(JaxSC.from_dense(dense), jnp.asarray(p["u"][0]),
                          jnp.asarray(p["s"][0]))
    et = tm.encode_sparse(sc, torch.tensor(p["u"][0]), torch.tensor(p["s"][0]))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-12)


# -------------------------------------------------------------- energies
def _coo_batch(dense, extra_pad=29):
    rows, cols = np.nonzero(dense)
    pad = len(rows) + extra_pad
    out = {"coo_rows": np.zeros(pad, np.int32),
           "coo_cols": np.zeros(pad, np.int32),
           "coo_vals": np.zeros(pad), "indices": np.arange(len(dense))}
    out["coo_rows"][:len(rows)] = rows
    out["coo_cols"][:len(rows)] = cols
    out["coo_vals"][:len(rows)] = dense[rows, cols]
    return out


def _blocked_batches(X, dtype):
    """The first block-aligned batch of each package (block_rows=8)."""
    kw = dict(batch_size=B, shuffle=True, seed=5, drop_remainder=True,
              block_rows=8)
    t = DeviceSparseCounts(SparseCounts.from_dense(X), device="cpu",
                           dtype=dtype, **kw)
    j = JaxDSC(JaxSC.from_dense(X), dtype=jnp.dtype(dtype), **kw)
    return next(iter(t)), next(iter(j))


def _parts(jm, tm, jbatch, tbatch, samples, dtype):
    jparts = jax.jit(lambda b, p: jm.unormalized_log_prob_parts(b, **p))(
        jbatch, {k: jnp.asarray(v) for k, v in samples.items()})
    tparts = tm.unormalized_log_prob_parts(
        tbatch, **torch_params(samples, getattr(torch, dtype)))
    assert set(tparts) == set(jparts)
    return tparts, jparts


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("energy", ["flat", "blocked", "dense_scatter"])
def test_coo_energies_match_jax_f64(energy, log_transform):
    """Each COO energy part by part, 1e-10 in float64, on the same samples
    and batch; the dispatch records the same branch."""
    scatter = energy == "dense_scatter"
    jm, tm, X = model_pair("float64", log_transform=log_transform,
                           sparse_dense_scatter=scatter)
    samples = random_samples(jm)
    if energy == "blocked":
        tbatch, jbatch = _blocked_batches(X, "float64")
    else:
        jbatch = tbatch = _coo_batch(X[:B].astype(float))
    tparts, jparts = _parts(jm, tm, jbatch, tbatch, samples, "float64")
    for k in jparts:
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-10, err_msg=k)
    assert tm.fusion_inactive_reason == jm.fusion_inactive_reason
    assert tm.fusion_inactive_reason.startswith(
        {"flat": "sparse COO gather", "blocked": "blocked COO",
         "dense_scatter": "fused_likelihood=False"}[energy])


@pytest.mark.parametrize("energy", ["flat", "blocked"])
def test_coo_energy_log_link_f32_through_expsum(energy):
    """The log link's float32 rate total goes through fused_exp_rate_sum
    (the K5 twin on the CPU) and matches the JAX energy through the
    interpreted kernel, 1e-5."""
    jm, tm, X = model_pair("float32", log_transform=True,
                           sparse_dense_scatter=False, gamma_sampler="fast")
    jm._fused_interpret = True
    samples = random_samples(jm)
    if energy == "blocked":
        tbatch, jbatch = _blocked_batches(X, "float32")
    else:
        tbatch = jbatch = _coo_batch(X[:B].astype(np.float32))
    tparts, jparts = _parts(jm, tm, jbatch, tbatch, samples, "float32")
    for k in jparts:
        np.testing.assert_allclose(tparts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-5, err_msg=k)


def test_blocked_elbo_step_matches_jax():
    """One ADVI step (sample, blocked COO energy, gradient, clip, Adam) on
    a block-aligned batch with JAX's draws injected, 1e-9 in float64."""
    jm, tm, X = model_pair("float64", gamma_sampler="fast")
    tbatch, jbatch = _blocked_batches(X, "float64")
    p_np = perturbed_params(jm, scale=0.1)
    key = jax.random.PRNGKey(3)
    loss_j, grads_j, new_j = _jax_step(
        jm, jax.tree_util.tree_map(jnp.asarray, p_np), jbatch, key, 1e-9)
    loss_t, grads_t, new_t = _torch_step(tm, p_np, tbatch,
                                         jax_draws(jm, key, S), torch.float64)
    assert tm.fusion_inactive_reason.startswith("blocked COO")
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-9)
    _assert_tree_close(grads_t, grads_j, 1e-9)
    _assert_tree_close(new_t, new_j, 1e-9)


@pytest.mark.parametrize("block_rows", [None, 8])
def test_sparse_fit_never_densifies(block_rows, monkeypatch):
    """sparse_dense_scatter=False trains through the COO energies without
    densifying, even with the fused likelihood on (which would make the
    auto dispatch densify), and the loss falls."""
    def refuse(self, *a, **k):
        raise AssertionError("densified a COO batch")

    monkeypatch.setattr(PoissonFactorization, "_densify_coo", refuse)
    X = counts(192, 16, seed=3)
    dev = SparseCounts.from_dense(X).shuffle(seed=3).batch(
        48, drop_remainder=True).to_device(block_rows=block_rows,
                                           device="cpu")
    m = PoissonFactorization(latent_dim=3, feature_dim=16, u_tau_scale=0.1,
                             log_transform=True, dtype="float32",
                             fused_likelihood=True, data=dev, device="cpu",
                             sparse_dense_scatter=False)
    losses = m.fit(num_steps=3, learning_rate=0.1, sample_size=4,
                   verbose=False, rel_tol=None)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert not m.fusion_active
    assert "COO" in m.fusion_inactive_reason
