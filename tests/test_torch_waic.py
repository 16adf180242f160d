"""WAIC and held-out scoring against spmf_tpu: the streaming moments, the
per-row log-likelihood of each branch (dense, densified COO, COO row
scorer; float64 1e-10, and the row-kernel twin against the interpreted
Pallas kernel in float32, 3e-5), and ``waic`` end to end with a stub
surrogate that hands both packages the same draws (1e-10)."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.vi.waic import streaming_waic_terms as jax_terms
from spmf_tpu.vi.waic import waic as jax_waic

from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.data import ArrayDataset, SparseCounts
from spmf_tpu_torch.vi.waic import streaming_waic_terms, waic

from torch_ref import B, counts, model_pair, random_samples, torch_params


def test_streaming_waic_terms_match_jax():
    rng = np.random.default_rng(0)
    chunks = [rng.normal(-3.0, 1.0, (s, 7)) for s in (4, 4, 3)]
    for a, b in zip(streaming_waic_terms(chunks), jax_terms(chunks)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    with pytest.warns(RuntimeWarning, match="non-finite"):
        streaming_waic_terms([np.array([[0.0, np.nan]])] * 2)


def _coo(dense):
    rows, cols = np.nonzero(dense)
    pad = len(rows) + 13
    out = {"coo_rows": np.zeros(pad, np.int32),
           "coo_cols": np.zeros(pad, np.int32),
           "coo_vals": np.zeros(pad), "indices": np.arange(len(dense))}
    out["coo_rows"][:len(rows)] = rows
    out["coo_cols"][:len(rows)] = cols
    out["coo_vals"][:len(rows)] = dense[rows, cols]
    return out


@pytest.mark.parametrize("branch,log_transform", [
    ("dense", False), ("dense", True), ("coo_row_scorer", False),
    ("densified_coo", True)])
def test_row_log_likelihood_matches_jax_f64(branch, log_transform):
    """Every branch of _row_log_likelihood on the same samples, 1e-10. On
    the CPU a COO batch takes the COO row scorer under the identity link
    and is densified under the log link, in both packages."""
    jm, tm, X = model_pair("float64", log_transform=log_transform)
    samples = random_samples(jm)
    dense = X[:B].astype(float)
    batch = {"counts": dense} if branch == "dense" else _coo(dense)
    out_j = jax.jit(jm._row_log_likelihood)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in samples.items()})
    out_t = tm._row_log_likelihood(batch, torch_params(samples, torch.float64))
    assert out_t.shape == (3, B)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-10)
    if branch != "dense":  # the COO branches agree with the dense one
        ref = tm._row_log_likelihood({"counts": dense},
                                     torch_params(samples, torch.float64))
        np.testing.assert_allclose(out_t.numpy(), ref.numpy(), rtol=1e-10)


def test_row_log_likelihood_through_row_kernel_twin_f32():
    """Fused dispatch: the K4 twin against the interpreted Pallas kernel,
    3e-5 (f32 cells, another lgamma)."""
    jm, tm, X = model_pair("float32", fused_likelihood=True,
                           gamma_sampler="fast", log_transform=True)
    jm._fused_interpret = True
    samples = random_samples(jm)
    batch = {"counts": X[:B].astype(np.float32)}
    out_j = jm._row_log_likelihood(
        {"counts": jnp.asarray(batch["counts"])},
        {k: jnp.asarray(v) for k, v in samples.items()})
    out_t = tm._row_log_likelihood(batch, torch_params(samples, torch.float32))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=3e-5)


class _Stub:
    """A surrogate whose ``sample`` returns the first n of fixed draws, as
    numpy arrays converted by ``to``."""

    def __init__(self, draws, to, device=None):
        self.draws, self.to, self.device = draws, to, device

    def sample(self, params, key, sample_shape):
        return {k: self.to(v[:sample_shape[0]]) for k, v in self.draws.items()}


@pytest.mark.parametrize("sample_chunk", [4, 10])
def test_waic_matches_jax_with_fixed_draws(sample_chunk):
    """waic over two batches with 10 draws in chunks (4, 4, 2 remainder, or
    one chunk), both packages fed the same draws, 1e-10."""
    jm, tm, X = model_pair("float64")
    draws = random_samples(jm, 10, seed=8)
    data = [{"counts": X[i * 32:(i + 1) * 32].astype(float),
             "indices": np.arange(32)} for i in range(2)]
    out_j = jax_waic(jm._row_log_likelihood, _Stub(draws, jnp.asarray), None,
                     lambda: iter(data), num_samples=10,
                     sample_chunk=sample_chunk)
    out_t = waic(tm._row_log_likelihood, _Stub(draws, torch.as_tensor), None,
                 lambda: iter(data), num_samples=10,
                 sample_chunk=sample_chunk, dtype=torch.float64, device="cpu")
    assert set(out_t) == set(out_j) and out_t["n_rows"] == 64
    for k in out_j:
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=1e-10, err_msg=k)


def _small_model(**kw):
    X = counts(96, 10, seed=5)
    ds = ArrayDataset({"counts": X, "indices": np.arange(96)}).batch(32)
    return PoissonFactorization(latent_dim=2, feature_dim=10, u_tau_scale=0.1,
                                dtype="float64", data=ds, device="cpu",
                                **kw), X


def test_log_likelihood_is_lppd_and_subsample_batch():
    """log_likelihood's total is waic's lppd for the same draws, per_row is
    total / n_rows; subsample='batch' scores the first batch alone; a
    held-out SparseCounts scores through the COO path to the dense value."""
    m, X = _small_model()
    w = m.waic(num_samples=6, sample_chunk=4, seed=3)
    ll = m.log_likelihood(num_samples=6, sample_chunk=4, seed=3)
    assert ll["n_rows"] == w["n_rows"] == 96
    assert ll["total"] == w["lppd"]
    assert ll["per_row"] == pytest.approx(w["lppd"] / 96, rel=1e-15)
    assert np.isfinite([w["waic"], w["se"], w["pwaic"]]).all()
    first = next(iter(m.data()))
    w_b = m.waic(subsample="batch", num_samples=6, sample_chunk=4, seed=3)
    w_1 = m.waic(data=[first], num_samples=6, sample_chunk=4, seed=3)
    assert w_b == w_1 and w_b["n_rows"] == 32
    with pytest.raises(ValueError):
        m.waic(subsample="rows")
    held = X[:40]
    sp = SparseCounts.from_dense(held).batch(20, drop_remainder=True).as_coo()
    dense = ArrayDataset({"counts": held, "indices": np.arange(40)}).batch(20)
    l_coo = m.log_likelihood(sp, num_samples=4, sample_chunk=2)
    l_dense = m.log_likelihood(dense, num_samples=4, sample_chunk=2)
    np.testing.assert_allclose(l_coo["total"], l_dense["total"], rtol=1e-10)


def test_scoring_does_not_clobber_fusion_record():
    """A training dispatch records the COO energy; scoring (the fused row
    path, record=False) leaves that record and the one-shot warning
    alone."""
    m, X = _small_model(fused_likelihood=True, sparse_dense_scatter=False)
    sp = SparseCounts.from_dense(X).batch(32).as_coo()
    m.unormalized_log_prob_parts(next(iter(sp)), **m.calibrated_expectations)
    reason = m.fusion_inactive_reason
    assert reason.startswith("sparse COO gather") and not m.fusion_active
    w = m.waic(num_samples=4, sample_chunk=2)     # dense batches: fused rows
    assert np.isfinite(w["waic"])
    assert m.fusion_inactive_reason == reason and m.fusion_active is False
    assert not m._fusion_warned
