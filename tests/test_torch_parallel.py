"""Multi-process training through the port (spmf_tpu_torch.parallel): the
cases of tests/test_sharding.py on one world of four gloo ranks on the
CPU, float64 unless a kernel twin's float32 is the point.

One world runs every case on every layout it takes: (4,) dp, (2, 2)
dp x fp, (1, 4) fp and (2, 2) dcn x dp (tests/_torch_multiprocess_worker.py).
Each case's results are held to

- the port in one process, running the same case function with no mesh on
  the same inputs: 1e-10 relative on losses and energies, 1e-9 on
  gradients (float64; the sums only run in another order), and the float32
  tolerances of the kernel twins where those run;
- the JAX package's sharded functions on the conftest's 8 virtual CPU
  devices (a (2, 2) or (4,) mesh of four; Pallas kernels interpreted), on
  the same draws (``torch_ref.jax_draws`` of the same key) or the same
  samples: 1e-9 in float64.

Every rank's results are also checked against rank 0's: all ranks hold the
same global values.
"""
import os
import pickle
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P_

import _torch_multiprocess_worker as W
from torch_ref import jax_draws

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
KEY = 5


def start_world(outdir, suite):
    """Four worker ranks of ``suite`` writing into ``outdir``."""
    from spmf_tpu_torch.parallel import free_port

    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("WORKER_CASES", None)
    return [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_multiprocess_worker.py"),
         str(r), str(WORLD), port, str(outdir), suite],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(WORLD)]


def join_world(procs, outdir, timeout=300):
    """The four ranks' results; a rank that fails or hangs fails the
    fixture (every rank is stopped)."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    results = []
    for r in range(WORLD):
        with open(os.path.join(outdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _jax_models():
    """The JAX models of the draw-fed cases ('fast' sampler, calibration
    skipped: every parameter is passed explicitly)."""
    from spmf_tpu import MixedFactorization as JMixed
    from spmf_tpu import PoissonFactorization as JPF
    from spmf_tpu.data import SparseCounts as JSparse

    with mock.patch.object(JPF, "set_calibration_expectations",
                           lambda self, *a, **kw: None):
        pf = JPF(latent_dim=W.P, feature_dim=W.D, u_tau_scale=0.1,
                 dtype="float64", scale_columns=False, gamma_sampler="fast")
        coo = JPF(latent_dim=3, feature_dim=12, u_tau_scale=0.1,
                  dtype="float64", gamma_sampler="fast",
                  data=JSparse.from_dense(W.COO_DENSE).batch(40))
        types, _ = W.mixed_problem()
        mixed = JMixed(column_types=types, latent_dim=3, u_tau_scale=0.1,
                       dtype="float64", fused_likelihood=True, obs_scale=0.7,
                       gamma_sampler="fast")
    return {"pf": (pf, W.S), "coo_eps": (coo, 3), "mixed_eps": (mixed, 2)}


def _write_draws(outdir, models):
    out = {}
    for name, (m, s) in models.items():
        for k, v in jax_draws(m, jax.random.PRNGKey(KEY), s).items():
            out[f"{name}/{k}"] = v
    np.savez(os.path.join(outdir, "draws.npz"), **out)


def _mesh4(shape, axes):
    from spmf_tpu.parallel import make_mesh

    return make_mesh(shape, axes, devices=jax.devices()[:4])


def _jax_loss(model, mesh, batch, sample_size, rows):
    """The JAX loss and gradients of one step on ``mesh`` (params split
    over fp where the mesh has it), from the key the draws came from."""
    from spmf_tpu.parallel import replicate, shard_params_feature_dim

    sur = model._surrogate

    def loss(p):
        s, lq = sur.sample_and_log_prob(p, jax.random.PRNGKey(KEY),
                                        (sample_size,))
        return -jnp.mean(model.unormalized_log_prob(data=batch, **s)
                         - lq) / rows

    params = (shard_params_feature_dim(model.surrogate_params, mesh, "fp")
              if "fp" in mesh.axis_names
              else replicate(model.surrogate_params, mesh))
    val, g = jax.jit(jax.value_and_grad(loss))(params)
    return float(val), jax.tree_util.tree_map(np.asarray, g)


def _parts(model, batch, samples):
    """A JAX model's energy parts on numpy samples, as numpy."""
    samples = {k: jnp.asarray(v) for k, v in samples.items()}
    return {k: np.asarray(v) for k, v in jax.jit(
        lambda s: model.unormalized_log_prob_parts(batch, **s))(
            samples).items()}


def _jax_refs(models):
    """The JAX package's sharded results the port is held to."""
    from spmf_tpu import PoissonFactorization as JPF
    from spmf_tpu.ops import fused_poisson_row_loglik_sharded
    from spmf_tpu.parallel import shard_batch

    refs = {}
    dpfp = _mesh4((2, 2), ("dp", "fp"))
    dp4 = _mesh4((4,), ("dp",))
    pf, _ = models["pf"]
    pf.mesh = dpfp
    pf._surrogate.mesh = dpfp
    batch = {"counts": jax.device_put(jnp.asarray(W.X),
                                      NamedSharding(dpfp, P_("dp", "fp"))),
             "indices": jax.device_put(jnp.arange(W.B),
                                       NamedSharding(dpfp, P_("dp")))}
    refs["loss"], refs["grads"] = _jax_loss(pf, dpfp, batch, W.S, W.B)

    with mock.patch.object(JPF, "set_calibration_expectations",
                           lambda self, *a, **kw: None):
        for name, kw in (("fused", {}), ("static",
                                         {"likelihood_clip": "static"})):
            fm = JPF(latent_dim=W.P, feature_dim=W.D, u_tau_scale=0.1,
                     dtype="float64", scale_columns=False, mesh=dpfp,
                     fused_likelihood=True, **kw)
            fm._fused_interpret = True
            samples = {k: jnp.asarray(v) for k, v in
                       W.samples_for(fm, 0).items()}
            refs[name] = np.asarray(
                fm.unormalized_log_prob_parts(batch, **samples)["x"])

    coo, _ = models["coo_eps"]
    coo.mesh = dp4
    cb = W.coo_batch(W.COO_DENSE, 40, seed=9)
    samples = {k: jnp.asarray(v) for k, v in W.samples_for(coo, 1).items()}
    refs["coo_energy"] = {k: np.asarray(v) for k, v in jax.jit(
        lambda s: coo.unormalized_log_prob_parts(cb, **s))(samples).items()}
    refs["coo_loss"], refs["coo_grads"] = _jax_loss(coo, dp4, cb, 3, 40)

    mixed, _ = models["mixed_eps"]
    mixed.mesh = dpfp
    mixed._fused_interpret = True
    _, Xm = W.mixed_problem()
    mb = {"counts": jax.device_put(jnp.asarray(Xm),
                                   NamedSharding(dpfp, P_("dp", "fp"))),
          "indices": jnp.arange(24)}
    samples = {k: jnp.asarray(v) for k, v in
               W.samples_for(mixed, 4, sample_size=2).items()}
    refs["mixed"] = np.asarray(
        mixed.unormalized_log_prob_parts(mb, **samples)["x"])

    with mock.patch.object(JPF, "set_calibration_expectations",
                           lambda self, *a, **kw: None):
        # :491 the dense scatter, :537 the gather energy on dp x fp (B=7),
        # :694 the COO row scorer on given samples
        sm = JPF(latent_dim=3, feature_dim=12, u_tau_scale=0.1,
                 dtype="float64", scale_columns=False,
                 sparse_dense_scatter=True, mesh=dp4)
        refs["scatter"] = _parts(sm, shard_batch(W.coo_batch(
            W.SCATTER_DENSE, 8), dp4), W.samples_for(sm, 2))
        gm = JPF(latent_dim=2, feature_dim=8, u_tau_scale=0.1,
                 dtype="float64", scale_columns=False, fused_likelihood=True,
                 mesh=dpfp)
        gm._fused_interpret = True
        refs["gather"] = _parts(gm, W.coo_batch(W.GATHER_DENSE, 8),
                                W.samples_for(gm, 3, sample_size=2))
        rm = JPF(latent_dim=W.P, feature_dim=W.D, u_tau_scale=0.1,
                 dtype="float64", scale_columns=False, mesh=dpfp)
        rm._DENSE_SCATTER_MAX_SLAB_BYTES = 0
        samples = {k: jnp.asarray(v) for k, v in
                   W.samples_for(rm, 7).items()}
        wb = W.coo_batch(W.WAIC_DENSE, 8)
        refs["coo_rows"] = np.asarray(jax.jit(
            lambda s: rm._row_log_likelihood(wb, s))(samples))

    # :468 the autoencoder's likelihood on a dp mesh, on given weights
    from spmf_tpu import PoissonAutoencoder as JAE
    from spmf_tpu.data import ArrayDataset as JDS

    with mock.patch.object(JAE, "set_calibration_expectations",
                           lambda self, *a, **kw: None):
        am = JAE(JDS({"counts": W.AE_X, "indices": np.arange(64)}).batch(32),
                 latent_dim=2, dtype="float64", mesh=dp4)
    refs["ae"] = _parts(am, shard_batch({"counts": W.AE_X[:32],
                                         "indices": np.arange(32)}, dp4),
                        W.ae_samples(am))

    rng = np.random.default_rng(5)
    theta = rng.gamma(1.0, 1.0, (W.S, W.B, W.P)).astype(np.float32)
    v = rng.gamma(1.0, 1.0, (W.S, W.P, W.D)).astype(np.float32)
    phi = rng.gamma(1.0, 0.1, (W.S, 1, W.D)).astype(np.float32)
    refs["k4"] = np.asarray(fused_poisson_row_loglik_sharded(
        theta, v, phi, W.X.astype(np.float32), 1.0, dpfp,
        log_transform=False, interpret=True))
    return refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the four ranks' results, the single-process port's, JAX's): the
    world runs while this process computes both references."""
    outdir = tmp_path_factory.mktemp("torch_parallel")
    models = _jax_models()
    _write_draws(outdir, models)
    procs = start_world(outdir, "parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)       # the world's four ranks share the host
    try:
        single = {case: getattr(W, "case_" + case)(None, str(outdir))
                  for case in W.SUITES["parallel"]}
        refs = _jax_refs(models)
    finally:
        torch.set_num_threads(threads)
        ranks = join_world(procs, outdir)
    return ranks, single, refs


def got(run, case, layout, rank=0):
    """A case's results on ``rank`` (a rank that failed failed the
    fixture)."""
    return run[0][rank][(case, layout)]


def close(a, b, rtol, atol=0.0, err=""):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol, err_msg=err)


def close_tree(a, b, rtol, atol=0.0, err=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (err, sorted(a), sorted(b))
        for k in a:
            close_tree(a[k], b[k], rtol, atol, f"{err}/{k}")
    else:
        close(a, b, rtol, atol, err)


def same_on_every_rank(run, case, layout, keys):
    for r in range(1, WORLD):
        for k in keys:
            close_tree(got(run, case, layout, r)[k],
                       got(run, case, layout)[k], 0, 0, f"rank {r} {k}")


ALL = tuple(W.LAYOUTS)


# ------------------------------------------------------------------ :49 :63
@pytest.mark.parametrize("layout", ALL)
def test_dp_sharded_loss_matches_single_device(run, layout):
    """:49: the loss of one step on the JAX draws, on every layout, equals
    one process and JAX's dp x fp mesh."""
    res = got(run, "loss_grad", layout)
    close(res["loss"], run[1]["loss_grad"]["loss"], 1e-10)
    close(res["loss"], run[2]["loss"], 1e-9)
    same_on_every_rank(run, "loss_grad", layout, ["loss"])


@pytest.mark.parametrize("layout", ALL)
def test_dp_fp_sharded_grad_matches_single_device(run, layout):
    """:63: every gradient (reduced over the ranks that hold the copy,
    gathered whole) equals one process and JAX's dp x fp gradients."""
    res = got(run, "loss_grad", layout)
    close_tree(res["grads"], run[1]["loss_grad"]["grads"], 1e-9, 1e-13)
    close_tree(res["grads"], run[2]["grads"], 1e-9, 1e-13)
    same_on_every_rank(run, "loss_grad", layout, ["grads"])


def test_full_train_step_on_mesh(run):
    """:90: two train steps (clip, Adam) on the dp x fp mesh: finite and
    equal to one process."""
    res = got(run, "loss_grad", "dpfp")
    assert np.isfinite(res["steps"]).all()
    close(res["steps"], run[1]["loss_grad"]["steps"], 1e-10)


def test_graft_entry_dryrun(run):
    """:113: parallel.dryrun_multichip(4) in the world (dp x fp step with
    the fused kernels' twins, mixed loss, dp COO loss), and in one
    process."""
    res = got(run, "dryrun", "dp")["dryrun"]
    assert (res["dp"], res["fp"]) == (2, 2)
    assert np.isfinite([res[k] for k in ("loss", "loss_step2", "mixed_loss",
                                         "sparse_coo_loss")]).all()
    assert np.isfinite(run[1]["dryrun"]["dryrun"]["loss"])


# ------------------------------------------------------------ :125 :158 :768
@pytest.mark.parametrize("layout", ALL)
def test_fit_routes_dp_fp_sharding_and_matches_single_device(run, layout):
    """:125 (and :768 on the dcn x dp layout): fit() on the mesh, params
    split over fp, reproduces one process; the parameters come back whole
    and encode works."""
    res = got(run, "fit", layout)
    close(res["auto"], run[1]["fit"]["auto"], 1e-10)
    assert res["auto_u"] == (W.D, W.P)
    close(res["auto_z"], run[1]["fit"]["auto_z"], 1e-9)
    same_on_every_rank(run, "fit", layout, ["auto"])


@pytest.mark.parametrize("layout", ("dpfp", "fp"))
def test_fit_param_sharding_replicated_option(run, layout):
    """:158: param_sharding='replicated' on an fp mesh trains, equal to
    one process."""
    res = got(run, "fit", layout)
    assert np.isfinite(res["replicated"]).all()
    close(res["replicated"], run[1]["fit"]["replicated"], 1e-10)


def test_fit_routes_dcn_dp_fp_sharding_matches_single_device(run):
    """:768: the multi-slice (dcn, dp) layout, rows over both."""
    res = got(run, "fit", "dcn")
    close(res["auto"], run[1]["fit"]["auto"], 1e-10)
    close(res["replicated"], run[1]["fit"]["replicated"], 1e-10)


# ----------------------------------------------------------- :173 :217 :743
@pytest.mark.parametrize("layout", ALL)
def test_fused_likelihood_composes_with_mesh(run, layout):
    """:173: the fused x part (K1's twin on each tile, the statistics
    combined over the ranks) equals the plain x part on the mesh and JAX's
    interpreted sharded kernel (float32 twins: 1e-5); its gradients equal
    one process's fused gradients at float32's 1e-5 and the plain ones
    where the clip bound is interior (5e-4, as spmf_tpu)."""
    res = got(run, "fused", layout)
    single = run[1]["fused"]
    assert res["fusion_ok"]
    close(res["fused"], res["plain"], 1e-5)
    close(res["fused"], single["fused"], 1e-6)
    close(res["fused"], run[2]["fused"], 1e-5)
    close(res["plain"], single["plain"], 1e-10)
    close_tree(res["fused_grads"], single["fused_grads"], 1e-5, 1e-7)
    close_tree(res["fused_grads"], res["plain_grads"], 5e-4, 1e-7)
    close_tree(res["plain_grads"], single["plain_grads"], 1e-9, 1e-13)


def test_fused_fit_runs_on_mesh(run):
    """:217: fit() with the fused likelihood on dp x fp: finite, and one
    process's trajectory at float32's 1e-6."""
    res = got(run, "fused", "dpfp")
    assert np.isfinite(res["fit"]).all()
    close(res["fit"], run[1]["fused"]["fit"], 1e-6)


@pytest.mark.parametrize("layout", ALL)
def test_static_clip_composes_with_mesh(run, layout):
    """:743: clip='static' (K2's twin, one SUM) equals the reference clip
    on the mesh and JAX's static sharded kernel."""
    res = got(run, "fused", layout)
    close(res["static"], res["fused"], 1e-6)
    close(res["static"], run[2]["static"], 1e-5)
    close_tree(res["static_grads"], res["fused_grads"], 1e-6, 1e-9)


def test_fused_likelihood_composes_with_dcn_mesh(run):
    """:794: rows split over (dcn, dp) jointly; a batch the row ranks do
    not divide is refused with the actionable reason."""
    res = got(run, "fused", "dcn")
    close(res["fused"], res["plain"], 1e-5)
    ok, reason = res["fusion_bad"]
    assert not ok and "does not divide mesh axes" in reason


# ------------------------------------------------------------ :241 :281 :318
@pytest.mark.parametrize("layout", ("dpfp", "fp"))
def test_fused_ig_sampler_sharded_assembly_exact(run, layout):
    """:241: with a deterministic kernel the per-slice assembly (local
    slices of the fp-split variables, the replicated ones whole, log q
    summed over fp) reproduces the whole computation exactly."""
    res = got(run, "ig", layout)
    assert res["sharded_ok"]
    shape, axes = W.LAYOUTS[layout]
    fp = shape[axes.index("fp")]
    full = run[1]["ig"]["det_values"]
    for n, v in full.items():
        parts = [got(run, "ig", layout, r)["det_values"][n]
                 for r in range(fp)]          # ranks 0..fp-1: one fp line
        if parts[0].shape == v.shape:
            close(parts[0], v, 1e-6, err=n)
        else:
            ax = next(i for i, (a, b) in enumerate(zip(parts[0].shape,
                                                        v.shape)) if a != b)
            close(np.concatenate(parts, axis=ax), v, 1e-6, err=n)
    close(res["det_logq"], run[1]["ig"]["det_logq"], 1e-5)


@pytest.mark.parametrize("layout", ("dpfp", "fp"))
def test_fused_ig_sampler_sharded_logq_identity_and_grads(run, layout):
    """:281: with K3's twin on the slices (seed base + fp index), the
    summed log q equals the surrogate density of the values it returns,
    and every IG parameter gets a finite, nonzero gradient."""
    res = got(run, "ig", layout)
    close(res["logq"], res["manual"], 1e-4)
    assert res["grads_nonzero"]
    same_on_every_rank(run, "ig", layout, ["logq"])


def test_fused_ig_sampler_plain_under_dp_mesh(run):
    """:318: a row mesh keeps the plain fused path (one K3 call, the same
    seed on every rank): the fit equals one process at float32's 1e-5."""
    res = got(run, "ig", "dp")
    assert not res["sharded_ok"]
    close(res["fit"], run[1]["ig"]["fit"], 1e-5)


@pytest.mark.parametrize("layout", ("dpfp", "fp"))
def test_fused_normal_sampler_full_width_then_sliced(run, layout):
    """K6's twin (``fused_normals``) on an fp mesh draws the whole Normal
    block with the one-process seed and keeps this rank's columns: one
    step's loss and gradients equal one process's at float32's 1e-5 (of
    each gradient leaf's largest entry), on every rank."""
    res, one = got(run, "normals", layout), run[1]["normals"]
    assert res["fused_ok"] and one["fused_ok"]
    close(res["loss"], one["loss"], 1e-5)
    for n, sub in one["grads"].items():
        for k, g in sub.items():
            close(res["grads"][n][k], g, 0, 1e-5 * np.abs(g).max(),
                  f"{n}/{k}")
    same_on_every_rank(run, "normals", layout, ["loss"])


# ---------------------------------------------------------- :347 :491 :537
@pytest.mark.parametrize("layout", ALL)
def test_coo_energy_dp_sharded_matches_single_device(run, layout):
    """:347: the COO energy, triplets shuffled and split over every rank,
    segment sums / row sums / nonzero sums summed over the mesh, equals
    one process and JAX's dp-sharded energy; its loss and gradients on the
    JAX draws too."""
    res = got(run, "coo", layout)
    close_tree(res["energy"], run[1]["coo"]["energy"], 1e-10)
    close_tree(res["energy"], run[2]["coo_energy"], 1e-9)
    close(res["loss"], run[1]["coo"]["loss"], 1e-10)
    close(res["loss"], run[2]["coo_loss"], 1e-9)
    close_tree(res["grads"], run[1]["coo"]["grads"], 1e-9, 1e-13)
    close_tree(res["grads"], run[2]["coo_grads"], 1e-9, 1e-13)


@pytest.mark.parametrize("layout", ALL)
def test_coo_dense_scatter_composes_with_dp_mesh(run, layout):
    """:491: the dense scatter builds this rank's tile; the energy equals
    one process's dense energy and JAX's on its dp mesh."""
    res = got(run, "coo", layout)
    close_tree(res["scatter"], run[1]["coo"]["scatter_dense"], 1e-10)
    close_tree(res["scatter"], res["scatter_dense"], 1e-10)
    close_tree(res["scatter"], run[2]["scatter"], 1e-9)


@pytest.mark.parametrize("layout", ("dp", "dpfp", "dcn"))
def test_coo_gather_energy_composes_with_fp_mesh(run, layout):
    """:537: B=7 defeats the row split, so the gather energy serves the
    mesh (triplets over every axis, A, v, phi gathered over fp); it equals
    the dense energy of one process and JAX's gather energy on its dp x fp
    mesh, and a padding the ranks do not divide raises the documented
    error."""
    res = got(run, "coo", layout)
    assert "gather energy dispatched" in res["gather_reason"]
    close_tree(res["gather"], run[1]["coo"]["gather_dense"], 1e-10)
    close_tree(res["gather"], run[2]["gather"], 1e-9)
    assert "must divide the mesh device" in res["bad"]


# ----------------------------------------------------------------- :406 :468
@pytest.mark.parametrize("layout", ("dpfp", "fp"))
def test_mixed_fused_composes_with_mesh(run, layout):
    """:406: the codes lane splits over fp like eta: the fused mixed x part
    equals one process and JAX's sharded kernel (float32 twins), the plain
    one equals one process at 1e-10, and the gradients agree."""
    res = got(run, "mixed", layout)
    single = run[1]["mixed"]
    assert res["fused_kind"] == ("mixed", 0.7)
    close(res["fused"]["x"], single["fused"]["x"], 1e-6)
    close(res["fused"]["x"], run[2]["mixed"], 1e-5)
    close_tree(res["plain"], single["plain"], 1e-10)
    close_tree(res["fused_grads"], single["fused_grads"], 1e-5, 1e-7)
    close_tree(res["plain_grads"], single["plain_grads"], 1e-9, 1e-13)


@pytest.mark.parametrize("layout", ("dp", "dcn"))
def test_autoencoder_trains_on_dp_mesh(run, layout):
    """:468: the autoencoder on a row mesh (weights replicated, the
    likelihood summed over the row ranks) reproduces one process; its
    likelihood on given weights equals JAX's on a dp mesh."""
    res = got(run, "autoencoder", layout)
    close(res["fit"], run[1]["autoencoder"]["fit"], 1e-10)
    close(res["x"], run[1]["autoencoder"]["x"], 1e-10)
    close(res["x"], run[2]["ae"]["x"], 1e-9)


# ------------------------------------------------------------ :587 :621 :722
@pytest.mark.parametrize("layout", ALL)
def test_epoch_scan_composes_with_mesh(run, layout):
    """:587: the scan path on the mesh (every rank every row of its
    columns, the global permutation, its rows of each batch; two full
    batches and a remainder) reproduces one process's scan; it runs
    uncaptured and says why, and the parameters come back whole."""
    res = got(run, "scan", layout)
    close(res["scan"], run[1]["scan"]["scan"], 1e-10)
    assert res["scan_extras"]["epoch_scan"] is True
    assert res["scan_extras"]["captured"] is False
    assert "ranks" in res["scan_extras"]["capture_reason"]
    assert res["scan_u"] == (W.D, W.P)


@pytest.mark.parametrize("layout", ("dpfp",))
def test_epoch_chunk_composes_with_mesh(run, layout):
    """:621: chunks of 3 epochs on the meshed scan equal single epochs bit
    for bit (losses and parameters)."""
    res = got(run, "scan", layout)
    assert res["chunk_used"] == 3
    np.testing.assert_array_equal(res["chunked"], res["single"])
    assert res["chunk_params_equal"]
    close(res["single"], run[1]["scan"]["single"], 1e-10)


@pytest.mark.parametrize("layout", ("dpfp",))
def test_epoch_scan_mesh_composes_with_fused_kernel(run, layout):
    """:722: the fused kernel inside the meshed scan: engaged, finite, and
    one process's trajectory at float32's 1e-6."""
    res = got(run, "scan", layout)
    assert res["fused_scan_engaged"]
    assert np.isfinite(res["fused_scan"]).all()
    close(res["fused_scan"], run[1]["scan"]["fused_scan"], 1e-6)


# ----------------------------------------------------------------- :650 :694
@pytest.mark.parametrize("layout", ALL)
def test_waic_streaming_kernel_composes_with_mesh(run, layout):
    """:650: waic() on the mesh (K4's twin per tile, summed over fp, rows
    gathered at the end) equals one process (spmf_tpu's tolerances: the
    float32 twin's order moves pwaic's cancellation), and the sharded K4
    equals the whole one and JAX's."""
    res = got(run, "waic", layout)
    for k in ("waic", "lppd", "pwaic", "se"):
        close(res["waic"][k], run[1]["waic"]["waic"][k], 1e-5, 1e-6, k)
    assert res["waic"]["n_rows"] == W.B
    close(res["k4"], run[1]["waic"]["k4"], 2e-5, 1e-4)
    close(res["k4"], run[2]["k4"], 2e-5, 1e-4)


@pytest.mark.parametrize("layout", ALL)
def test_coo_row_scorer_composes_with_mesh(run, layout):
    """:694: the COO row scorer, triplets over the mesh, per-row partials
    summed: waic over COO batches equals one process, and the per-row
    log-likelihoods on given samples equal one process's and JAX's."""
    res = got(run, "waic", layout)
    for k in ("waic", "lppd", "pwaic", "se"):
        close(res["coo_waic"][k], run[1]["waic"]["coo_waic"][k], 1e-10,
              1e-12, k)
    close(res["coo_rows"], run[1]["waic"]["coo_rows"], 1e-10)
    close(res["coo_rows"], run[2]["coo_rows"], 1e-9)


# ---------------------------------------------------------------------- :825
def test_make_multislice_mesh_single_process_shape(run):
    """:825: one node of four ranks is one slice: ('dcn', 'dp', 'fp') with
    dcn 1, dp 2, fp 2; the layouts' meshes have their shapes."""
    res = got(run, "meshes", "dpfp")
    names, shape = res["multislice"]
    assert names == ("dcn", "dp", "fp")
    assert shape == {"dcn": 1, "dp": 2, "fp": 2}
    assert res["shape"] == {"dp": 2, "fp": 2}
    coords = sorted(tuple(got(run, "meshes", "dpfp", r)["coords"].values())
                    for r in range(WORLD))
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_trivial_mesh_and_refusals():
    """In one process a mesh is trivial; a batch the row ranks do not
    divide, a non-Mesh mesh and an fp autoencoder are refused."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.parallel import (
        data_parallel_mesh,
        make_mesh,
        process_local_rows,
        shard_batch,
    )

    mesh = data_parallel_mesh()
    assert mesh.trivial and mesh.shape == {"dp": 1}
    batch = {"counts": W.X}
    assert shard_batch(batch, mesh) is batch
    assert process_local_rows(10) == (0, 10)
    with pytest.raises(ValueError, match="every rank"):
        make_mesh((2,), ("dp",), devices=[0, 1])
    with pytest.raises(TypeError, match="parallel.Mesh"):
        PoissonFactorization(latent_dim=2, feature_dim=4, device="cpu",
                             mesh="dp")
    torch.manual_seed(0)


@pytest.mark.parametrize("device,backend,want", [
    ("cpu", None, "gloo"), ("cuda", None, "nccl"), (None, None, "nccl"),
    ("cuda", "gloo", "gloo")])
def test_initialize_distributed_backend_follows_device(monkeypatch, device,
                                                       backend, want):
    """The default backend is NCCL for ranks on cards and gloo for ranks
    on the CPU, as ``device`` says (None: the card where one is present);
    an explicit backend stands."""
    from spmf_tpu_torch.parallel import initialize_distributed

    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert initialize_distributed("127.0.0.1:1", 2, 0, backend=backend,
                                  device=device)
    assert seen["backend"] == want


def test_dryrun_entry_point_runs_on_the_card_by_default(monkeypatch):
    """``python -m spmf_tpu_torch.parallel.dryrun N`` runs on the card
    unless ``--device cpu`` is given: a host without a card raises and
    names the flag."""
    from spmf_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.main(["1"])
    assert dryrun.main(["1", "--device", "cpu"]) == 0
