"""Worker ranks of the port's multi-process CPU tests.

Not a pytest file (leading underscore): ``tests/test_torch_parallel.py``
and ``tests/test_torch_multiprocess.py`` start four of these as one gloo
world (``python _torch_multiprocess_worker.py RANK WORLD PORT OUTDIR
SUITE``). Each rank runs every case of its suite on every mesh layout the
case takes, and writes its results (numpy arrays, floats, strings) to
``OUTDIR/rank{RANK}.pkl``; the tests read them from a module-scoped
fixture. The same case functions run with ``mesh=None`` in the test
process, which gives the single-process reference on the same inputs.

The inputs, and the samples the energy cases take, are made with numpy
from fixed seeds; the base draws of the loss and gradient cases are read
from ``OUTDIR/draws.npz`` (the JAX package's draws for its key, written by
the test before the world starts), so the ranks, the single-process port
and the JAX package all see the same randomness.
"""
import os
import pickle
import sys
import time
import traceback

import numpy as np

B, D, P, S = 32, 16, 4, 3
X = np.random.default_rng(0).poisson(1.0, size=(B, D)).astype(np.float64)

#: name -> (mesh shape, axis names) of the four-rank layouts
LAYOUTS = {
    "dp": ((4,), ("dp",)),
    "dpfp": ((2, 2), ("dp", "fp")),
    "fp": ((1, 4), ("dp", "fp")),
    "dcn": ((2, 2), ("dcn", "dp")),
}


def make_layout(name):
    from spmf_tpu_torch.parallel import make_mesh, make_multislice_mesh

    if name is None:
        return None
    shape, axes = LAYOUTS[name]
    if axes[0] == "dcn":
        # a node of two ranks is the slice stand-in
        os.environ["LOCAL_WORLD_SIZE"] = str(shape[1])
        return make_multislice_mesh(ici_shape=shape[1:], ici_axis_names=axes[1:])
    return make_mesh(shape, axes)


def pf(mesh=None, **kw):
    from spmf_tpu_torch import PoissonFactorization

    kw.setdefault("dtype", "float64")
    kw.setdefault("scale_columns", False)
    return PoissonFactorization(latent_dim=P, feature_dim=kw.pop("D", D),
                                u_tau_scale=0.1, device="cpu", mesh=mesh,
                                **kw)


def _np(t):
    import torch

    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return t


def samples_for(model, seed, sample_size=S):
    """Positive values of every surrogate variable's whole shape with a
    leading sample axis (valid inputs to the energies of both packages)."""
    rng = np.random.default_rng(seed)
    return {n: rng.lognormal(-1.0, 0.5, (sample_size,) + tuple(s.shape))
            for n, s in model._surrogate.surrogates.items()}


def _draws(outdir, name):
    with np.load(os.path.join(outdir, "draws.npz")) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files
                if k.startswith(name + "/")}


def _plan(model, mesh):
    from spmf_tpu_torch.vi.minibatch import _MeshPlan

    return None if mesh is None else _MeshPlan(mesh, model._surrogate,
                                               "auto")


def _live(params):
    return {n: {k: t.detach().clone().requires_grad_(True)
                for k, t in sub.items()} for n, sub in params.items()}


def loss_and_grads(model, mesh, batch, draws, sample_size=S, rows=None):
    """The ELBO loss of one step and the gradients of every parameter,
    whole, as the fit engine computes them on ``mesh``."""
    import torch

    from spmf_tpu_torch.parallel import collectives

    plan = _plan(model, mesh)
    params = _live(model.surrogate_params if plan is None
                   else plan.local_params(model.surrogate_params))
    local = batch if plan is None else plan.batch(batch)
    gen = torch.Generator().manual_seed(0)
    samples, logq = model._surrogate.sample_and_log_prob(
        params, gen, (sample_size,), draws=draws)
    lp = model.unormalized_log_prob(data=local, **samples)
    n_rows = len(batch["indices"]) if rows is None else rows
    loss = -torch.mean(lp - logq) / n_rows
    if plan is None:
        loss.backward()
        grads = {n: {k: t.grad for k, t in sub.items()}
                 for n, sub in params.items()}
    else:
        (loss / mesh.size).backward()
        collectives.reduce_gradients(plan.buckets(params))
        grads = plan.full_params({n: {k: t.grad for k, t in sub.items()}
                                  for n, sub in params.items()})
    return float(loss.detach()), _np(grads)


def energy_parts(model, mesh, batch, samples):
    """The energy parts on ``mesh`` (this rank's part of a dense batch, the
    whole of a sparse one) from whole-width samples."""
    import torch

    from spmf_tpu_torch.parallel.mesh import shard_batch

    samples = {k: torch.as_tensor(v) for k, v in samples.items()}
    local = batch if mesh is None else shard_batch(batch, mesh)
    with torch.no_grad():
        parts = model.unormalized_log_prob_parts(local, **samples)
    return {k: _np(v) for k, v in parts.items()}


# ------------------------------------------------------------- the cases
def case_loss_grad(mesh, outdir):
    """tests/test_sharding.py:49 / :63 / :90: the loss and every gradient
    of one step on the JAX draws; then two train steps."""
    model = pf(mesh)
    batch = {"counts": X, "indices": np.arange(B)}
    loss, grads = loss_and_grads(model, mesh, batch, _draws(outdir, "pf"))
    losses = model.fit(batched_data_factory=batch, num_steps=2,
                       learning_rate=0.05, sample_size=S, seed=0,
                       verbose=False, rel_tol=None, clip_value=5.0)
    return {"loss": loss, "grads": grads, "steps": np.asarray(losses)}


def case_fit(mesh, outdir):
    """:125 / :158 / :768: fit() on the mesh (params split over fp, then
    replicated) against one process; encode after."""
    import torch

    batch = {"counts": X, "indices": np.arange(B)}
    out = {}
    for mode in ("auto", "replicated"):
        m = pf(mesh)
        losses = m.fit(batched_data_factory=batch, num_steps=3,
                       learning_rate=0.05, sample_size=S, seed=7,
                       verbose=False, rel_tol=None, param_sharding=mode)
        out[mode] = np.asarray(losses)
        out[mode + "_u"] = tuple(m.surrogate_params["u"]["loc"].shape)
        out[mode + "_z"] = _np(m.encode(torch.as_tensor(X[:4])))
    return out


def case_fused(mesh, outdir):
    """:173 / :743 / :794: the fused x part (the K1 twin, and K2 at
    clip='static') against the plain one on the same mesh, the gradients
    of both, and the batch shape a mesh cannot split."""
    batch = {"counts": X, "indices": np.arange(B)}
    out = {}
    for name, kw in (("plain", dict(fused_likelihood=False)),
                     ("fused", dict(fused_likelihood=True)),
                     ("static", dict(fused_likelihood=True,
                                     likelihood_clip="static"))):
        m = pf(mesh, **kw)
        out[name] = energy_parts(m, mesh, batch, samples_for(m, 0))["x"]
        out[name + "_loss"], out[name + "_grads"] = loss_and_grads(
            m, mesh, batch, _draws(outdir, "pf"))
        if name == "fused":
            out["fusion_bad"] = m._fusion_check((B + 2, D))
            out["fusion_ok"] = m._can_fuse((B, D))
            m2 = pf(mesh, fused_likelihood=True)
            out["fit"] = np.asarray(m2.fit(
                batched_data_factory=batch, num_steps=2, learning_rate=0.05,
                sample_size=S, seed=7, verbose=False, rel_tol=None))
    return out


def _ig_model(mesh, **kw):
    return pf(mesh, dtype="float32", gamma_sampler="fused",
              fused_likelihood=False, **kw)


def case_ig(mesh, outdir):
    """:241 / :281: the fused IG block on local slices (K3's twin with
    seed base + fp index): the assembly with a deterministic kernel is
    exact, log q is the sum of the parts and every IG parameter gets a
    gradient; and :318, the plain fused path on a row mesh."""
    import torch

    from spmf_tpu_torch.vi.minibatch import _MeshPlan

    out = {}
    m = _ig_model(mesh)
    sur = m._surrogate
    names = sur._ig_names
    out["sharded_ok"] = sur._fused_igs_sharded_ok(names, (S,))
    plan = _plan(m, mesh)
    params = (m.surrogate_params if plan is None
              else plan.local_params(m.surrogate_params))

    def det(a, b, seed, S_, antithetic=False):
        y = (2.0 * a + b).expand((S_,) + a.shape)
        return y, torch.sum(a * b).expand((S_,))

    sur._ig_kernel = det
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        values, logq = sur._sample_igs(names, params, gen, (S,))
    out["det_values"] = _np(values)
    out["det_logq"] = _np(logq)
    del sur._ig_kernel

    live = _live(params)
    gen = torch.Generator().manual_seed(3)
    values, logq = sur._sample_igs(names, live, gen, (S,))
    with torch.no_grad():
        # the fp-split variables' densities are this rank's part of the sum
        split = [n for n in names if sur._split_axis(n) is not None]
        manual = sum(sur.surrogates[n].log_prob(live[n], values[n])
                     for n in names if n not in split)
        if split:
            manual = manual + mesh.all_sum(sum(
                sur.surrogates[n].log_prob(live[n], values[n])
                for n in split), ("fp",))
    out["logq"] = _np(logq)
    out["manual"] = _np(manual)
    torch.sum(logq).backward()
    if plan is not None:
        from spmf_tpu_torch.parallel import collectives

        collectives.reduce_gradients(
            _MeshPlan(mesh, sur, "auto").buckets(live))
    out["grads_nonzero"] = all(
        bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().max()) > 0
        for n in names for t in live[n].values())
    if mesh is None or mesh.fp_axis is None:
        data = {"counts": X.astype(np.float32), "indices": np.arange(B)}
        out["fit"] = np.asarray(_ig_model(mesh).fit(
            batched_data_factory=data, num_steps=2, learning_rate=0.05,
            sample_size=S, seed=11, verbose=False, rel_tol=None))
    return out


def case_normals(mesh, outdir):
    """The fused Normal sampler (K6's twin, ``fused_normals``) on an fp
    mesh: drawn at full width from the gathered parameters with the same
    seed on every rank, then sliced, so one step's loss and gradients
    equal one process's (horshoe_plus=False: the surrogate is all Normal,
    so no IG block draws per shard)."""
    m = pf(mesh, dtype="float32", horshoe_plus=False,
           gamma_sampler="fused", fused_likelihood=False)
    sur = m._surrogate
    sur.fused_normals = True
    batch = {"counts": X.astype(np.float32), "indices": np.arange(B)}
    loss, grads = loss_and_grads(m, mesh, batch, None)
    return {"fused_ok": sur._fused_normals_ok(sur._normal_names, (S,))
            and not sur._ig_names, "loss": loss, "grads": grads}


def coo_batch(dense, mult, seed=None):
    """A padded triplet batch of ``dense`` (pad a multiple of ``mult``;
    triplets shuffled when ``seed`` is given)."""
    from spmf_tpu_torch.data import SparseCounts

    n = dense.shape[0]
    rows, cols, vals = SparseCounts.from_dense(dense).batch_coo(np.arange(n))
    pad = -(-max(len(vals), 1) // mult) * mult
    batch = {"coo_rows": np.zeros(pad, np.int64),
             "coo_cols": np.zeros(pad, np.int64),
             "coo_vals": np.zeros(pad), "indices": np.arange(n)}
    batch["coo_rows"][:len(vals)] = rows
    batch["coo_cols"][:len(vals)] = cols
    batch["coo_vals"][:len(vals)] = vals
    if seed is not None:
        perm = np.random.default_rng(seed).permutation(pad)
        for k in ("coo_rows", "coo_cols", "coo_vals"):
            batch[k] = batch[k][perm]
    return batch


COO_DENSE = np.random.default_rng(9).poisson(0.8, (40, 12)).astype(float)
SCATTER_DENSE = np.random.default_rng(10).poisson(0.6, (32, 12)).astype(float)
#: B=7 defeats the row split (and so the dense scatter) on a row mesh
GATHER_DENSE = np.random.default_rng(0).poisson(0.8, (7, 8)).astype(float)


def case_coo(mesh, outdir):
    """:347 (the COO energy, triplets split over the mesh, row scaling on;
    its gradient), :491 (the dense scatter into this rank's tile) and
    :537 (the gather energy on an fp mesh against the dense energy; a
    padding the mesh does not divide raises)."""
    import torch

    from spmf_tpu_torch.data import SparseCounts

    out = {}
    from spmf_tpu_torch import PoissonFactorization

    sp = SparseCounts.from_dense(COO_DENSE)
    batch = coo_batch(COO_DENSE, 40, seed=9)

    def coo_model(**kw):
        return PoissonFactorization(latent_dim=3, feature_dim=12,
                                    u_tau_scale=0.1, dtype="float64",
                                    device="cpu", mesh=mesh, **kw)

    m = coo_model(data=sp.batch(40))
    out["energy"] = energy_parts(m, mesh, batch, samples_for(m, 1))
    loss, grads = loss_and_grads(m, mesh, batch, _draws(outdir, "coo_eps"),
                                 sample_size=3)
    out["loss"], out["grads"] = loss, grads

    ms = coo_model(scale_columns=False, sparse_dense_scatter=True)
    sc = coo_batch(SCATTER_DENSE, 8)
    out["scatter"] = energy_parts(ms, mesh, sc, samples_for(ms, 2))
    dense = {"counts": SCATTER_DENSE, "indices": np.arange(32)}
    out["scatter_dense"] = energy_parts(ms, mesh, dense, samples_for(ms, 2))

    mg = PoissonFactorization(latent_dim=2, feature_dim=8, u_tau_scale=0.1,
                              dtype="float64", device="cpu", mesh=mesh,
                              scale_columns=False, fused_likelihood=True)
    gb = coo_batch(GATHER_DENSE, 8)
    gs = samples_for(mg, 3, sample_size=2)
    out["gather"] = energy_parts(mg, mesh, gb, gs)
    out["gather_reason"] = str(mg.fusion_inactive_reason)
    if mesh is None:
        # the plain dense energy (the mesh's B=7 takes no fused kernel)
        mg.fused_likelihood = False
        out["gather_dense"] = energy_parts(
            mg, mesh, {"counts": GATHER_DENSE, "indices": np.arange(7)}, gs)
    bad = {k: (v[:-3] if np.ndim(v) and len(v) == len(gb["coo_vals"])
               else v) for k, v in gb.items()}
    try:
        energy_parts(mg, mesh, bad, gs)
        out["bad"] = "no error"
    except ValueError as exc:
        out["bad"] = str(exc)
    return out


def mixed_problem():
    """tests/test_sharding.py:406's column types and data."""
    rng = np.random.default_rng(5)
    types = ["poisson"] * 4 + ["bernoulli"] * 4 + ["normal"] * 4
    rng.shuffle(types)
    Xm = rng.poisson(1.0, size=(24, 12)).astype(np.float64)
    bern = [i for i, t in enumerate(types) if t == "bernoulli"]
    norm = [i for i, t in enumerate(types) if t == "normal"]
    Xm[:, bern] %= 2
    Xm[:, norm] = rng.normal(size=(24, len(norm)))
    return types, Xm


def case_mixed(mesh, outdir):
    """:406: the mixed family's codes lane splits over fp like eta; the
    fused x part (the twin, f32) and the plain one, and the gradient."""
    from spmf_tpu_torch import MixedFactorization

    types, Xm = mixed_problem()
    batch = {"counts": Xm, "indices": np.arange(24)}
    out = {}
    for name, fused in (("fused", True), ("plain", False)):
        m = MixedFactorization(column_types=types, latent_dim=3,
                               u_tau_scale=0.1, dtype="float64",
                               fused_likelihood=fused, obs_scale=0.7,
                               device="cpu", mesh=mesh)
        out[name] = energy_parts(m, mesh, batch, samples_for(m, 4,
                                                             sample_size=2))
        out[name + "_kind"] = m._fused_kind()
        out[name + "_loss"], out[name + "_grads"] = loss_and_grads(
            m, mesh, batch, _draws(outdir, "mixed_eps"), sample_size=2)
    return out


#: tests/test_sharding.py:468's counts
AE_X = np.random.default_rng(4).poisson(1.0, (64, 6)).astype(np.float64)


def ae_samples(model):
    """Weights and biases near 0 for every layer of an autoencoder."""
    rng = np.random.default_rng(6)
    return {n: rng.normal(0.0, 0.3, (4,) + tuple(s.shape))
            for n, s in model._surrogate.surrogates.items()}


def case_autoencoder(mesh, outdir):
    """tests/test_sharding.py:468: the autoencoder on every layout against
    one process: on a row mesh its weights whole; on fp=2 every w_l split
    over its output axis (D=6 and latent 2 both divide), on fp=4 none; the
    first step's loss and gradients, a two-step fit, the energy on given
    weights, waic and encode after the fit."""
    import torch

    from spmf_tpu_torch import PoissonAutoencoder
    from spmf_tpu_torch.data import ArrayDataset

    data = ArrayDataset({"counts": AE_X, "indices": np.arange(64)}).batch(32)
    m = PoissonAutoencoder(data, latent_dim=2, dtype="float64", device="cpu",
                           mesh=mesh)
    plan = _plan(m, mesh)
    first = {"counts": AE_X[:32], "indices": np.arange(32)}
    loss, grads = loss_and_grads(m, mesh, first, None, sample_size=4)
    losses = m.fit(batched_data_factory=data, num_steps=2,
                   learning_rate=0.05, sample_size=4, verbose=False,
                   rel_tol=None)
    parts = energy_parts(m, mesh, first, ae_samples(m))
    return {"fit": np.asarray(losses), "x": parts["x"], "loss": loss,
            "grads": grads, "split": {} if plan is None else plan.split,
            "waic": m.waic(data=first, num_samples=4, sample_chunk=4),
            "z": _np(m.encode(torch.as_tensor(AE_X[:4]))),
            "w0": tuple(m.surrogate_params["w_0"]["loc"].shape)}


def case_scan(mesh, outdir):
    """:587 / :621 / :722: the scan path on the mesh (2 full batches and a
    remainder), chunks of 3 against single epochs, and the fused kernel
    inside the scan. And 31 rows at batch 12: the remainder of 7 that the
    row ranks do not divide is replicated over them (spmf_tpu's
    ``_row_spec``), with fusion off for it alone; a full batch they do not
    divide, and the general loop's remainder, still raise."""
    import warnings

    from spmf_tpu_torch.data import (ArrayDataset, DeviceArrayDataset,
                                     as_data_factory)

    def run(bs, steps, rows=B, **kw):
        fused = kw.pop("fused", False)
        m = pf(mesh, fused_likelihood=fused)
        ds = DeviceArrayDataset({"counts": X[:rows],
                                 "indices": np.arange(rows)},
                                batch_size=bs, shuffle=True, seed=0,
                                device="cpu")
        losses = m.fit(batched_data_factory=as_data_factory(ds),
                       num_steps=steps, learning_rate=0.05, sample_size=S,
                       seed=7, verbose=False, rel_tol=None, **kw)
        return m, np.asarray(losses)

    def refused(fn):
        try:
            fn()
        except ValueError as exc:
            return str(exc)
        return "no error"

    out = {}
    m, out["scan"] = run(12, 3)
    out["scan_extras"] = {k: m.last_fit.extras.get(k) for k in (
        "epoch_scan", "captured", "capture_reason")}
    out["scan_u"] = tuple(m.surrogate_params["u"]["loc"].shape)
    layout = None if mesh is None else mesh.shape
    if layout in (None, {"dp": 4}, {"dp": 2, "fp": 2}, {"dcn": 2, "dp": 2}):
        _, out["odd"] = run(12, 3, rows=B - 1)
    if layout in (None, {"dp": 4}):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mf, out["odd_fused"] = run(12, 2, rows=B - 1, fused=True)
        out["odd_reason"] = str(mf.fusion_inactive_reason)
        out["odd_warnings"] = sum("fused likelihood disabled" in str(w.message)
                                  for w in caught)
    if layout == {"dp": 4}:
        out["full_refused"] = refused(lambda: run(10, 1))
        host = ArrayDataset({"counts": X[:B - 1],
                             "indices": np.arange(B - 1)}).batch(12)
        out["loop_refused"] = refused(lambda: pf(mesh).fit(
            batched_data_factory=host, num_steps=1, learning_rate=0.05,
            sample_size=S, verbose=False, rel_tol=None))
    if mesh is not None and layout != {"dp": 2, "fp": 2}:
        return out     # the chunk and fused arms: on the dp x fp mesh
    m1, out["single"] = run(8, 6, patience=2, epoch_chunk=1)
    mk, out["chunked"] = run(8, 6, patience=2, epoch_chunk=3)
    out["chunk_used"] = mk.last_fit.extras["epoch_chunk"]
    out["chunk_params_equal"] = all(
        np.array_equal(_np(a), _np(b)) for a, b in zip(
            [t for s in m1.surrogate_params.values() for t in s.values()],
            [t for s in mk.surrogate_params.values() for t in s.values()]))
    mf, out["fused_scan"] = run(16, 2, fused=True)
    out["fused_scan_engaged"] = mf.last_fit.extras["epoch_scan"]
    return out


def case_waic(mesh, outdir):
    """:650 (the row kernel's twin on the tile, summed over fp: waic on
    the mesh against one process, and the sharded K4 against the whole)
    and :694 (the COO row scorer, triplets over the mesh)."""
    import torch

    from spmf_tpu_torch.data import SparseCounts
    from spmf_tpu_torch.ops.fused_poisson import (
        fused_poisson_row_loglik,
        fused_poisson_row_loglik_sharded,
    )

    out = {}
    m = pf(mesh, fused_likelihood=True)
    out["waic"] = m.waic(data={"counts": X, "indices": np.arange(B)},
                         num_samples=4, sample_chunk=4)
    rng = np.random.default_rng(5)
    theta = rng.gamma(1.0, 1.0, (S, B, P)).astype(np.float32)
    v = rng.gamma(1.0, 1.0, (S, P, D)).astype(np.float32)
    phi = rng.gamma(1.0, 0.1, (S, 1, D)).astype(np.float32)
    xs = X.astype(np.float32)
    if mesh is None:
        out["k4"] = _np(fused_poisson_row_loglik(
            torch.as_tensor(theta), torch.as_tensor(v), torch.as_tensor(phi),
            torch.as_tensor(xs), 1.0))
    else:
        r0, r1 = mesh.local_rows(B)
        c0, c1 = mesh.feature_slice(D)
        local = fused_poisson_row_loglik_sharded(
            torch.as_tensor(theta[:, r0:r1]),
            torch.as_tensor(v[..., c0:c1]),
            torch.as_tensor(phi[..., c0:c1]),
            torch.as_tensor(xs[r0:r1, c0:c1]), 1.0, mesh,
            data_axis=("dcn", "dp") if "dcn" in mesh.axis_names else "dp")
        out["k4"] = _np(mesh.gather(local, 1, mesh.row_axes)) \
            if mesh.row_axes else _np(local)
    dense = WAIC_DENSE
    sp = SparseCounts.from_dense(dense).batch(B, drop_remainder=True).as_coo()
    mc = pf(mesh)
    mc._DENSE_SCATTER_MAX_SLAB_BYTES = 0
    out["coo_waic"] = mc.waic(data=sp, num_samples=4, sample_chunk=4)
    # the scorer on given samples: this rank's rows, gathered
    batch = coo_batch(dense, 8)
    rows = mc._row_log_likelihood(batch, {
        k: torch.as_tensor(v) for k, v in samples_for(mc, 7).items()})
    out["coo_rows"] = _np(mesh.gather(rows, 1, mesh.row_axes)
                          if mesh is not None else rows)
    return out


#: tests/test_sharding.py:694's sparse counts (about 5% nonzero)
WAIC_DENSE = ((np.random.default_rng(11).random((B, D)) < 0.05)
              * np.random.default_rng(12).poisson(2.0, (B, D)))


def _sub_fit(mesh):
    m = pf(mesh)
    return np.asarray(m.fit(batched_data_factory={"counts": X,
                                                  "indices": np.arange(B)},
                            num_steps=3, learning_rate=0.05, sample_size=S,
                            seed=7, verbose=False, rel_tol=None))


def case_meshes(mesh, outdir):
    """:825: the multi-slice mesh builder with one node of four ranks, and
    the mesh's shape. Meshes over some of the world's ranks
    (tests/test_models.py:478 and :569 / :589, tests/test_engine.py:218
    take data_parallel_mesh(2) of 8 devices): data_parallel_mesh(2) and a
    mesh over ranks 2 and 3, their members' fits against one process, the
    refusals of each entry point on a rank outside a mesh, the fusion rule
    of a 7-row batch on two ranks, and data_parallel_mesh(8) in a world of
    four."""
    import warnings

    from spmf_tpu_torch.parallel import (data_parallel_mesh, make_mesh,
                                         make_multislice_mesh)

    out = {}
    if mesh is None:
        out["sub_fit"] = _sub_fit(None)
        return out
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    ms = make_multislice_mesh(ici_shape=(2, 2),
                              ici_axis_names=("dp", "fp"))
    out["multislice"] = (ms.axis_names, ms.shape)
    out["shape"] = mesh.shape
    out["coords"] = mesh.coords
    for tag, devices in (("twice", [0, 0]), ("outside", [3, 4])):
        try:
            make_mesh((2,), ("dp",), devices=devices)
            out[tag] = "no error"
        except ValueError as exc:
            out[tag] = str(exc)
    # every rank builds both meshes, in the same order
    first, last = data_parallel_mesh(2), make_mesh((2,), ("dp",),
                                                   devices=[2, 3])
    whole = data_parallel_mesh(8)
    out["whole"] = (whole.size, whole.devices.tolist(), whole.member)
    for tag, sub in (("first", first), ("last", last)):
        out[tag + "_member"] = sub.member
        out[tag + "_writes"] = sub.writes
        if sub.member:
            out[tag + "_fit"] = _sub_fit(sub)
            m = pf(fused_likelihood=True)
            m.mesh = sub
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ok = (m._can_fuse(batch_shape=(7, D)),
                      m._can_fuse(batch_shape=(7, D)),
                      m._can_fuse(batch_shape=(8, D)))
            out[tag + "_fusion"] = (ok, len(caught), str(caught[0].message))
            continue
        m = pf(sub, data={"counts": X, "indices": np.arange(B)})
        errs = []
        for call in (lambda: m.fit(num_steps=1, verbose=False),
                     lambda: m.calibrate_advi(num_steps=1, verbose=False),
                     lambda: m.waic(num_samples=2),
                     lambda: m.log_likelihood(num_samples=2)):
            try:
                call()
                errs.append("no error")
            except ValueError as exc:
                errs.append(str(exc))
        out[tag + "_refusals"] = errs
    return out


#: a feature dim that neither fp=2 nor fp=4 divides
X15 = np.random.default_rng(15).poisson(1.0, size=(B, 15)).astype(np.float64)


def case_pf15(mesh, outdir):
    """A feature dim fp does not divide (D=15): spmf_tpu leaves every
    variable and column whole (``shard_params_feature_dim``,
    ``_device_batch``) and its fusion check sends the batch to the plain
    path. The loss and gradients of one step on the JAX draws, a two-step
    fit with the fused likelihood asked for (its one warning and reason),
    and waic, against one process."""
    import warnings

    batch = {"counts": X15, "indices": np.arange(B)}
    m = pf(mesh, D=15)
    plan = _plan(m, mesh)
    out = {"split": {} if plan is None else plan.split}
    out["loss"], out["grads"] = loss_and_grads(m, mesh, batch,
                                               _draws(outdir, "pf15"))
    mf = pf(mesh, D=15, fused_likelihood=mesh is not None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["fit"] = np.asarray(mf.fit(
            batched_data_factory=batch, num_steps=2, learning_rate=0.05,
            sample_size=S, seed=7, verbose=False, rel_tol=None))
    out["reason"] = str(mf.fusion_inactive_reason)
    out["warnings"] = sum("fused likelihood disabled" in str(w.message)
                          for w in caught)
    out["u"] = tuple(mf.surrogate_params["u"]["loc"].shape)
    out["waic"] = pf(mesh, D=15).waic(data=batch, num_samples=4,
                                      sample_chunk=4)
    return out


def case_dryrun(mesh, outdir):
    """:113: the meshed dry run (dp x fp step, mixed loss, dp COO loss)."""
    from spmf_tpu_torch.parallel.dryrun import dryrun_multichip

    return {"dryrun": dryrun_multichip(4 if mesh is not None else 1,
                                       device="cpu")}


# ------------------------------------------ tests/test_multiprocess.py
def gauss_problem(mesh):
    """tests/test_engine.py's conjugate problem (z ~ N(0, 1), x_i ~ N(z,
    1)) with the energy a mesh needs: its sum over this rank's rows summed
    over the row ranks."""
    import torch

    from spmf_tpu_torch import bijectors as tfb
    from spmf_tpu_torch import distributions as tfd
    from spmf_tpu_torch.vi import surrogates as sur_mod

    x = np.random.default_rng(0).normal(1.5, 1.0, size=64)
    surrogate = sur_mod.SurrogatePosterior({"z": sur_mod.TransformedSurrogate(
        sur_mod.TrainableNormal(np.zeros((1, 1)), 0.5 * np.ones((1, 1)), 2,
                                dtype=torch.float64, device="cpu"),
        tfb.Identity())})

    def energy(batch, samples, prior_weight):
        z = samples["z"][..., 0, 0]
        lik = torch.sum(tfd.Normal(z[..., None], 1.0).log_prob(
            batch["counts"][None, :]), dim=-1)
        if mesh is not None and mesh.row_axes:
            lik = mesh.all_sum(lik, mesh.row_axes)
        return tfd.Normal(0.0, 1.0).log_prob(z) + lik

    return x, surrogate, energy


def pf_problem():
    """tests/test_multiprocess.py's counts and batches."""
    from spmf_tpu_torch.data import ArrayDataset

    Xp = np.random.default_rng(3).poisson(1.0, (64, 8))
    data = ArrayDataset({"counts": Xp, "indices": np.arange(64)}).batch(
        32, drop_remainder=True)
    return Xp, data


def _pf_fit(mesh, **kw):
    from spmf_tpu_torch import PoissonFactorization

    Xp, data = pf_problem()
    m = PoissonFactorization(latent_dim=2, feature_dim=Xp.shape[1],
                             u_tau_scale=0.1, dtype="float64", device="cpu",
                             mesh=mesh)
    m.fit(batched_data_factory=data, num_steps=2, learning_rate=0.05,
          rel_tol=None, sample_size=4, seed=0, verbose=False, **kw)
    return m


def case_gauss(mesh, outdir):
    """:28: the engine on a dp mesh over every rank."""
    import torch

    from spmf_tpu_torch.data import ArrayDataset
    from spmf_tpu_torch.vi.minibatch import fit_surrogate_posterior

    x, surrogate, energy = gauss_problem(mesh)
    data = ArrayDataset({"counts": x}).batch(32)
    result = fit_surrogate_posterior(
        energy, surrogate, surrogate.init(), lambda: iter(data),
        sample_size=8, num_steps=3, learning_rate=0.05, rel_tol=None,
        verbose=False, dtype=torch.float64, seed=0, mesh=mesh)
    return {"losses": np.asarray(result.losses)}


def case_pf(mesh, outdir):
    """:56 (dp x fp) and :86 (the dcn layout): the flagship model."""
    m = _pf_fit(mesh)
    return {"losses": np.asarray(m.last_fit.losses),
            "u": _np(m.surrogate_params["u"]["loc"])}


def case_ckpt(mesh, outdir):
    """:115: full-state checkpoints of fp-split params (gathered; rank 0
    alone writes), then a fresh model resumes from the directory."""
    from spmf_tpu_torch.vi import minibatch

    writes = []
    real = minibatch.save_fit_state

    def counted(path, *a, **kw):
        writes.append(os.path.basename(path))
        return real(path, *a, **kw)

    ckdir = os.path.join(outdir, "mp" if mesh is not None else "sp")
    minibatch.save_fit_state = counted
    try:
        m1 = _pf_fit(mesh, checkpoint_dir=ckdir)
        m2 = _pf_fit(mesh, resume_from=ckdir)
    finally:
        minibatch.save_fit_state = real
    return {"first": np.asarray(m1.last_fit.losses),
            "losses": np.asarray(m2.last_fit.losses),
            "writes": writes, "path": m1.last_fit.checkpoint_path,
            "u": _np(m2.surrogate_params["u"]["loc"])}


SUITES = {
    "parallel": {
        "loss_grad": tuple(LAYOUTS),
        "fit": tuple(LAYOUTS),
        "fused": tuple(LAYOUTS),
        "ig": ("dp", "dpfp", "fp"),
        "normals": ("dpfp", "fp"),
        "coo": tuple(LAYOUTS),
        "mixed": ("dpfp", "fp"),
        "autoencoder": tuple(LAYOUTS),
        "pf15": ("dpfp", "fp"),
        "scan": tuple(LAYOUTS),
        "waic": tuple(LAYOUTS),
        "meshes": ("dpfp",),
        "dryrun": ("dp",),
    },
    "multiprocess": {
        "gauss": ("dp",),
        "pf": ("dpfp", "dcn"),
        "ckpt": ("dpfp",),
    },
}


def run_suite(suite, outdir):
    """Every case of ``suite`` on every layout it takes: {(case, layout):
    results}. A case that raises ends the rank (its traceback printed):
    the other ranks would wait in a collective it never reaches, until
    the world's timeout ends them too."""
    results = {}
    only = os.environ.get("WORKER_CASES")
    for case, layouts in SUITES[suite].items():
        if only and case not in only.split(","):
            continue
        fn = globals()["case_" + case]
        for layout in layouts:
            t0 = time.perf_counter()
            try:
                results[(case, layout)] = fn(make_layout(layout), outdir)
            except Exception:
                print(f"case {case} on {layout} failed:\n"
                      f"{traceback.format_exc()}", flush=True)
                os._exit(1)
            results[(case, layout)]["seconds"] = time.perf_counter() - t0
    return results


def main():
    rank, world, port, outdir, suite = sys.argv[1:6]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    torch.set_num_threads(1)
    from spmf_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", int(world), int(rank),
                           backend="gloo", timeout=120)
    results = run_suite(suite, outdir)
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
