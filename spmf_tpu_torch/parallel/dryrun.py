"""A dry run of the meshed training step (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

In a world of n ranks it builds the dp x fp mesh (fp = 2 when n is even and
at least 4), then runs at tiny shapes:

- one full training step of ``PoissonFactorization`` (float32, the fused
  likelihood and the fused IG sampler: on the card K1 and K3 on each
  rank's tile and slices, their twins on the CPU), rows split over dp and
  the feature dim over fp: sample, energy, backward, the gradient
  reduction, the elementwise clip and Adam;
- the loss and gradient of ``MixedFactorization`` on the same mesh (its
  codes lane split over fp);
- the loss and gradient of the COO energy on a dp mesh of all n ranks,
  the triplets split over the ranks.

Launch it as n gloo processes on this host::

    python -m spmf_tpu_torch.parallel.dryrun N [--device cuda|cpu]

(on the card, the default, every rank takes card 0, gloo staging the
collectives through the host; a host without a card needs
``--device cpu``). In one process, ``dryrun_multichip(1)`` runs the same
step on a trivial mesh.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _step_loss(model, mesh, batch, sample_size, rows, optimizer=None,
               params=None, seed=0):
    """One step's loss on the mesh: this rank's part of ``batch``, the
    gradient reduction and, with ``optimizer``, the clip and Adam."""
    from spmf_tpu_torch.parallel import collectives
    from spmf_tpu_torch.vi.minibatch import _MeshPlan, clip_and_step

    plan = _MeshPlan(mesh, model._surrogate, "auto")
    if params is not None:
        for sub in params.values():
            for t in sub.values():
                t.grad = None
    else:
        params = plan.local_params(model.surrogate_params)
        params = {n: {k: t.detach().clone().requires_grad_(True)
                      for k, t in sub.items()} for n, sub in params.items()}
    gen = torch.Generator(device=model.device).manual_seed(seed)
    samples, logq = model._surrogate.sample_and_log_prob(
        params, gen, (sample_size,))
    lp = model.unormalized_log_prob(data=plan.batch(batch), **samples)
    loss = -torch.mean(lp - logq) / rows
    (loss / mesh.size).backward()
    collectives.reduce_gradients(plan.buckets(params))
    grads_finite = all(bool(torch.isfinite(t.grad).all())
                       for sub in params.values() for t in sub.values())
    if optimizer is not None:
        clip_and_step(optimizer(params), 5.0)
    return float(loss.detach()), grads_finite, params


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dry run in a world of ``n_devices`` ranks (the process group
    already joined; 1: no process group). Returns the losses; raises on a
    non-finite loss or gradient."""
    from spmf_tpu_torch import MixedFactorization, PoissonFactorization
    from spmf_tpu_torch.data import SparseCounts
    from spmf_tpu_torch.parallel.mesh import _world, make_mesh
    from spmf_tpu_torch.vi.minibatch import make_optimizer

    world, rank = _world()
    if world != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) in a world of "
                           f"{world} ranks")
    fp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    dp = n_devices // fp
    mesh = make_mesh((dp, fp), ("dp", "fp"))
    D, P, S = 16 * fp, 4, 3
    B = 8 * dp
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, size=(B, D)).astype(np.float32)
    batch = {"counts": X, "indices": np.arange(B, dtype=np.int64)}

    model = PoissonFactorization(
        latent_dim=P, feature_dim=D, u_tau_scale=0.1, dtype="float32",
        scale_columns=False, mesh=mesh, fused_likelihood=True,
        gamma_sampler="fused", device=device)
    if not model._can_fuse((B, D)):
        raise RuntimeError("the dry run must take the fused likelihood")
    sur = model._surrogate
    if fp > 1 and not sur._fused_igs_sharded_ok(sur._ig_names, (S,)):
        raise RuntimeError("the dry run must take the sharded fused IG "
                           "sampler")
    opt = {}

    def optimizer(params):
        if "adam" not in opt:
            opt["adam"] = make_optimizer(params, 0.05)
        return opt["adam"]

    loss, ok, params = _step_loss(model, mesh, batch, S, B, optimizer)
    loss2, ok2, _ = _step_loss(model, mesh, batch, S, B, optimizer,
                               params=params, seed=1)

    types = (["poisson"] * (D // 2) + ["bernoulli"] * (D - D // 2 - 2)
             + ["normal"] * 2)
    Xm = X.copy()
    Xm[:, D // 2:D - 2] %= 2
    mixed = MixedFactorization(
        column_types=types, latent_dim=P, u_tau_scale=0.1, dtype="float32",
        scale_columns=False, mesh=mesh, fused_likelihood=True, device=device)
    if not mixed._can_fuse(Xm.shape):
        raise RuntimeError("the mixed dry run must take the fused likelihood")
    mloss, mok, _ = _step_loss(mixed, mesh, {"counts": Xm,
                                             "indices": batch["indices"]},
                               S, B)

    dp_mesh = make_mesh((n_devices,), ("dp",))
    rows, cols, vals = SparseCounts.from_dense(X).batch_coo(np.arange(B))
    pad = -(-max(len(vals), 1) // (n_devices * 8)) * (n_devices * 8)
    coo = {"coo_rows": np.zeros(pad, np.int64),
           "coo_cols": np.zeros(pad, np.int64),
           "coo_vals": np.zeros(pad, np.float32), "indices": np.arange(B)}
    coo["coo_rows"][:len(vals)] = rows
    coo["coo_cols"][:len(vals)] = cols
    coo["coo_vals"][:len(vals)] = vals
    coo_m = PoissonFactorization(
        latent_dim=P, feature_dim=D, u_tau_scale=0.1, dtype="float32",
        scale_columns=False, mesh=dp_mesh, sparse_dense_scatter=False,
        device=device)
    if not coo_m._coo_energy_supported():
        raise RuntimeError("the COO dry run must take the COO energy")
    closs, cok, _ = _step_loss(coo_m, dp_mesh, coo, S, B)

    out = {"loss": loss, "loss_step2": loss2, "mixed_loss": mloss,
           "sparse_coo_loss": closs, "dp": dp, "fp": fp}
    if not (ok and ok2 and mok and cok
            and np.isfinite([loss, loss2, mloss, closs]).all()):
        raise RuntimeError(f"dry run not finite: {out}")
    if rank == 0:
        print(f"dryrun_multichip ok: {n_devices} ranks, mesh dp={dp} "
              f"fp={fp}, loss={loss:.4f} mixed_loss={mloss:.4f} "
              f"sparse_coo_loss={closs:.4f}", flush=True)
    return out


def main(argv=None):
    from spmf_tpu_torch.cli import resolve_device
    from spmf_tpu_torch.parallel import free_port, initialize_distributed

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ranks", type=int)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every rank (default: cuda; on a "
                         "host without a card pass --device cpu)")
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.rank is None:
        if args.ranks == 1:
            dryrun_multichip(1, device=device)
            return 0
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "spmf_tpu_torch.parallel.dryrun",
             str(args.ranks), "--device", args.device, "--rank", str(r),
             "--port", str(port)]) for r in range(args.ranks)]
        codes = [p.wait() for p in procs]
        if any(codes):
            raise SystemExit(f"dry run ranks exited with {codes}")
        return 0
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    initialize_distributed(f"127.0.0.1:{args.port}", args.ranks, args.rank,
                           backend="gloo")
    try:
        dryrun_multichip(args.ranks, device=device)
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
