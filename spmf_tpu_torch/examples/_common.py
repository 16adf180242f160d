"""What the example modules share: their command line, the planted-structure
data of the JAX scripts, the figure writer and the record of a run (wall
seconds, ms a step, kernel launches, peak device memory)."""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from spmf_tpu_torch.cli import resolve_device

# the planted-structure examples: 10 signal columns (every third of 30),
# 20 noise columns, P = 3
D_FACTOR, D_NOISE, P_PLANTED = 10, 20, 3


def parser(doc, rows, steps):
    """The flags every example takes; ``rows`` and ``steps`` default to the
    JAX script's sizes (``rows=None``: no ``--rows``)."""
    ap = argparse.ArgumentParser(
        description=doc.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; on a host without a "
                         "card pass --device cpu)")
    ap.add_argument("--outdir", default=".",
                    help="where the figures and files go (default: the "
                         "current directory)")
    if rows is not None:
        ap.add_argument("--rows", type=int, default=rows,
                        help=f"rows of the data (default {rows})")
    ap.add_argument("--steps", "-e", "--num-steps", dest="steps", type=int,
                    default=steps,
                    help=f"most epochs of the fit (default {steps})")
    return ap


def planted_counts(rng, n, z_loc, nonlinear):
    """The JAX scripts' planted data from ``rng``: V, Z, ZV, then Poisson(1)
    noise whose every third column is replaced by the signal (ZV, or its
    nonlinear warp)."""
    d = D_FACTOR + D_NOISE
    V = np.abs(rng.normal(1.5, 0.5, size=(P_PLANTED, D_FACTOR)))
    Z = np.abs(rng.normal(z_loc, 1.0, size=(n, P_PLANTED)))
    ZV = Z.dot(V)
    X = rng.poisson(1.0, size=(n, d))
    X[:, ::3] = rng.poisson(warp(ZV) if nonlinear else ZV)
    return X


def warp(ZV):
    """The nonlinear examples' signal rate."""
    return ZV * np.exp(ZV / ZV.mean() / 10) + (ZV / ZV.mean() / 10) ** 2


def column_mass(A):
    """Mean |A| column mass of the signal columns (every third) and of the
    noise columns."""
    mass = np.abs(A).sum(1)
    return float(mass[::3].mean()), float(np.delete(mass, np.s_[::3]).mean())


def launches():
    """The kernel wrappers' launch counters, by kernel (the whole-K and the
    K-chunked kernels of K1/K2, K4 and K5 together)."""
    from spmf_tpu_torch.ops import fused_ig, fused_normal, fused_poisson

    def both(key):
        return (fused_poisson.LAUNCHES[key]
                + fused_poisson.LAUNCHES[key + "_wide"])

    return {"K1": both("stats"), "K2": both("static"), "K4": both("row_ll"),
            "K5": both("expsum"),
            "K3f": fused_ig.LAUNCHES["fwd"], "K3b": fused_ig.LAUNCHES["bwd"],
            "K6f": fused_normal.LAUNCHES["fwd"],
            "K6b": fused_normal.LAUNCHES["bwd"]}


def save_arrays(outdir, **arrays):
    """Each array as ``outdir/<name>.npy``; returns the paths."""
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for name, arr in arrays.items():
        paths.append(os.path.join(outdir, name + ".npy"))
        np.save(paths[-1], np.asarray(arr))
    return paths


def save_figure(outdir, name, draw):
    """``draw(plt)`` into ``outdir/name`` with matplotlib's Agg backend;
    returns the path, or None where matplotlib is not installed (as the
    JAX scripts skip their figures)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print(f"matplotlib unavailable; skipping {name}")
        return None
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, name)
    draw(plt)
    plt.savefig(path, bbox_inches="tight")
    plt.close("all")
    print(f"wrote {path}")
    return path


class Run:
    """The record of one example: each fit's loss trace and its steps, and
    over the whole run the wall seconds, the kernel launches and (on the
    card) the peak device memory above what was allocated before it."""

    def __init__(self, device_name):
        self.device = resolve_device(device_name)
        self.fits = []
        self._base_bytes = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            self._base_bytes = torch.cuda.memory_allocated(self.device)
        self._launches = launches()
        self._t0 = time.perf_counter()

    def record(self, model, batches_per_epoch):
        """Note ``model``'s last fit, of ``batches_per_epoch`` steps an
        epoch; returns its loss trace (the initial loss, then each
        epoch's average-batch loss)."""
        fit = model.last_fit
        steps = (len(fit.losses) - 1) * batches_per_epoch
        seconds = float(sum(fit.extras["epoch_seconds"]))
        self.fits.append({"losses": [float(x) for x in fit.losses],
                          "epochs": len(fit.losses) - 1, "steps": steps,
                          "fit_seconds": seconds,
                          "ms_per_step": 1e3 * seconds / max(steps, 1)})
        return fit.losses

    def summary(self, **extra):
        """The run's record as a dict, printed as one line."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = launches()
        out = {"device": str(self.device),
               "wall_seconds": time.perf_counter() - self._t0,
               "launches": {k: now[k] - self._launches[k] for k in now},
               "peak_gb": ((torch.cuda.max_memory_allocated(self.device)
                            - self._base_bytes) / 1e9
                           if self.device.type == "cuda" else None),
               "fits": self.fits}
        out.update(extra)
        last = self.fits[-1]
        launched = {k: v for k, v in out["launches"].items() if v}
        print(f"summary: converged loss {last['losses'][-1]:.4f} after "
              f"{last['epochs']} epochs, {last['steps']} steps at "
              f"{last['ms_per_step']:.2f} ms/step; "
              f"{out['wall_seconds']:.1f} s wall; launches {launched}; "
              f"peak GB {out['peak_gb']}")
        return out
