"""What the kinds of cell (``kinds/<kind>.py``) share: the seeds, the
card's readings, the window's epoch count, the inputs made from the seed
and the program built on them, the profiler and the per-layer metrics'
context. Each kind builds its inputs from the seed, sets the program up,
measures its window, and then checks what the timed path produced against
the plain reference (``reference.py``), once the program's state is
freed.

The training check: set-up builds the model, drives it from the seed
through its first steps by ``fit()`` over the first ``check_batches``
batches of the resident rows (the scan path and its capture, as in the
window), and hands the same model on to the warm-up and the window. The
fit returns its initial loss and the epoch's mean loss, and its Adam state
holds the gradients as the optimizer got them: those, and the parameters'
change, are compared with the reference's same steps."""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import subprocess
import time

import numpy as np

from harness import counts, datagen, reference


def derive_seed(seed, tag):
    """A 63-bit seed of its own for each use of the run's seed."""
    seq = np.random.SeedSequence([int(seed) % 2**64, tag])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def smi():
    """The card's name, power limit, SM clock, power draw and temperature
    (nvidia-smi), or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    """The device's peak of allocated bytes since the last reset (0 on the
    CPU, which only tests drive)."""
    import torch

    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _clone(params):
    return {n: {k: t.detach().clone() for k, t in sub.items()}
            for n, sub in params.items()}


def epochs_for(seconds, epoch_seconds, traffic):
    """The window's epoch count: ``lead`` epochs and then whole steps of
    ``step`` epochs (the engine's chunks), at least ``min``, lasting about
    ``seconds`` at ``epoch_seconds`` an epoch."""
    e = traffic["epochs"]
    lead, step = e["lead"], e["step"]
    n = round((seconds / epoch_seconds - lead) / step)
    return lead + step * max(n, -(-(e["min"] - lead) // step))


def program_class(config):
    """The model class the configuration names (``model.class``), from the
    program's package."""
    import spmf_tpu_torch

    return getattr(spmf_tpu_torch, config["model"]["class"])


class Setup:
    """A training cell's inputs, made from its seed, and the program built
    on them.
    ``layout``: 'dense' (a ``DeviceArrayDataset``) or 'csr' (a
    ``DeviceSparseCounts`` without blocks)."""

    def __init__(self, cell, seed, device):
        import torch

        from spmf_tpu_torch.data import DeviceArrayDataset, SparseCounts

        cfg, tr = cell.config, cell.traffic
        reference.require_followed(cfg)
        m = cfg["model"]
        self.D, self.K = int(m["feature_dim"]), int(m["latent_dim"])
        self.N = int(cfg["data"]["rows"])
        self.B = int(tr["batch_size"])
        self.S = int(cfg["fit"]["sample_size"])
        self.nb = self.N // self.B
        self.n_check = int(tr["check_batches"]) * self.B
        self.layout = tr["layout"]
        self.device = device
        self.engine_seed = derive_seed(seed, 1)
        self.phases = {}
        self._t = time.perf_counter()
        x = datagen.counts(cfg["data"], self.D, self.N,
                           derive_seed(seed, 0), device)
        self.phase("counts")
        colsum = x.sum(0, dtype=torch.float64)
        rowsum = x.sum(1, dtype=torch.float64)
        # the CLI's column norms (an all-zero gene's is 1) and row size
        # factors; u_tau_scale = 1 / sqrt(D N)
        col_norm = (colsum / self.N).cpu().numpy()
        self.col_norm = np.where(col_norm > 0, col_norm, 1.0)
        rowsum = rowsum.cpu().numpy()
        rsf = rowsum / np.median(rowsum)
        self.u_tau_scale = 1.0 / math.sqrt(self.D * self.N)
        self.x, self.csr, self.nnz = None, None, None
        if self.layout == "dense":
            self.x = x
            idx = torch.arange(self.N, device=device)
            rsf_t = torch.as_tensor(rsf, device=device)

            def dataset(rows):
                return DeviceArrayDataset(
                    {"data": x[:rows], "indices": idx[:rows],
                     "normalization": rsf_t[:rows]},
                    batch_size=self.B, shuffle=True, drop_remainder=True,
                    device=device)
        elif self.layout == "csr":
            self.csr = datagen.to_csr(x)
            self.nnz = int(self.csr[0][-1])
            del x, colsum, rowsum
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

            def dataset(rows):
                indptr, indices, data = self.csr
                end = int(indptr[rows])
                sc = SparseCounts(indptr[:rows + 1], indices[:end],
                                  data[:end], (rows, self.D),
                                  extras={"normalization": rsf[:rows]})
                return (sc.shuffle(seed=0).batch(self.B, drop_remainder=True)
                        .to_device(device=device))
        else:
            raise ValueError(f"unknown layout {self.layout!r}")
        self.ds = dataset(self.N)
        self.ds_check = dataset(self.n_check)
        self.phase("datasets")
        self.model = program_class(cfg)(
            self.ds, latent_dim=self.K, feature_dim=self.D, strategy=None,
            column_norms=self.col_norm, u_tau_scale=self.u_tau_scale,
            device=device, **m["kwargs"])
        f = cfg["fit"]
        self.fit_kw = dict(learning_rate=f["learning_rate"],
                           clip_value=f["clip_value"],
                           sample_size=self.S, rel_tol=None, abs_tol=None,
                           seed=self.engine_seed, verbose=False)
        self.phase("model")

    def phase(self, name):
        """Record the seconds since the last phase ended under ``name``."""
        _sync(self.device)
        t = time.perf_counter()
        self.phases[name] = round(t - self._t, 4)
        self._t = t

    def fit(self, data, epochs):
        self.model.fit(batched_data_factory=data, num_steps=int(epochs),
                       **self.fit_kw)
        return self.model.last_fit

    def check_fit(self):
        """The first steps through ``fit()``: what the program produced."""
        init = _clone(self.model.surrogate_params)
        r = self.fit(self.ds_check, 1)
        self.phase("check fit")
        after = self.model.surrogate_params
        names = [(n, k) for n in after for k in after[n]]
        state = r.opt_state["state"]
        return {"losses": list(r.losses),
                "exp_avg": {nk: state[i]["exp_avg"].double()
                            for i, nk in enumerate(names)},
                "step": {nk: after[nk[0]][nk[1]].double()
                         - init[nk[0]][nk[1]].double() for nk in names}}

    def reference_model(self, dtype, tf32=False):
        """The reference's model, with the column statistics worked out
        again from the counts."""
        import torch

        if self.layout == "dense":
            colsum, nnz = reference.column_stats(
                self.x[i:i + self.B] for i in range(0, self.N, self.B))
        else:
            _, indices, data = self.csr
            colsum = np.bincount(indices, weights=data, minlength=self.D)
            nnz = np.bincount(indices, minlength=self.D).astype(np.float64)
        return reference.Model(self.D, self.K, self.u_tau_scale,
                               eta=self.col_norm,
                               xi=reference.xi_global(colsum, nnz),
                               dtype=dtype, device=self.device, tf32=tf32)

    def rows_of(self, dtype):
        """The check dataset's rows, by index, in ``dtype``."""
        import torch

        def rows(idx):
            idx = np.asarray(idx, np.int64)
            if self.layout == "dense":
                return self.x[torch.as_tensor(idx, device=self.device)] \
                    .to(dtype)
            return datagen.dense_rows(self.csr, idx, self.D, self.device,
                                      dtype)
        return rows

    def reference_steps(self, cell, dtype, tf32=False, rows=None):
        """The reference's first steps (``rows``: in place of
        ``rows_of(dtype)``), as norms a leaf."""
        import torch

        f = cell.config["fit"]
        ref = reference.train_steps(
            self.reference_model(dtype, tf32),
            reference.init_params(self.D, self.K, self.u_tau_scale),
            rows or self.rows_of(dtype), self.n_check, self.B, self.S,
            int(cell.traffic["check_batches"]), self.engine_seed,
            float(np.float32(f["learning_rate"])), float(f["clip_value"]),
            self.device)
        init = reference.init_params(self.D, self.K, self.u_tau_scale)
        return {"initial": ref["initial"], "losses": ref["losses"],
                "exp_avg": {nk: t.double()
                            for nk, t in ref["exp_avg"].items()},
                "step": {nk: t.double() - torch.as_tensor(
                    init[nk[0]][nk[1]], device=t.device).double()
                    for nk, t in ref["params"].items()}}

    def free_program(self):
        """Drop the program's state (its model and datasets) before the
        reference runs."""
        import torch

        self.model = self.ds = self.ds_check = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def launch_counts():
    from spmf_tpu_torch.ops import fused_ig, fused_normal, fused_poisson
    from spmf_tpu_torch.parallel import collectives

    return {"fused_poisson": dict(fused_poisson.LAUNCHES),
            "fused_ig": dict(fused_ig.LAUNCHES),
            "fused_normal": dict(fused_normal.LAUNCHES),
            "collectives": {k: v for k, v in collectives.STATS.items()}}


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])


class Context:
    """What a per-layer metric's reader gets."""

    def __init__(self, kind, trace, shape, steps=0, calls=0):
        self.kind, self.trace, self.shape = kind, trace, shape
        self.steps, self.calls, self.counts = steps, calls, counts


def _per_layer(cell, ctx):
    out = {}
    for entry, reader in cell.per_layer:
        value = reader.read(ctx)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def p90_ms(seconds):
    """The 90th percentile, in ms, of latencies given in seconds."""
    ms = [x * 1e3 for x in seconds]
    return statistics.quantiles(ms, n=10)[8] if len(ms) > 1 else ms[0]


def _chunks(n, chunk):
    chunk = min(chunk, n)
    return [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])


def _range(on, name):
    import torch

    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())
