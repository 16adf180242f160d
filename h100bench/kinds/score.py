"""The scoring kind: one caller in a closed loop, ``log_likelihood()`` of
the next block of a held-out pool at ``num_samples`` posterior samples in
chunks of ``sample_chunk``, as an analyst scores a saved fit.

Set-up loads the fit as a saved model is loaded: the model is built
without data, its column norms and its row scale's global worked out by
the benchmark from the seed's training rows, and its surrogate posterior
drawn by the benchmark from the seed (each raw parameter of the initial
surrogate moved by up to ``posterior_spread``, as far as about 128 Adam
steps move it). The same numbers go to the reference; nothing the program
made goes there.

The held-out pool holds ``pool_blocks`` blocks of ``batch_size`` rows,
block j starting ``pool_stride`` rows after block j - 1. A call's work does
not depend on which rows it scores; the overlap lets the check read single
rows' scores out of the calls' totals: two consecutive blocks' totals
differ by the scores of the rows that one holds and the other does not.
The check compares every call's total with the reference's (``lppd``) and
every difference of two consecutive calls' totals with the reference's
(``row_lppd``, over the mean row's score), where unbiased rounding of the
products no longer averages out over 4,096 rows. The reference computes
the cells in float32, as the configuration states (``reference.py``)."""
import contextlib
import gc
import json
import math
import statistics
import time

import numpy as np

from harness import calibration, cells, datagen, judge, reference
from harness.trace import Trace


class ScoreSetup:
    """A scoring cell's inputs, made from its seed, and the program loaded
    with them."""

    def __init__(self, cell, seed, device):
        import torch

        from spmf_tpu_torch.data import DeviceArrayDataset

        cfg, tr = cell.config, cell.traffic
        reference.require_followed(cfg)
        m = cfg["model"]
        self.D, self.K = int(m["feature_dim"]), int(m["latent_dim"])
        self.N = int(cfg["data"]["rows"])
        self.B = int(tr["batch_size"])
        self.blocks_n = int(tr["pool_blocks"])
        self.stride = int(tr["pool_stride"])
        self.device = device
        self.phases = {}
        self._t = time.perf_counter()
        pool = self.B + (self.blocks_n - 1) * self.stride
        x = datagen.counts(cfg["data"], self.D, self.N + pool,
                           cells.derive_seed(seed, 0), device)
        self.pool = x[self.N:].clone()
        colsum, nnz = reference.column_stats(
            x[i:i + self.B] for i in range(0, self.N, self.B))
        del x
        if device.type == "cuda":
            torch.cuda.empty_cache()
        # the CLI's column norms (an all-zero gene's is 1), u_tau_scale
        # = 1 / sqrt(D N), the row scale's global from the column stats
        self.col_norm = np.where(colsum > 0, colsum / self.N, 1.0)
        self.xi = reference.xi_global(colsum, nnz)
        self.u_tau_scale = 1.0 / math.sqrt(self.D * self.N)
        self.phase("counts")
        self.params = datagen.posterior(
            reference.init_params(self.D, self.K, self.u_tau_scale),
            cells.derive_seed(seed, 3), float(tr["posterior_spread"]),
            device)
        self.phase("posterior")
        self.model = cells.program_class(cfg)(
            None, latent_dim=self.K, feature_dim=self.D, strategy=None,
            column_norms=self.col_norm, u_tau_scale=self.u_tau_scale,
            device=device, **m["kwargs"])
        have = {n: {k: tuple(t.shape) for k, t in sub.items()}
                for n, sub in self.model.surrogate_params.items()}
        want = {n: {k: a.shape for k, a in sub.items()}
                for n, sub in self.params.items()}
        if have != want:
            raise ValueError(f"the model's surrogate {have} is not the "
                             f"benchmark's posterior {want}")
        self.model.surrogate_params = {
            n: {k: torch.as_tensor(a, device=device).clone()
                for k, a in sub.items()} for n, sub in self.params.items()}
        self.model.xi_u_global = torch.tensor(
            self.xi, dtype=self.model.dtype, device=device)
        self.blocks = [DeviceArrayDataset(
            {"counts": self.pool[j * self.stride:j * self.stride + self.B]},
            device=device) for j in range(self.blocks_n)]
        self.kw = dict(num_samples=tr["num_samples"],
                       sample_chunk=tr["sample_chunk"])
        self.phase("model")

    def phase(self, name):
        cells._sync(self.device)
        t = time.perf_counter()
        self.phases[name] = round(t - self._t, 4)
        self._t = t

    def call(self, j):
        """One scoring call of block ``j``: its total."""
        return self.model.log_likelihood(data=self.blocks[j],
                                         **self.kw)["total"]

    def free_program(self):
        import torch

        self.model = self.blocks = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_rows(self, cell, tf32=False):
        """The reference's score of every row of the pool, in float64 from
        cells in float32 (with ``tf32``, the control's: TF32 products)."""
        import torch

        tr = cell.traffic
        dtype = torch.float32
        model = reference.Model(self.D, self.K, self.u_tau_scale,
                                eta=self.col_norm, xi=self.xi, dtype=dtype,
                                device=self.device, tf32=tf32)
        draws = reference.score_draws(model, self.params, 1,
                                      tr["num_samples"], tr["sample_chunk"],
                                      self.device)
        return reference.lppd_rows(model, draws, self.pool.to(dtype),
                                   self.B).cpu().numpy()

    def block_totals(self, rows):
        """Each block's total from rows' scores."""
        return [float(np.sum(rows[j * self.stride:j * self.stride + self.B]))
                for j in range(self.blocks_n)]


def score_gaps(st, calls, rows):
    """``calls``: (block, total) in the order they were made; ``rows``: the
    reference's row scores. Returns {name: (gap, what)}: the worst call's
    total against the reference's (``lppd``), and the worst difference of
    two consecutive calls of consecutive blocks against the reference's,
    over the mean row's score of the first block (``row_lppd``)."""
    ref = st.block_totals(rows)
    lppd = (0.0, None)
    row = (0.0, None)
    for i, (b, total) in enumerate(calls):
        gap = judge.rel_gap(total, ref[b])
        if not gap <= lppd[0]:
            lppd = (gap, f"call {i} (block {b})")
        if i + 1 < len(calls) and calls[i + 1][0] == b + 1:
            d_prog = total - calls[i + 1][1]
            d_ref = ref[b] - ref[b + 1]
            gap = abs(d_prog - d_ref) / (abs(ref[b]) / st.B)
            if not gap <= row[0]:
                row = (gap, f"calls {i}, {i + 1} (blocks {b}, {b + 1})")
    return {"lppd": lppd, "row_lppd": row}


def run(cell, seed, seconds, trace, device, clock, say):
    """A scoring cell's run: returns the result's fields."""
    tr = cell.traffic
    st = ScoreSetup(cell, seed, device)
    for i in range(tr["warmup_calls"]):
        st.call(i % st.blocks_n)
    st.phase("warm-up calls")
    setup_s = clock()
    say(f"set-up {setup_s:.3f} s ({json.dumps(st.phases)})")
    say(f"card before the window: {cells.smi()}")
    cells._reset_peak(device)
    calls, lat = [], []
    prof = cells._profile() if trace else None
    limit = tr["trace_calls"] if trace else None
    t0 = time.perf_counter()
    with (prof if trace else contextlib.nullcontext()), \
            cells._range(trace, "h100bench scoring"):
        while (len(calls) < limit if trace
               else time.perf_counter() - t0 < seconds):
            blk = len(calls) % st.blocks_n
            t_call = time.perf_counter()
            with cells._range(trace, "h100bench score call"):
                total = st.call(blk)
            lat.append(time.perf_counter() - t_call)
            calls.append((blk, total))
    wall = time.perf_counter() - t0
    peak = cells._peak(device)
    say(f"card after the window: {cells.smi()}")
    say(f"window {wall:.4f} s; {len(calls)} scoring calls; latency p50 "
        f"{statistics.median(lat) * 1e3:.3f} ms, p90 "
        f"{cells.p90_ms(lat):.3f} ms; peak {peak} B")
    say("launches " + json.dumps(cells.launch_counts()))
    out = {"attempted": len(calls),
           "failed": sum(1 for _, v in calls if not math.isfinite(v)),
           "peak": peak}
    if trace:
        shape = {"S": int(cell.config["fit"]["sample_size"]), "B": st.B,
                 "D": st.D, "K": st.K, "samples": tr["num_samples"],
                 "chunks": cells._chunks(tr["num_samples"],
                                         tr["sample_chunk"])}
        t = Trace(prof, "h100bench scoring", ("h100bench score call",),
                  skip=1)
        ctx = cells.Context("score", t, shape, calls=len(calls) - 1)
        out["metrics"] = cells._per_layer(cell, ctx)
        out["busy_s"], out["window_s"] = t.busy_s(), t.window_s
        out["breakdown"] = t.breakdown()
        del prof, t, ctx
    else:
        out["metrics"] = {
            "score_rows_per_s": {"value": len(calls) * st.B / wall,
                                 "unit": "rows/s"},
            "score_ms_p90": {"value": cells.p90_ms(lat), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    st.free_program()
    t_ref = time.perf_counter()
    gaps = score_gaps(st, calls, st.reference_rows(cell))
    say(f"reference {time.perf_counter() - t_ref:.2f} s; gaps "
        + json.dumps({k: [v[0], str(v[1])] for k, v in gaps.items()}))
    out["checks"], out["correct"] = judge.verdict(gaps, cell.limits)
    return out


def readings(cell, seed, control, device):
    """The program's gaps on ``seed`` over one call of each block in turn;
    with ``control``, also the control's (the reference in float32 with
    TF32 products) and two faults', each put in the program's place: one
    row's answer replaced by the next row's in every call, and half of
    each batch left out with the mean taken over the rest."""
    st = ScoreSetup(cell, seed, device)
    calls = [(j, st.call(j)) for j in range(st.blocks_n)]
    st.free_program()
    ref = st.reference_rows(cell)
    rows = [("program", score_gaps(st, calls, ref))]
    if control:
        def as_calls(totals):
            return list(enumerate(totals))

        ctrl = st.reference_rows(cell,
                                 tf32=calibration.control_mode(device))
        rows.append(("control", score_gaps(st, as_calls(
            st.block_totals(ctrl)), ref)))
        swapped = [t - ref[j * st.stride] + ref[j * st.stride + 1]
                   for j, t in enumerate(st.block_totals(ref))]
        rows.append(("fault_row_answer",
                     score_gaps(st, as_calls(swapped), ref)))
        half = [2.0 * float(np.sum(ref[j * st.stride:
                                       j * st.stride + st.B // 2]))
                for j in range(st.blocks_n)]
        rows.append(("fault_half_batch",
                     score_gaps(st, as_calls(half), ref)))
    return [calibration.row(name, gaps) for name, gaps in rows]
