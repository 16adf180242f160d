"""The training kind: ``fit()`` on the captured scan path over a
device-resident dataset (``layout`` 'dense' or 'csr'), its window one
``fit()`` call sized to last about ``--seconds``. The check: set-up drives
the model from the seed through its first ``check_batches`` steps by
``fit()``, and the reference follows the same steps (``cells.Setup``)."""
import json
import math
import time

from harness import calibration, cells, judge
from harness.trace import Trace


def run(cell, seed, seconds, trace, device, clock, say):
    """A training cell's run: returns the result's fields."""
    import torch

    st = cells.Setup(cell, seed, device)
    prog = st.check_fit()
    r = st.fit(st.ds, cell.traffic["warmup_epochs"])
    st.phase("warm-up fit")
    epoch_s = float(r.extras["epoch_seconds"][-1])
    window = cell.traffic["trace_seconds"] if trace else seconds
    epochs = cells.epochs_for(window, epoch_s, cell.traffic)
    setup_s = clock()
    say(f"set-up {setup_s:.3f} s ({json.dumps(st.phases)}); a warm epoch "
        f"{epoch_s:.4f} s; the window fits {epochs} epochs of {st.nb} steps")
    say(f"card before the window: {cells.smi()}")
    cells._reset_peak(device)
    prof = cells._profile() if trace else None
    t0 = time.perf_counter()
    if trace:
        with prof, torch.profiler.record_function("h100bench fit"):
            r = st.fit(st.ds, epochs)
            cells._sync(device)
    else:
        r = st.fit(st.ds, epochs)
        cells._sync(device)
    wall = time.perf_counter() - t0
    peak = cells._peak(device)
    say(f"card after the window: {cells.smi()}")
    say(f"window {wall:.4f} s; epoch losses first {r.losses[1]:.6g} last "
        f"{r.losses[-1]:.6g}; peak {peak} B")
    say("launches " + json.dumps(cells.launch_counts()))
    bad = sum(1 for v in r.losses[1:] if not math.isfinite(v))
    out = {"attempted": epochs * st.nb, "failed": bad * st.nb,
           "peak": peak}
    if trace:
        shape = {"S": st.S, "B": st.B, "D": st.D, "K": st.K,
                 "nnz": None if st.nnz is None else st.nnz * st.B / st.N}
        tr = Trace(prof, "h100bench fit", ("fit epoch", "fit chunk"), skip=1)
        ctx = cells.Context("train", tr, shape, steps=(epochs - 1) * st.nb)
        out["metrics"] = cells._per_layer(cell, ctx)
        out["busy_s"], out["window_s"] = tr.busy_s(), tr.window_s
        out["breakdown"] = tr.breakdown()
        del prof, tr, ctx
    else:
        out["metrics"] = {
            "train_rows_per_s": {"value": epochs * st.nb * st.B / wall,
                                 "unit": "rows/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    st.free_program()
    t_ref = time.perf_counter()
    ref = st.reference_steps(cell, torch.float64)
    gaps = judge.training_gaps(prog, ref)
    say(f"reference {time.perf_counter() - t_ref:.2f} s; gaps "
        + json.dumps({k: [v[0], str(v[1])] for k, v in gaps.items()}))
    out["checks"], out["correct"] = judge.verdict(gaps, cell.limits)
    return out


def readings(cell, seed, control, device):
    """The program's gaps on ``seed``; with ``control``, also the
    control's and the half-batch fault's (the reference with half of each
    batch left out, the mean over the rest), each put in the program's
    place."""
    import torch

    st = cells.Setup(cell, seed, device)
    prog = st.check_fit()
    st.free_program()
    f64 = torch.float64
    ref = st.reference_steps(cell, f64)
    rows = [("program", judge.training_gaps(prog, ref))]
    if control:
        ctrl = st.reference_steps(cell, torch.float32,
                                  tf32=calibration.control_mode(device))
        rows.append(("control", judge.training_gaps(
            calibration.as_program(ctrl), ref)))
        full = st.rows_of(f64)
        half = st.reference_steps(
            cell, f64, rows=lambda idx: full(idx[:len(idx) // 2]))
        rows.append(("fault_half_batch", judge.training_gaps(
            calibration.as_program(half), ref)))
    return [calibration.row(name, gaps) for name, gaps in rows]
