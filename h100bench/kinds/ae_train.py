"""The autoencoder's training kind: ``PoissonAutoencoder.fit()`` on the
captured scan path over a ``DeviceArrayDataset`` of the resident rows
(``layout`` 'dense'), its window one ``fit()`` call sized to last about
``--seconds``. It is ``train.py`` with a set-up and a reference of its
own: set-up drives the model from the seed through ``fit()`` twice from the
same initial surrogate, one step over the first batch's rows and then the
first ``check_batches`` steps, and ``harness/ae_reference.py`` follows both.
Its context is a ``train`` one, so the training cells' readers apply; it
also holds ``step_spans``, the device time under the program's spans inside
the step (``harness/ae_spans.py``).

The check holds ``loss`` and ``step`` after the ``check_batches`` steps,
and ``grad`` and ``grad_diff`` (Adam's first moment) after the one step.
From the second step on, a few sampled weights of the 8.1M fall so near
the horseshoe's log pole at w = 0 that the energy's gradient there, which
goes as 1 / (w log|w|), passes the element clip, and they do not fall
there alike in the program and in the float64 reference: such an element
of the first moment reads the clip's 0.1 x 10 in one and a hundredth of
it in the other, against a leaf median near 5e-5, and a few of them carry
a leaf's gap (``pole_readings``; PERF.md section 2). The norms of the
change and the loss do not see them; after the first step, where every
loc is 0, the moment reads to float32's rounding."""
import json
import math
import time

import numpy as np

from harness import ae_reference, ae_spans, calibration, cells, datagen, \
    judge, reference
from harness.trace import Trace


class Setup(cells.Setup):
    """The cell's counts, made from its seed, and the autoencoder built on
    them; what it shares with the training cells' set-up (the check fit,
    the rows, freeing the program) is inherited."""

    def __init__(self, cell, seed, device):
        import torch

        from spmf_tpu_torch.data import DeviceArrayDataset

        cfg, tr = cell.config, cell.traffic
        ae_reference.require_followed(cfg)
        if tr["layout"] != "dense":
            raise ValueError(f"unknown layout {tr['layout']!r}")
        m = cfg["model"]
        self.D, self.K = int(m["feature_dim"]), int(m["latent_dim"])
        self.sizes = ae_reference.layer_sizes(self.D, self.K,
                                              **m["kwargs"])
        self.N = int(cfg["data"]["rows"])
        self.B = int(tr["batch_size"])
        self.S = int(cfg["fit"]["sample_size"])
        self.nb = self.N // self.B
        self.n_check = int(tr["check_batches"]) * self.B
        self.layout = "dense"
        self.device = device
        self.engine_seed = cells.derive_seed(seed, 1)
        self.phases = {}
        self._t = time.perf_counter()
        self.x = datagen.counts(cfg["data"], self.D, self.N,
                                cells.derive_seed(seed, 0), device)
        self.phase("counts")
        # each gene's mean count, 1 for a gene with none
        col_norm = (self.x.sum(0, dtype=torch.float64) / self.N).cpu().numpy()
        self.col_norm = np.where(col_norm > 0, col_norm, 1.0)

        def dataset(rows):
            return DeviceArrayDataset({"data": self.x[:rows]},
                                      batch_size=self.B, shuffle=True,
                                      drop_remainder=True, device=device)
        self.ds = dataset(self.N)
        self.ds_check = dataset(self.n_check)
        self.ds_one = dataset(self.B)
        self.phase("datasets")
        self.model = cells.program_class(cfg)(
            self.ds, latent_dim=self.K, column_norms=self.col_norm,
            strategy=None, dtype=m["dtype"], device=device, **m["kwargs"])
        f = cfg["fit"]
        # no dataset_size: the engine's prior weight is 1, as the CLIs fit
        self.prior_weight = 1.0
        self.fit_kw = dict(learning_rate=f["learning_rate"],
                           clip_value=f["clip_value"],
                           sample_size=self.S, rel_tol=None, abs_tol=None,
                           seed=self.engine_seed, verbose=False)
        self.phase("model")

    def reference_model(self, dtype, tf32=False):
        return ae_reference.Model(self.D, self.sizes, self.col_norm, dtype,
                                  self.device, self.prior_weight, tf32)

    def check_fit(self):
        """The program's two check fits from the initial surrogate: one
        step over the first batch's rows (``one``), then the first
        ``check_batches`` steps (``all``)."""
        init = cells._clone(self.model.surrogate_params)
        checks, self.ds_check = self.ds_check, self.ds_one
        one = super().check_fit()
        self.phases["check fit, one step"] = self.phases.pop("check fit")
        self.model.surrogate_params, self.ds_check = init, checks
        self.ds_one = None
        return {"one": one, "all": super().check_fit()}

    def reference_steps(self, cell, dtype, tf32=False, rows=None):
        """The reference's two checks (``rows``: in place of
        ``rows_of(dtype)``), each as ``cells.Setup.reference_steps`` gives
        its steps."""
        return {"one": self._steps(cell, dtype, tf32, rows, 1),
                "all": self._steps(cell, dtype, tf32, rows,
                                   int(cell.traffic["check_batches"]))}

    def _steps(self, cell, dtype, tf32, rows, steps):
        import torch

        f = cell.config["fit"]
        init = ae_reference.init_params(self.D, self.sizes)
        # a copy of its own: float32 leaves on the CPU share the arrays
        ref = reference.train_steps(
            self.reference_model(dtype, tf32),
            ae_reference.init_params(self.D, self.sizes),
            rows or self.rows_of(dtype), steps * self.B, self.B, self.S,
            steps, self.engine_seed,
            float(np.float32(f["learning_rate"])), float(f["clip_value"]),
            self.device)
        return {"initial": ref["initial"], "losses": ref["losses"],
                "exp_avg": {nk: t.double()
                            for nk, t in ref["exp_avg"].items()},
                "step": {nk: t.double() - torch.as_tensor(
                    init[nk[0]][nk[1]], device=t.device).double()
                    for nk, t in ref["params"].items()}}


def check_gaps(prog, ref):
    """The check's gaps: ``loss`` and ``step`` after the ``check_batches``
    steps, ``grad`` and ``grad_diff`` after the one step (the module's
    docstring says why)."""
    gaps = judge.training_gaps(prog["all"], ref["all"])
    one = judge.training_gaps(prog["one"], ref["one"])
    gaps.update(grad=one["grad"], grad_diff=one["grad_diff"])
    return gaps


def pole_readings(prog, ref):
    """What the check leaves out: after the ``check_batches`` steps,
    ``grad_all`` and ``grad_diff_all``, the first moment's gaps there, and
    ``top_share``, the share of the worst ``grad_diff_all`` leaf's squared
    difference in its largest element, with that element's first moment
    in the program and the reference and the leaf's median one; after the
    one step, ``flips``, the elements the program moved the other way from
    the reference."""
    gaps = judge.training_gaps(prog["all"], ref["all"])
    leaf = gaps["grad_diff"][1]
    m = ref["all"]["exp_avg"][leaf].flatten()
    d = prog["all"]["exp_avg"][leaf].flatten() - m
    i = int(d.abs().argmax())
    share = float(d[i] ** 2 / (d * d).sum())
    at = (f"{leaf} [{i}]: program {float(m[i] + d[i]):.4g} reference "
          f"{float(m[i]):.4g}, the leaf's median "
          f"{float(m.abs().median()):.3g}")
    flips = {k: int((t * prog["one"]["step"][k] < 0).sum())
             for k, t in ref["one"]["step"].items()}
    worst = max(flips, key=flips.get)
    size = ref["one"]["step"][worst].numel()
    return {"grad_all": gaps["grad"], "grad_diff_all": gaps["grad_diff"],
            "top_share": (share, at),
            "flips": (sum(flips.values()),
                      f"{worst} {flips[worst]} of {size}")}


def _as_program(ref):
    return {n: calibration.as_program(r) for n, r in ref.items()}


def run(cell, seed, seconds, trace, device, clock, say):
    """A run of the cell: returns the result's fields."""
    import torch

    st = Setup(cell, seed, device)
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
        f"{r.losses[-1]:.6g}; the largest chunk {r.extras['epoch_chunk']}; "
        f"peak {peak} B")
    bad = sum(1 for v in r.losses[1:] if not math.isfinite(v))
    out = {"attempted": epochs * st.nb, "failed": bad * st.nb,
           "peak": peak}
    if trace:
        shape = {"S": st.S, "B": st.B, "D": st.D, "K": st.K,
                 "dims": [st.D] + st.sizes}
        tr = Trace(prof, "h100bench fit", ("fit epoch", "fit chunk"), skip=1)
        ctx = cells.Context("train", tr, shape, steps=(epochs - 1) * st.nb)
        ctx.step_spans = ae_spans.StepSpans(*ae_spans.from_profiler(prof))
        say("step spans: " + json.dumps(
            {n: ctx.step_spans.step_ns(n) for n in ("ae prior",
                                                    "ae network")}))
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
    gaps = check_gaps(prog, ref)
    say(f"reference {time.perf_counter() - t_ref:.2f} s; gaps "
        + json.dumps({k: [v[0], str(v[1])] for k, v in gaps.items()}))
    out["checks"], out["correct"] = judge.verdict(gaps, cell.limits)
    return out


def readings(cell, seed, control, device):
    """The program's gaps on ``seed`` and what the check leaves out
    (``pole_readings``); with ``control``, also the control's and the
    half-batch fault's (the reference with half of each batch left out,
    the mean over the rest), each put in the program's place."""
    import torch

    st = Setup(cell, seed, device)
    prog = st.check_fit()
    st.free_program()
    f64 = torch.float64
    ref = st.reference_steps(cell, f64)
    rows = [("program", check_gaps(prog, ref)),
            ("program_pole", pole_readings(prog, ref))]
    if control:
        ctrl = st.reference_steps(cell, torch.float32,
                                  tf32=calibration.control_mode(device))
        rows.append(("control", check_gaps(_as_program(ctrl), ref)))
        full = st.rows_of(f64)
        half = st.reference_steps(
            cell, f64, rows=lambda idx: full(idx[:len(idx) // 2]))
        rows.append(("fault_half_batch", check_gaps(_as_program(half), ref)))
    return [calibration.row(name, gaps) for name, gaps in rows]
