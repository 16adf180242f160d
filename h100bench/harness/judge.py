"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference works out, each held to the cell's
limit (``limits/<cell>.json``)."""
from __future__ import annotations

import math
import statistics

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves under Adam by round-off alone: it is left out
NOUGHT = 1e-3


def rel_gap(value, ref):
    return abs(value - ref) / abs(ref)


def leaf_gap(prog, ref):
    """The worst leaf's gap between two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger; ``prog`` and
    ``ref`` map each leaf to its norm. Returns (gap, leaf)."""
    med = statistics.median(ref.values())
    worst = (0.0, None)
    for k, r in ref.items():
        if r < NOUGHT * med:
            continue
        gap = abs(prog[k] - r) / max(r, med)
        if not gap <= worst[0]:          # a NaN reads as the worst
            worst = (gap, k)
    return worst


def _norms(leaves):
    return {k: float(t.norm()) for k, t in leaves.items()}


def diff_gap(prog, ref):
    """The worst leaf's norm of the difference of two tensors, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger. Returns (gap, leaf)."""
    norms = _norms(ref)
    med = statistics.median(norms.values())
    worst = (0.0, None)
    for k, t in ref.items():
        if norms[k] < NOUGHT * med:
            continue
        gap = float((prog[k] - t).norm()) / max(norms[k], med)
        if not gap <= worst[0]:
            worst = (gap, k)
    return worst


def training_gaps(prog, ref):
    """``prog``: the losses the fit returned (its initial loss and the
    epoch's mean), and per leaf Adam's first moment and the parameters'
    change after the steps; ``ref``: the same worked out by the
    reference. Returns {name: (gap, what)}: the losses' gap, the worst
    leaf's gap of the first moment's norm (``grad``) and of the change's
    norm (``step``), and the worst leaf's norm of the first moment's
    difference (``grad_diff``): the norms average the products' rounding
    out, the difference keeps it."""
    ref_mean = sum(ref["losses"]) / len(ref["losses"])
    loss = max(rel_gap(prog["losses"][0], ref["initial"]),
               rel_gap(prog["losses"][1], ref_mean))
    grads = _norms(ref["exp_avg"])
    keep = _keep(grads, grads)
    return {"loss": (loss, "initial and epoch-mean loss"),
            "grad": leaf_gap(_norms(prog["exp_avg"]), keep),
            "step": leaf_gap(_norms(prog["step"]),
                             _keep(_norms(ref["step"]), grads)),
            "grad_diff": diff_gap(prog["exp_avg"],
                                  {k: ref["exp_avg"][k] for k in keep})}


def _keep(norms, grads):
    """``norms`` of the leaves whose reference gradient is not nought."""
    med = statistics.median(grads.values())
    return {k: v for k, v in norms.items() if grads[k] >= NOUGHT * med}


def verdict(gaps, limits):
    """({name: {"value", "limit"}}, correct): each gap against its limit;
    a gap that is not finite fails."""
    checks = {name: {"value": float(gaps[name][0]),
                     "limit": float(limits[name])} for name in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok
