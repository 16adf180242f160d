"""The device's idle inside ``vi/minibatch.py``'s ``fit bookkeep`` spans
(the host's work between an epoch's or a chunk's fetch and the next: the
replay of the decisions, the accounting, the restore, the checkpoint, the
convergence test), the one that follows the first range (which holds the
capture) left out, a training step of the steady ranges."""
from harness import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    idle = spans.idle_s(ctx.trace, ("fit bookkeep",), "after")
    return None if idle is None else 1e3 * idle / ctx.steps
