"""The data layer's device time a training step on the device CSR layout:
the epoch's permutation sort and decode (``data/sparse.py``: cumsum, scatter,
gathers), each batch's slice, and ``models/poisson.py``'s ``_densify_coo``
(an accumulating index_put, which sorts), by kernel name, in the steady
epochs."""
import re

UNIT = "ms"
LAYER = "data"
MOVES = "train_rows_per_s"
KERNELS = re.compile(r"index|scatter|gather|cumsum|[Ss]can|[Ss]ort")


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    hits = ctx.trace.steady_kernels(lambda n: KERNELS.search(n) is not None)
    if not hits:
        return None
    return 1e3 * sum(t for _, t in hits) / ctx.steps
