"""K3's device time a training step (``csrc/fused_ig.cu``: the forward, its
per-sample block sums and the backward), by kernel name, in the steady
epochs."""
import re

UNIT = "ms"
LAYER = "surrogate"
MOVES = "train_rows_per_s"
KERNELS = re.compile(r"\big_(fwd|bwd|lq_sum)_kernel\b")


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    hits = ctx.trace.steady_kernels(lambda n: KERNELS.search(n) is not None)
    if not hits:
        return None
    return 1e3 * sum(t for _, t in hits) / ctx.steps
