"""K1/K2's share of its roofline (``csrc/fused_poisson.cu``'s
``stats_kernel`` and ``csrc/fused_poisson_wide.cu``'s ``stats_wide_kernel``):
the count's least time of each launch at the step's shape (S, B, D, K),
summed, over the device time of those kernels in the steady epochs."""
import re

UNIT = "%"
LAYER = "kernels"
MOVES = "train_rows_per_s"
KERNELS = re.compile(r"\bstats(_wide)?_kernel\b")


def read(ctx):
    if ctx.kind != "train":
        return None
    hits = ctx.trace.steady_kernels(lambda n: KERNELS.search(n) is not None)
    if not hits:
        return None
    s = ctx.shape
    least = len(hits) * ctx.counts.stats_seconds(s["S"], s["B"], s["D"],
                                                 s["K"])
    return 100.0 * least / sum(t for _, t in hits)
