"""K4's share of its roofline (``row_ll_kernel``, ``row_ll_wide_kernel``):
the count's least time of each launch at its chunk's sample count and the
call's (B, D, K), summed, over the device time of those kernels in the
traced calls. A call whose launches do not match its chunks one to one is
left out."""
import re

UNIT = "%"
LAYER = "kernels"
MOVES = "score_rows_per_s"
KERNELS = re.compile(r"\brow_ll(_wide)?_kernel\b")


def read(ctx):
    if ctx.kind != "score":
        return None
    s = ctx.shape
    least = seconds = 0.0
    for hits in ctx.trace.steady_kernels_by_window(
            lambda n: KERNELS.search(n) is not None):
        if len(hits) != len(s["chunks"]):
            continue
        least += sum(ctx.counts.row_ll_seconds(c, s["B"], s["D"], s["K"])
                     for c in s["chunks"])
        seconds += sum(t for _, t in hits)
    return 100.0 * least / seconds if seconds else None
