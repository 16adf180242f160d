"""The device's idle inside ``vi/waic.py``'s ``waic reduce`` spans (each
chunk's host reduce in float64, in ``streaming_waic_terms``), a traced
scoring call, the first call left out."""
from harness import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    idle = spans.idle_s(ctx.trace, ("waic reduce",), "steady")
    return None if idle is None else 1e3 * idle / ctx.calls
