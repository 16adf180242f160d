"""The device's idle inside ``vi/waic.py``'s ``waic fetch`` spans (each
chunk's synchronous fetch of its per-row log-likelihoods), a traced
scoring call, the first call left out."""
from harness import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    idle = spans.idle_s(ctx.trace, ("waic fetch",), "steady")
    return None if idle is None else 1e3 * idle / ctx.calls
