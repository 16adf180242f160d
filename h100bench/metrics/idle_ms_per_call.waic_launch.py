"""The device's idle inside ``vi/waic.py``'s ``waic draw`` and
``waic row_ll`` spans (each chunk's posterior draws and per-row
log-likelihoods, while the host launches them), a traced scoring call, the
first call left out."""
from harness import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    idle = spans.idle_s(ctx.trace, ("waic draw", "waic row_ll"), "steady")
    return None if idle is None else 1e3 * idle / ctx.calls
