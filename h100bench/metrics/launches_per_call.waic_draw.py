"""The CUDA runtime's kernel and graph launches issued inside
``vi/waic.py``'s ``waic draw`` spans (the surrogate's posterior draws: the
Normal block, K3, the transforms), a traced scoring call, the first call
left out."""
from harness import spans

UNIT = "launches"
LAYER = "surrogate"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    n = spans.launches(ctx.trace, ("waic draw",), "steady")
    return None if n is None else n / ctx.calls
