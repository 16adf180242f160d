"""The CUDA runtime's kernel and graph launches a scoring call
(``vi/waic.py``'s chunk loop and what it calls), inside the benchmark's
range around each call, the first call left out."""
UNIT = "launches"
LAYER = "engine"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    return ctx.trace.steady_launches() / ctx.calls
