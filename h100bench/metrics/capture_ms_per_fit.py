"""The host wall of ``vi/epoch_scan.py``'s ``graph capture`` spans (each
CUDA graph the fit makes: the eager warm-up on a side stream, the state
put back, the capture) in the traced ``fit()``, which captures anew as
every call does."""
from harness import spans

UNIT = "ms"
LAYER = "engine"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train":
        return None
    wall = spans.wall_s(ctx.trace, ("graph capture",), "outer")
    return None if wall is None else 1e3 * wall
