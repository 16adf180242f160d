"""The device time of the work launched inside ``vi/epoch_scan.py``'s
``epoch permutation`` and ``epoch decode`` spans (the epoch's permutation,
drawn for 8 epochs at once, and the flat CSR layout's epoch decode: eager
work outside the step's graph), in the steady ranges, a training step."""
from harness import spans

UNIT = "ms"
LAYER = "data"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    dev = spans.device_s(ctx.trace, ("epoch permutation", "epoch decode"),
                         "steady")
    return None if dev is None else 1e3 * dev / ctx.steps
