"""The autoencoder's training step's share of the chip's TF32 peak: the
network's products of the steps in the traced fit's steady epochs
(``harness/ae_counts.py``: S B (10 D^2 + 12 D K) a step at the
configuration's widths) over those epochs' wall time, against 494.7
TFLOP/s. A context without the network's widths reads None."""
from harness import ae_counts

UNIT = "%"
LAYER = "whole step"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.steps or "dims" not in ctx.shape:
        return None
    s = ctx.shape
    flops = ctx.steps * ae_counts.network_flops(s["S"], s["B"], s["dims"])
    return 100.0 * flops / ctx.trace.steady_wall_s \
        / ctx.counts.PEAK_TF32_FLOPS
