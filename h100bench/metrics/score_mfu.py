"""The scoring call's share of the chip's TF32 peak: 4 D K FLOPs a row and
posterior sample of the traced calls, over their wall time, against 494.7
TFLOP/s."""
UNIT = "%"
LAYER = "whole scoring call"
MOVES = "score_rows_per_s"


def read(ctx):
    if ctx.kind != "score" or not ctx.calls:
        return None
    s = ctx.shape
    flops = ctx.calls * ctx.counts.score_flops(s["B"], s["samples"], s["D"],
                                               s["K"])
    return 100.0 * flops / ctx.trace.steady_wall_s \
        / ctx.counts.PEAK_TF32_FLOPS
