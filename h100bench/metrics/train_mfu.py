"""The training step's share of the chip's TF32 peak: the model FLOPs of
the steps in the traced fit's steady epochs (10 S B D K a step; the encode's
4 at the batch's nonzeros on sparse input) over those epochs' wall time,
against 494.7 TFLOP/s."""
UNIT = "%"
LAYER = "whole step"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    s = ctx.shape
    flops = ctx.steps * ctx.counts.train_step_flops(
        s["S"], s["B"], s["D"], s["K"], s.get("nnz"))
    return 100.0 * flops / ctx.trace.steady_wall_s \
        / ctx.counts.PEAK_TF32_FLOPS
