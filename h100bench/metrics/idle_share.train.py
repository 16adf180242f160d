"""The share of the traced fit's steady epochs in which no device
operation ran: 1 - (the union of the device events' intervals) / wall."""
UNIT = "%"
LAYER = "device"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.trace.steady_wall_s:
        return None
    return 100.0 * (1.0 - ctx.trace.steady_busy_s()
                    / ctx.trace.steady_wall_s)
