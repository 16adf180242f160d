"""The CUDA runtime's kernel and graph launches a training step, inside the
engine's ``fit epoch`` / ``fit chunk`` ranges (``vi/minibatch.py``), the
first range (which holds the capture) left out."""
UNIT = "launches"
LAYER = "engine"
MOVES = "train_rows_per_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    return ctx.trace.steady_launches() / ctx.steps
