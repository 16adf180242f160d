"""The autoencoder's weight prior's share of its roofline: the yardstick's
least time for the prior a step (``harness/ae_counts.py``: the S sampled
weights and biases read once and their gradient written once, at 3.35
TB/s) over its device time a step (``weight_prior_ms_per_step``'s
reading)."""
from harness import ae_counts

UNIT = "%"
LAYER = "kernels"
MOVES = "train_rows_per_s"


def read(ctx):
    found = getattr(ctx, "step_spans", None)
    if ctx.kind != "train" or found is None or "dims" not in ctx.shape:
        return None
    ms = found.ms_per_step("ae prior")
    if not ms:
        return None
    least = ae_counts.prior_seconds(ctx.shape["S"], ctx.shape["dims"])
    return 100.0 * least / (ms / 1e3)
