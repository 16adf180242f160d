"""The device ms a training step of the autoencoder's weight prior, forward
and backward: what ``models/autoencoder.py``'s ``ae prior`` span launched
and what the backward ranges of the nodes its operations made launched,
in the steps that ran eagerly (each capture's warm-up inside the traced
``fit()``, which runs the kernels each replay runs;
``harness/ae_spans.py``)."""
UNIT = "ms"
LAYER = "model"
MOVES = "train_rows_per_s"


def read(ctx):
    found = getattr(ctx, "step_spans", None)
    if ctx.kind != "train" or found is None:
        return None
    return found.ms_per_step("ae prior")
