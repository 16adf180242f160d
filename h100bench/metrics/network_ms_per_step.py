"""The device ms a training step of the autoencoder's network and
likelihood, forward and backward: what ``models/autoencoder.py``'s
``ae network`` span (``log_likelihood_components``: the layers' products,
the activations, the rates and the Poisson log-prob) launched and what the
backward ranges of the nodes its operations made launched (the backward
products among them), in the steps that ran eagerly
(``harness/ae_spans.py``)."""
UNIT = "ms"
LAYER = "model"
MOVES = "train_rows_per_s"


def read(ctx):
    found = getattr(ctx, "step_spans", None)
    if ctx.kind != "train" or found is None:
        return None
    return found.ms_per_step("ae network")
