"""Named host spans at the program's layer boundaries, for
``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler records (``fit(profile_dir=...)``'s, or any the caller runs), so
the span lands in the profiler's timeline beside the device's events, on
one clock. With no profiler recording it is one shared null context: the
cost is one flag test, where an unguarded ``record_function`` costs
microseconds a call.

Every span is host-side. The spans but ``ae prior`` and ``ae network`` are
outside any captured CUDA graph; those two are inside the training step,
so in a captured step they record its eager warm-up and its capture, never
a replay.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

__all__ = ["SPANS", "span"]

#: every span name the program emits
SPANS = (
    # vi/minibatch.py: one single epoch of ``fit()``, from its steps to its
    # one fetch of the batch losses (the first holds the step's capture)
    "fit epoch",
    # vi/minibatch.py: one chunk of epochs on the scan path, from its steps
    # and on-device decisions to its one fetch
    "fit chunk",
    # vi/minibatch.py: the host's work after an epoch's or a chunk's fetch,
    # up to the next epoch or chunk: the replay of the chunk's decisions,
    # the epoch's accounting, the restore, the checkpoint, the convergence
    # test
    "fit bookkeep",
    # vi/epoch_scan.py: one CUDA graph made (``EpochScan._capture``): the
    # eager warm-up on a side stream, the state put back, the capture
    "graph capture",
    # vi/epoch_scan.py: an epoch's permutation taken from the drawn ones
    # (a draw of ``_PERM_EPOCHS`` at once every that many epochs)
    "epoch permutation",
    # vi/epoch_scan.py, data/sparse.py: the flat CSR layout's epoch decode
    # (``DeviceSparseCounts._epoch_decode_math``), run eagerly each epoch
    "epoch decode",
    # vi/waic.py: a chunk's posterior draws (``surrogate.sample``)
    "waic draw",
    # vi/waic.py: a chunk's per-row log-likelihoods (the model's
    # ``_row_log_likelihood``)
    "waic row_ll",
    # vi/waic.py: a chunk's synchronous fetch to the host
    "waic fetch",
    # vi/waic.py: a chunk's host reduce (``streaming_waic_terms``)
    "waic reduce",
    # models/autoencoder.py: the joint weight prior's log-prob parts in
    # ``unormalized_log_prob_parts`` (``_prior_parts``: the exact-E1
    # horseshoe of every sampled weight, the biases' Normal). Inside the
    # step: on the card it records the capture's eager warm-up and the
    # capture, and the step's backward of it runs under autograd's own
    # ranges, not under the span. The autoencoder launches no kernel of its
    # own, so no ``LAUNCHES`` counter stands beside this span: a Python
    # counter would never see a graph replay
    "ae prior",
    # models/autoencoder.py: ``log_likelihood_components``, the forward
    # through ``assemble_networks`` and the Poisson log-prob (in a fit's
    # step as ``ae prior``; in ``log_likelihood`` a chunk's network)
    "ae network",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context for the span ``name`` (one of ``SPANS``): a
    ``record_function`` while a torch profiler records, else a shared
    no-op."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
