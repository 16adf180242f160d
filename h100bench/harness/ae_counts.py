"""The autoencoder's yardstick (``counts.py``'s rules and peaks): the work
the training step's function needs, never the route the program takes.

- The network's products: per layer l of widths (d_{l-1}, d_l), the forward
  (2), the gradient of the layer's weights (2) and of its input (2), each
  S B d_{l-1} d_l multiply-adds, but no input gradient for the first
  layer, whose input is the data: 6 S B sum_l d_{l-1} d_l - 2 S B d_0 d_1
  flops a step. At the configuration's widths D -> D -> K -> D -> D that is
  S B (10 D^2 + 12 D K).
- The weight prior's bytes: its S sampled values of every weight and bias
  read once and their gradient written once, in float32. The prior is
  elementwise; its arithmetic (E1 on every sampled weight) is not counted.
"""
from __future__ import annotations

from harness import counts


def network_flops(S, B, dims):
    """One training step's network products, ``dims`` = [d_0, d_1, ...]."""
    pairs = [a * b for a, b in zip(dims[:-1], dims[1:])]
    return 2 * S * B * (3 * sum(pairs) - pairs[0])


def prior_elements(dims):
    """The weights and biases one sample of the prior holds."""
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def prior_bytes(S, dims):
    return 2 * counts.FLOAT_BYTES * S * prior_elements(dims)


def prior_seconds(S, dims):
    """The weight prior's least time a step, forward and backward."""
    return counts.least_seconds(0, prior_bytes(S, dims))
