"""The yardstick: the work each function needs, at the data sheet's peaks.

The counts are of the function, never of the route a kernel takes, so a
kernel that changes route leaves them as they are. Products count 2 flops a
multiply-add and their least time is one pass at the TF32 tensor rate: no
float32-accurate route can beat it. Element-wise work is not counted. Bytes
are each input read once and each output written once (float32). A
kernel's least time is the larger of the two."""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_TF32_FLOPS = 494.7e12
PEAK_HBM_BYTES = 3.35e12
FLOAT_BYTES = 4


def least_seconds(flops, n_bytes):
    """The larger of the products at the TF32 rate and the bytes at the HBM
    rate."""
    return max(flops / PEAK_TF32_FLOPS, n_bytes / PEAK_HBM_BYTES)


def stats_flops(S, B, D, K):
    """K1/K2 (the clipped likelihood sums with their gradients): the decode
    and the two products of its backward, 6 S B D K."""
    return 6 * S * B * D * K


def stats_bytes(S, B, D, K):
    """K1/K2: theta, v, phi, eta and x read; dtheta, dv, dphi and the sums
    written."""
    return FLOAT_BYTES * (2 * S * B * K + 2 * S * K * D + 2 * S * D
                          + B * D + D)


def stats_seconds(S, B, D, K):
    return least_seconds(stats_flops(S, B, D, K), stats_bytes(S, B, D, K))


def row_ll_flops(S, B, D, K):
    """K4 (per-row log-likelihood sums): the decode, 2 S B D K."""
    return 2 * S * B * D * K


def row_ll_bytes(S, B, D, K):
    """K4: theta, v, phi, eta and x read; the (S, B) row sums written."""
    return FLOAT_BYTES * (S * B * K + S * K * D + S * D + B * D + D + S * B)


def row_ll_seconds(S, B, D, K):
    return least_seconds(row_ll_flops(S, B, D, K), row_ll_bytes(S, B, D, K))


def train_step_flops(S, B, D, K, nnz=None):
    """One training step's model FLOPs: the encode forward (2) and its
    gradient with respect to the encoder (2), the decode forward (2) and
    its backward (4), each S B D K. On sparse input the encode's 4 are
    counted at the batch's ``nnz`` nonzeros, all that the model needs."""
    encode = 4 * S * (B * D if nnz is None else nnz) * K
    return encode + 6 * S * B * D * K


def score_flops(rows, samples, D, K):
    """A scoring call: the encode and the decode, 4 D K a row and posterior
    sample."""
    return 4 * D * K * rows * samples
