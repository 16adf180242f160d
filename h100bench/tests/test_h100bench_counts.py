"""The yardstick's counts on known shapes."""
import pytest

from _tiny import BENCH  # noqa: F401  (puts the harness on the path)
from harness import counts


def test_peaks_are_the_data_sheets():
    assert counts.PEAK_TF32_FLOPS == 494.7e12
    assert counts.PEAK_HBM_BYTES == 3.35e12


def test_stats_at_the_scrna_width():
    S, B, D, K = 8, 4096, 20000, 32
    assert counts.stats_flops(S, B, D, K) == 6 * 8 * 4096 * 20000 * 32
    assert counts.stats_bytes(S, B, D, K) == 4 * (
        2 * 8 * 4096 * 32 + 2 * 8 * 32 * 20000 + 2 * 8 * 20000
        + 4096 * 20000 + 20000)
    # the products at one TF32 pass bound it: 0.254 ms
    assert counts.stats_seconds(S, B, D, K) == pytest.approx(
        1.2583e11 / 494.7e12, rel=1e-4)
    assert counts.stats_seconds(S, B, D, 128) == pytest.approx(
        4 * counts.stats_seconds(S, B, D, K))


def test_row_ll_is_bytes_bound_at_k32():
    S, B, D, K = 8, 4096, 20000, 32
    n_bytes = 4 * (8 * 4096 * 32 + 8 * 32 * 20000 + 8 * 20000
                   + 4096 * 20000 + 20000 + 8 * 4096)
    assert counts.row_ll_bytes(S, B, D, K) == n_bytes
    assert counts.row_ll_flops(S, B, D, K) == 2 * 8 * 4096 * 20000 * 32
    assert counts.row_ll_seconds(S, B, D, K) == pytest.approx(
        n_bytes / 3.35e12)


def test_training_step_and_scoring_flops():
    S, B, D, K = 8, 4096, 20000, 32
    assert counts.train_step_flops(S, B, D, K) == 10 * S * B * D * K
    # sparse input: the encode's 4 at the nonzeros
    assert counts.train_step_flops(S, B, D, K, nnz=1000) == \
        4 * S * 1000 * K + 6 * S * B * D * K
    assert counts.score_flops(4096, 100, D, K) == 4 * D * K * 4096 * 100
