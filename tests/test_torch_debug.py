"""``spmf_tpu_torch.utils.check_finite`` and ``debug_nans``: the cases of
tests/test_utils.py (check_finite raising on a non-finite leaf, the NaN
trap inside the scope and its state restored on exit) through the port,
with the bad leaf named as spmf_tpu names it."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.utils import check_finite as jax_check_finite

from spmf_tpu_torch.utils import check_finite, debug_nans
from spmf_tpu_torch.utils import debug as tdebug


@pytest.mark.parametrize("leaf", [torch.tensor, np.asarray],
                         ids=["tensor", "numpy"])
def test_check_finite_raises(leaf):
    ok = {"a": leaf([1.0, 2.0, 3.0]), "b": [leaf([0.5]), (leaf([1]),)]}
    assert check_finite(ok) is ok
    bad = {"a": {"c": leaf([1.0, float("nan")])},
           "b": [leaf([0.5]), (leaf([float("inf")]),)],
           "d": leaf([2.0])}
    with pytest.raises(FloatingPointError, match="a") as err:
        check_finite(bad, name="params")
    # the same message as spmf_tpu's: the name and each bad leaf's keystr
    jbad = {"a": {"c": jnp.array([1.0, jnp.nan])},
            "b": [jnp.array([0.5]), (jnp.array([jnp.inf]),)],
            "d": jnp.array([2.0])}
    with pytest.raises(FloatingPointError) as jerr:
        jax_check_finite(jbad, name="params")
    assert str(err.value) == str(jerr.value)
    assert "['a']['c']" in str(err.value) and "['b'][1][0]" in str(err.value)


def test_debug_nans_context():
    prev = torch.is_anomaly_enabled()
    with debug_nans(True):
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor(-1.2345)) * 2
    assert torch.is_anomaly_enabled() == prev
    assert not tdebug._SETTINGS
    # outside the scope a NaN passes
    assert torch.isnan(torch.log(torch.tensor(-1.2345)) * 2)


def test_debug_nans_checks_the_backward():
    x = torch.tensor([0.0, 1.0], dtype=torch.float64, requires_grad=True)
    with debug_nans(True):
        y = (torch.sqrt(x) * 0.0).sum()      # finite forward
        with pytest.raises(FloatingPointError, match="nan"):
            y.backward()                     # 0 * inf in the backward


def test_debug_nans_restores_after_an_exception_and_when_nested():
    with pytest.raises(ValueError):
        with debug_nans(True):
            raise ValueError("inside")
    assert not tdebug._SETTINGS and not torch.is_anomaly_enabled()
    torch.log(torch.tensor(-1.0))            # the trap is off again
    with debug_nans(True):
        with debug_nans(False):
            torch.log(torch.tensor(-1.0))    # the inner scope turns it off
            assert not torch.is_anomaly_enabled()
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))    # ... and gives it back
        with debug_nans(True):
            with pytest.raises(FloatingPointError):
                torch.log(torch.tensor(-1.0))
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor(-1.0))
    assert not tdebug._SETTINGS and not torch.is_anomaly_enabled()
    torch.log(torch.tensor(-1.0))


def test_debug_nans_passes_finite_work_and_uninitialized_buffers():
    """A finite fit step runs inside; an empty buffer (uninitialized
    memory, not a computed NaN) does not trip the trap."""
    with debug_nans(True):
        torch.empty(1000)
        a = torch.randn(8, 4, dtype=torch.float64, requires_grad=True)
        loss = torch.nn.functional.softplus(a @ a.T).log().sum()
        loss.backward()
    assert torch.isfinite(a.grad).all()
