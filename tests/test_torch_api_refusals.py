"""The API names of spmf_tpu that the port does not carry yet refuse by name:
each raises NotImplementedError naming the ROADMAP.md item that ports it,
never AttributeError or ImportError."""
import numpy as np
import pytest

import spmf_tpu_torch
from spmf_tpu_torch import PoissonFactorization
from spmf_tpu_torch.vi import surrogates

API = "section 1, item 1"
PERSISTENCE = "section 1, item 2"


def _model():
    return PoissonFactorization(latent_dim=2, feature_dim=5, dtype="float64",
                                device="cpu")


#: (name, the call that must refuse, the ROADMAP item its message names)
CALLS = [
    ("surrogate_distribution", lambda: _model().surrogate_distribution, API),
    ("surrogate_vars", lambda: _model().surrogate_vars, API),
    ("save", lambda: _model().save("model.npz"), PERSISTENCE),
    ("load_params", lambda: _model().load_params("model.npz"), PERSISTENCE),
    ("reconstitute", lambda: _model().reconstitute({}), PERSISTENCE),
    ("encode_batched", lambda: _model().encode_batched(np.ones((3, 5))), API),
    ("predictive_distribution",
     lambda: _model().predictive_distribution(None, None, None, None, None),
     API),
    ("unormalized_log_prob_list",
     lambda: _model().unormalized_log_prob_list(1.0, 2.0), API),
    ("build_surrogate_posterior",
     lambda: surrogates.build_surrogate_posterior({}, {}), API),
    ("load_model", lambda: spmf_tpu_torch.load_model("model.npz"),
     PERSISTENCE),
]


@pytest.mark.parametrize("name,call,item", CALLS, ids=[c[0] for c in CALLS])
def test_missing_api_refuses_by_name(name, call, item):
    with pytest.raises(NotImplementedError) as info:
        call()
    msg = str(info.value)
    assert name in msg and "ROADMAP.md" in msg and item in msg
