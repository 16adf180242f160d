from .checkpoint import (flatten_jax_order, load_fit_state, load_pytree,
                         save_fit_state, save_pytree, unflatten_jax_order)
from .convert import (adam_state_from_numpy, adam_state_to_numpy,
                      params_from_numpy, params_to_numpy)
from .debug import check_finite, debug_nans

__all__ = ["params_from_numpy", "params_to_numpy", "adam_state_to_numpy",
           "adam_state_from_numpy", "flatten_jax_order",
           "unflatten_jax_order", "save_pytree", "load_pytree",
           "save_fit_state", "load_fit_state", "check_finite", "debug_nans"]
