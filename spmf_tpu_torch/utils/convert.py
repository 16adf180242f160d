"""Parameter-tree conversion between numpy and the port.

The JAX package's ``surrogate_params`` pytree, fetched as numpy
(``jax.tree_util.tree_map(np.asarray, params)``), and the port's parameter
dict share their structure and leaf names, so a tree converts leaf for leaf
in both directions. The CPU tests use this to make both packages compute
the same thing.

The optimizer state converts too: ``torch.optim.Adam``'s per-parameter
``step`` / ``exp_avg`` / ``exp_avg_sq`` and optax's flat state of
``inject_hyperparams(chain(clip, adam))``, which has 3 + 2 L leaves for L
parameter leaves: the inject count (int32), ``lr`` (float32), Adam's count
(int32), then ``mu`` and ``nu`` each in JAX leaf order. Both apply the same
bias-corrected step with ``eps`` outside the square root, so a state moves
between the packages without changing the next update.
"""
from __future__ import annotations

import numpy as np
import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.utils.checkpoint import flatten_jax_order, to_numpy

__all__ = ["params_from_numpy", "params_to_numpy", "adam_state_to_numpy",
           "adam_state_from_numpy", "adam_leaf_count"]


def params_from_numpy(tree, device=None, dtype=None):
    """Nested dict of arrays -> nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), dtype=canonical_dtype(dtype),
                           device=canonical_device(device))


def params_to_numpy(params):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return to_numpy(params)


def adam_leaf_count(params):
    """Leaves of optax's flat Adam state for the parameter tree ``params``."""
    return 3 + 2 * len(flatten_jax_order(params))


def adam_state_to_numpy(optimizer, params, state=None, lr=None):
    """The Adam state of ``optimizer`` over the tensors of ``params`` as
    optax's flat leaves (see the module docstring). A parameter with no
    state yet (before the first step) gives zero moments and count 0.
    ``state`` (a mapping like ``optimizer.state``) and ``lr`` replace the
    optimizer's own (the fit engine's best-epoch buffers)."""
    leaves = flatten_jax_order(params)
    state = optimizer.state if state is None else state
    states = [state.get(t, {}) for t in leaves]
    count = int(states[0]["step"]) if states[0] else 0
    mu, nu = [], []
    for t, st in zip(leaves, states):
        zero = np.zeros(tuple(t.shape), to_numpy(t).dtype)
        mu.append(to_numpy(st["exp_avg"]) if st else zero)
        nu.append(to_numpy(st["exp_avg_sq"]) if st else zero)
    # a float, or a device tensor in a capturable optimizer
    lr = float(optimizer.param_groups[0]["lr"] if lr is None else lr)
    return ([np.asarray(count, np.int32), np.asarray(lr, np.float32),
             np.asarray(count, np.int32)] + mu + nu)


def adam_state_from_numpy(leaves, optimizer, params):
    """Load optax's flat Adam leaves into ``optimizer``, whose parameters
    are the tensors of ``params``: each tensor's ``step``, ``exp_avg`` and
    ``exp_avg_sq`` (created where a fresh optimizer has none yet, cast to
    the parameter's dtype and device) and the group's learning rate."""
    flat = flatten_jax_order(params)
    L = len(flat)
    if len(leaves) != adam_leaf_count(params):
        raise ValueError(f"optimizer state has {len(leaves)} leaves, "
                         f"{adam_leaf_count(params)} expected for {L} "
                         "parameters")
    index = {id(t): i for i, t in enumerate(
        t for g in optimizer.param_groups for t in g["params"])}
    count = float(np.asarray(leaves[2]))
    state = {}
    for j, t in enumerate(flat):
        state[index[id(t)]] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.asarray(leaves[3 + j])),
            "exp_avg_sq": torch.as_tensor(np.asarray(leaves[3 + L + j])),
        }
    sd = optimizer.state_dict()
    sd["state"] = state
    for g in sd["param_groups"]:
        g["lr"] = float(np.asarray(leaves[1]))
    optimizer.load_state_dict(sd)
