"""npz checkpoints in the JAX package's format (mirrors the npz half of
spmf_tpu/utils/checkpoint.py; the Orbax backend is not carried).

A tree is a nested dict (or list / tuple) of arrays or tensors. Its leaves
are stored as ``leaf_{i}`` in the order ``jax.tree_util.tree_flatten``
gives them, which sorts dict keys at every level: the port's parameter
dicts keep insertion order (``v, w, u, u_eta, ...``), so every file goes
through ``flatten_jax_order`` and a file written by either package loads in
the other. A full fit state adds the optimizer leaves as ``opt_{i}``
(``utils.convert.adam_state_to_numpy`` gives them in optax's order) and the
control state as the ``__fit_state__`` JSON dict (lr, best_loss, stall,
epoch). Files are read with ``np.load(..., allow_pickle=False)``.

On a rank mesh a checkpoint holds the whole variables: each rank's fp
slice is gathered (``gather_shard``, a collective every rank joins) and
rank 0 alone writes (``writes_files``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["flatten_jax_order", "unflatten_jax_order", "treedef_string",
           "save_pytree", "load_pytree", "save_fit_state", "load_fit_state",
           "gather_shard", "writes_files"]


def flatten_jax_order(tree):
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten`` order: dict
    keys sorted at every level, lists and tuples in order."""
    if isinstance(tree, dict):
        children = [tree[k] for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return [tree]
    return [leaf for child in children for leaf in flatten_jax_order(child)]


def unflatten_jax_order(leaves, like):
    """The inverse of ``flatten_jax_order``: ``leaves`` placed into the
    structure of ``like`` (whose dicts keep their own key order)."""
    leaves = list(leaves)
    want = len(flatten_jax_order(like))
    if len(leaves) != want:
        raise ValueError(
            f"Checkpoint has {len(leaves)} leaves, structure wants {want}")
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            placed = {k: build(node[k]) for k in sorted(node)}
            return {k: placed[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)

    return build(like)


def treedef_string(tree):
    """The ``str()`` of the tree's JAX treedef, e.g.
    ``PyTreeDef({'a': *, 'b': {'x': *}})``, as the JAX package stores it."""
    def render(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {render(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(render(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(render(c) for c in node)
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({render(tree)})"


def to_numpy(x):
    """A leaf as a host array (tensors are copied off the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaf_entries(tree, prefix):
    return {f"{prefix}{i}": to_numpy(x)
            for i, x in enumerate(flatten_jax_order(tree))}


def _read_leaves(zf, prefix):
    flat = []
    while f"{prefix}{len(flat)}" in zf:
        flat.append(zf[f"{prefix}{len(flat)}"])
    return flat


def _makedirs_for(path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_pytree(path, tree):
    """Write ``tree``'s leaves as ``leaf_{i}`` plus ``__treedef__``."""
    _makedirs_for(path)
    np.savez(path, __treedef__=json.dumps(treedef_string(tree)),
             **_leaf_entries(tree, "leaf_"))
    return path


def load_pytree(path, like):
    """The ``leaf_{i}`` arrays of ``path`` in the structure of ``like``
    (host numpy arrays)."""
    with np.load(path, allow_pickle=False) as zf:
        flat = _read_leaves(zf, "leaf_")
    return unflatten_jax_order(flat, like)


def save_fit_state(path, params, opt_state, meta):
    """A full fit state: the params as ``save_pytree`` names them (so a
    params-only reader loads the file unchanged), the optimizer leaves as
    ``opt_{i}`` and ``meta`` as the ``__fit_state__`` JSON dict."""
    _makedirs_for(path)
    np.savez(path, __treedef__=json.dumps(treedef_string(params)),
             __fit_state__=json.dumps(meta),
             **_leaf_entries(params, "leaf_"),
             **_leaf_entries(opt_state, "opt_"))
    return path


def load_fit_state(path, params_like):
    """``(params, opt_leaves, meta)`` from a file of either saver: params in
    the structure of ``params_like``; ``opt_leaves`` the flat optimizer
    arrays, None for a params-only file; ``meta`` None when absent."""
    with np.load(path, allow_pickle=False) as zf:
        flat = _read_leaves(zf, "leaf_")
        opt = _read_leaves(zf, "opt_")
        meta = (json.loads(str(zf["__fit_state__"]))
                if "__fit_state__" in zf else None)
    return unflatten_jax_order(flat, params_like), (opt or None), meta


def gather_shard(t, axis, mesh):
    """The whole of a variable whose fp slice along ``axis`` this rank
    holds (``axis`` None: ``t`` is whole already), as a host array. A
    collective: every rank of the mesh calls it, in the same order."""
    t = torch.as_tensor(t)
    if axis is not None and mesh is not None:
        t = mesh.gather(t, axis, (mesh.fp_axis,))
    return to_numpy(t)


def writes_files(mesh):
    """Whether this rank writes checkpoint files: rank 0 of a mesh, or the
    one process."""
    return mesh is None or mesh.rank == 0
