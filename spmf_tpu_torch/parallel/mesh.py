"""Rank meshes over ``torch.distributed`` (the port's counterpart of
spmf_tpu/parallel/mesh.py).

A ``Mesh`` lays the ranks of the process group out on named axes, as a JAX
mesh lays out devices:

- **dp** (rows): each rank trains on its rows of every batch; gradients are
  summed over the ranks that hold the same parameters.
- **fp** (features): the feature dim D of ``u, v, w, s`` (and of the data
  columns) splits over fp; the encode contraction and every sum over D
  become partial sums plus one ``all_reduce`` over the fp line.
- **dcn** (multi-slice): rows shard jointly over (dcn, dp); parameters
  replicate over dcn.

Where JAX's GSPMD inserts the collectives of one global program, each rank
here runs its own program and the collectives are written out
(``parallel.collectives``, used by the engine and the models). A mesh whose
axes all have size 1 is trivial: nothing is sharded and no collective runs.
The mesh makes one process group for each line of the row axes (the joint
(dcn, dp) line on a multi-slice mesh), one for each fp line, and uses the
world for the whole mesh.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spmf_tpu_torch.parallel import collectives as _coll

__all__ = [
    "Mesh",
    "make_mesh",
    "make_multislice_mesh",
    "data_parallel_mesh",
    "shard_batch",
    "replicate",
    "shard_params_feature_dim",
]


def row_block(n_global_rows, parts, index):
    """(start, stop) of block ``index`` of ``n_global_rows`` rows split
    into ``parts`` equal blocks.

    The global batch must divide evenly — silently flooring would drop the
    remainder rows from training with no signal."""
    if n_global_rows % parts != 0:
        raise ValueError(
            f"global batch of {n_global_rows} rows does not divide over "
            f"{parts} processes; batch with drop_remainder=True (or pad) so "
            "every host feeds an equal row shard")
    per = n_global_rows // parts
    return per * index, per * (index + 1)


def _world():
    """(world size, rank) of the process group; (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The ranks of the process group on named axes. ``devices``: the ranks
    as an array of the mesh's shape (every rank of the world once);
    ``shape``: axis name -> size; ``coords``: this rank's index on each
    axis."""

    def __init__(self, ranks, axis_names):
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {ranks.shape} needs "
                             f"{ranks.ndim} axis names, got {axis_names}")
        world, rank = _world()
        if sorted(ranks.ravel().tolist()) != list(range(world)):
            raise ValueError(
                f"a Mesh holds every rank of the process group once: got "
                f"ranks {ranks.ravel().tolist()} for a world of {world} "
                "(call initialize_distributed first for several ranks)")
        self.devices = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.rank = rank
        self.coords = dict(zip(axis_names, (
            int(i) for i in np.argwhere(ranks == rank)[0])))
        self._groups = {}
        if not self.trivial:
            # every rank makes every line's group, in the same order
            for axes in (self.row_axes, (self.fp_axis,), self.live_axes):
                if all(axes):
                    self.group(axes)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    # ------------------------------------------------------------- layout
    @property
    def trivial(self):
        """All axes of size 1: nothing shards, no collective runs."""
        return self.size == 1

    @property
    def live_axes(self):
        return tuple(a for a in self.axis_names if self.shape[a] > 1)

    @property
    def fp_axis(self):
        """'fp' when the mesh splits the feature dim, else None."""
        if "fp" in self.axis_names and self.shape["fp"] > 1:
            return "fp"
        return None

    @property
    def row_axes(self):
        """The live axes the batch rows shard over: 'dp' (or the first
        axis that is not 'fp'), jointly with 'dcn' on a multi-slice mesh."""
        names = [a for a in self.axis_names if a != "fp"]
        if not names:
            return ()
        data = "dp" if "dp" in names else names[0]
        axes = (data,)
        if ("dcn" in self.axis_names and self.shape["dcn"] > 1
                and data != "dcn"):
            axes = ("dcn", data)
        return tuple(a for a in axes if self.shape[a] > 1)

    def size_of(self, axes):
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))

    def index_of(self, axes):
        """This rank's position on its line over ``axes`` (row-major in
        the order given)."""
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    @property
    def rows(self):
        return self.size_of(self.row_axes)

    @property
    def row_index(self):
        return self.index_of(self.row_axes)

    @property
    def fp(self):
        return self.shape["fp"] if self.fp_axis else 1

    @property
    def fp_index(self):
        return self.coords["fp"] if self.fp_axis else 0

    def group(self, axes):
        """The process group of this rank's line over ``axes`` (the world
        when the line is the whole mesh); made for every line at first
        use, which every rank reaches in the same order."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if not axes:
            return None
        if axes not in self._groups:
            if self.size_of(axes) == self.size:
                self._groups[axes] = dist.group.WORLD
            else:
                pos = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(len(self.axis_names))
                        if i not in pos]
                arr = np.transpose(self.devices, rest + pos)
                arr = arr.reshape(-1, self.size_of(axes))
                for line in arr:
                    g = dist.new_group(line.tolist())
                    if self.rank in line:
                        self._groups[axes] = g
        return self._groups[axes]

    # -------------------------------------------------------- collectives
    def all_sum(self, x, axes=None):
        """Differentiable SUM over the line ``axes`` (default: the whole
        mesh); ``x`` itself where the line has one rank."""
        g = self.group(self.live_axes if axes is None else axes)
        return x if g is None else _coll.all_reduce_sum(x, g)

    def all_min(self, x, axes=None):
        """Differentiable MIN over the line ``axes`` (default: the whole
        mesh)."""
        g = self.group(self.live_axes if axes is None else axes)
        return x if g is None else _coll.all_reduce_min(x, g)

    def all_sum_(self, x, axes=None):
        g = self.group(self.live_axes if axes is None else axes)
        return x if g is None else _coll.all_sum_(x, g)

    def all_min_(self, x, axes=None):
        g = self.group(self.live_axes if axes is None else axes)
        return x if g is None else _coll.all_min_(x, g)

    def broadcast_(self, x):
        """``x`` from rank 0 of the mesh, in place."""
        if not self.trivial:
            _coll.broadcast_(x, self.group(self.live_axes),
                             int(self.devices.ravel()[0]))
        return x

    def gather(self, local, dim, axes, grad=False):
        """The blocks of ``local`` along ``dim`` over the line ``axes``,
        concatenated in line order; with ``grad`` differentiable."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        g = self.group(axes)
        if g is None:
            return local
        fn = _coll.gather_cols if grad else _coll.gather_full
        return fn(local, dim, self.size_of(axes), self.index_of(axes), g)

    # ----------------------------------------------------------- sharding
    def local_rows(self, n_global_rows):
        """(start, stop) of this rank's rows of a batch of
        ``n_global_rows`` (rows shard over ``row_axes``)."""
        return row_block(n_global_rows, self.rows, self.row_index)

    def feature_slice(self, d):
        """(start, stop) of this rank's columns of a feature dim ``d``
        (all of it when fp does not split it)."""
        if self.fp_axis is None or d <= 1 or d % self.fp:
            return 0, d
        per = d // self.fp
        return per * self.fp_index, per * (self.fp_index + 1)


def make_mesh(shape=None, axis_names=("dp",), devices=None) -> Mesh:
    """A mesh over ``devices`` (ranks; default every rank of the world),
    reshaped to ``shape`` (default: all on the first axis)."""
    world, _ = _world()
    ranks = list(range(world)) if devices is None else list(devices)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    return Mesh(np.asarray(ranks).reshape(shape), axis_names)


def make_multislice_mesh(ici_shape=None, ici_axis_names=("dp",),
                         dcn_axis="dcn", devices=None) -> Mesh:
    """A mesh whose outer ``dcn`` axis enumerates slices, so that only the
    row-parallel gradient reduction crosses between them (spmf_tpu's
    multi-slice recipe). A slice is a node: the ranks ``LOCAL_WORLD_SIZE``
    (set by ``torchrun``) says share a host, rank // LOCAL_WORLD_SIZE; with
    no such variable each process is its own slice. Each slice reshapes to
    ``ici_shape`` (default: all its ranks on the first axis)."""
    world, _ = _world()
    ranks = list(range(world)) if devices is None else list(devices)
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", 0) or 1)
    slices = {}
    for r in ranks:
        slices.setdefault(r // per_node, []).append(r)
    slices = [slices[k] for k in sorted(slices)]
    per = len(slices[0])
    if any(len(s) != per for s in slices):
        raise ValueError(
            "multislice mesh needs equally-sized slices; got "
            f"{[len(s) for s in slices]} devices per slice")
    if ici_shape is None:
        ici_shape = (per,) + (1,) * (len(ici_axis_names) - 1)
    arr = np.asarray(slices).reshape((len(slices),) + tuple(ici_shape))
    return Mesh(arr, (dcn_axis,) + tuple(ici_axis_names))


def data_parallel_mesh(num_devices: Optional[int] = None) -> Mesh:
    """A one-axis ('dp',) mesh over every rank (``num_devices``, when
    given, must be the world size)."""
    world, _ = _world()
    if num_devices not in (None, world):
        raise ValueError(f"data_parallel_mesh({num_devices}) in a world of "
                         f"{world} ranks: a mesh holds every rank")
    return make_mesh((world,), ("dp",))


def _is_coo(batch):
    return isinstance(batch, dict) and ("coo_vals" in batch
                                        or "coo_rowl" in batch)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's part of a dict batch: its rows of every array (over the
    mesh's row axes) and, with an fp axis, its columns of each 2-D array
    whose width fp divides. A sparse (COO) batch is returned whole: the
    COO energies split its triplets over the mesh themselves."""
    if mesh is None or mesh.trivial or _is_coo(batch):
        return batch
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
            continue
        r0, r1 = mesh.local_rows(len(v))
        v = v[r0:r1]
        if (mesh.fp_axis is not None and np.ndim(v) >= 2
                and v.shape[1] > 1 and v.shape[1] % mesh.fp == 0):
            c0, c1 = mesh.feature_slice(v.shape[1])
            v = v[:, c0:c1]
        out[k] = v
    return out


def replicate(tree, mesh: Mesh):
    """Every tensor of a (nested dict) tree, as rank 0 of the mesh holds
    it, on every rank (a broadcast; copies)."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    out = torch.as_tensor(tree).detach().clone()
    return mesh.broadcast_(out) if mesh is not None else out


# Feature-dim axis position per variable of the factorization models:
# u (D,K) -> 0, v (K,D) -> 1, w (1,D) -> 1, s (2,D) -> 1, and the same for
# every horseshoe auxiliary (they share their primary's shape).
_FEATURE_AXIS = {"u": 0, "v": 1, "w": 1, "s": 1}


def _feature_axis_for(name: str) -> Optional[int]:
    for stem, ax in _FEATURE_AXIS.items():
        if name == stem or name.startswith(stem + "_"):
            return ax
    return None


def sharded_axis(name, shape, mesh):
    """The axis of a variable of full ``shape`` that fp splits, or None
    when it stays whole (no fp axis, no feature axis, size 1, or a size fp
    does not divide; ``u_tau*`` (1, K) stay replicated)."""
    if mesh is None or mesh.fp_axis is None:
        return None
    ax = _feature_axis_for(name)
    if ax is None or ax >= len(shape) or shape[ax] == 1 \
            or shape[ax] % mesh.fp:
        return None
    return ax


def shard_params_feature_dim(params: dict, mesh: Mesh, axis: str = "fp"
                             ) -> dict:
    """This rank's slice of the feature dim D of every variable of the
    surrogate parameter tree (contiguous copies); the other leaves as they
    are."""
    if axis != "fp":
        raise ValueError(f"the port's feature axis is 'fp', got {axis!r}")
    out = {}
    for name, leafs in params.items():
        new = {}
        for pname, arr in leafs.items():
            t = torch.as_tensor(arr)
            ax = sharded_axis(name, tuple(t.shape), mesh)
            if ax is not None:
                c0, c1 = mesh.feature_slice(t.shape[ax])
                t = t.narrow(ax, c0, c1 - c0).contiguous()
            new[pname] = t
        out[name] = new
    return out
