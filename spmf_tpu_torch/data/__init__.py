"""Data pipeline: datasets of dict batches (written after
spmf_tpu/data/__init__.py; the port may not import the JAX package).
Batches are dicts ``{'counts' | 'data', 'indices', ...}`` of host arrays
(``ArrayDataset``), of tensors already on the device (``DeviceArrayDataset``),
or of COO triplets from the sparse datasets (``data/sparse.py``, whose
``DeviceSparseCounts`` yields tensors already on the card); the fit engine
moves each host batch to the device. A device-resident source is what the
engine's whole-epoch scan path takes (``vi/epoch_scan.py``)."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.data.prefetch import prefetch_batches
from spmf_tpu_torch.data.sparse import DeviceSparseCounts, SparseCounts

__all__ = ["ArrayDataset", "DeviceArrayDataset", "DeviceSparseCounts",
           "SparseCounts", "as_data_factory", "load_csv_counts",
           "prefetch_batches"]


class ArrayDataset:
    """Minimal tf.data-like dataset over aligned arrays.

    Supports ``shuffle().batch().prefetch()`` chaining; each ``__iter__``
    re-shuffles (fresh permutation per epoch)."""

    def __init__(self, tensors: Dict[str, np.ndarray]):
        self.tensors = {k: np.asarray(v) for k, v in tensors.items()}
        lens = {k: v.shape[0] for k, v in self.tensors.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"Misaligned leading dims: {lens}")
        self.num_rows = next(iter(lens.values()))
        self._shuffle = False
        self._seed = None
        self._batch_size: Optional[int] = None
        self._drop_remainder = False
        self._epoch = 0

    @classmethod
    def from_tensor_slices(cls, tensors):
        return cls(tensors)

    def _clone(self):
        new = ArrayDataset.__new__(ArrayDataset)
        new.__dict__.update(self.__dict__)
        new.tensors = self.tensors  # share storage
        return new

    def shuffle(self, buffer_size=None, seed=None):
        new = self._clone()
        new._shuffle = True
        new._seed = seed
        return new

    def batch(self, batch_size: int, drop_remainder: bool = False):
        new = self._clone()
        new._batch_size = int(batch_size)
        new._drop_remainder = drop_remainder
        return new

    def prefetch(self, n=None):
        return self

    def to_device(self, dtype=None, *, device=None):
        """Move the whole dataset onto ``device`` (a ``DeviceArrayDataset``;
        None means the card), keeping the shuffle and batch settings;
        floating arrays are cast to ``dtype`` when one is given."""
        return DeviceArrayDataset(
            self.tensors, batch_size=self._batch_size, shuffle=self._shuffle,
            seed=self._seed or 0, drop_remainder=self._drop_remainder,
            dtype=dtype, device=device)

    def __len__(self):
        if self._batch_size is None:
            return self.num_rows
        if self._drop_remainder:
            return self.num_rows // self._batch_size
        return -(-self.num_rows // self._batch_size)

    def __iter__(self):
        idx = np.arange(self.num_rows)
        if self._shuffle:
            seed = self._seed if self._seed is not None else 0
            rng = np.random.default_rng(seed + self._epoch)
            self._epoch += 1
            rng.shuffle(idx)
        bs = self._batch_size or self.num_rows
        stop = (self.num_rows - (self.num_rows % bs) if self._drop_remainder
                else self.num_rows)
        for start in range(0, stop, bs):
            sl = idx[start:start + bs]
            yield {k: v[sl] for k, v in self.tensors.items()}


class DeviceArrayDataset:
    """Device-resident dataset: the full tensors live on the device once
    and each batch is a gather there, with no copy from the host per step.

    At the scRNA width (50,000 x 20,000 float32 counts, 4 GB) the whole
    matrix fits the card many times over. The fit engine's scan path
    (``vi/epoch_scan.py``) draws its own permutation per epoch and gathers
    each batch inside the captured step; iterating the dataset (the general
    loop, ``epoch_scan=False``) shuffles with
    ``numpy.random.default_rng(seed + epoch)``, as ``ArrayDataset`` does."""

    def __init__(self, tensors: Dict, batch_size: Optional[int] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_remainder: bool = False, dtype=None, *, device=None):
        self.device = canonical_device(device)
        self.tensors = {}
        for k, v in tensors.items():
            t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                                else np.asarray(v))
            if dtype is not None and t.is_floating_point():
                t = t.to(canonical_dtype(dtype))
            self.tensors[k] = t.to(self.device)
        lens = {k: v.shape[0] for k, v in self.tensors.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"Misaligned leading dims: {lens}")
        self.num_rows = next(iter(lens.values()))
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._drop_remainder = drop_remainder
        self._epoch = 0

    def shuffle(self, buffer_size=None, seed=None):
        self._shuffle = True
        if seed is not None:
            self._seed = seed
        return self

    def batch(self, batch_size, drop_remainder=False):
        self._batch_size = int(batch_size)
        self._drop_remainder = drop_remainder
        return self

    def prefetch(self, n=None):
        return self

    def peek_batch(self):
        """The first batch without a shuffle gather: rows ``[0:bs)`` as
        views. It uses up no shuffle epoch, and a shuffled gather over the
        whole dataset would allocate a dataset-sized temporary (the
        engine's initial-loss evaluation takes this batch)."""
        bs = min(self._batch_size or self.num_rows, self.num_rows)
        return {k: v[:bs] for k, v in self.tensors.items()}

    def __iter__(self):
        bs = self._batch_size or self.num_rows
        n = self.num_rows
        stop = n - (n % bs) if self._drop_remainder else n
        idx = None
        if self._shuffle:
            perm = np.arange(n)
            np.random.default_rng(self._seed + self._epoch).shuffle(perm)
            self._epoch += 1
            idx = torch.as_tensor(perm, device=self.device)
        for start in range(0, stop, bs):
            if idx is None:
                yield {k: v[start:start + bs]
                       for k, v in self.tensors.items()}
            else:
                sl = idx[start:start + bs]
                yield {k: v.index_select(0, sl)
                       for k, v in self.tensors.items()}


def as_data_factory(data) -> Callable[[], Iterable[dict]]:
    """Normalize any supported data input into a zero-arg factory returning
    an iterable of dict batches: a factory callable, an ArrayDataset or
    DeviceArrayDataset, a SparseCounts or DeviceSparseCounts, any
    re-iterable of dict batches, a dict of arrays (one full batch), or a
    bare 2-D array (treated as counts). The factory's ``source`` attribute is the dataset it iterates
    (``compute_scales`` reads a sparse source's ``col_stats`` from it, and
    the fit engine takes a device-resident source's scan path)."""
    if data is None:
        return None
    if callable(data):
        return data

    def _factory_over(obj):
        f = lambda: iter(obj)  # noqa: E731
        f.source = data
        return f

    if isinstance(data, (ArrayDataset, DeviceArrayDataset)):
        return _factory_over(data)
    if isinstance(data, dict):
        return _factory_over([{k: np.asarray(v) for k, v in data.items()}])
    if isinstance(data, np.ndarray) or hasattr(data, "__array__"):
        arr = np.asarray(data)
        return _factory_over([{"counts": arr,
                               "indices": np.arange(arr.shape[0])}])
    return _factory_over(data)


def load_csv_counts(path: str, dtype=np.float64) -> np.ndarray:
    """Load a headerless CSV count matrix with the native C++ parser
    (``data/native.py``), or numpy where it cannot build or parse."""
    from spmf_tpu_torch.data.native import load_csv

    return load_csv(path, dtype=dtype)
