"""Data pipeline: numpy-backed datasets of dict batches (copied from
spmf_tpu/data/__init__.py, which is pure numpy; the port may not import the
JAX package). Batches are dicts ``{'counts' | 'data', 'indices', ...}`` of
host arrays; the fit engine moves each batch to the device."""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import numpy as np

__all__ = ["ArrayDataset", "as_data_factory", "load_csv_counts"]


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


def as_data_factory(data) -> Callable[[], Iterable[dict]]:
    """Normalize any supported data input into a zero-arg factory returning
    an iterable of dict batches: a factory callable, an ArrayDataset, any
    re-iterable of dict batches, a dict of arrays (one full batch), or a
    bare 2-D array (treated as counts)."""
    if data is None:
        return None
    if callable(data):
        return data

    def _factory_over(obj):
        f = lambda: iter(obj)  # noqa: E731
        f.source = data
        return f

    if isinstance(data, ArrayDataset):
        return _factory_over(data)
    if isinstance(data, dict):
        return _factory_over([{k: np.asarray(v) for k, v in data.items()}])
    if isinstance(data, np.ndarray) or hasattr(data, "__array__"):
        arr = np.asarray(data)
        return _factory_over([{"counts": arr,
                               "indices": np.arange(arr.shape[0])}])
    return _factory_over(data)


def load_csv_counts(path: str, dtype=np.float64) -> np.ndarray:
    """Load a headerless CSV count matrix (the JAX package's numpy path;
    its native C++ parser is not ported)."""
    return np.loadtxt(path, delimiter=",", dtype=dtype, ndmin=2)
