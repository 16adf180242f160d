"""CSR-backed sparse count datasets (mirrors spmf_tpu/data/sparse.py).

``SparseCounts`` keeps CSR on the host (numpy, copied from the JAX package,
which the port may not import) and hands out dense row slabs or padded COO
triplet batches. ``DeviceSparseCounts`` keeps the CSR arrays on the card and
decodes each epoch's shuffled COO stream there, in torch.

Production scRNA matrices (50k cells x 20k genes, 2-5% nonzero) do not fit
host memory densely in float64, so the dense (B, D) slab is made only per
batch, or never (the COO energies of ``models/poisson.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmf_tpu_torch.config import canonical_device, canonical_dtype
from spmf_tpu_torch.utils.spans import span

__all__ = ["DeviceSparseCounts", "SparseCounts"]


class SparseCounts:
    """Row-sliceable CSR counts with the ArrayDataset batching API."""

    def __init__(self, indptr, indices, data, shape,
                 extras: Optional[dict] = None):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.data = np.asarray(data, np.float64)
        self.shape = tuple(shape)
        self.num_rows = self.shape[0]
        self.extras = dict(extras or {})
        self._shuffle = False
        self._seed = None
        self._batch_size = None
        self._drop_remainder = False
        self._epoch = 0
        self.count_key = "counts"
        self._coo = False
        self._max_nnz = None
        self._pad_bs = None  # batch size an auto-computed _max_nnz was sized for

    # ------------------------------------------------------------ builders
    @classmethod
    def from_dense(cls, x, extras=None):
        x = np.asarray(x)
        indptr = [0]
        indices, data = [], []
        for row in x:
            nz = np.nonzero(row)[0]
            indices.append(nz)
            data.append(row[nz])
            indptr.append(indptr[-1] + len(nz))
        return cls(
            np.asarray(indptr),
            np.concatenate(indices) if indices else np.zeros(0, np.int64),
            np.concatenate(data) if data else np.zeros(0),
            x.shape,
            extras,
        )

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, extras=None):
        order = np.argsort(rows, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.zeros(shape[0] + 1, np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr, cols, vals, shape, extras)

    @classmethod
    def from_mtx(cls, path, transpose=False, extras=None):
        """10x matrix.mtx (genes x cells) -> cells x genes when transpose,
        read by the native MatrixMarket parser (``data/native.py``; scipy
        where it cannot build or parse)."""
        from spmf_tpu_torch.data.native import load_mtx_coo

        rows, cols, vals, shape = load_mtx_coo(path)
        if transpose:
            rows, cols = cols, rows
            shape = (shape[1], shape[0])
        return cls.from_coo(rows, cols, vals, shape, extras)

    # ----------------------------------------------------------- accessors
    def _positions(self, row_ids):
        """(batch-local row, CSR position) of every nonzero of the rows."""
        lo = self.indptr[row_ids]
        counts = self.indptr[row_ids + 1] - lo
        total = int(counts.sum())
        out_rows = np.repeat(np.arange(len(row_ids)), counts)
        # each row's run starts at lo[k] and advances by its offset
        run_starts = np.cumsum(counts) - counts
        pos = np.repeat(lo - run_starts, counts) + np.arange(total)
        return out_rows, pos

    def row_slab(self, row_ids) -> np.ndarray:
        """Densify selected rows into a (B, D) float64 slab."""
        row_ids = np.asarray(row_ids)
        out = np.zeros((len(row_ids), self.shape[1]))
        out_rows, pos = self._positions(row_ids)
        out[out_rows, self.indices[pos]] = self.data[pos]
        return out

    def batch_coo(self, row_ids):
        """COO triplets (batch-local rows, cols, vals) of the selected
        rows."""
        out_rows, pos = self._positions(np.asarray(row_ids))
        return out_rows, self.indices[pos], self.data[pos]

    def col_stats(self):
        """One pass over the nonzeros: column sums and nonzero counts, each
        (1, D) (compute_scales without densifying)."""
        colsums = np.zeros(self.shape[1])
        col_nnz = np.zeros(self.shape[1])
        np.add.at(colsums, self.indices, self.data)
        np.add.at(col_nnz, self.indices, 1.0)
        return colsums[None, :], col_nnz[None, :]

    def row_sums(self):
        counts = np.diff(self.indptr)
        row_ids = np.repeat(np.arange(self.num_rows), counts)
        out = np.zeros(self.num_rows)
        np.add.at(out, row_ids, self.data)
        return out

    @property
    def density(self):
        return len(self.data) / (self.shape[0] * self.shape[1])

    # ------------------------------------------------------------ batching
    def shuffle(self, buffer_size=None, seed=None):
        self._shuffle = True
        self._seed = seed
        return self

    def batch(self, batch_size, drop_remainder=False):
        self._batch_size = int(batch_size)
        self._drop_remainder = drop_remainder
        return self

    def prefetch(self, n=None):
        return self

    def as_coo(self, max_nnz=None):
        """Switch batching to padded COO triplets: batches are
        {'coo_rows','coo_cols','coo_vals','indices'} with a fixed nnz
        padding (zero-valued entries are exact no-ops in the sparse
        energy). The model then trains without densifying (B, D)."""
        self._coo = True
        self._max_nnz = max_nnz
        # a user-supplied pad is authoritative for ANY batch size; clearing
        # the auto-pad provenance also discards a stale auto pad sized for
        # an earlier batch size
        self._pad_bs = None
        return self

    def to_device(self, max_nnz=None, dtype=None, block_rows=None, *,
                  device=None):
        """Move the CSR structure onto ``device`` (``DeviceSparseCounts``),
        keeping the shuffle and batch settings. ``block_rows=R`` builds the
        block-aligned layout instead: rows grouped into blocks of R
        CSR-adjacent rows, each block's triplets padded to one width, and
        epochs shuffle blocks (rows of one block always share a batch;
        ``num_rows % R`` trailing rows are dropped)."""
        if max_nnz is None and self._pad_bs is None:
            # forward only a USER-supplied host pad (authoritative for any
            # batch size); an auto pad was sized for a specific batch size
            max_nnz = self._max_nnz
        return DeviceSparseCounts(
            self, batch_size=self._batch_size, shuffle=self._shuffle,
            seed=self._seed or 0, drop_remainder=self._drop_remainder,
            max_nnz=max_nnz, dtype=dtype, block_rows=block_rows,
            device=device,
        )

    def _coo_pad_size(self, bs):
        """Fixed padding: batch-mean nnz + 8 sigma + one max row, rounded
        up to 1024 (an overflowing host batch takes the next multiple)."""
        if self._max_nnz is not None and self._pad_bs in (None, bs):
            # user-supplied (pad_bs None) or auto pad cached for this bs —
            # an auto pad computed for a SMALLER batch size must recompute,
            # not silently undersize
            return int(self._max_nnz)
        row_nnz = np.diff(self.indptr)
        est = bs * row_nnz.mean() + 8.0 * np.sqrt(bs) * row_nnz.std() \
            + row_nnz.max()
        self._max_nnz = int(-(-est // 1024) * 1024)
        self._pad_bs = bs
        return self._max_nnz

    def _coo_batch(self, sl, pad):
        rows, cols, vals = self.batch_coo(sl)
        nnz = len(vals)
        if nnz > pad:  # overflow: next 1024-multiple
            pad = int(-(-nnz // 1024) * 1024)
        out_r = np.zeros(pad, np.int32)
        out_c = np.zeros(pad, np.int32)
        out_v = np.zeros(pad, np.float64)
        out_r[:nnz] = rows
        out_c[:nnz] = cols
        out_v[:nnz] = vals
        return {"coo_rows": out_r, "coo_cols": out_c, "coo_vals": out_v,
                "indices": sl}

    def __iter__(self):
        idx = np.arange(self.num_rows)
        if self._shuffle:
            rng = np.random.default_rng((self._seed or 0) + self._epoch)
            self._epoch += 1
            rng.shuffle(idx)
        bs = self._batch_size or self.num_rows
        stop = (self.num_rows - (self.num_rows % bs) if self._drop_remainder
                else self.num_rows)
        pad = self._coo_pad_size(bs) if self._coo else None
        for start in range(0, stop, bs):
            sl = idx[start:start + bs]
            if self._coo:
                batch = self._coo_batch(sl, pad)
            else:
                batch = {"counts": self.row_slab(sl), "indices": sl}
            for k, v in self.extras.items():
                batch[k] = np.asarray(v)[sl]
            yield batch


class DeviceSparseCounts:
    """Device-resident CSR counts: the nnz triplet arrays live on ``device``
    once, and each epoch's shuffled COO stream is decoded there.

    Epoch decode: every epoch covers all consumed rows, so one pass builds
    ``(erows, ecols, evals)`` in shuffled-row order with a scatter + cumsum
    run decode (slot j's owning row is the cumsum of ones scattered at the
    run starts), and each batch is a slice of that stream at the batch's
    nnz offset, taken with device indices so no batch waits for the host.

    Pad overflow (batch nnz > pad) cannot be seen per batch without a host
    sync, so the entries past the pad would be dropped silently; the pad
    includes +8 sigma + one max row, every batch records its nnz on the
    device, and ``check_overflow()`` (at each epoch end) raises if any batch
    overflowed. The epoch permutation comes from
    ``np.random.default_rng(seed + epoch)``, as in the JAX package, so the
    batches are the same element for element.
    """

    def __init__(self, sparse: SparseCounts, batch_size=None, shuffle=False,
                 seed=0, drop_remainder=False, max_nnz=None, dtype=None,
                 block_rows=None, *, device=None):
        self._host = sparse
        self.shape = sparse.shape
        self.num_rows = sparse.num_rows
        self.count_key = sparse.count_key
        self.device = canonical_device(device)
        self.dtype = canonical_dtype(dtype)
        self.block_rows = int(block_rows) if block_rows else None
        if self.block_rows:
            self._build_blocked(sparse)
        else:
            self.indptr = self._tensor(sparse.indptr, torch.int64)
            self.indices = self._tensor(sparse.indices, torch.int32)
            self.data = self._tensor(sparse.data, self.dtype)
        self.extras = {k: torch.as_tensor(np.asarray(v), device=self.device)
                       for k, v in sparse.extras.items()}
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._drop_remainder = drop_remainder
        self._max_nnz = max_nnz
        self._pad_bs = None  # stays None for a user-supplied max_nnz
        self._epoch = 0
        self._pending_nnz = []

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _build_blocked(self, sparse):
        """Block-aligned layout: one (n_blocks, NBLK) table per triplet
        component, each block's run padded with exact no-ops (val 0, col 0,
        row_local R-1, which keeps the within-block row sort)."""
        R = self.block_rows
        nb = self.num_rows // R
        if nb == 0:
            raise ValueError(
                f"block_rows={R} exceeds the dataset's {self.num_rows} rows")
        indptr = sparse.indptr
        blk_ptr = indptr[: nb * R + 1: R]                    # (nb+1,)
        blk_nnz = np.diff(blk_ptr)
        # the JAX layout's 128-lane width, kept so the batches are equal
        nblk = int(-(-int(blk_nnz.max()) // 128) * 128)
        total = int(blk_ptr[-1] - blk_ptr[0])
        cols_blk = np.zeros((nb, nblk), np.int32)
        vals_blk = np.zeros((nb, nblk), np.float64)
        rowl_blk = np.full((nb, nblk), R - 1, np.int32)
        out_blk = np.repeat(np.arange(nb), blk_nnz)
        run_starts = np.cumsum(blk_nnz) - blk_nnz
        off = np.arange(total) - np.repeat(run_starts, blk_nnz)
        # block runs are contiguous in CSR position order
        src = np.arange(int(blk_ptr[0]), int(blk_ptr[0]) + total)
        cols_blk[out_blk, off] = sparse.indices[src]
        vals_blk[out_blk, off] = sparse.data[src]
        rows_global = np.repeat(np.arange(nb * R),
                                np.diff(indptr[: nb * R + 1]))
        rowl_blk[out_blk, off] = rows_global % R
        self.n_blocks = nb
        self.block_nnz = nblk
        self.cols_blk = self._tensor(cols_blk, torch.int32)
        self.vals_blk = self._tensor(vals_blk, self.dtype)
        self.rowl_blk = self._tensor(rowl_blk, torch.int32)

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

    def col_stats(self):
        return self._host.col_stats()

    def row_sums(self):
        return self._host.row_sums()

    @property
    def density(self):
        return self._host.density

    def _pad(self, bs):
        # same contract as SparseCounts._coo_pad_size: a user-supplied pad
        # is authoritative for any batch size; an auto pad recomputes when
        # the batch size changes
        if self._max_nnz is not None and self._pad_bs in (None, bs):
            return int(self._max_nnz)
        self._max_nnz = self._host._coo_pad_size(bs)
        self._pad_bs = bs
        return int(self._max_nnz)

    # ---------------------------------------------------- blocked batches
    @staticmethod
    def _blocked_take_math(tables, ids, R):
        """One batch of the block-aligned layout: a row gather per
        component (ids: (Rb,) block ids). The batch-local row of entry
        (j, n) is j*R + rowl[j, n]."""
        arange = torch.arange(R, dtype=torch.int32, device=ids.device)
        return {
            "coo_cols": tables["cols"].index_select(0, ids),
            "coo_vals": tables["vals"].index_select(0, ids),
            "coo_rowl": tables["rowl"].index_select(0, ids),
            "indices": (ids[:, None] * R + arange).reshape(-1),
        }

    def _batches(self):
        """(batches an epoch, rows a batch) under the static batch shape;
        the remainder is dropped, and only with ``drop_remainder=True``
        (an unshuffled remainder would never be trained on). The blocked
        layout takes whole blocks, ``bs % block_rows == 0``."""
        bs = self._batch_size or self.num_rows
        n = self.num_rows
        R = self.block_rows
        if R:
            if bs % R:
                raise ValueError(
                    f"batch size {bs} must be a multiple of block_rows={R}")
            nb = self.n_blocks // (bs // R)
            if n - nb * bs and not self._drop_remainder:
                raise ValueError(
                    f"the blocked layout drops the {n - nb * bs}-row "
                    f"remainder (N={n}, batch={bs}, block_rows={R}): pass "
                    "drop_remainder=True to batch() to accept this")
            return nb, bs
        if n % bs and not self._drop_remainder:
            raise ValueError(
                f"DeviceSparseCounts drops the {n % bs}-row remainder "
                f"(N={n}, batch={bs}, fixed batch shape): pass "
                "drop_remainder=True to batch() to accept this, or a "
                "batch size dividing N")
        return n // bs, bs

    def _iter_blocked(self):
        nb, bs = self._batches()
        R = self.block_rows
        Rb = bs // R
        n_use = nb * Rb
        idx = np.arange(self.n_blocks)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._epoch += 1
            rng.shuffle(idx)
        tables = {"cols": self.cols_blk, "vals": self.vals_blk,
                  "rowl": self.rowl_blk}
        for start in range(0, n_use, Rb):
            ids = self._tensor(idx[start:start + Rb], torch.int32)
            batch = self._blocked_take_math(tables, ids, R)
            for k, v in self.extras.items():
                batch[k] = v[batch["indices"]]
            yield batch

    # --------------------------------------------------------- epoch decode
    @staticmethod
    def _epoch_decode_math(indptr, cols, vals, perm, pad):
        """The whole shuffled epoch's COO triplets in shuffled-row order, of
        length nnz (the dataset's) + pad zeros so any batch slice stays in
        bounds: {erows (shuffled-row index per slot), ecols, evals, cum
        (per-row inclusive nnz cumsum), perm}."""
        nnz = cols.shape[0]
        dev = cols.device
        lo = indptr[perm]                              # (N,) CSR run starts
        counts = indptr[perm + 1] - lo                 # (N,)
        cum = torch.cumsum(counts, 0)                  # (N,) inclusive
        # run decode: a 1 at each row's first slot (rows 1..N-1 start at
        # cum[i-1]; zero-count rows stack their starts, which index_add_
        # sums; a start at nnz falls in the dropped extra slot)
        starts = torch.zeros(nnz + 1, dtype=torch.int32, device=dev)
        starts.index_add_(0, cum[:-1], torch.ones_like(cum[:-1],
                                                       dtype=torch.int32))
        r = torch.cumsum(starts[:nnz], 0)              # (nnz,) row per slot
        # CSR position of slot j: row r's run begins at epoch offset
        # cum[r-1] and CSR offset lo[r]. Slots past the consumed rows' nnz
        # (a dropped remainder) are never read unmasked; clamp them in
        # range as the JAX gather does
        shift = lo - (cum - counts)                    # (N,)
        pos = (shift[r] + torch.arange(nnz, device=dev)).clamp_(0, nnz - 1)
        zpad = (0, pad)
        pad_ = torch.nn.functional.pad
        return {
            "erows": pad_(r.to(torch.int32), zpad),
            "ecols": pad_(cols[pos], zpad),
            "evals": pad_(vals[pos], zpad),
            "cum": cum,
            "perm": perm,
        }

    @staticmethod
    def _epoch_take_math(ep, b, bs, pad):
        """Batch ``b`` of an epoch decode: the ``pad`` slots from the
        batch's nnz offset, masked past the batch's nnz (values 0, an exact
        no-op in the sparse energy; rows and cols 0 so they stay in
        range). ``b`` is an int or a 0-d integer tensor on the device (the
        scan path's batch counter): every index is a gather, so taking a
        batch never waits for the host."""
        cum = ep["cum"]
        dev = cum.device
        # the batch's first row as a one-element index (a tensor is never
        # indexed by a 0-d tensor here: that would read it on the host)
        start = ((b * bs).reshape(1) if isinstance(b, torch.Tensor)
                 else torch.full((1,), b * bs, dtype=torch.int64,
                                 device=dev))
        # nnz before row r is cum0[r] (the exclusive run ends)
        cum0 = torch.nn.functional.pad(cum, (1, 0))
        lo_hi = cum0.index_select(0, torch.cat([start, start + bs]))
        off = lo_hi[0]
        bn = lo_hi[1] - off
        slots = torch.arange(pad, device=dev)
        idx = off + slots
        valid = slots < bn
        rows = ep["erows"][idx] - start
        vals = ep["evals"][idx]
        return {
            "coo_rows": torch.where(valid, rows, 0).to(torch.int32),
            "coo_cols": torch.where(valid, ep["ecols"][idx], 0),
            "coo_vals": torch.where(valid, vals, torch.zeros_like(vals)),
            "coo_nnz": bn,
            "indices": ep["perm"].index_select(
                0, start + torch.arange(bs, device=dev)),
        }

    def peek_batch(self):
        """The first batch of rows ``[0:bs)`` in the dataset's order: no
        shuffle and no epoch decode (the engine's initial-loss
        evaluation). The block-aligned layout gives its first ``bs / R``
        blocks; the flat layout the rows' triplets, padded as the
        training batches are."""
        bs = min(self._batch_size or self.num_rows, self.num_rows)
        if self.block_rows:
            R = self.block_rows
            tables = {"cols": self.cols_blk, "vals": self.vals_blk,
                      "rowl": self.rowl_blk}
            ids = torch.arange(max(bs // R, 1), dtype=torch.int32,
                               device=self.device)
            batch = self._blocked_take_math(tables, ids, R)
        else:
            host = self._host._coo_batch(np.arange(bs), self._pad(bs))
            batch = {k: self._tensor(v, self.dtype if k == "coo_vals"
                                     else torch.int32 if k != "indices"
                                     else torch.int64)
                     for k, v in host.items()}
        for k, v in self.extras.items():
            batch[k] = v[batch["indices"]]
        return batch

    def check_overflow(self):
        """One host fetch for all recorded per-batch nnz totals; raises if
        any batch exceeded the pad (an energy with dropped entries)."""
        if self.block_rows or not self._pending_nnz:
            # block-aligned layout: the pad is exact by construction
            self._pending_nnz = []
            return
        # 0-d totals from the batches this iterator yields, (nb,) vectors
        # from the scan path's epochs: both kinds may be pending at once
        totals = torch.cat([t.reshape(-1) for t in self._pending_nnz]
                           ).cpu().numpy()
        self._pending_nnz = []
        if (totals > self._max_nnz).any():
            raise ValueError(
                f"device COO batch overflowed the static pad "
                f"(max nnz {int(totals.max())} > pad {self._max_nnz}); "
                "pass a larger max_nnz to to_device()"
            )

    def __iter__(self):
        if self.block_rows:
            yield from self._iter_blocked()
            return
        nb, bs = self._batches()
        n = self.num_rows
        stop = nb * bs
        pad = self._pad(bs)
        idx = np.arange(n)
        if self._shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            self._epoch += 1
            rng.shuffle(idx)
        # the permutation truncated to the consumed rows, so the epoch
        # decode is exactly the concatenation of the yielded batches
        perm = self._tensor(idx[:stop], torch.int32)
        with span("epoch decode"):
            ep = self._epoch_decode_math(self.indptr, self.indices,
                                         self.data, perm, pad)
        for b in range(stop // bs):
            batch = self._epoch_take_math(ep, b, bs, pad)
            self._pending_nnz.append(batch.pop("coo_nnz"))
            for k, v in self.extras.items():
                batch[k] = v[batch["indices"]]
            yield batch
        self.check_overflow()
