"""The fit engine's whole-epoch path over a device-resident source (the
counterpart of spmf_tpu's ``epoch_scan`` and ``epoch_chunk``,
spmf_tpu/vi/minibatch.py).

With a ``DeviceArrayDataset`` or a ``DeviceSparseCounts`` (flat or blocked
layout) in a single process, each epoch runs on the device: one permutation
drawn there from the engine's generator, then per batch a gather from the
resident tensors and the training step (sample, energy, backward, clip,
Adam). On the card the gather and the step of a batch are one CUDA graph,
captured at first use and replayed: the host launches one graph a batch
instead of the step's hundreds of kernels. A batch counter on the device
says which slice of the permutation a replay gathers, and each replay
writes its loss (and, for the flat sparse layout, its nnz total) into a
device buffer. A single epoch is fetched once; a chunk of K epochs
(``run_chunk``) ends each epoch with the best / plateau / divergence
decisions made on the device (``EpochDecisions``, on the card a CUDA graph
of its own) and is fetched once, after its last epoch. On the CPU the same
step and decisions run eagerly: there is no graph there.

Capture needs a step that never waits for the host and state whose storage
never moves: the engine builds Adam with ``capturable=True`` and a device
learning rate, creates its state before the first step and restores it in
place, and the best epoch's state lives in fixed buffers the decisions
write in place. A failed capture raises; nothing falls back to the eager
loop.

On a rank mesh (a ``DeviceArrayDataset``; sparse sources keep the general
loop there, as in spmf_tpu) every rank holds all rows of its columns of the
resident tensors, draws the same global permutation from the engine's
generator (seeded alike on every rank) and gathers its rows of each batch.
A remainder batch that the row ranks do not divide is replicated over them,
as spmf_tpu's scan replicates it (``_row_spec``): every rank trains on all
of its rows, inside ``Mesh.whole_rows()``, so that its energy is counted
once. A full batch they do not divide raises, as in spmf_tpu. With more
than one rank the step runs uncaptured: its collectives stage through the
host, which a CUDA graph cannot hold.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

import numpy as np
import torch

from spmf_tpu_torch.data import DeviceArrayDataset, DeviceSparseCounts
from spmf_tpu_torch.utils.spans import span

__all__ = ["EpochDecisions", "EpochScan", "packed_clone", "scan_source"]

#: capture the scan's step in CUDA graphs on the card (False runs the same
#: scan eagerly there). A private switch for the smoke script and the GPU
#: tests, which hold the captured scan to the uncaptured one bit for bit.
_CAPTURE = True

#: epochs whose permutations one draw makes (one batched sort of random
#: keys: the launches of a permutation are spread over this many epochs)
_PERM_EPOCHS = 8


def _processes():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def scan_source(batched_data_factory, epoch_scan, mesh=None):
    """The device-resident source whose epochs the scan path runs, or None
    for the general loop. ``epoch_scan=None`` (auto) engages for a
    ``DeviceArrayDataset`` or ``DeviceSparseCounts`` source in a single
    process, or a ``DeviceArrayDataset`` on a rank mesh (``mesh``, not
    trivial), ``False`` never, and ``True`` raises where it cannot."""
    if epoch_scan is False:
        return None
    src = getattr(batched_data_factory, "source", None)
    if mesh is not None and not mesh.trivial:
        if isinstance(src, DeviceArrayDataset):
            return src
        if epoch_scan:
            raise ValueError(
                "epoch_scan=True requires a DeviceArrayDataset source "
                "(meshes are fine) or a DeviceSparseCounts source (on a "
                f"trivial mesh); got source={type(src).__name__}, "
                f"mesh={mesh.shape}")
        return None
    if (isinstance(src, (DeviceArrayDataset, DeviceSparseCounts))
            and _processes() == 1):
        return src
    if epoch_scan:
        raise ValueError(
            "epoch_scan=True requires a DeviceArrayDataset or "
            "DeviceSparseCounts source and a single process; got "
            f"source={type(src).__name__}, processes={_processes()}")
    return None


def _launch_counters():
    """Every kernel wrapper's launch counter, as (dict, key) pairs."""
    from spmf_tpu_torch.ops import (coo_scatter, fused_ig, fused_normal,
                                    fused_poisson)

    return [(d, k) for d in (fused_poisson.LAUNCHES, fused_ig.LAUNCHES,
                             fused_normal.LAUNCHES, coo_scatter.LAUNCHES)
            for k in d]


class _Replay:
    """One captured step: ``replay()`` launches the graph and adds the
    kernel launches the capture recorded to the wrappers' counters (their
    Python increments ran once, at capture, where nothing was launched).
    ``before``: called before each replay (the rematerialised draw's
    generator replicas take the engine generator's state there)."""

    def __init__(self, graph, launches, before=None):
        self.graph = graph
        self.launches = launches
        self.before = before

    def __call__(self):
        if self.before is not None:
            self.before()
        self.graph.replay()
        for (d, k), n in self.launches:
            d[k] += n


def packed_clone(tensors):
    """Clones of ``tensors`` that are views into one flat buffer per dtype
    and device, so that the decisions select and restore all of them in a
    few kernels: (the clones, [(a buffer, the indices of its tensors)])."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    clones = [None] * len(tensors)
    packs = []
    for idx in groups.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            clones[i] = piece.view(tensors[i].shape)
        packs.append((flat, idx))
    return clones, packs


class EpochDecisions:
    """The best / plateau / divergence decisions that end an epoch of a
    chunk, made on the device (spmf_tpu's ``_run_chunk_impl`` epoch body,
    spmf_tpu/vi/minibatch.py:758-807): one function on tensors, with every
    write an in-place ``copy_`` of a ``torch.where``, so that on the card it
    is captured once and replayed after each epoch's steps.

    ``state``: the tensors the step updates (the parameters, then Adam's
    count and moments); ``packs``: the best epoch's copy of them, as
    ``packed_clone`` gives it (the engine's host path writes its views in
    place too); ``optimizer``: its one group's learning rate is the
    carry's. ``rows``: the most epochs a chunk runs; ``width``: the batch
    losses an epoch. The carry (best loss in the compute dtype, stall
    count, float32 lr) stays on the device between chunks; ``load`` sets it
    from the host."""

    def __init__(self, state, packs, optimizer, rows, width, patience,
                 decay_rate, dtype, device):
        self.state = list(state)
        self.packs = packs
        group = optimizer.param_groups[0]
        # the learning rate: on the card the capturable Adam's float32
        # device tensor itself. On the CPU torch's Adam takes a Python float
        # (a tensor lr needs capturable=True or foreach=False), so there the
        # carry is a float32 0-d tensor, written into the group as a float
        # after each decision: the value a host-side decay gives
        self._group = None if isinstance(group["lr"], torch.Tensor) else group
        self.lr = (group["lr"] if self._group is None else
                   torch.tensor(float(group["lr"]), dtype=torch.float32))
        self.bloss = torch.zeros((), dtype=dtype, device=device)
        self.stall = torch.zeros((), dtype=torch.int64, device=device)
        self.patience = int(patience)
        self.decay = float(np.float32(decay_rate))
        self.width = width
        # a row an epoch, fetched once a chunk: its batch losses, the flags
        # (improved, plateau, finite) and the carry after its decision
        # (best loss, stall, lr), all exact in float64. ``row`` is the
        # device counter that says which row a replay writes
        self.report = torch.zeros((rows, width + 6), dtype=torch.float64,
                                  device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)

    def load(self, best_loss, stall, lr):
        """The carry from the host's control state (after a single
        epoch, or at the first chunk)."""
        self.bloss.fill_(best_loss)
        self.stall.fill_(stall)
        self.lr.fill_(lr)

    def tensors(self):
        """Every tensor a decision writes."""
        return self.state + [flat for flat, _ in self.packs] + [
            self.bloss, self.stall, self.lr, self.report, self.row]

    def __call__(self, losses):
        """Decide the epoch whose batch losses are ``losses``."""
        f64 = torch.float64
        with torch.no_grad():
            eloss = losses.mean().to(self.bloss.dtype)
            finite = torch.isfinite(eloss)
            improved = finite & (eloss < self.bloss)
            stall = torch.where(finite,
                                torch.where(improved, 0, self.stall + 1),
                                self.stall)
            plateau = finite & (stall >= self.patience)
            restore = ~finite | plateau
            for flat, idx in self.packs:
                cur = torch.cat([self.state[i].reshape(-1) for i in idx])
                flat.copy_(torch.where(improved, cur, flat))
                new = torch.where(restore, flat, cur)
                torch._foreach_copy_(
                    [self.state[i] for i in idx],
                    [piece.view(self.state[i].shape) for i, piece in zip(
                        idx, new.split([self.state[i].numel()
                                        for i in idx]))])
            self.bloss.copy_(torch.where(improved, eloss, self.bloss))
            self.lr.copy_(torch.where(
                ~finite, self.lr * 0.5,
                torch.where(plateau, self.lr * self.decay, self.lr)))
            self.stall.copy_(torch.where(plateau, 0, stall))
            row = torch.cat([
                losses.to(f64),
                torch.stack([improved, plateau, finite]).to(f64),
                torch.stack([self.bloss.to(f64), self.stall.to(f64),
                             self.lr.to(f64)])])
            self.report.index_copy_(0, self.row.reshape(1), row[None])
            self.row.add_(1)
        if self._group is not None:
            self._group["lr"] = float(self.lr)


class EpochScan:
    """The epochs of one fit over a device-resident source ``ds``.

    ``step(batch)``: the engine's training step, returning the batch's
    loss as a 0-d tensor. ``state()``: the tensors the step updates in
    place (parameters, Adam's moments and count), which the warm-up before
    a capture restores. ``generator``: the engine's generator, which draws
    the permutations and the step's samples; ``remat``: the step's
    ``RematDraw`` (vi/remat.py) when it rematerialises its draw, whose
    generator replicas each capture registers. Batches follow spmf_tpu's
    scan: a dense remainder batch is trained (on a mesh whose row ranks do
    not divide it, whole on each of them); the sparse layouts drop it,
    and only with ``drop_remainder=True``; the blocked layout needs
    ``bs % block_rows == 0``; with no full batch the remainder is the one
    batch."""

    def __init__(self, ds, step: Callable, state: Callable[[], List],
                 generator, dtype, device, capture: bool, remat=None,
                 mesh=None):
        self.ds = ds
        self.remat = remat
        self.step = step
        self.state = state
        self.generator = generator
        self.device = device
        self.capture = capture
        self.mesh = mesh
        n = ds.num_rows
        bs = int(ds._batch_size or n)
        self.blocked = isinstance(ds, DeviceSparseCounts) and bool(
            ds.block_rows)
        self.sparse = isinstance(ds, DeviceSparseCounts) and not self.blocked

        def cast(t):
            t = t.to(device)
            return t.to(dtype) if t.is_floating_point() else t

        if isinstance(ds, DeviceSparseCounts):
            # the iterator's geometry: a fixed batch shape, the remainder
            # dropped with the caller's consent
            nb, bs = ds._batches()
            rem = 0
            self.extras = {k: cast(v) for k, v in ds.extras.items()}
        else:
            nb = n // bs
            rem = 0 if ds._drop_remainder else n % bs
            self.tensors = {k: cast(v) for k, v in ds.tensors.items()}
            if mesh is not None:
                # every row of this rank's columns (the permutation is
                # global)
                for k, v in self.tensors.items():
                    if v.dim() >= 2 and mesh.splits(v.shape[1]):
                        c0, c1 = mesh.feature_slice(v.shape[1])
                        self.tensors[k] = v[:, c0:c1].contiguous()
            self.extras = {}
        self.n_perm = n
        if self.blocked:
            self.rb = bs // ds.block_rows
            self.tables = {"cols": ds.cols_blk.to(device),
                           "vals": cast(ds.vals_blk),
                           "rowl": ds.rowl_blk.to(device)}
            self.n_perm = ds.n_blocks
        elif self.sparse:
            self.pad = ds._pad(bs)
            self.csr = (ds.indptr.to(device), ds.indices.to(device),
                        cast(ds.data))
        if nb == 0:
            if rem == 0:
                raise ValueError(
                    "batched_data_factory() yields no batches — check "
                    "batch_size/drop_remainder vs dataset size")
            nb, bs, rem = 1, rem, 0
        self.nb, self.bs, self.rem = nb, bs, rem
        self.shuffle = bool(ds._shuffle)
        # the static buffers every captured step reads and writes: their
        # storage never moves (a new epoch copies into them). The counter
        # counts full batches over the whole fit; batch b of an epoch is
        # counter mod nb, so no epoch resets it
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = torch.zeros(nb + (1 if rem else 0), dtype=dtype,
                                  device=device)
        self.nnz = (torch.zeros(nb, dtype=torch.int64, device=device)
                    if self.sparse else None)
        # the batch positions this rank gathers: all of them, or its rows
        # (a full batch the row ranks do not divide raises here)
        lo, hi = (0, self.rb if self.blocked else bs) if mesh is None \
            else mesh.local_rows(bs)
        self.arange = torch.arange(lo, hi, device=device)
        # a remainder the row ranks do not divide: all its rows on each
        self.rem_whole = mesh is not None and rem % mesh.rows != 0
        self.rem_rows = (0, rem) if mesh is None or not rem \
            or self.rem_whole else mesh.local_rows(rem)
        self.perm = None      # this epoch's permutation (int32)
        self.perms = None     # the drawn epochs' permutations, and the next
        self.next_perm = 0
        self.ep = None        # the flat sparse layout's epoch decode
        self.graphs = {}      # "full" / "rem" -> _Replay

    # ------------------------------------------------------------ batches
    def _with_extras(self, batch):
        for k, v in self.extras.items():
            batch[k] = v[batch["indices"]]
        return batch

    def _gather(self, b):
        """Batch ``b`` (a 0-d device tensor) and its nnz total (None
        unless the flat sparse layout)."""
        if self.blocked:
            ids = self.perm.index_select(0, b * self.rb + self.arange)
            return self._with_extras(DeviceSparseCounts._blocked_take_math(
                self.tables, ids, self.ds.block_rows)), None
        if self.sparse:
            batch = DeviceSparseCounts._epoch_take_math(self.ep, b, self.bs,
                                                        self.pad)
            nnz = batch.pop("coo_nnz")
            return self._with_extras(batch), nnz
        rows = self.perm.index_select(0, b * self.bs + self.arange)
        return {k: v.index_select(0, rows)
                for k, v in self.tensors.items()}, None

    def _full_step(self):
        b = self.counter % self.nb
        batch, nnz = self._gather(b)
        loss = self.step(batch)
        at = b.reshape(1)
        self.losses.index_copy_(0, at, loss.reshape(1).to(self.losses.dtype))
        if nnz is not None:
            self.nnz.index_copy_(0, at, nnz.reshape(1).to(torch.int64))
        self.counter.add_(1)

    def _rem_step(self):
        lo, hi = self.rem_rows
        rows = self.perm[self.nb * self.bs + lo:self.nb * self.bs + hi]
        with (self.mesh.whole_rows() if self.rem_whole
              else contextlib.nullcontext()):
            loss = self.step({k: v.index_select(0, rows)
                              for k, v in self.tensors.items()})
        self.losses[self.nb:].copy_(loss.reshape(1).to(self.losses.dtype))

    # ------------------------------------------------------------ capture
    def _buffers(self):
        return [t for t in (self.counter, self.losses, self.nnz)
                if t is not None]

    def _capture(self, fn, tensors, what, draws=True):
        """Warm ``fn`` up once eagerly on a side stream (Adam's and the
        kernels' first-use work, the caches the wrappers fill), put
        ``tensors`` (every tensor it changes) and the generator back, then
        capture it. ``draws``: ``fn`` draws from the engine's generator,
        which the graph then registers (each replay fills its seed and
        offset)."""
        saved = [t.detach().clone() for t in tensors]
        gen_state = self.generator.get_state()
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        self.generator.set_state(gen_state)
        del saved
        counters = _launch_counters()
        before = [d[k] for d, k in counters]
        graph = torch.cuda.CUDAGraph()
        remat = self.remat if draws else None
        if draws:
            graph.register_generator_state(self.generator)
        if remat is not None:
            remat.register(graph)
        try:
            with torch.cuda.graph(graph):
                fn()
        except Exception as exc:
            raise RuntimeError(
                f"capturing {what} in a CUDA graph failed (the scan path "
                f"does not fall back to the eager loop): {exc}") from exc
        launches = []
        for (d, k), n0 in zip(counters, before):
            if d[k] != n0:
                launches.append(((d, k), d[k] - n0))
                d[k] = n0      # capture launches nothing
        return _Replay(graph, launches,
                       before=remat.sync if remat is not None else None)

    def _run(self, kind, fn, tensors, draws=True):
        """Run ``fn``: eagerly, or on the card as the graph ``kind``,
        captured at its first use (``tensors``, ``draws``: ``_capture``)."""
        if not self.capture:
            fn()
            return
        if kind not in self.graphs:
            what = ("the epoch's decisions" if kind == "decide"
                    else "the training step")
            with span("graph capture"):
                self.graphs[kind] = self._capture(fn, tensors(), what, draws)
        self.graphs[kind]()

    def _step_state(self):
        return list(self.state()) + self._buffers()

    # -------------------------------------------------------------- epoch
    def _epoch(self):
        """The permutation, the flat layout's epoch decode and the steps of
        one epoch; its nnz totals join the dataset's pending audit."""
        if self.perm is None:
            self.perm = torch.arange(self.n_perm, dtype=torch.int32,
                                     device=self.device)
        if self.shuffle:
            with span("epoch permutation"):
                self.perm.copy_(self._permutation())
        if self.sparse:
            with span("epoch decode"):
                ep = DeviceSparseCounts._epoch_decode_math(
                    *self.csr, self.perm[:self.nb * self.bs], self.pad)
                if self.ep is None:
                    self.ep = ep
                else:
                    for k, v in ep.items():
                        self.ep[k].copy_(v)
        for _ in range(self.nb):
            self._run("full", self._full_step, self._step_state)
        if self.rem:
            self._run("rem", self._rem_step, self._step_state)
        if self.sparse:
            self.ds._pending_nnz.append(self.nnz.clone())

    def _audit(self):
        """The flat layout's pad overflow audit: one fetch of the pending
        nnz totals."""
        if self.sparse:
            self.ds.check_overflow()

    def run_epoch(self):
        """Train one epoch; returns the device buffer of its batch losses
        (valid until the next epoch)."""
        self._epoch()
        self._audit()
        return self.losses

    def run_chunk(self, k, decide):
        """Train ``k`` epochs, each ended by ``decide`` (an
        ``EpochDecisions``) on its batch losses, with nothing fetched
        between them; the flat layout's nnz totals are audited once, after
        the last. Returns the device rows of ``decide.report`` (one an
        epoch), valid until the next chunk."""
        decide.row.zero_()
        for _ in range(k):
            self._epoch()
            # draws nothing: the engine's generator is not registered
            self._run("decide", lambda: decide(self.losses), decide.tensors,
                      draws=False)
        self._audit()
        return decide.report[:k]

    def _permutation(self):
        """This epoch's uniform permutation, from the engine's generator:
        the argsort of float64 uniform keys (ties have probability about
        n^2 / 2^54), drawn for ``_PERM_EPOCHS`` epochs at once."""
        if self.perms is None or self.next_perm == len(self.perms):
            keys = torch.rand((_PERM_EPOCHS, self.n_perm),
                              generator=self.generator, dtype=torch.float64,
                              device=self.device)
            self.perms = torch.argsort(keys, dim=1).to(torch.int32)
            self.next_perm = 0
        self.next_perm += 1
        return self.perms[self.next_perm - 1]

    def close(self):
        """Release the graphs and their private memory pools."""
        self.graphs.clear()
