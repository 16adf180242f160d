"""Minibatch stochastic ADVI engine (mirrors the general per-batch loop of
spmf_tpu/vi/minibatch.py).

Per batch: draw ``sample_size`` reparameterized samples, evaluate the
energy, take the gradient of -ELBO / rows, clip every gradient element at
±clip_value (``optax.clip``, not a norm clip), and apply Adam with the
learning rate the plateau logic sets. Per epoch: print the average and last
batch loss, keep the best parameters, restore them and decay the learning
rate on a plateau (or halve it after a non-finite epoch), and stop on the
rel_tol / abs_tol window. Returns the best parameters and the loss trace.

Persistence (spmf_tpu's npz format, utils.checkpoint): a checkpoint is
written on every improving epoch (once a chunk on the chunk path), and a
fit resumes from one; a KeyboardInterrupt returns the best parameters
reached so far.

A device-resident source (``DeviceArrayDataset``, ``DeviceSparseCounts``)
takes the whole-epoch scan path (``vi/epoch_scan.py``): batches gathered on
the device and, on the card, each batch's gather and step replayed from a
CUDA graph. Its epochs run singly, with the control flow above on the host,
or K to a chunk (``epoch_chunk``), with the decisions made on the device
after each epoch and replayed on the host from one fetch a chunk. A host
source's batches are assembled and moved to the device ``prefetch``
batches ahead in a worker thread (``data/prefetch.py``).

On a rank mesh (``mesh=``, ``parallel.Mesh``) every rank runs this loop
over the same global batch sequence and keeps its part of each batch: its
rows and, with an fp axis, its columns (a sparse batch stays whole; the
COO energies split its triplets). With ``param_sharding`` 'fp' (or 'auto'
on an fp mesh) each rank holds its slice of the feature dim of the
variables the surrogate maps to a feature axis. The energy returns the
whole batch's energy on every rank, so each rank computes the one global
loss L; it backpropagates L / ranks, and each gradient is summed over the
ranks that hold the same copy of its parameter (one flat bucket a group)
before the clip and Adam. Decisions read the global loss, so every rank
takes the same branch. Checkpoints gather the slices and rank 0 writes;
the returned parameters are whole on every rank.
"""
from __future__ import annotations

import contextlib
import copy
import glob
import os
import re
import time
import uuid
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from spmf_tpu_torch.data.prefetch import prefetch_batches
from spmf_tpu_torch.parallel import collectives as _coll
from spmf_tpu_torch.parallel.mesh import (
    _is_coo,
    shard_batch,
    shard_params_feature_dim,
)
from spmf_tpu_torch.vi import epoch_scan as _scan
from spmf_tpu_torch.vi.remat import RematDraw
from spmf_tpu_torch.utils.checkpoint import (
    flatten_jax_order,
    gather_shard,
    load_fit_state,
    save_fit_state,
    save_pytree,
    writes_files,
)
from spmf_tpu_torch.utils.convert import (
    adam_leaf_count,
    adam_state_from_numpy,
    adam_state_to_numpy,
)

__all__ = ["FitResult", "clip_and_step", "elbo_loss", "fit_surrogate_posterior",
           "make_optimizer", "resume_seed"]


@dataclass
class FitResult:
    params: Any
    losses: List[float]
    learning_rate: float
    #: the optimizer's ``state_dict()`` at the end of the fit; pass it back
    #: as ``opt_state=`` to continue
    opt_state: Any = None
    #: the run's checkpoint directory, ``{checkpoint_dir}/{run_id}``
    checkpoint_path: Optional[str] = None
    converged: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


def _device_batch(batch, dtype, device):
    """A dict batch as tensors on ``device``: floating arrays cast to the
    engine dtype, index arrays kept as integers, and tensors already on
    ``device`` (a DeviceSparseCounts batch) passed through uncopied."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if t.is_floating_point():
            t = t.to(dtype)
        out[k] = t.to(device, non_blocking=True)
    return out


def _batch_rows(batch):
    for k in ("indices", "counts", "data"):
        if k in batch:
            return batch[k].shape[0]
    return next(iter(batch.values())).shape[0]


class _MeshPlan:
    """How one fit lays its state out on a rank mesh: which parameter
    leaves hold this rank's fp slice (``split``: name -> axis), the
    gradient buckets, and each batch's part on this rank."""

    def __init__(self, mesh, surrogate, param_sharding):
        self.mesh = mesh
        split_fn = getattr(surrogate, "_split_axis", None)
        fp_params = (param_sharding != "replicated"
                     and mesh.fp_axis is not None and split_fn is not None
                     and getattr(surrogate, "mesh", None) is mesh)
        self.split = {n: split_fn(n) for n in surrogate.surrogates
                      if fp_params and split_fn(n) is not None}

    def local_params(self, params):
        """This rank's slices of the split variables (the surrogate's
        feature axes are ``shard_params_feature_dim``'s)."""
        return shard_params_feature_dim(params, self.mesh) if self.split \
            else params

    @staticmethod
    def _moments(params):
        """(variable name, the indices of its first and second moments) of
        each leaf of optax's flat Adam state, in its order."""
        names = flatten_jax_order({n: {k: n for k in sub}
                                   for n, sub in params.items()})
        L = len(names)
        return [(n, (3 + j, 3 + L + j)) for j, n in enumerate(names)]

    def local_opt(self, leaves, params):
        """optax's flat Adam leaves of the whole variables, with the moments
        of the split ones at this rank's slice."""
        out = list(leaves)
        for n, idx in self._moments(params):
            ax = self.split.get(n)
            for i in idx if ax is not None else ():
                a = np.asarray(out[i])
                c0, c1 = self.mesh.feature_slice(a.shape[ax])
                out[i] = np.take(a, np.arange(c0, c1), axis=ax)
        return out

    def full_params(self, params):
        """The whole variables on every rank (a collective)."""
        return {n: {k: torch.as_tensor(gather_shard(t, self.split.get(n),
                                                    self.mesh)).to(t.device)
                    for k, t in sub.items()} for n, sub in params.items()}

    def full_opt(self, leaves, params):
        """optax's flat Adam leaves with the split moments gathered whole
        (a collective)."""
        out = list(leaves)
        device = _leaves(params)[0].device
        for n, idx in self._moments(params):
            for i in idx:
                out[i] = gather_shard(torch.as_tensor(out[i]).to(device),
                                      self.split.get(n), self.mesh)
        return out

    def buckets(self, params):
        """(group, leaves) of the gradient reduction: the split leaves over
        the row ranks (each fp line holds its own slices), the others over
        the whole mesh; a group of one rank is left out."""
        split = [t for n, sub in params.items() if n in self.split
                 for t in sub.values()]
        whole = [t for n, sub in params.items() if n not in self.split
                 for t in sub.values()]
        out = []
        for axes, leaves in ((self.mesh.row_axes, split),
                             (self.mesh.live_axes, whole)):
            group = self.mesh.group(axes)
            if group is not None and leaves:
                out.append((group, leaves))
        return out

    def batch(self, batch):
        """This rank's part of a global batch."""
        return shard_batch(batch, self.mesh)

    def rows(self, batch):
        """The rows of the global batch whose part is ``batch``."""
        n = _batch_rows(batch)
        return n if _is_coo(batch) else n * self.mesh.rows


def _leaves(params):
    return [t for sub in params.values() for t in sub.values()]


def _like(params, tensors):
    """``tensors`` (in ``_leaves`` order) in the nested dict of ``params``."""
    it = iter(tensors)
    return {n: {k: next(it) for k in sub} for n, sub in params.items()}


def _epoch_tag(path):
    """A checkpoint ``{run_id}-{epoch}.npz``'s order: its epoch tag (-1 if
    the name has none), then its mtime."""
    m = re.search(r"-(\d+)\.npz$", os.path.basename(path))
    return (int(m.group(1)) if m else -1, os.path.getmtime(path))


def _resolve_checkpoint(path):
    """``path`` itself, or for a directory the newest .npz under it
    (searched recursively) by epoch tag, then mtime."""
    if not os.path.isdir(path):
        return path
    cands = sorted(glob.glob(os.path.join(path, "**", "*.npz"),
                             recursive=True), key=_epoch_tag)
    if not cands:
        raise FileNotFoundError(f"no .npz checkpoints under {path}")
    return cands[-1]


def resume_seed(seed, epoch_offset):
    """The generator seed of a fit resumed at global epoch ``epoch_offset``:
    the first 64-bit word of ``numpy.random.SeedSequence([seed mod 2**64,
    epoch_offset])``. Deterministic (same seed and checkpoint, same
    continuation) and a fresh stream, so a resume does not replay the first
    run's draws (the JAX engine folds the offset into its key instead)."""
    seq = np.random.SeedSequence([int(seed) % 2**64, int(epoch_offset)])
    return int(seq.generate_state(1, np.uint64)[0])


def make_optimizer(params, learning_rate):
    """Adam with optax's defaults (b1=0.9, b2=0.999, eps=1e-8) over every
    leaf of the parameter dict; the learning rate is set per plateau."""
    return torch.optim.Adam(_leaves(params), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _settle_optimizer(optimizer, capturable):
    """Fix the optimizer's storage before the first step, after any state
    was loaded: every parameter's Adam state exists (count 0 and zero
    moments where none was loaded, which is what Adam's first step would
    create), and with ``capturable`` the count and the learning rate are
    float32 tensors on the device, as a CUDA graph of the step needs them.
    From here on every restore copies into these tensors."""
    for group in optimizer.param_groups:
        device = group["params"][0].device if capturable else "cpu"
        lr = float(group["lr"])
        group["capturable"] = capturable
        group["lr"] = (torch.tensor(lr, dtype=torch.float32, device=device)
                       if capturable else lr)
        for p in group["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = torch.tensor(0.0, dtype=torch.float32)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
            st["step"] = st["step"].to(dtype=torch.float32, device=device)


def _adam_tensors(optimizer):
    """Every tensor of the Adam state, in parameter order."""
    return [optimizer.state[p][k] for g in optimizer.param_groups
            for p in g["params"] for k in ("step", "exp_avg", "exp_avg_sq")]


def _restore(tensors, snapshot):
    """Copy ``snapshot`` into ``tensors`` in place (a captured step keeps
    reading the same storage)."""
    with torch.no_grad():
        for t, s in zip(tensors, snapshot):
            t.copy_(s)


def elbo_loss(surrogate, energy_fn, params, batch, generator, sample_size,
              prior_weight=1.0, sample_batches=1, antithetic=False,
              draws=None, draw=None, rows=None):
    """-ELBO / rows of one batch, estimated from ``sample_size`` x
    ``sample_batches`` surrogate samples (``draws``: injected base draws,
    tests only). ``draw(params, j) -> (samples, logq)``: the engine's draw
    of sample batch j (the STL and rematerialised forms), in place of the
    surrogate's plain ``sample_and_log_prob``. ``rows``: the global batch's
    rows where ``batch`` is a rank's part of it."""
    total = 0.0
    for j in range(sample_batches):
        if draw is None:
            samples, logq = surrogate.sample_and_log_prob(
                params, generator, (sample_size,), antithetic=antithetic,
                draws=draws)
        else:
            samples, logq = draw(params, j)
        lp = energy_fn(batch, samples, prior_weight)
        total = total + torch.mean(lp - logq)
    return -(total / sample_batches) / (_batch_rows(batch) if rows is None
                                        else rows)


def clip_and_step(optimizer, clip_value):
    """Clip every gradient element at +-clip_value (optax.clip), then take
    the Adam step."""
    with torch.no_grad():
        for group in optimizer.param_groups:
            for t in group["params"]:
                if t.grad is not None:
                    t.grad.clamp_(-clip_value, clip_value)
    optimizer.step()


def fit_surrogate_posterior(
    energy_fn: Callable,  # (batch_dict, samples_dict, prior_weight) -> (S,)
    surrogate,            # SurrogatePosterior
    params,               # {name: {leaf: tensor}}
    batched_data_factory: Callable,  # () -> iterable of dict batches
    dataset_size: Optional[int] = None,
    batch_size: Optional[int] = None,
    sample_size: int = 8,
    sample_batches: int = 1,
    num_steps: int = 100,
    learning_rate: float = 0.1,
    decay_rate: float = 0.99,
    abs_tol: Optional[float] = None,
    rel_tol: Optional[float] = 1e-4,
    clip_value: float = 5.0,
    patience: int = 3,
    convergence_window: int = 8,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
    checkpoint_dir: Optional[str] = None,
    verbose: bool = True,
    decay_schedule: Optional[str] = None,
    elbo_estimator: str = "standard",
    antithetic: bool = False,
    opt_state=None,
    resume_from: Optional[str] = None,
    checkpoint_full_state: bool = True,
    epoch_scan: Optional[bool] = None,
    epoch_chunk: Optional[int] = None,
    prefetch: int = 2,
    profile_dir: Optional[str] = None,
    remat_sampling: Optional[bool] = None,
    mesh=None,
    param_sharding: str = "auto",
) -> FitResult:
    """Run minibatch ADVI. The displayed per-batch loss is -ELBO / rows,
    the ELBO estimated by ``sample_size`` x ``sample_batches`` samples;
    ``prior_weight = batch_size / dataset_size`` is forwarded to the
    energy. Randomness comes from one ``torch.Generator`` seeded with
    ``seed`` on the parameters' device. ``antithetic``: mirror the
    surrogate's base draws across the (even) sample axis; 'stratified' also
    couples the S/2 pairs on a randomly shifted Korobov lattice.

    ``checkpoint_dir``: on every improving epoch write
    ``{checkpoint_dir}/{run_id}/{run_id}-{global epoch}.npz`` with that
    epoch's parameters and, with ``checkpoint_full_state`` (the default),
    the Adam state and the control state (lr, best_loss, stall, epoch).
    ``resume_from``: a checkpoint file, or a directory (its newest file by
    epoch tag, then mtime, searched recursively), of either package. Its
    parameters are cast to ``dtype``; a full state also continues the Adam
    moments, the learning rate (the checkpoint's wins over the argument),
    best_loss and stall, and the epoch tags continue its global epoch. The
    generator is then re-seeded with ``resume_seed(seed, epoch)`` after the
    initial evaluation. ``opt_state``: a ``FitResult.opt_state`` of this
    package; it wins over a checkpoint's optimizer state, with a
    RuntimeWarning.

    ``epoch_scan`` (default auto): with a ``DeviceArrayDataset`` or
    ``DeviceSparseCounts`` source in a single process, each epoch runs on
    the device (``vi/epoch_scan.py``): one permutation drawn from the
    engine's generator, then per batch a gather and the training step, on
    the card captured once in a CUDA graph and replayed. True raises on
    any other source; False keeps the general loop. ``epoch_chunk``: K > 1
    runs K epochs a dispatch on the scan path, with the best / plateau /
    divergence decisions made on the device after each epoch and one fetch
    a chunk; None (auto) runs chunks of 8 on a dense device dataset once
    two single epochs took a second or less each and 24 epochs remain.

    ``elbo_estimator``: 'standard', or 'stl' ("sticking the landing",
    Roeder et al. 2017): log q is evaluated at the parameters detached, so
    only the pathwise sample term carries gradient. It drops the score
    term (zero in expectation) and its variance; unbiased, and opt-in
    (spmf_tpu measured it converging slower on the parity config, where
    the score term is a control variate for the heavy-tailed horseshoe
    auxiliaries). It forces the plain samplers. ``remat_sampling``: draw
    the samples without keeping their graph and draw them again in the
    backward from the same generator state (``vi/remat.py``); None turns it
    on unless the surrogate's sampler is 'fused', whose replay backward
    keeps no residuals already (rematerialising it re-runs the kernel).

    ``mesh``: a ``parallel.Mesh`` of the ranks that run this fit together
    (see the module docstring; a mesh whose axes all have size 1 changes
    nothing); the energy must return the global energy on every rank.
    ``param_sharding``: 'auto' (split the feature dim over an fp axis),
    'fp' or 'replicated'. With more than one rank the scan path runs
    uncaptured: the collectives stage through the host and cannot sit in
    a CUDA graph (``extras['captured']``, ``extras['capture_reason']``)."""
    say = print if verbose else (lambda *a, **k: None)
    if elbo_estimator not in ("standard", "stl"):
        raise ValueError(f"unknown elbo_estimator {elbo_estimator!r}")
    if decay_schedule == "reference":
        # the reference engine's observed plateau decays are ~x0.93
        decay_rate = 0.93
    elif decay_schedule not in (None, "default"):
        raise ValueError(f"unknown decay_schedule {decay_schedule!r}")

    if epoch_chunk is not None and epoch_chunk < 1:
        raise ValueError(f"epoch_chunk must be >= 1, got {epoch_chunk}")
    if param_sharding not in ("auto", "fp", "replicated"):
        raise ValueError(f"unknown param_sharding {param_sharding!r}: "
                         "'auto', 'fp' or 'replicated'")
    if mesh is not None and mesh.trivial:
        mesh = None
    plan = (None if mesh is None
            else _MeshPlan(mesh, surrogate, param_sharding))
    scan_ds = _scan.scan_source(batched_data_factory, epoch_scan, mesh)
    explicit_chunk = epoch_chunk is not None and epoch_chunk > 1
    if explicit_chunk and scan_ds is None:
        raise ValueError(
            "epoch_chunk > 1 requires the epoch_scan fast path "
            "(DeviceArrayDataset or DeviceSparseCounts source, single "
            "process)")

    prior_weight = 1.0
    if dataset_size is not None and batch_size is not None:
        prior_weight = float(batch_size) / float(dataset_size)

    if device is None:
        device = _leaves(params)[0].device
    epoch_offset = 0
    resume_opt = None     # optax's flat Adam leaves of a full checkpoint
    resume_meta = None    # its control state
    if resume_from is not None:
        path = _resolve_checkpoint(resume_from)
        # the global epoch continues in this run's tags; the recorded one
        # backs up a renamed file's
        epoch_offset = max(_epoch_tag(path)[0], 0)
        params, resume_opt, resume_meta = load_fit_state(path, params)
        if resume_meta is not None:
            epoch_offset = max(epoch_offset,
                               int(resume_meta.get("epoch", 0)))
        say(f"Resumed surrogate params from {path}")
    params = {n: {k: torch.as_tensor(t).detach()
                  .to(device=device, dtype=dtype).clone()
                  for k, t in sub.items()}
              for n, sub in params.items()}
    full_like = params
    if plan is not None:
        # every rank from rank 0's values, then this rank's slices
        params = plan.local_params(_like(params, [
            mesh.broadcast_(t) for t in _leaves(params)]))
        if resume_opt is not None:
            resume_opt = plan.local_opt(resume_opt, full_like)
    for t in _leaves(params):
        t.requires_grad_(True)
    leaves = _leaves(params)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def _f32(value):
        """The JAX engine injects lr as a float32 hyperparameter; the
        learning rate applied here is rounded the same way."""
        return float(np.float32(value))

    optimizer = make_optimizer(params, _f32(learning_rate))

    def _set_lr(value):
        for group in optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(_f32(value))
            else:
                group["lr"] = _f32(value)

    if opt_state is not None:
        optimizer.load_state_dict(copy.deepcopy(opt_state))
        if resume_opt is not None:
            warnings.warn(
                "both opt_state= and a full-state resume_from checkpoint "
                "were given; the explicit opt_state wins (checkpoint "
                "optimizer/control state ignored)", RuntimeWarning)
            resume_meta = None
    elif resume_opt is not None:
        if len(resume_opt) == adam_leaf_count(params):
            adam_state_from_numpy(resume_opt, optimizer, params)
        else:  # another optimizer's state
            warnings.warn(
                f"resume_from checkpoint has {len(resume_opt)} optimizer "
                f"leaves but this run's optimizer has "
                f"{adam_leaf_count(params)}; restoring params only (fresh "
                "optimizer state)", RuntimeWarning)
            resume_meta = None
    # the scan path on the card runs the step in a CUDA graph, which needs
    # Adam's capturable mode; the eager scan keeps the mode, so that the
    # two agree bit for bit (several ranks' collectives stage through the
    # host, so a meshed scan runs eagerly)
    card_scan = scan_ds is not None and device.type == "cuda"
    _settle_optimizer(optimizer, card_scan)
    capture = card_scan and _scan._CAPTURE and mesh is None
    opt_tensors = _adam_tensors(optimizer)

    def draw(p, j=0):
        # STL: the density's parameters are the live ones detached, the
        # sample path stays live
        logq_params = ({n: {k: t.detach() for k, t in sub.items()}
                        for n, sub in p.items()}
                       if elbo_estimator == "stl" else None)
        return surrogate.sample_and_log_prob(
            p, generator, (sample_size,), antithetic=antithetic,
            logq_params=logq_params)

    if remat_sampling is None:
        remat_sampling = getattr(surrogate, "gamma_sampler", "") != "fused"
    remat = RematDraw(draw, generator) if remat_sampling else None

    def _loss(batch):
        return elbo_loss(surrogate, energy_fn, params, batch, generator,
                         sample_size, prior_weight, sample_batches,
                         antithetic, draw=draw if remat is None else remat,
                         rows=None if plan is None else plan.rows(batch))

    buckets = [] if plan is None else plan.buckets(params)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = _loss(batch)
        if plan is None:
            loss.backward()
        else:
            # every rank holds the global loss: each backpropagates its
            # share, and the copies' gradients are summed
            (loss / mesh.size).backward()
            _coll.reduce_gradients(buckets)
        clip_and_step(optimizer, clip_value)
        return loss.detach()

    # the prefetch worker's current stream is the default one: its copies
    # go on the caller's stream, which the steps that read them run on
    stream = (torch.cuda.current_stream(device) if device.type == "cuda"
              else None)

    def to_device(b):
        if plan is not None:
            b = plan.batch(b)
        with torch.cuda.stream(stream):      # None: no stream to set
            return _device_batch(b, dtype, device)

    # a device-resident source's first rows, as a view: no shuffle epoch
    # used up and no dataset-sized gather
    src = getattr(batched_data_factory, "source", None)
    first_batch = (src.peek_batch() if hasattr(src, "peek_batch")
                   else next(iter(batched_data_factory())))
    with torch.no_grad():
        initial_loss = float(_loss(to_device(first_batch)))
    say(f"Initial loss: {initial_loss}")
    if epoch_offset > 0:
        # after the display-only initial eval, as the JAX engine folds the
        # offset into its key; a fresh run's generator is left as it is
        generator.manual_seed(resume_seed(seed, epoch_offset))

    losses: List[float] = [initial_loss]
    # epoch averages are the checkpoint unit; the single-batch initial eval
    # is display-only and does not seed best_loss
    best_loss = np.inf
    lr = learning_rate
    stall = 0
    if resume_meta is not None:
        # a full-state resume continues the run's control state; the
        # checkpoint's learning rate supersedes the argument
        lr = _f32(resume_meta.get("lr", lr))
        best_loss = float(resume_meta.get("best_loss", best_loss))
        stall = int(resume_meta.get("stall", 0))
        _set_lr(lr)
        say("Restored optimizer/control state: "
            f"lr={lr}, best_loss={best_loss}, stall={stall}, "
            f"epoch={epoch_offset}"
            + (f" (checkpoint lr supersedes learning_rate={learning_rate};"
               " pass opt_state= or checkpoint_full_state=False runs to"
               " override)"
               if np.float32(learning_rate) != np.float32(lr) else ""))
    ckpt_path = None
    run_id = str(uuid.uuid4())
    if mesh is not None and checkpoint_dir is not None:
        # every rank agrees on the run directory and file names (rank 0's
        # files are the checkpoint)
        code = torch.tensor(list(run_id.encode("ascii")), dtype=torch.int64,
                            device=device)
        run_id = bytes(mesh.broadcast_(code).tolist()).decode("ascii")
    if checkpoint_dir is not None:
        ckpt_path = os.path.join(checkpoint_dir, run_id)
        os.makedirs(ckpt_path, exist_ok=True)

    # the best epoch's parameters and Adam state, in fixed buffers that
    # both paths write in place (the chunk path's decisions on the device;
    # a captured decision reads this storage)
    state = leaves + opt_tensors
    best, best_packs = _scan.packed_clone(state)
    best_params = _like(params, best[:len(leaves)])
    opt_params = [p for g in optimizer.param_groups for p in g["params"]]
    best_adam = {p: dict(zip(("step", "exp_avg", "exp_avg_sq"),
                             best[len(leaves) + 3 * i:len(leaves) + 3 * i + 3]))
                 for i, p in enumerate(opt_params)}
    checkpoint_seconds: List[float] = []

    def save_ckpt(epoch, control, opt_lr):
        """The best state, tagged with its epoch; ``control``: the (best
        loss, stall, lr) a resume continues, ``opt_lr``: the learning rate
        of the Adam leaves (the one the best epoch ran with)."""
        t_write = time.perf_counter()
        tag = epoch + epoch_offset
        path = os.path.join(ckpt_path, f"{run_id}-{tag}.npz")
        tree = best_params if plan is None else plan.full_params(best_params)
        if checkpoint_full_state:
            c_loss, c_stall, c_lr = control
            opt = adam_state_to_numpy(optimizer, params, state=best_adam,
                                      lr=opt_lr)
            if plan is not None:
                # gathered before the rank-0 gate: every rank joins
                opt = plan.full_opt(opt, best_params)
            if writes_files(mesh):
                save_fit_state(path, tree, opt,
                               meta={"lr": _f32(c_lr),
                                     "best_loss": float(c_loss),
                                     "stall": int(c_stall), "epoch": tag})
        elif writes_files(mesh):
            save_pytree(path, tree)
        checkpoint_seconds.append(time.perf_counter() - t_write)
        say(f"Saved a checkpoint: {path}")

    converged = False
    epoch_seconds: List[float] = []

    def _decay_f32(value, factor):
        return float(np.float32(value) * np.float32(factor))

    def _check_convergence(epoch):
        nonlocal converged
        if len(losses) > convergence_window:
            window = losses[-convergence_window:]
            spread = max(window) - min(window)
            if rel_tol is not None and spread < rel_tol * abs(window[-1]):
                converged = True
            if abs_tol is not None and spread < abs_tol:
                converged = True
            if converged:
                say(f"Converged (window spread {spread:.3e}); "
                    f"stopping at epoch {epoch}")
        return converged

    def _bookkeep(epoch, epoch_loss, last_batch_loss, improved, finite,
                  on_improve=None):
        """One epoch's prints and best / stall / lr accounting, from the
        host's comparisons (single epochs) or the device's flags (the chunk
        path's replay). Returns the plateau decision."""
        nonlocal best_loss, stall, lr
        losses.append(epoch_loss)
        say(f"Epoch {epoch}: average-batch loss: {epoch_loss} "
            f"last batch loss: {last_batch_loss}")
        if not finite:
            # divergence: restore best and decay hard
            say(f"Non-finite loss; restoring from a checkpoint - loss: "
                f"{best_loss}")
            lr = _decay_f32(lr, 0.5)
            return False
        if improved:
            best_loss = epoch_loss
            stall = 0
            if on_improve is not None:
                on_improve(epoch)
        else:
            stall += 1
        plateau = stall >= patience
        if plateau:
            lr = _decay_f32(lr, decay_rate)
            say(f"We are in a loss plateau learning rate: {lr} "
                f"loss: {epoch_loss}")
            say(f"Restoring from a checkpoint - loss: {best_loss}")
            stall = 0
        return plateau

    def _on_improve(epoch):
        _restore(best, state)
        if ckpt_path is not None:
            save_ckpt(epoch, (best_loss, stall, lr), lr)

    scan = None
    if scan_ds is not None:
        scan = _scan.EpochScan(
            scan_ds, step, lambda: state, generator, dtype, device,
            capture=capture, remat=remat, mesh=mesh)
    chunk_size = epoch_chunk if explicit_chunk else 0
    chunk_used = 0
    decide = None          # the chunk path's EpochDecisions
    carry_on_device = False

    def run_chunk(epoch, k):
        """Epochs ``epoch + 1 .. epoch + k`` as one chunk, then the host's
        replay of their decisions and the chunk's checkpoint. Returns the
        last epoch."""
        nonlocal decide, carry_on_device, chunk_used
        if decide is None:
            decide = _scan.EpochDecisions(
                state, best_packs, optimizer, min(chunk_size, num_steps),
                len(scan.losses), patience, decay_rate, dtype, device)
        if not carry_on_device:
            decide.load(best_loss, stall, lr)
        t_chunk = time.perf_counter()
        with torch.profiler.record_function("fit chunk"):
            # ONE device fetch for the chunk
            rows = scan.run_chunk(k, decide).tolist()
        # the carry stays in device form between chunks: re-deriving the
        # best loss from the host's float64 means would drift from it
        carry_on_device = True
        per_epoch = (time.perf_counter() - t_chunk) / k
        chunk_used = max(chunk_used, k)
        w = decide.width
        last_improve = None
        for row in rows:
            epoch += 1
            epoch_seconds.append(per_epoch)
            improved, plateau_dev, finite = (bool(f) for f in row[w:w + 3])
            if improved:
                last_improve = (epoch, row[w + 5])
            plateau = _bookkeep(epoch, float(np.mean(row[:w])), row[w - 1],
                                improved, finite)
            if plateau != plateau_dev:
                # the parameters followed the device's decisions either way
                warnings.warn(
                    "epoch-chunk replay drifted from the on-device decision "
                    f"sequence at epoch {epoch} (host plateau={plateau}, "
                    f"device={plateau_dev}); prints/lr bookkeeping may lag "
                    "the device state", RuntimeWarning)
        if last_improve is not None and ckpt_path is not None:
            # the device carry is the control state a resume continues
            c_loss, c_stall, c_lr = rows[-1][w + 3:]
            save_ckpt(last_improve[0], (c_loss, c_stall, c_lr),
                      last_improve[1])
        return epoch

    if profile_dir is not None:
        profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA]
                if device.type == "cuda" else []),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir))
    else:
        profiler = contextlib.nullcontext()

    epoch = 0
    interrupted = False
    try:
        with profiler:
            while epoch < num_steps:
                remaining = num_steps - epoch
                if (scan is not None and epoch_chunk is None and epoch == 2
                        and not (scan.sparse or scan.blocked)
                        and epoch_seconds[1] <= 1.0 and remaining >= 3 * 8):
                    # spmf_tpu's adaptive default (its sparse scans measured
                    # slower chunked, so only the dense scan engages)
                    chunk_size = 8
                k = 0
                if chunk_size > 1:
                    # an explicit K is clamped to the epochs left; the
                    # default leaves a shorter tail to single epochs
                    k = (min(chunk_size, remaining) if explicit_chunk
                         else (chunk_size if remaining >= chunk_size else 0))
                if k >= 2:
                    epoch = run_chunk(epoch, k)
                    if _check_convergence(epoch):
                        break
                    continue

                carry_on_device = False
                epoch += 1
                t_epoch = time.perf_counter()
                # a named range for torch.profiler (the smoke script's per-
                # step launches and busy share are read inside these)
                with torch.profiler.record_function("fit epoch"):
                    if scan is not None:
                        batch_losses = scan.run_epoch()
                    else:
                        batch_losses = [step(b) for b in prefetch_batches(
                            batched_data_factory(), prefetch, to_device)]
                        if not batch_losses:
                            raise ValueError(
                                "batched_data_factory() yielded no batches "
                                f"in epoch {epoch} — check "
                                "batch_size/drop_remainder vs dataset size")
                        batch_losses = torch.stack(batch_losses)
                    # ONE device fetch for the epoch
                    batch_losses = batch_losses.cpu().tolist()
                epoch_seconds.append(time.perf_counter() - t_epoch)
                epoch_loss = float(np.mean(batch_losses))
                finite = bool(np.isfinite(epoch_loss))
                plateau = _bookkeep(epoch, epoch_loss, batch_losses[-1],
                                    finite and epoch_loss < best_loss, finite,
                                    on_improve=_on_improve)
                if not finite or plateau:
                    # in place: a captured step reads this storage
                    _restore(state, best)
                    _set_lr(lr)
                    if not finite:
                        continue
                if _check_convergence(epoch):
                    break
    except KeyboardInterrupt:
        # Ctrl-C / SIGINT: return the best state reached so far (written
        # checkpoints stay on disk)
        interrupted = True
        say(f"Interrupted at epoch {epoch}; returning the best params so "
            f"far (loss {best_loss})")
    finally:
        if scan is not None:
            # the graphs' private pools hold the step's activations, and
            # the gradients live in them
            scan.close()
            optimizer.zero_grad(set_to_none=True)

    extras = {}
    if scan is not None:
        extras["captured"] = scan.capture
        if mesh is not None:
            extras["capture_reason"] = (
                f"{mesh.size} ranks: the collectives stage through the host "
                "and cannot sit in a CUDA graph")
    return FitResult(
        params=best_params if plan is None else plan.full_params(best_params),
        losses=losses,
        learning_rate=lr,
        opt_state=optimizer.state_dict(),
        checkpoint_path=ckpt_path,
        converged=converged,
        extras={"epoch_seconds": epoch_seconds,
                "epoch_scan": scan is not None,
                # the largest K-epoch chunk run (0: none)
                "epoch_chunk": chunk_used,
                # each checkpoint write: the copy to the host and the npz
                "checkpoint_seconds": checkpoint_seconds,
                # the returned params are the best before the interrupt
                "interrupted": interrupted, **extras},
    )
