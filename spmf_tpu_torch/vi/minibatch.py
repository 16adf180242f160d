"""Minibatch stochastic ADVI engine (mirrors the general per-batch loop of
spmf_tpu/vi/minibatch.py).

Per batch: draw ``sample_size`` reparameterized samples, evaluate the
energy, take the gradient of -ELBO / rows, clip every gradient element at
±clip_value (``optax.clip``, not a norm clip), and apply Adam with the
learning rate the plateau logic sets. Per epoch: print the average and last
batch loss, keep the best parameters, restore them and decay the learning
rate on a plateau (or halve it after a non-finite epoch), and stop on the
rel_tol / abs_tol window. Returns the best parameters and the loss trace.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["FitResult", "clip_and_step", "elbo_loss", "fit_surrogate_posterior",
           "make_optimizer"]


@dataclass
class FitResult:
    params: Any
    losses: List[float]
    learning_rate: float
    converged: bool = False
    extras: Dict[str, Any] = field(default_factory=dict)


def _device_batch(batch, dtype, device):
    """A dict batch as tensors on ``device``; floating arrays cast to the
    engine dtype."""
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


def _leaves(params):
    return [t for sub in params.values() for t in sub.values()]


def _detached(params):
    return {n: {k: t.detach().clone() for k, t in sub.items()}
            for n, sub in params.items()}


def make_optimizer(params, learning_rate):
    """Adam with optax's defaults (b1=0.9, b2=0.999, eps=1e-8) over every
    leaf of the parameter dict; the learning rate is set per plateau."""
    return torch.optim.Adam(_leaves(params), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def elbo_loss(surrogate, energy_fn, params, batch, generator, sample_size,
              prior_weight=1.0, sample_batches=1, antithetic=False,
              draws=None):
    """-ELBO / rows of one batch, estimated from ``sample_size`` x
    ``sample_batches`` surrogate samples (``draws``: injected base draws,
    tests only)."""
    total = 0.0
    for _ in range(sample_batches):
        samples, logq = surrogate.sample_and_log_prob(
            params, generator, (sample_size,), antithetic=antithetic,
            draws=draws)
        lp = energy_fn(batch, samples, prior_weight)
        total = total + torch.mean(lp - logq)
    return -(total / sample_batches) / _batch_rows(batch)


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
) -> FitResult:
    """Run minibatch ADVI. The displayed per-batch loss is -ELBO / rows,
    the ELBO estimated by ``sample_size`` x ``sample_batches`` samples;
    ``prior_weight = batch_size / dataset_size`` is forwarded to the
    energy. Randomness comes from one ``torch.Generator`` seeded with
    ``seed`` on the parameters' device."""
    say = print if verbose else (lambda *a, **k: None)
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint_dir is not ported to spmf_tpu_torch yet")
    if elbo_estimator == "stl":
        raise NotImplementedError(
            "elbo_estimator='stl' is not ported to spmf_tpu_torch yet")
    if elbo_estimator != "standard":
        raise ValueError(f"unknown elbo_estimator {elbo_estimator!r}")
    if antithetic == "stratified":
        raise NotImplementedError(
            "antithetic='stratified' is not ported to spmf_tpu_torch yet")
    if decay_schedule == "reference":
        # the reference engine's observed plateau decays are ~x0.93
        decay_rate = 0.93
    elif decay_schedule not in (None, "default"):
        raise ValueError(f"unknown decay_schedule {decay_schedule!r}")

    prior_weight = 1.0
    if dataset_size is not None and batch_size is not None:
        prior_weight = float(batch_size) / float(dataset_size)

    if device is None:
        device = _leaves(params)[0].device
    params = {n: {k: t.detach().to(device=device, dtype=dtype).clone()
                  .requires_grad_(True) for k, t in sub.items()}
              for n, sub in params.items()}
    leaves = _leaves(params)
    generator = torch.Generator(device=device).manual_seed(int(seed))

    def _f32(value):
        """The JAX engine injects lr as a float32 hyperparameter; the
        learning rate applied here is rounded the same way."""
        return float(np.float32(value))

    optimizer = make_optimizer(params, _f32(learning_rate))

    def _set_lr(value):
        for group in optimizer.param_groups:
            group["lr"] = _f32(value)

    def _loss(batch):
        return elbo_loss(surrogate, energy_fn, params, batch, generator,
                         sample_size, prior_weight, sample_batches,
                         antithetic)

    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        loss = _loss(batch)
        loss.backward()
        clip_and_step(optimizer, clip_value)
        return loss.detach()

    to_device = lambda b: _device_batch(b, dtype, device)  # noqa: E731

    first_batch = next(iter(batched_data_factory()))
    with torch.no_grad():
        initial_loss = float(_loss(to_device(first_batch)))
    say(f"Initial loss: {initial_loss}")

    losses: List[float] = [initial_loss]
    # epoch averages are the checkpoint unit; the single-batch initial eval
    # is display-only and does not seed best_loss
    best_loss = np.inf
    lr = learning_rate
    stall = 0
    best_params = _detached(params)
    best_opt_state = copy.deepcopy(optimizer.state_dict())
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

    epoch = 0
    while epoch < num_steps:
        epoch += 1
        t_epoch = time.perf_counter()
        batch_losses = [step(to_device(b)) for b in batched_data_factory()]
        if not batch_losses:
            raise ValueError(
                "batched_data_factory() yielded no batches in epoch "
                f"{epoch} — check batch_size/drop_remainder vs dataset size")
        # ONE device fetch for the epoch
        batch_losses = torch.stack(batch_losses).cpu().tolist()
        epoch_seconds.append(time.perf_counter() - t_epoch)
        epoch_loss = float(np.mean(batch_losses))
        finite = bool(np.isfinite(epoch_loss))
        losses.append(epoch_loss)
        say(f"Epoch {epoch}: average-batch loss: {epoch_loss} "
            f"last batch loss: {batch_losses[-1]}")
        plateau = False
        if not finite:
            # divergence: restore best and decay hard
            say(f"Non-finite loss; restoring from a checkpoint - loss: "
                f"{best_loss}")
            lr = _decay_f32(lr, 0.5)
        else:
            if epoch_loss < best_loss:
                best_loss = epoch_loss
                stall = 0
                best_params = _detached(params)
                best_opt_state = copy.deepcopy(optimizer.state_dict())
            else:
                stall += 1
            plateau = stall >= patience
            if plateau:
                lr = _decay_f32(lr, decay_rate)
                say(f"We are in a loss plateau learning rate: {lr} "
                    f"loss: {epoch_loss}")
                say(f"Restoring from a checkpoint - loss: {best_loss}")
                stall = 0
        if not finite or plateau:
            with torch.no_grad():
                for t, b in zip(leaves, _leaves(best_params)):
                    t.copy_(b)
            optimizer.load_state_dict(copy.deepcopy(best_opt_state))
            _set_lr(lr)
            if not finite:
                continue
        if _check_convergence(epoch):
            break

    return FitResult(
        params=best_params,
        losses=losses,
        learning_rate=lr,
        converged=converged,
        extras={"epoch_seconds": epoch_seconds},
    )
