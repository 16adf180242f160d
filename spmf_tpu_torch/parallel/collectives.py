"""The collectives of hand-written SPMD training over ``torch.distributed``.

Each rank runs its own program on its own shard, and every cross-rank
dependency is one of these calls. They are built from ``all_reduce`` (SUM,
MIN) and ``broadcast`` alone, the two collectives the ``gloo`` backend runs
on CUDA tensors, so two ranks sharing one card (gloo) and one rank per card
(NCCL) take the same code.

- ``all_reduce_sum``: a differentiable SUM. Its backward is a SUM of the
  cotangents over the same group, so that with every rank backpropagating
  its share L / n of the one global loss L, each partial receives the
  cotangent of the sum.
- ``all_reduce_min``: a differentiable MIN (the plain path's clip bound,
  whose gradient reaches the cell that holds the minimum).
- ``all_min_`` / ``all_sum_``: in place and without gradient (the fused
  kernels' clip statistics, row sums of the data).
- ``broadcast_``: from a group's first rank.
- ``gather_full`` / ``gather_cols``: a shard placed at its offset in a
  zero buffer and summed (gloo has no ``all_gather`` on CUDA tensors);
  ``gather_cols`` is differentiable, its backward the SUM of the full
  cotangent and the local slice of it (a reduce-scatter).
- ``reduce_gradients``: one flat bucket and one ``all_reduce`` per group.

``STATS`` counts the gradient reductions (calls, bytes, seconds; with
``TIME_GRADIENTS`` each is bracketed by device synchronisations so that
its seconds are its own).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["STATS", "all_reduce_sum", "all_reduce_min", "all_min_", "all_sum_", "broadcast_",
           "gather_full", "gather_cols", "reduce_gradients", "reset_stats"]

#: the gradient reductions of this process: calls, bytes reduced, seconds
STATS = {"grad_calls": 0, "grad_bytes": 0, "grad_seconds": 0.0}
#: synchronise the device around each gradient reduction (its seconds then
#: hold the reduction alone; off by default)
TIME_GRADIENTS = False


def reset_stats():
    for k in STATS:
        STATS[k] = 0 if isinstance(STATS[k], int) else 0.0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x, group):
    """The SUM of ``x`` over ``group``, on every rank of it; differentiable
    (the backward sums the cotangents over the group)."""
    return _AllReduceSum.apply(x, group)


class _AllReduceMin(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
        # the ranks that hold the minimum share its cotangent
        owner = (x.detach() == out).to(x.dtype)
        holders = owner.clone()
        dist.all_reduce(holders, op=dist.ReduceOp.SUM, group=group)
        ctx.group = group
        ctx.save_for_backward(owner / holders)
        return out

    @staticmethod
    def backward(ctx, g):
        share, = ctx.saved_tensors
        g = g.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g * share, None


def all_reduce_min(x, group):
    """The MIN of ``x`` over ``group``, on every rank of it; differentiable:
    the summed cotangent goes to the ranks that hold the minimum, in equal
    shares."""
    return _AllReduceMin.apply(x, group)


@torch.no_grad()
def all_min_(x, group):
    """``x`` replaced in place by its MIN over ``group`` (no gradient)."""
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


@torch.no_grad()
def all_sum_(x, group):
    """``x`` replaced in place by its SUM over ``group`` (no gradient)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@torch.no_grad()
def broadcast_(x, group, src):
    """``x`` replaced in place by the value on global rank ``src``."""
    dist.broadcast(x, src=src, group=group)
    return x


def _placed(local, dim, full, index):
    """``local`` at block ``index`` of a zero tensor ``full`` wide along
    ``dim``."""
    shape = list(local.shape)
    shape[dim] = full
    buf = local.new_zeros(shape)
    buf.narrow(dim, index * local.shape[dim], local.shape[dim]).copy_(local)
    return buf


@torch.no_grad()
def gather_full(local, dim, parts, index, group):
    """The concatenation along ``dim`` of the ``parts`` equal blocks that
    the ranks of ``group`` hold (this rank's is block ``index``), on every
    rank: each block placed in a zero buffer, then one SUM (exact: each
    element is one block's value plus zeros). No gradient."""
    buf = _placed(local.detach(), dim, local.shape[dim] * parts, index)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, parts, index, group):
        ctx.args = (dim, local.shape[dim], index, group)
        return gather_full(local, dim, parts, index, group)

    @staticmethod
    def backward(ctx, g):
        dim, width, index, group = ctx.args
        g = g.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return (g.narrow(dim, index * width, width).contiguous(), None, None,
                None, None)


def gather_cols(local, dim, parts, index, group):
    """``gather_full`` with a gradient: the backward sums the full
    cotangent over the group and keeps this rank's block (a
    reduce-scatter built from ``all_reduce``)."""
    return _GatherCols.apply(local, dim, parts, index, group)


@torch.no_grad()
def reduce_gradients(buckets):
    """SUM every tensor's ``.grad`` over its group: ``buckets`` is a list of
    (group, [tensors]); each bucket is one flat buffer and one
    ``all_reduce``. A tensor with no gradient contributes zeros (and gets
    the sum), so every rank reduces buffers of the same layout."""
    for group, tensors in buckets:
        if not tensors:
            continue
        grads = [t.grad if t.grad is not None else torch.zeros_like(t)
                 for t in tensors]
        if TIME_GRADIENTS and grads[0].is_cuda:
            torch.cuda.synchronize(grads[0].device)
        t0 = time.perf_counter()
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        for t, piece in zip(tensors, flat.split([g.numel() for g in grads])):
            if t.grad is None:
                t.grad = piece.view(t.shape).clone()
            else:
                t.grad.copy_(piece.view(t.shape))
        if TIME_GRADIENTS and flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        STATS["grad_calls"] += 1
        STATS["grad_bytes"] += flat.numel() * flat.element_size()
        STATS["grad_seconds"] += time.perf_counter() - t0
