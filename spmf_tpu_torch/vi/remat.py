"""Rematerialised surrogate sampling (the port of spmf_tpu's
``remat_sampling``, spmf_tpu/vi/minibatch.py:471-483, where the draw is
wrapped in ``jax.checkpoint`` and its random stream replays from the key).

The forward draws the samples without keeping their autograd graph; the
backward draws them again, with grad, from the same generator state and
backpropagates through the recomputed graph. ``torch.utils.checkpoint``
cannot do this: its recompute restores the default generators only, not
the engine's own ``torch.Generator``, so it would redraw other samples and
give wrong gradients without an error.

How the backward finds the forward's stream:
- eagerly (the CPU, and the card outside a CUDA graph), the forward records
  the engine generator's state and the backward sets it, redraws and puts
  the generator back;
- inside a captured CUDA graph no host state can be read or set. There the
  backward of draw ``j`` of a step swaps the engine generator's state for a
  replica (``clone_state``) registered with the graph, whose seed and
  offset ``sync`` sets before each replay to the engine's, advanced by the
  offset draw ``j`` starts at within the step (measured in the eager
  warm-up that precedes every capture). So the replica's kernels read the
  seed and offset the forward's read, and the recomputed samples equal the
  forward's bit for bit.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["RematDraw"]


def _capturing(generator):
    return (generator.device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


class _Remat(torch.autograd.Function):
    """(leaves) -> (the draw's values..., log q), recomputed in the
    backward."""

    @staticmethod
    def forward(ctx, remat, region, names, *leaves):
        ctx.set_materialize_grads(False)
        ctx.remat, ctx.region, ctx.names = remat, region, names
        ctx.state = remat._record(region)
        ctx.save_for_backward(*leaves)
        values, logq = remat.draw(remat._tree(names, leaves))
        remat._keys = list(values)
        return (*values.values(), logq)

    @staticmethod
    def backward(ctx, *grads):
        remat = ctx.remat
        leaves = ctx.saved_tensors
        with torch.enable_grad():
            live = [t.detach().requires_grad_(t.requires_grad)
                    for t in leaves]
            with remat._replay(ctx.region, ctx.state):
                values, logq = remat.draw(remat._tree(ctx.names, live))
        pairs = [(o, g) for o, g in zip([*values.values(), logq], grads)
                 if g is not None and o.requires_grad]
        wanted = [t for t in live if t.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else ())
        return (None, None, None) + tuple(
            next(got) if t.requires_grad else None for t in live)


class RematDraw:
    """``draw(params) -> (values, logq)`` run without saving its graph and
    redrawn in the backward. ``generator``: the one ``draw`` takes its
    randomness from. Calling it with grad disabled just draws."""

    def __init__(self, draw, generator):
        self.draw = draw
        self.generator = generator
        self._keys = None
        self._base = None       # the generator offset draw 0 starts at
        self._starts = {}       # draw -> its start past draw 0's
        self._replicas = {}     # draw -> the generator its captured
        #                         backward redraws from

    @staticmethod
    def _tree(names, leaves):
        params = {}
        for (n, k), t in zip(names, leaves):
            params.setdefault(n, {})[k] = t
        return params

    def __call__(self, params, region=0):
        """The draw of sample batch ``region`` of a step."""
        if not torch.is_grad_enabled():
            return self.draw(params)
        names = [(n, k) for n, sub in params.items() for k in sub]
        out = _Remat.apply(self, region, names,
                           *(params[n][k] for n, k in names))
        return dict(zip(self._keys, out[:-1])), out[-1]

    def _record(self, region):
        """The generator state the backward of draw ``region`` replays
        (None under capture, where the replica stands for it)."""
        gen = self.generator
        if _capturing(gen):
            if region not in self._replicas:
                raise RuntimeError(
                    f"remat_sampling: draw {region} of the step was not "
                    "seen before the capture")
            return None
        state = gen.get_state()
        if gen.device.type == "cuda":
            offset = int(state.view(torch.int64)[1])
            if region == 0:
                self._base = offset
            self._starts[region] = offset - self._base
            if region not in self._replicas:
                self._replicas[region] = gen.clone_state()
        return state

    @contextlib.contextmanager
    def _replay(self, region, state):
        gen = self.generator
        if state is None:            # inside a capture
            current = gen.graphsafe_get_state()
            gen.graphsafe_set_state(self._replicas[region])
            try:
                yield
            finally:
                gen.graphsafe_set_state(current)
            return
        current = gen.get_state()
        gen.set_state(state)
        try:
            yield
        finally:
            gen.set_state(current)

    def register(self, graph):
        """Register the replicas with ``graph`` before its capture."""
        for rep in self._replicas.values():
            graph.register_generator_state(rep)

    def sync(self):
        """Before a replay: each replica at the engine generator's seed and
        offset, advanced by its draw's start within the step."""
        state = self.generator.get_state()
        for region, rep in self._replicas.items():
            st = state.clone()
            st.view(torch.int64)[1] += self._starts[region]
            rep.set_state(st)
