"""The slice as a whole: one full ADVI training step — sample, energy,
gradient, elementwise clip, Adam — in both packages from the same
parameters and the same base draws (JAX's, reproduced from its key and
injected into the port). The JAX side is bench.build_step with
optax.chain(optax.clip(5.0), optax.adam(lr))."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
from spmf_tpu_torch.vi.minibatch import clip_and_step, elbo_loss, make_optimizer

from torch_ref import B, S, jax_draws, model_pair, perturbed_params, to_np, torch_params

LR = 2.0 ** -7  # exact in float32 and float64


def _jax_step(jm, params, batch, key, rtol):
    surrogate = jm._surrogate

    def loss_fn(p):
        samples, logq = surrogate.sample_and_log_prob(p, key, (S,))
        lp = jm.unormalized_log_prob(data=batch, **samples)
        return -jnp.mean(lp - logq) / B

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    optimizer = optax.chain(optax.clip(5.0), optax.adam(LR))
    step = jax.jit(bench.build_step(jm, optimizer, B, sample_size=S))
    new_params, _, loss2 = step(params, optimizer.init(params), key, batch)
    np.testing.assert_allclose(float(loss2), float(loss), rtol=rtol)
    return float(loss), to_np(grads), to_np(new_params)


def _torch_step(tm, params_np, batch, draws, dtype):
    params = torch_params(params_np, dtype)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_(True)
    opt = make_optimizer(params, LR)
    loss = elbo_loss(tm._surrogate, tm._energy, params, batch, None, S,
                     draws=draws)
    loss.backward()
    grads = {n: {k: t.grad.numpy().copy() for k, t in sub.items()}
             for n, sub in params.items()}
    clip_and_step(opt, 5.0)
    return float(loss.detach()), grads, to_np(params)


def _assert_tree_close(t, j, rtol):
    for n in j:
        for k in j[n]:
            ref = np.asarray(j[n][k])
            np.testing.assert_allclose(t[n][k], ref, rtol=rtol,
                                       atol=rtol * np.abs(ref).max(),
                                       err_msg=f"{n}.{k}")


@pytest.mark.parametrize("dtype,rtol,fused", [
    ("float64", 1e-9, False),
    ("float32", 1e-4, True),
])
def test_one_training_step_matches_jax(dtype, rtol, fused):
    jm, tm, X = model_pair(dtype, gamma_sampler="fast",
                           fused_likelihood=fused)
    if fused:
        jm._fused_interpret = True
    tdtype = torch.float64 if dtype == "float64" else torch.float32
    p_np = perturbed_params(jm, scale=0.1)
    params = jax.tree_util.tree_map(jnp.asarray, p_np)
    x = X[:B].astype(dtype)
    key = jax.random.PRNGKey(7)
    loss_j, grads_j, new_j = _jax_step(
        jm, params, {"counts": jnp.asarray(x), "indices": jnp.arange(B)}, key,
        rtol)
    draws = jax_draws(jm, key, S)
    loss_t, grads_t, new_t = _torch_step(
        tm, p_np, {"counts": torch.tensor(x), "indices": torch.arange(B)},
        draws, tdtype)
    assert tm.fusion_active == fused
    np.testing.assert_allclose(loss_t, loss_j, rtol=rtol)
    _assert_tree_close(grads_t, grads_j, rtol)
    _assert_tree_close(new_t, new_j, rtol)
