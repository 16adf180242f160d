"""The benchmark's plain autoencoder reference
(``h100bench/harness/ae_reference.py``) against the port's
``PoissonAutoencoder`` on the CPU, in float64 at D = 12, K = 3, B = 16,
S = 2: the prior parts, the likelihood ``x`` and the whole energy's
gradient on the same samples, three ``fit()`` steps on the scan path and
the general loop on the same draws, the initial surrogate, and the
reference's E1 against scipy's. The reference is loaded from its file; it
imports nothing of the port."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import ast
import importlib.util
import math
import os
import sys

import numpy as np
import pytest
import torch

from spmf_tpu_torch import PoissonAutoencoder
from spmf_tpu_torch.data import DeviceArrayDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "h100bench")
if BENCH not in sys.path:
    # the reference's own imports (harness.reference) resolve there
    sys.path.append(BENCH)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "h100bench_" + name, os.path.join(BENCH, "harness", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


aeref = _load("ae_reference")
ref_steps = _load("reference").train_steps

D, K, B, S = 12, 3, 16, 2
N = 3 * B
F64 = torch.float64
CPU = torch.device("cpu")


def _counts(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.poisson(rng.gamma(1.0, 1.5, (1, D)), (N, D)).astype(np.float64)
    norms = x.mean(0)
    return x, np.where(norms > 0, norms, 1.0)


def _port(dtype="float64", shuffle=True, seed=0):
    x, norms = _counts(seed)
    ds = DeviceArrayDataset({"data": x}, batch_size=B, shuffle=shuffle,
                            drop_remainder=True, device="cpu")
    m = PoissonAutoencoder(ds, latent_dim=K, column_norms=norms,
                           dtype=dtype, device="cpu")
    return m, ds, torch.as_tensor(x), norms


def _reference(norms, prior_weight=1.0):
    return aeref.Model(D, aeref.layer_sizes(D, K), norms, F64, CPU,
                       prior_weight=prior_weight, model_dtype=F64)


def _samples(m, seed):
    """S draws of the port's surrogate at seeded random parameters (locs
    spread over the prior's scale, so that the horseshoe is read away from
    and near 0), as leaves with grad."""
    g = torch.Generator().manual_seed(seed)
    params = {n: {"loc": 0.5 * torch.randn(sub["loc"].shape, generator=g,
                                           dtype=F64)
                  * aeref.reference.softplus(sub["raw_scale"]) * 10,
                  "raw_scale": sub["raw_scale"]
                  + 0.3 * torch.randn(sub["raw_scale"].shape, generator=g,
                                      dtype=F64)}
              for n, sub in m.surrogate_params.items()}
    values = m._surrogate.sample(params, g, (S,))
    return {n: v.detach().clone().requires_grad_(True)
            for n, v in values.items()}


# both sides sum float64 terms over at most a few hundred elements; the
# port's E1 comes from spmf_tpu's rationals (relative error 3.3e-14), the
# reference's from its series and continued fraction (2.4e-14): the parts
# agree to about 1e-13 of their size
PARTS_RTOL = 1e-12


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("prior_weight", [1.0, 0.25])
def test_prior_parts(seed, prior_weight):
    m, _, x, norms = _port()
    t = _samples(m, seed)
    parts = m.unormalized_log_prob_parts({"data": x[:B]},
                                         prior_weight=prior_weight, **t)
    prior = sum(v for k, v in parts.items() if k != "x")
    want = prior_weight * _reference(norms).prior(t)
    torch.testing.assert_close(prior, want, rtol=PARTS_RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_likelihood_x(seed):
    m, _, x, norms = _port()
    t = _samples(m, seed)
    got = m.unormalized_log_prob_parts({"data": x[:B]}, **t)["x"]
    want = _reference(norms).likelihood(t, x[:B])
    torch.testing.assert_close(got, want, rtol=PARTS_RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_energy_gradient_on_the_same_samples(seed):
    """d(energy)/d(sample) for every weight and bias: E1's derivative is
    -1/g(z) in the port (the rational, 3.3e-14) and -1/(z e^z E1(z)) here;
    summed through the network's products in float64, each leaf's gradient
    agrees to 1e-10 of its norm."""
    m, _, x, norms = _port()
    t = _samples(m, seed)
    names = list(t)
    got = torch.autograd.grad(
        m.unormalized_log_prob({"data": x[:B]}, prior_weight=0.5, **t).sum(),
        [t[n] for n in names])
    want = torch.autograd.grad(
        _reference(norms, 0.5).energy(t, x[:B]).sum(), [t[n] for n in names])
    for n, a, b in zip(names, got, want):
        assert float((a - b).norm()) <= 1e-10 * float(b.norm()), n


def _fit_result(m, ds, **kw):
    m.fit(batched_data_factory=ds, num_steps=1, learning_rate=0.01,
          clip_value=10.0, sample_size=S, rel_tol=None, abs_tol=None,
          seed=20241018, verbose=False, **kw)
    r = m.last_fit
    names = [(n, k) for n in r.params for k in r.params[n]]
    state = r.opt_state["state"]
    return (r.losses, {nk: r.params[nk[0]][nk[1]] for nk in names},
            {nk: state[i]["exp_avg"] for i, nk in enumerate(names)})


def _in_order_steps(model, init, x, seed, steps, lr, clip):
    """``reference.train_steps`` for the general loop over an unshuffled
    dataset: the batches in order, and no permutation drawn."""
    gen = torch.Generator().manual_seed(seed)
    p = model.params(init)
    leaves = [(n, k) for n in p for k in p[n]]
    with torch.no_grad():
        initial = float(model.loss(p, x[:B], gen, S))
    m = {nk: torch.zeros_like(p[nk[0]][nk[1]]) for nk in leaves}
    v = {nk: torch.zeros_like(p[nk[0]][nk[1]]) for nk in leaves}
    losses = []
    for step in range(1, steps + 1):
        loss = model.loss(p, x[(step - 1) * B:step * B], gen, S)
        grads = torch.autograd.grad(loss, [p[n][k] for n, k in leaves])
        losses.append(float(loss.detach()))
        bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
        with torch.no_grad():
            for (n, k), g in zip(leaves, grads):
                g = g.clamp(-clip, clip)
                m[n, k] = 0.9 * m[n, k] + 0.1 * g
                v[n, k] = 0.999 * v[n, k] + 0.001 * g * g
                p[n][k] -= (lr / bc1) * m[n, k] / (
                    torch.sqrt(v[n, k]) / math.sqrt(bc2) + 1e-8)
    return {"initial": initial, "losses": losses,
            "params": {nk: p[nk[0]][nk[1]].detach() for nk in leaves},
            "exp_avg": m}


# float64 end to end; after the first Adam step a sampled weight may lie
# close to the horseshoe's log pole at 0, where the energy's gradient goes
# as 1/w and the ulp of w's loc (1e-18 here) becomes a relative error of
# ulp / |w|: 1e-9 of each leaf's norm leaves room for w down to 1e-9
STEP_RTOL = 1e-9


def _close(got, want):
    for nk, b in want.items():
        a = got[nk]
        assert float((a - b).norm()) <= STEP_RTOL * max(float(b.norm()),
                                                        1e-12), nk


@pytest.mark.parametrize("path", ["scan", "general loop"])
def test_three_fit_steps(path):
    """One epoch of three batches through ``fit()``, the engine's prior
    weight B / N included, against the reference's three steps on the same
    draws (and, on the scan path, the same permutation)."""
    scan = path == "scan"
    m, ds, x, norms = _port(shuffle=scan)
    init = {n: {k: t.detach().numpy().copy() for k, t in sub.items()}
            for n, sub in m.surrogate_params.items()}
    losses, params, exp_avg = _fit_result(
        m, ds, dataset_size=N, batch_size=B,
        **({} if scan else {"epoch_scan": False}))
    assert m.last_fit.extras["epoch_scan"] is scan
    model = _reference(norms, prior_weight=B / N)
    if scan:
        ref = ref_steps(model, init, lambda idx: x[idx], N, B, S, 3,
                        20241018, float(np.float32(0.01)), 10.0, CPU)
    else:
        ref = _in_order_steps(model, init, x, 20241018, 3,
                              float(np.float32(0.01)), 10.0)
    assert losses[0] == pytest.approx(ref["initial"], rel=1e-12)
    assert losses[1] == pytest.approx(np.mean(ref["losses"]), rel=1e-12)
    _close(params, ref["params"])
    _close(exp_avg, ref["exp_avg"])


def test_initial_surrogate_is_the_float32_models():
    m, _, _, _ = _port(dtype="float32")
    want = aeref.init_params(D, aeref.layer_sizes(D, K))
    assert list(m.surrogate_params) == list(want)
    for n, sub in want.items():
        assert list(m.surrogate_params[n]) == list(sub)
        for k, a in sub.items():
            got = m.surrogate_params[n][k].numpy()
            assert got.dtype == a.dtype and np.array_equal(got, a), (n, k)


def test_e1_against_scipy():
    """log E1 and its derivative over z from 1e-30 to 1e6, both sides of
    the series' cut at 2, against scipy's E1 (float64)."""
    special = pytest.importorskip("scipy.special")
    z = np.concatenate([np.logspace(-30, 6, 400), [1.999999, 2.0, 2.000001]])
    zt = torch.tensor(z, dtype=F64, requires_grad=True)
    got = aeref.log_e1(zt)
    (grad,) = torch.autograd.grad(got.sum(), zt)
    e1 = special.exp1(z)
    finite = e1 > 0
    # where E1 underflows (z > 700), its asymptotic series: log E1(z) =
    # -z - log z + log(1 - 1/z + 2/z^2 - 6/z^3 + 24/z^4), 120/z^5 off
    u = 1.0 / z
    want = np.where(finite, np.log(np.where(finite, e1, 1.0)),
                    -z - np.log(z) + np.log1p(u * (-1 + u * (2 + u * (
                        -6 + 24 * u)))))
    tol = 2e-13 * np.maximum(np.abs(want), 1.0)
    assert np.all(np.abs(got.detach().numpy() - want) <= tol)
    dwant = -np.exp(-z[finite]) / (z[finite] * e1[finite])
    np.testing.assert_allclose(grad.numpy()[finite], dwant, rtol=2e-13)


@pytest.mark.parametrize("name", ["ae_reference", "ae_counts", "ae_spans"])
def test_the_reference_imports_nothing_of_the_program(name):
    with open(os.path.join(BENCH, "harness", name + ".py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    tops = {m.split(".", 1)[0] for m in mods}
    assert not tops & {"spmf_tpu_torch", "spmf_tpu", "jax", "jaxlib"}
