"""The hand-written CUDA kernels against their plain PyTorch twins on the
card, at small and ragged shapes (B and D not multiples of any tile). These
need a CUDA device and skip without one; run them on the card with
``python -m pytest tests/test_torch_gpu.py -q``.

Tolerances: the kernels compute in float32 and the twins run in float64 on
the same inputs. Sums 1e-5 relative (f32 cells, f64 block sums); counts
exact; the finite minimum 1e-6 relative; gradients 1e-4 of their largest
entry (f32 atomics in run order); sampler outputs 1e-5 relative (the same
Philox bits, f32 vs f64 transcendentals).
"""
import numpy as np
import pytest
import torch

from spmf_tpu_torch.ops import fused_ig as tig
from spmf_tpu_torch.ops import fused_poisson as tfp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _stats_inputs(S, B, K, D, dev, seed=0, rescue=False):
    g = torch.Generator(device="cpu").manual_seed(seed)
    theta = torch.rand(S, B, K, generator=g) * 0.5
    v = torch.rand(S, K, D, generator=g) * 0.2
    phi = torch.rand(S, 1, D, generator=g) * 0.5 + 0.05
    x = torch.poisson(torch.ones(B, D), generator=g)
    eta = torch.rand(1, D, generator=g) * 1.5 + 0.5
    if rescue:
        phi[:, :, ::37] = -5.0
    return [t.to(dev) for t in (theta, v, phi, x, eta)]


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape", [(3, 200, 8, 1000), (2, 37, 5, 130)])
def test_stats_kernel_matches_twin(cuda, shape, static, log_transform):
    args = _stats_inputs(*shape, cuda)
    out_k = tfp._kernel_stats(*args, log_transform, static)
    out_t = tfp.stats_twin(*[a.double() for a in args],
                           log_transform=log_transform, static=static)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
    np.testing.assert_allclose(out_k[2].cpu().numpy(), out_t[2].cpu().numpy(),
                               rtol=1e-6)
    for k, t in zip(out_k[3:], out_t[3:]):
        assert _rel_max(k, t) < 1e-4


def test_stats_kernel_rescue_batch(cuda):
    args = _stats_inputs(2, 150, 6, 400, cuda, seed=1, rescue=True)
    out_k = tfp._kernel_stats(*args, False, False)
    out_t = tfp.stats_twin(*[a.double() for a in args])
    assert int(out_t[1].sum()) > 0
    assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)


def test_fused_loglik_backward_runs_the_kernel(cuda):
    args = _stats_inputs(2, 70, 4, 300, cuda)
    for a in args[:3]:
        a.requires_grad_(True)
    before = tfp.LAUNCHES["stats"]
    out = tfp.fused_poisson_loglik(*args)
    out.sum().backward()
    assert tfp.LAUNCHES["stats"] == before + 1
    ref = [a.detach().double().requires_grad_(True) for a in args[:3]]
    tfp.poisson_loglik_reference(*ref, args[3].double(),
                                 args[4].double()).sum().backward()
    for a, r in zip(args[:3], ref):
        assert _rel_max(a.grad, r.grad) < 1e-4


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("total", [1000, 70001])
def test_ig_kernels_match_twin(cuda, total, antithetic):
    S = 4
    g = torch.Generator(device="cpu").manual_seed(2)
    a = (torch.rand(total, generator=g) * 5 + 0.3).to(cuda)
    b = (torch.rand(total, generator=g) * 3 + 0.1).to(cuda)
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda)
    y_k, lq_k = tig._kernel_fwd(a, b, seed, S, antithetic)
    y_t, lq_t = tig.ig_twin_fwd(a.double(), b.double(), seed, S, antithetic)
    np.testing.assert_allclose(y_k.cpu().numpy(), y_t.cpu().numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(lq_k.cpu().numpy(), lq_t.cpu().numpy(),
                               rtol=1e-5)
    gy = torch.randn(S, total, generator=g).to(cuda)
    glq = torch.randn(S, generator=g).to(cuda)
    ga_k, gb_k = tig._kernel_bwd(a, b, seed, S, antithetic, gy, glq)
    ga_t, gb_t = tig.ig_twin_bwd(a.double(), b.double(), seed, S, antithetic,
                                 gy.double(), glq.double())
    assert _rel_max(ga_k, ga_t) < 1e-4
    assert _rel_max(gb_k, gb_t) < 1e-4


def test_cuda_tensors_never_fall_back(cuda):
    a = torch.ones(10, device=cuda, dtype=torch.float64)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tig.fused_ig_sample_logq(a, a, seed, 2)
    args = _stats_inputs(1, 8, 2, 16, cuda)
    with pytest.raises(ValueError):
        tfp._kernel_stats(*[t.double() for t in args], False, False)
