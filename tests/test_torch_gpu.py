"""The hand-written CUDA kernels against their plain PyTorch twins on the
card, at small and ragged shapes (B and D not multiples of any tile). These
need a CUDA device and skip without one; run them on the card with
``python -m pytest tests/test_torch_gpu.py -q``.

Tolerances: the kernels compute in float32 and the twins run in float64 on
the same inputs. Sums 1e-5 relative (f32 cells, f64 block sums) — the K1
sums, the K4 row sums and the K5 exp-rate totals; counts exact; the finite
minimum 1e-6 relative; gradients 1e-4 of their largest entry (f32 atomics
in run order); sampler outputs 1e-5 relative (the same Philox bits, f32 vs
f64 transcendentals; the Normal sampler's y and gradients 1e-5 and 1e-4 of
their largest entry, since y = loc + scale * eps may cancel to near zero, and
its log q sums 1e-6). K4's NaN rows (negative rates) match position for
position. The new likelihoods of K1/K2 and K4 are held to the Poisson
tolerances.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

from spmf_tpu_torch.ops import fused_ig as tig
from spmf_tpu_torch.ops import fused_normal as tfn
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


#: (S, B, K, D): B and D no multiples of the kernels' 128 x 64 tiles, K = 5 and
#: 33 no multiples of their k-step, K = 20 five k-groups (no power of two), D =
#: 130 and 257 rows of x that do not start on 16 bytes, and the least shape
SHAPES = [(3, 200, 8, 1000), (2, 37, 5, 130), (2, 300, 20, 1000),
          (3, 129, 33, 257), (1, 1, 1, 1)]


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
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


IG_MODES = [False, True, "stratified"]


#: (mode, S): S = 6 gives 3 pairs (no power of two), S = 5 an odd count
IG_CASES = [(m, n) for m in IG_MODES for n in (2, 6, 8)] + [(False, 5)]


@pytest.mark.parametrize("antithetic,S", IG_CASES)
@pytest.mark.parametrize("total", [1000, 70001])
def test_ig_kernels_match_twin(cuda, total, antithetic, S):
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


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_row_ll_kernel_matches_twin(cuda, shape, log_transform):
    args = _stats_inputs(*shape, cuda, seed=3)
    out_k = tfp._kernel_row_ll(*args, log_transform)
    out_t = tfp.row_loglik_twin(*[a.double() for a in args],
                                log_transform=log_transform)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k.cpu().numpy(), out_t.cpu().numpy(),
                               rtol=1e-5)


def test_row_ll_kernel_is_deterministic(cuda):
    """Each row sum is one plain store of a fixed-order sum: two launches
    give the same bits (K1's atomics do not)."""
    args = _stats_inputs(4, 300, 20, 3000, cuda, seed=8)
    for log_transform in (False, True):
        first = tfp._kernel_row_ll(*args, log_transform)
        second = tfp._kernel_row_ll(*args, log_transform)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


#: latent dimensions past the whole-K tiles of one kernel or another: K5's
#: instances end at 64, K1/K2's tiles at 124, K4's at 152
WIDE_K = (65, 128, 256)


@pytest.mark.parametrize("kind", ["stats", "row_ll", "expsum"])
def test_launch_geometry_matches_the_library(cuda, kind):
    """The wrapper's shared-memory arithmetic is the built library's, and
    the occupancy API grants the two blocks an SM the tiling was chosen
    for, at the registers the build log reports; the wide kernels too."""
    for latent in (1, 5, 16, 20, 32, 33, 64) + WIDE_K:
        geom = tfp.launch_geometry(kind, 8, 4096, latent, 20000)
        if kind == "expsum":
            lib = tfp._expsum_lib().expsum_smem_bytes(latent)
        else:
            lib = tfp._lib().poisson_smem_bytes(int(kind == "row_ll"), latent)
        assert geom.smem_bytes == lib
    info = tfp.kernel_info(kind, 32)
    geom = tfp.launch_geometry(kind, 8, 4096, 32, 20000)
    assert info["smem_bytes"] == geom.smem_bytes
    assert info["static_smem_bytes"] <= geom.static_smem_bytes
    assert info["blocks_per_sm"] == geom.blocks_per_sm == 2
    assert info["registers"] <= 128
    if kind == "expsum":   # past K = 32 its registers allow one block
        info = tfp.kernel_info(kind, 64)
        assert info["blocks_per_sm"] == tfp.launch_geometry(
            kind, 8, 4096, 64, 20000).blocks_per_sm == 1
    wide = 256 if kind == "row_ll" else 128
    info = tfp.kernel_info(kind, wide)
    geom = tfp.launch_geometry(kind, 8, 4096, wide, 20000)
    assert geom.chunks > 1 and info["smem_bytes"] == geom.smem_bytes
    assert info["static_smem_bytes"] <= geom.static_smem_bytes
    # the wide K4 keeps two blocks an SM under 128 registers; the split-TF32
    # wide K1/K2 and K5 take one block an SM and up to 255 registers
    per_sm, regs = (2, 128) if kind == "row_ll" else (1, 255)
    assert info["blocks_per_sm"] == geom.blocks_per_sm == per_sm
    assert info["registers"] <= regs


def _wide_inputs(K, dev, seed):
    """_stats_inputs at S=2, B=300, D=997 (no tile multiples, D odd), v
    scaled by sqrt(8 / K) so that theta . v keeps its spread at K = 8."""
    args = _stats_inputs(2, 300, K, 997, dev, seed=seed)
    args[1] *= min(1.0, (8.0 / K) ** 0.5)
    return args


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("K", WIDE_K)
def test_kernels_match_twin_at_wide_latent_dims(cuda, K, log_transform):
    """K1, K2 and K4 past their whole-K tiles (the K-chunked kernels of
    csrc/fused_poisson_wide.cu where launch_geometry says so) against the
    float64 twin at the tolerances above; the wrapper launches, nothing
    falls back."""
    args = _wide_inputs(K, cuda, seed=K)
    args64 = [a.double() for a in args]
    wide = tfp.launch_geometry("stats", 2, 300, K, 997).chunks > 1
    for static in (False, True):
        key = ("static" if static else "stats") + ("_wide" if wide else "")
        before = tfp.LAUNCHES[key]
        out_k = tfp._kernel_stats(*args, log_transform, static)
        out_t = tfp.stats_twin(*args64, log_transform=log_transform,
                               static=static)
        torch.cuda.synchronize()
        assert tfp.LAUNCHES[key] == before + 1
        np.testing.assert_allclose(out_k[0].cpu().numpy(),
                                   out_t[0].cpu().numpy(), rtol=1e-5)
        assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
        np.testing.assert_allclose(out_k[2].cpu().numpy(),
                                   out_t[2].cpu().numpy(), rtol=1e-6)
        for k, t in zip(out_k[3:], out_t[3:]):
            assert _rel_max(k, t) < 1e-4
    out_k = tfp._kernel_row_ll(*args, log_transform)
    out_t = tfp.row_loglik_twin(*args64, log_transform=log_transform)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k.cpu().numpy(), out_t.cpu().numpy(),
                               rtol=1e-5)


def test_row_ll_kernel_rescue_rows_are_nan(cuda):
    args = _stats_inputs(2, 150, 6, 400, cuda, seed=4)
    args[2][1, :, 5] = -1e-3     # sample 1, column 5: a negative intercept
    args[0][1, [3, 70, 149]] = 0.0  # ...which is the rate of these rows
    out_k = tfp._kernel_row_ll(*args, False).cpu().numpy()
    out_t = tfp.row_loglik_twin(*[a.double() for a in args]).cpu().numpy()
    nan_t = np.isnan(out_t)
    assert nan_t.sum() == 3 and nan_t[1, [3, 70, 149]].all()
    np.testing.assert_array_equal(np.isnan(out_k), nan_t)
    np.testing.assert_allclose(out_k[~nan_t], out_t[~nan_t], rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_expsum_kernel_matches_twin(cuda, shape):
    theta, v, _, _, eta = _stats_inputs(*shape, cuda, seed=5)
    out_k = tfp._kernel_expsum(theta, v, eta)
    out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    for k, t in zip(out_k[1:], out_t[1:]):
        assert _rel_max(k, t) < 1e-4


#: K5 at full width, ragged: B = 1000 no multiple of the row tile, D =
#: 19,997 odd (the 4-byte loads and the scalar dv atomics), K = 20 (three
#: k-steps, half an m16 tile of dv) and K = 32; one sample and eight
EXPSUM_RAGGED = [(S, 1000, K, 19997) for S in (1, 8) for K in (20, 32)]


@pytest.mark.parametrize("shape", EXPSUM_RAGGED)
def test_expsum_kernel_matches_twin_ragged_full_width(cuda, shape):
    """The C-to-A fragment permutation of the dtheta product and the edges
    of every tile, at the tolerances above."""
    theta, v, _, _, eta = _stats_inputs(*shape, cuda, seed=9)
    v *= 0.25      # chip_smoke.py's loadings: T up to about 0.5
    out_k = tfp._kernel_expsum(theta, v, eta)
    out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    for k, t in zip(out_k[1:], out_t[1:]):
        assert _rel_max(k, t) < 1e-4


def test_expsum_rate_total_is_deterministic(cuda):
    """R is a fixed-order sum (each block's partial in one plain store), and
    dtheta has one owner per element: two launches give the same bits (dv's
    atomics need not)."""
    theta, v, _, _, eta = _stats_inputs(8, 1000, 32, 19997, cuda, seed=10)
    first = tfp._kernel_expsum(theta, v, eta)
    second = tfp._kernel_expsum(theta, v, eta)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.parametrize("K", (64,) + WIDE_K)
def test_expsum_kernel_matches_twin_past_its_instances(cuda, K):
    """K5 at its last instance (K = 64) and past it (the K-chunked wide
    kernel), ragged, against the float64 twin: R 1e-5 relative, gradients
    1e-4 of their largest entry; dtheta has one owner per element, so two
    launches give the same bits."""
    theta, v, _, _, eta = _wide_inputs(K, cuda, seed=K + 1)
    out_k = tfp._kernel_expsum(theta, v, eta)
    again = tfp._kernel_expsum(theta, v, eta)
    out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    torch.cuda.synchronize()
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    for k, t in zip(out_k[1:], out_t[1:]):
        assert _rel_max(k, t) < 1e-4
    assert torch.equal(out_k[0], again[0]) and torch.equal(out_k[1], again[1])


def test_exp_rate_sum_backward_runs_the_kernel(cuda):
    theta, v, _, _, eta = _stats_inputs(2, 70, 4, 300, cuda, seed=6)
    theta.requires_grad_(True)
    v.requires_grad_(True)
    before = tfp.LAUNCHES["expsum"]
    g = torch.tensor([0.5, -2.0], device=cuda)
    (tfp.fused_exp_rate_sum(theta, v, eta) * g).sum().backward()
    assert tfp.LAUNCHES["expsum"] == before + 1
    ref = [a.detach().double().requires_grad_(True) for a in (theta, v)]
    (torch.exp(ref[0] @ ref[1] * eta.double()).sum((-1, -2))
     * g.double()).sum().backward()
    for a, r in zip((theta, v), ref):
        assert _rel_max(a.grad, r.grad) < 1e-4


def _bits_checksum(t):
    """Sum of the float32 bit patterns, as an exact integer."""
    return int(t.contiguous().view(torch.int32).to(torch.int64).sum())


#: _bits_checksum of K3f's y, per antithetic mode, for the inputs below; taken
#: on an NVIDIA H100 80GB HBM3 with nvcc 12.9 before and after the Philox
#: helpers moved into csrc/philox.cuh (equal). Another toolkit's erfinvf /
#: logf may round otherwise: then compare against a build of the commit
#: before, not against these.
K3_Y_CHECKSUMS = {False: 17555290085716, True: 17553513816291}


@pytest.mark.parametrize("antithetic", [False, True])
def test_ig_kernel_bits_are_pinned(cuda, antithetic):
    total, S = 4099, 4
    a = torch.linspace(0.3, 6.0, total, device=cuda)
    b = torch.linspace(3.0, 0.1, total, device=cuda)
    seed = torch.tensor([20240607], dtype=torch.int32, device=cuda)
    y, lq = tig._kernel_fwd(a, b, seed, S, antithetic)
    assert _bits_checksum(y) == K3_Y_CHECKSUMS[antithetic]
    # the uniforms behind them are the twin's, bit for bit: Philox and the
    # half-ulp grid have no rounding to differ in
    y_t, _ = tig.ig_twin_fwd(a.double(), b.double(), seed, S, antithetic)
    np.testing.assert_allclose(y.cpu().numpy(), y_t.cpu().numpy(), rtol=1e-5)


#: _bits_checksum of stratified K3f's y for the inputs of the pin above,
#: taken on an NVIDIA H100 80GB HBM3 with nvcc 12.9 when the mode landed
K3_Y_CHECKSUM_STRATIFIED = 17552979237665


def test_ig_kernel_stratified_bits_are_pinned(cuda):
    total, S = 4099, 4
    a = torch.linspace(0.3, 6.0, total, device=cuda)
    b = torch.linspace(3.0, 0.1, total, device=cuda)
    seed = torch.tensor([20240607], dtype=torch.int32, device=cuda)
    y, _ = tig._kernel_fwd(a, b, seed, S, "stratified")
    assert _bits_checksum(y) == K3_Y_CHECKSUM_STRATIFIED
    y_t, _ = tig.ig_twin_fwd(a.double(), b.double(), seed, S, "stratified")
    np.testing.assert_allclose(y.cpu().numpy(), y_t.cpu().numpy(), rtol=1e-5)


@pytest.mark.parametrize("antithetic", IG_MODES)
def test_ig_kernels_are_deterministic_and_launch_once(cuda, antithetic):
    """K3f's log q partials are summed in a fixed order (two launches, the
    same bits); through the autograd Function a step launches K3f and K3b
    once each; the build reports no spill and the occupancy API at least
    two blocks an SM for every instance."""
    S, total = 8, 50001
    g = torch.Generator(device="cpu").manual_seed(9)
    a = (torch.rand(total, generator=g) * 5 + 0.3).to(cuda)
    b = (torch.rand(total, generator=g) * 3 + 0.1).to(cuda)
    seed = torch.tensor([31337], dtype=torch.int32, device=cuda)
    first = tig._kernel_fwd(a, b, seed, S, antithetic)
    second = tig._kernel_fwd(a, b, seed, S, antithetic)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    a.requires_grad_(True)
    before = dict(tig.LAUNCHES)
    y, lq = tig.fused_ig_sample_logq(a, b, seed, S, antithetic)
    (y.sum() + lq.sum()).backward()
    assert tig.LAUNCHES == {"fwd": before["fwd"] + 1,
                            "bwd": before["bwd"] + 1}
    for kind in ("fwd", "bwd"):
        info = tig.kernel_info(kind, antithetic, S)
        assert info["blocks_per_sm"] >= 2 and info["registers"] <= 128


def _normal_inputs(total, dev, kind, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    loc = torch.randn(total, generator=g) * 2.0
    rs = torch.randn(total, generator=g) * 1.5 - 2.0
    mask = {"softplus": torch.ones(total),
            "both": (torch.rand(total, generator=g) < 0.5).float()}[kind]
    return loc.to(dev), rs.to(dev), mask.to(dev)


@pytest.mark.parametrize("S", [4, 1, 7, 8])
@pytest.mark.parametrize("kind", ["softplus", "both"])
@pytest.mark.parametrize("total", [1000, 70001])
def test_normal_kernels_match_twin(cuda, total, kind, S):
    loc, rs, mask = _normal_inputs(total, cuda, kind)
    seed = torch.tensor([4242], dtype=torch.int32, device=cuda)
    y_k, lq_k = tfn._kernel_fwd(loc, rs, mask, seed, S)
    y_t, lq_t = tfn.normal_twin_fwd(loc.double(), rs.double(), mask.double(),
                                    seed, S)
    torch.cuda.synchronize()
    assert _rel_max(y_k, y_t) < 1e-5
    np.testing.assert_allclose(lq_k.cpu().numpy(), lq_t.cpu().numpy(),
                               rtol=1e-6)
    g = torch.Generator(device="cpu").manual_seed(1)
    gy = torch.randn(S, total, generator=g).to(cuda)
    glq = torch.randn(S, generator=g).to(cuda)
    gl_k, gr_k = tfn._kernel_bwd(loc, rs, mask, seed, S, gy, glq)
    gl_t, gr_t = tfn.normal_twin_bwd(loc.double(), rs.double(), mask.double(),
                                     seed, S, gy.double(), glq.double())
    assert _rel_max(gl_k, gl_t) < 1e-4
    assert _rel_max(gr_k, gr_t) < 1e-4


def test_fused_normal_backward_runs_the_kernel(cuda):
    S, total = 4, 5000
    loc, rs, mask = _normal_inputs(total, cuda, "both", seed=2)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(3)
    gy = torch.randn(S, total, generator=g).to(cuda)
    glq = torch.randn(S, generator=g).to(cuda)
    loc.requires_grad_(True)
    rs.requires_grad_(True)
    before = dict(tfn.LAUNCHES)
    y, lq = tfn.fused_normal_sample_logq(loc, rs, mask, seed, S)
    ((y * gy).sum() + (lq * glq).sum()).backward()
    assert tfn.LAUNCHES == {"fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    ref = [t.detach().double().requires_grad_(True) for t in (loc, rs)]
    y_t, lq_t = tfn.normal_twin_fwd(*ref, mask.double(), seed, S)
    ((y_t * gy.double()).sum() + (lq_t * glq.double()).sum()).backward()
    for t, r in zip((loc, rs), ref):
        assert _rel_max(t.grad, r.grad) < 1e-4


#: _bits_checksum of K6f's y for the inputs below, taken on an NVIDIA H100
#: 80GB HBM3 with nvcc 12.9 when K6 moved to four samples a Philox call.
#: Another toolkit's erfinvf / log1pf may round otherwise: then compare
#: against a build of the commit before, not against this.
K6_Y_CHECKSUM = 8473303805635


def test_normal_kernel_bits_are_pinned(cuda):
    total, S = 4099, 7
    loc = torch.linspace(-3.0, 3.0, total, device=cuda)
    rs = torch.linspace(-4.0, 2.0, total, device=cuda)
    mask = (torch.arange(total, device=cuda) % 3 == 0).float()
    seed = torch.tensor([20240607], dtype=torch.int32, device=cuda)
    y, _ = tfn._kernel_fwd(loc, rs, mask, seed, S)
    assert _bits_checksum(y) == K6_Y_CHECKSUM
    # the draws behind them are the twin's, bit for bit
    y_t, _ = tfn.normal_twin_fwd(loc.double(), rs.double(), mask.double(),
                                 seed, S)
    assert _rel_max(y, y_t) < 1e-5


def test_normal_kernels_are_deterministic_and_launch_two_and_one(cuda):
    """K6f's log q partials are summed in a fixed order (the same bits on
    every launch); one forward through the autograd Function is two device
    kernels (the sampler and the partials' sum) and its backward one, as
    torch.profiler counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    S, total = 8, 50001
    loc, rs, mask = _normal_inputs(total, cuda, "both", seed=5)
    seed = torch.tensor([31337], dtype=torch.int32, device=cuda)
    first = tfn._kernel_fwd(loc, rs, mask, seed, S)
    second = tfn._kernel_fwd(loc, rs, mask, seed, S)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    loc.requires_grad_(True)
    gy = torch.ones(S, total, device=cuda)
    glq = torch.ones(S, device=cuda)
    out = []

    def device_kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    fwd = device_kernels(lambda: out.extend(
        tfn.fused_normal_sample_logq(loc, rs, mask, seed, S)))
    bwd = device_kernels(lambda: torch.autograd.backward(out, [gy, glq]))
    assert len(fwd) == 2 and len(bwd) == 1, (fwd, bwd)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_normal_kernel_info(cuda, kind):
    """The occupancy API gives K6f and K6b at least two blocks an SM at no
    more than 128 registers a thread."""
    info = tfn.kernel_info(kind, 8)
    assert info["blocks_per_sm"] >= 2 and info["registers"] <= 128, info


OBS = 0.8
SELECTORS = {"bernoulli": "bernoulli", "normal": ("normal", OBS),
             "poisson_softplus": "poisson_softplus", "mixed": ("mixed", OBS)}


def _likelihood_inputs(name, S, B, K, D, dev, seed=0, rescue=False):
    """Signed operands; binary x for 'bernoulli', real x for 'normal', counts
    for 'poisson_softplus', three column blocks for 'mixed'. ``rescue``:
    rates of -2000 in some columns, whose softplus underflows to 0."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    theta = torch.randn(S, B, K, generator=g) * 0.4
    # theta . v keeps the spread it has at K = 8 for wider latent dimensions
    # (under the log link a wider one reaches rates whose float32 rounding
    # alone passes the 1e-6 of the minimum)
    v = torch.randn(S, K, D, generator=g) * 0.3 * min(1.0, (8.0 / K) ** 0.5)
    phi = torch.randn(S, 1, D, generator=g) * 0.3
    eta = torch.rand(1, D, generator=g) * 1.5 + 0.5
    counts = torch.poisson(torch.ones(B, D), generator=g)
    real = torch.randn(B, D, generator=g) + 0.5
    codes = None
    if name == "bernoulli":
        x = counts.clamp_max(1.0)
    elif name == "normal":
        x = real
    elif name == "poisson_softplus":
        x = counts
    else:
        codes = (torch.arange(D) % 3).float()[None]
        x = torch.where(codes == tfp.CODE_BERNOULLI, counts.clamp_max(1.0),
                        torch.where(codes == tfp.CODE_NORMAL, real, counts))
    if rescue:
        phi[:, :, ::7] = -2000.0
        theta[:, ::5] = 0.0
    args = [t.to(dev) for t in (theta, v, phi, x, eta)]
    return args, (None if codes is None else codes.to(dev))


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("name", list(SELECTORS))
def test_stats_kernel_likelihoods_match_twin(cuda, name, static,
                                             log_transform):
    lik = SELECTORS[name]
    for shape in SHAPES:
        args, codes = _likelihood_inputs(name, *shape, cuda)
        out_k = tfp._kernel_stats(*args, log_transform, static, lik, codes)
        out_t = tfp.stats_twin(*[a.double() for a in args],
                               log_transform=log_transform, static=static,
                               likelihood=lik, codes=codes)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out_k[0].cpu().numpy(),
                                   out_t[0].cpu().numpy(), rtol=1e-5)
        assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
        np.testing.assert_allclose(out_k[2].cpu().numpy(),
                                   out_t[2].cpu().numpy(), rtol=1e-6)
        for k, t in zip(out_k[3:], out_t[3:]):
            assert _rel_max(k, t) < 1e-4


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("name", list(SELECTORS))
def test_row_ll_kernel_likelihoods_match_twin(cuda, name, log_transform):
    lik = SELECTORS[name]
    for shape in SHAPES:
        args, codes = _likelihood_inputs(name, *shape, cuda, seed=3)
        out_k = tfp._kernel_row_ll(*args, log_transform, lik, codes)
        out_t = tfp.row_loglik_twin(*[a.double() for a in args],
                                    log_transform=log_transform,
                                    likelihood=lik, codes=codes)
        torch.cuda.synchronize()
        np.testing.assert_allclose(out_k.cpu().numpy(), out_t.cpu().numpy(),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["poisson_softplus", "mixed"])
def test_softplus_link_rescue_batch(cuda, name):
    """An underflowed softplus rate: the clipped cells are counted exactly
    and K4's poisoned rows sit where the twin's do."""
    lik = SELECTORS[name]
    args, codes = _likelihood_inputs(name, 2, 150, 6, 400, cuda, seed=1,
                                     rescue=True)
    args64 = [a.double() for a in args]
    out_k = tfp._kernel_stats(*args, False, False, lik, codes)
    out_t = tfp.stats_twin(*args64, likelihood=lik, codes=codes)
    assert int(out_t[1].sum()) > 0
    assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    for k, t in zip(out_k[3:], out_t[3:]):
        assert bool(torch.isfinite(k).all()) and _rel_max(k, t) < 1e-4
    rows_k = tfp._kernel_row_ll(*args, False, lik, codes).cpu().numpy()
    rows_t = tfp.row_loglik_twin(*args64, likelihood=lik,
                                 codes=codes).cpu().numpy()
    bad = ~np.isfinite(rows_t)
    assert bad.any()
    np.testing.assert_array_equal(~np.isfinite(rows_k), bad)
    np.testing.assert_allclose(rows_k[~bad], rows_t[~bad], rtol=1e-5)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("name", list(SELECTORS))
def test_wide_stats_kernel_likelihoods_match_twin(cuda, name, static,
                                                  log_transform):
    """The split-TF32 wide K1/K2 at K = 128 (S=2, B=300, D=997: no tile
    multiples) for the four likelihoods past 'poisson', both clips and both
    links, against the float64 twin at the tolerances above; the wide
    kernel is the one that launches. Under the log link the largest rates
    are about 30, where a few ulps of theta . v move the minimum by 1e-6
    (tests/test_torch_stats_split.py emulates the kernel's decode here)."""
    lik = SELECTORS[name]
    args, codes = _likelihood_inputs(name, 2, 300, 128, 997, cuda, seed=11)
    assert tfp.launch_geometry("stats", 2, 300, 128, 997).chunks > 1
    key = ("static" if static else "stats") + "_wide"
    before = tfp.LAUNCHES[key]
    out_k = tfp._kernel_stats(*args, log_transform, static, lik, codes)
    out_t = tfp.stats_twin(*[a.double() for a in args],
                           log_transform=log_transform, static=static,
                           likelihood=lik, codes=codes)
    torch.cuda.synchronize()
    assert tfp.LAUNCHES[key] == before + 1
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
    np.testing.assert_allclose(out_k[2].cpu().numpy(), out_t[2].cpu().numpy(),
                               rtol=1e-6)
    for k, t in zip(out_k[3:], out_t[3:]):
        assert _rel_max(k, t) < 1e-4


@pytest.mark.parametrize("name", ["poisson_softplus", "mixed"])
def test_wide_softplus_link_rescue_batch(cuda, name):
    """An underflowed softplus rate through the wide K1 at K = 128: the
    clipped cells are counted exactly, the sums and gradients held to the
    twin."""
    lik = SELECTORS[name]
    args, codes = _likelihood_inputs(name, 2, 150, 128, 400, cuda, seed=1,
                                     rescue=True)
    out_k = tfp._kernel_stats(*args, False, False, lik, codes)
    out_t = tfp.stats_twin(*[a.double() for a in args], likelihood=lik,
                           codes=codes)
    assert int(out_t[1].sum()) > 0
    assert torch.equal(out_k[1].cpu(), out_t[1].cpu())
    np.testing.assert_allclose(out_k[0].cpu().numpy(), out_t[0].cpu().numpy(),
                               rtol=1e-5)
    for k, t in zip(out_k[3:], out_t[3:]):
        assert bool(torch.isfinite(k).all()) and _rel_max(k, t) < 1e-4


def test_wide_expsum_rate_total_is_deterministic(cuda):
    """The wide K5 at K = 128 (S=8, B=1000, D=19,997): R is a fixed-order
    sum and dtheta has one owner per element (kept on chip for the block's
    life and written once), so two launches give the same bits of both."""
    theta, v, _, _, eta = _stats_inputs(8, 1000, 128, 19997, cuda, seed=12)
    v *= 0.25 * (8.0 / 128) ** 0.5
    assert tfp.launch_geometry("expsum", 8, 1000, 128, 19997).chunks > 1
    first = tfp._kernel_expsum(theta, v, eta)
    second = tfp._kernel_expsum(theta, v, eta)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_fused_loglik_mixed_backward_runs_the_kernel(cuda):
    args, codes = _likelihood_inputs("mixed", 2, 70, 4, 300, cuda)
    for a in args[:3]:
        a.requires_grad_(True)
    before = tfp.LAUNCHES["stats"]
    out = tfp.fused_poisson_loglik(*args, likelihood=("mixed", OBS),
                                   codes=codes)
    out.sum().backward()
    assert tfp.LAUNCHES["stats"] == before + 1
    ssum, cnt, gmin, *grads = tfp.stats_twin(
        *[a.detach().double() for a in args], likelihood=("mixed", OBS),
        codes=codes)
    for a, g in zip(args[:3], grads):
        assert _rel_max(a.grad, g) < 1e-4


def test_cuda_tensors_never_fall_back(cuda):
    a = torch.ones(10, device=cuda, dtype=torch.float64)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tig.fused_ig_sample_logq(a, a, seed, 2)
    with pytest.raises(ValueError):
        tfn.fused_normal_sample_logq(a, a, a, seed, 2)
    with pytest.raises(ValueError):
        tfn.fused_normal_sample_logq(a.float(), a.float(), a.float(),
                                     seed.cpu(), 2)
    args = _stats_inputs(1, 8, 2, 16, cuda)
    with pytest.raises(ValueError):
        tfp._kernel_stats(*[t.double() for t in args], False, False)
    with pytest.raises(ValueError):
        tfp._kernel_row_ll(*[t.double() for t in args], False)
    with pytest.raises(ValueError):
        tfp._kernel_expsum(args[0].double(), args[1], args[4])


def _card_model(x):
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset

    return PoissonFactorization(latent_dim=4, feature_dim=x.shape[1],
                                device="cuda",
                                data=ArrayDataset({"counts": x}).batch(64))


def test_save_and_load_model_round_trip_on_the_card(cuda, tmp_path):
    """A float32 model on the card saved and rebuilt by load_model: the same
    parameter bits on the card, and (the recalibration draws the same
    Philox stream on the same parameters) the same encode bits."""
    from spmf_tpu_torch import load_model
    from spmf_tpu_torch.utils import flatten_jax_order

    x = np.random.default_rng(0).poisson(1.0, (64, 300)).astype(np.float32)
    m = _card_model(x)
    path = str(tmp_path / "model.npz")
    m.save(path)
    r = load_model(path, device="cuda")
    assert r.device.type == "cuda" and r.dtype == torch.float32
    for a, b in zip(flatten_jax_order(m.surrogate_params),
                    flatten_jax_order(r.surrogate_params)):
        assert b.is_cuda and torch.equal(a, b)
    assert torch.equal(r.eta_i, m.eta_i)
    assert torch.equal(r.encode(x), m.encode(x))


def test_encode_batched_matches_encode_on_the_card(cuda):
    x = np.random.default_rng(1).poisson(1.0, (1000, 300)).astype(np.float32)
    m = _card_model(x)
    chunked = m.encode_batched(x, row_chunk=256)
    assert isinstance(chunked, np.ndarray) and chunked.shape == (1000, 4)
    full = m.encode(x).cpu().numpy()
    # another M may take another cuBLAS algorithm
    assert np.abs(chunked - full).max() <= 1e-6 * np.abs(full).max()


# ------------------------------------------------ the captured scan path
def _scan_fit(dev, capture, dtype, monkeypatch, n=250, bs=100, d=300, k=4,
              epochs=6, fit_kw=None, fused_normals=False, **model_kw):
    """A fit over a DeviceArrayDataset through the scan path, captured in
    CUDA graphs or run eagerly on the card: 2 full batches and a 50-row
    remainder, patience=1 and a learning rate that forces plateau
    restores; ``fused_normals`` sets the surrogate's opt-in."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset
    from spmf_tpu_torch.vi import epoch_scan

    monkeypatch.setattr(epoch_scan, "_CAPTURE", capture)
    X = np.random.default_rng(7).poisson(1.0, (n, d))
    ds = DeviceArrayDataset({"counts": X, "indices": np.arange(n)},
                            batch_size=bs, shuffle=True, seed=3, dtype=dtype,
                            device=dev)
    m = PoissonFactorization(latent_dim=k, feature_dim=d, dtype=dtype,
                             device=dev, u_tau_scale=1.0 / np.sqrt(n * d),
                             data=ds, **model_kw)
    m._surrogate.fused_normals = fused_normals
    losses = m.fit(num_steps=epochs, learning_rate=2.0, sample_size=4,
                   patience=1, rel_tol=None, verbose=False, seed=5,
                   **(fit_kw or {}))
    assert m.last_fit.extras["epoch_scan"] is True
    return m, losses


@pytest.mark.parametrize("dtype, model_kw", [
    ("float64", dict(fused_likelihood=False, gamma_sampler="fast")),
    # K3 (deterministic); K1's float32 atomic sums are not, see below
    ("float32", dict(fused_likelihood=False, gamma_sampler="fused"))])
def test_captured_scan_equals_uncaptured_bit_for_bit(cuda, monkeypatch,
                                                     dtype, model_kw):
    """The scan path's step replayed from CUDA graphs draws the same bits
    and computes the same numbers as the same scan run eagerly: the loss
    trace, the parameters and the learning rate are equal, across plateau
    restores and a remainder batch."""
    runs = {c: _scan_fit(cuda, c, dtype, monkeypatch, **model_kw)
            for c in (True, False)}
    (m_c, l_c), (m_e, l_e) = runs[True], runs[False]
    assert np.isfinite(l_c).all()
    assert l_c == l_e
    assert m_c.last_fit.learning_rate == m_e.last_fit.learning_rate < 2.0
    for name, sub in m_c.surrogate_params.items():
        for leaf, t in sub.items():
            assert torch.equal(t, m_e.surrogate_params[name][leaf]), (name,
                                                                      leaf)


def test_captured_scan_through_k1_matches_uncaptured(cuda, monkeypatch):
    """Through K1, whose float32 dv and dphi sums are atomic (their order
    varies from run to run, even at one row tile), the captured scan's
    losses lie within 1e-5 relative of the eager scan's, with the same
    restores."""
    kw = dict(fused_likelihood=True, gamma_sampler="fused")
    (m_c, l_c), (m_e, l_e) = (_scan_fit(cuda, c, "float32", monkeypatch,
                                        **kw) for c in (True, False))
    np.testing.assert_allclose(l_c, l_e, rtol=1e-5)
    assert m_c.last_fit.learning_rate == m_e.last_fit.learning_rate < 2.0


def test_scan_replays_advance_the_launch_counters(cuda, monkeypatch):
    """A wrapper's counter moves once at capture (which launches nothing),
    so each replay adds the graph's kernels: K1 counts the initial loss,
    one warm-up per graph and one launch per batch; K3b one per warm-up and
    batch."""
    for d in (tfp.LAUNCHES, tig.LAUNCHES):
        for k in d:
            d[k] = 0
    epochs = 3
    _scan_fit(cuda, True, "float32", monkeypatch, epochs=epochs,
              fused_likelihood=True, gamma_sampler="fused")
    graphs, batches = 2, 3
    assert tfp.LAUNCHES["stats"] == 1 + graphs + epochs * batches
    assert tig.LAUNCHES["bwd"] == graphs + epochs * batches


def test_failed_capture_raises(cuda):
    """A step that reads a value on the host cannot be captured: the scan
    raises and names the capture; it does not fall back to the eager
    loop."""
    from spmf_tpu_torch import bijectors as tb
    from spmf_tpu_torch.data import DeviceArrayDataset, as_data_factory
    from spmf_tpu_torch.vi.minibatch import fit_surrogate_posterior
    from spmf_tpu_torch.vi.surrogates import (SurrogatePosterior,
                                              TrainableNormal,
                                              TransformedSurrogate)

    sur = SurrogatePosterior({"z": TransformedSurrogate(
        TrainableNormal(np.zeros((1, 1)), 0.5 * np.ones((1, 1)), 2,
                        dtype=torch.float64, device=cuda), tb.Identity())})

    def energy(batch, samples, pw):
        z = samples["z"][..., 0, 0]
        if float(batch["counts"].sum()) > 1e9:    # a host read
            z = z * 2
        return -0.5 * z * z - 0.5 * torch.sum(
            (batch["counts"][None, :] - z[..., None]) ** 2, dim=-1)

    ds = DeviceArrayDataset({"counts": np.ones(64)}, batch_size=16,
                            device=cuda)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        fit_surrogate_posterior(energy, sur, sur.init(), as_data_factory(ds),
                                num_steps=2, verbose=False,
                                dtype=torch.float64)


# ------------------------------------------------ the chunk path and prefetch
def _assert_same_fit(a, b):
    (m_a, l_a), (m_b, l_b) = a, b
    assert l_a == l_b
    assert m_a.last_fit.learning_rate == m_b.last_fit.learning_rate
    for name, sub in m_a.surrogate_params.items():
        for leaf, t in sub.items():
            assert torch.equal(t, m_b.surrogate_params[name][leaf]), (name,
                                                                      leaf)


def test_captured_chunks_equal_single_epochs_and_eager_chunks(cuda,
                                                              monkeypatch):
    """Chunks of 4 with the decisions replayed from their own CUDA graph
    equal the captured single-epoch fit and the eager chunked fit bit for
    bit at float64, across the restores patience=1 forces inside a chunk."""
    kw = dict(epochs=8, fused_likelihood=False, gamma_sampler="fast")
    chunk = _scan_fit(cuda, True, "float64", monkeypatch,
                      fit_kw=dict(epoch_chunk=4), **kw)
    single = _scan_fit(cuda, True, "float64", monkeypatch,
                       fit_kw=dict(epoch_chunk=1), **kw)
    eager = _scan_fit(cuda, False, "float64", monkeypatch,
                      fit_kw=dict(epoch_chunk=4), **kw)
    assert chunk[0].last_fit.extras["epoch_chunk"] == 4
    assert chunk[0].last_fit.learning_rate < 2.0
    _assert_same_fit(chunk, single)
    _assert_same_fit(chunk, eager)


def test_decision_graph_keeps_the_storage(cuda, monkeypatch):
    """The captured decisions copy in place: across chunks and their
    restores the parameters, Adam's state and the best buffers keep their
    data_ptr()."""
    from spmf_tpu_torch.vi import epoch_scan

    ptrs = []
    run_chunk = epoch_scan.EpochScan.run_chunk

    def spy(self, k, decide):
        ptrs.append([t.data_ptr() for t in decide.tensors()])
        return run_chunk(self, k, decide)

    monkeypatch.setattr(epoch_scan.EpochScan, "run_chunk", spy)
    m, _ = _scan_fit(cuda, True, "float64", monkeypatch, epochs=12,
                     fit_kw=dict(epoch_chunk=4), fused_likelihood=False,
                     gamma_sampler="fast")
    assert m.last_fit.learning_rate < 2.0
    assert len(ptrs) == 3 and all(p == ptrs[0] for p in ptrs)


def test_prefetch_on_the_card_equals_inline(cuda):
    """The general loop over a host dataset with the batches copied to the
    card in the prefetch worker equals the in-line loop at float64."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset

    n, d = 250, 300
    X = np.random.default_rng(7).poisson(1.0, (n, d))
    runs = []
    for prefetch in (2, 0):
        data = ArrayDataset({"counts": X, "indices": np.arange(n)}
                            ).shuffle(seed=3).batch(100)
        m = PoissonFactorization(latent_dim=4, feature_dim=d,
                                 dtype="float64", device=cuda,
                                 u_tau_scale=1.0 / np.sqrt(n * d),
                                 fused_likelihood=False,
                                 gamma_sampler="fast")
        losses = m.fit(batched_data_factory=data, num_steps=3,
                       learning_rate=0.5, sample_size=4, rel_tol=None,
                       verbose=False, seed=5, prefetch=prefetch)
        assert m.last_fit.extras["epoch_scan"] is False
        runs.append((m, losses))
    _assert_same_fit(*runs)


# ------------------------------- engine options: remat, exact, broadcast, stl
@pytest.mark.parametrize("dtype, model_kw, fused_normals", [
    ("float64", dict(fused_likelihood=False, gamma_sampler="fast"), False),
    # through K3, and through K3 and K6 (both deterministic)
    ("float32", dict(fused_likelihood=False, gamma_sampler="fused"), False),
    ("float32", dict(fused_likelihood=False, gamma_sampler="fused"), True)])
def test_captured_remat_equals_eager_without_remat(cuda, monkeypatch, dtype,
                                                   model_kw, fused_normals):
    """remat_sampling=True on the captured scan redraws each step's samples
    in the backward from generator replicas registered with the graph: the
    fit equals remat_sampling=False on the eager scan bit for bit (losses,
    parameters, learning rate), across restores and a remainder batch."""
    remat = _scan_fit(cuda, True, dtype, monkeypatch,
                      fit_kw=dict(remat_sampling=True),
                      fused_normals=fused_normals, **model_kw)
    plain = _scan_fit(cuda, False, dtype, monkeypatch,
                      fit_kw=dict(remat_sampling=False),
                      fused_normals=fused_normals, **model_kw)
    assert np.isfinite(remat[1]).all() and remat[0].last_fit.learning_rate < 2
    _assert_same_fit(remat, plain)


def test_exact_sampler_draws_and_gradient_on_the_card(cuda):
    """sample_gamma(method='exact') on the card: the draws' KS distance
    from Gamma(a) (scipy) and their implicit gradient against the float64
    formula at the same (a, x)."""
    from scipy import stats

    from spmf_tpu_torch.ops.gamma import sample_gamma

    gen = torch.Generator(device=cuda).manual_seed(3)
    for a in (0.3, 1.0, 4.0):
        conc = torch.full((200_000,), a, device=cuda, requires_grad=True)
        x = sample_gamma(gen, conc, "exact")
        w = torch.rand(x.shape, generator=gen, device=cuda)
        (x * w).sum().backward()
        xs = x.detach().double().cpu().numpy()
        assert stats.kstest(xs[:50_000], "gamma", args=(a,)).statistic < 0.01
        ref = w.double().cpu() * torch._standard_gamma_grad(
            conc.detach().double().cpu(), x.detach().double().cpu())
        np.testing.assert_allclose(conc.grad.double().cpu().numpy(),
                                   ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))


def test_aux_broadcast_draws_k3_at_one_sample(cuda):
    """aux_broadcast=True on the card: the IG block is drawn once a step
    through K3 at S=1 (values without the sample axis), the Normal block
    per sample, and one training step runs through K3f and K3b."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset

    n, d = 256, 300
    X = np.random.default_rng(7).poisson(1.0, (n, d))
    m = PoissonFactorization(latent_dim=4, feature_dim=d, device=cuda,
                             dtype="float32", aux_broadcast=True,
                             u_tau_scale=1.0 / np.sqrt(n * d),
                             data=ArrayDataset({"counts": X}).batch(128))
    gen = torch.Generator(device=cuda).manual_seed(0)
    values, lq = m._surrogate.sample_and_log_prob(m.surrogate_params, gen,
                                                  (8,))
    assert values["u_eta"].shape == (d, 4) and values["u"].shape == (8, d, 4)
    assert lq.shape == (8,)
    for k in tig.LAUNCHES:
        tig.LAUNCHES[k] = 0
    losses = m.fit(num_steps=2, sample_size=8, verbose=False, rel_tol=None)
    assert np.isfinite(losses).all()
    assert tig.LAUNCHES["fwd"] > 0 and tig.LAUNCHES["bwd"] > 0


def test_stl_fit_on_the_card_skips_the_samplers(cuda):
    """elbo_estimator='stl' forces the plain samplers: a float32 'fused'
    model trains through K1 and no step launches K3 (its backward K3b never
    runs; the posterior means after the fit draw through K3f)."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset

    n, d = 256, 300
    X = np.random.default_rng(7).poisson(1.0, (n, d))
    m = PoissonFactorization(latent_dim=4, feature_dim=d, device=cuda,
                             dtype="float32",
                             u_tau_scale=1.0 / np.sqrt(n * d),
                             data=ArrayDataset({"counts": X}).batch(128))
    for d_ in (tig.LAUNCHES, tfp.LAUNCHES):
        for k in d_:
            d_[k] = 0
    losses = m.fit(num_steps=2, sample_size=8, verbose=False, rel_tol=None,
                   elbo_estimator="stl")
    assert np.isfinite(losses).all()
    assert tig.LAUNCHES["bwd"] == 0 and tfp.LAUNCHES["stats"] > 0


def test_debug_nans_on_the_card(cuda):
    """``debug_nans`` traps a NaN made by an op on the card, forward and
    in a backward run on autograd's device thread, and a finite fit step
    through the kernels runs inside it."""
    from spmf_tpu_torch.utils import debug_nans

    with debug_nans():
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(torch.tensor([-1.0], device=cuda))
        x = torch.tensor([0.0, 1.0], device=cuda, requires_grad=True)
        y = (torch.sqrt(x) * 0.0).sum()
        with pytest.raises(FloatingPointError):
            y.backward()
        args = _stats_inputs(2, 64, 8, 100, cuda)
        theta = args[0].requires_grad_()
        out = tfp.fused_poisson_loglik(theta, *args[1:])
        out.sum().backward()
        assert torch.isfinite(theta.grad).all()
    torch.log(torch.tensor([-1.0], device=cuda))


# ------------------------------------------- meshes that split some widths
def _trivial_fp_mesh():
    from spmf_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, 1), ("dp", "fp"))
    assert mesh.trivial and mesh.member
    return mesh


def test_feature_dim_fp_does_not_divide_on_the_card(cuda):
    """D=15, which fp=2 would leave whole on every rank, in one process on
    a trivial dp x fp mesh: the energy through K1 and the per-row scores
    through K4 on the card equal the float64 plain path on the CPU on the
    same samples, and a fit step launches K1 and K3. (Two ranks on the
    card: phase M (g) of chip_smoke.py.)"""
    from spmf_tpu_torch import PoissonFactorization

    x = np.random.default_rng(2).poisson(1.0, (64, 15)).astype(np.float32)
    rng = np.random.default_rng(3)

    def model(dev, dtype, **kw):
        return PoissonFactorization(latent_dim=4, feature_dim=15,
                                    u_tau_scale=0.1, device=dev, dtype=dtype,
                                    mesh=_trivial_fp_mesh(), **kw)

    mk = model(cuda, "float32")
    mc = model("cpu", "float64", fused_likelihood=False)
    samples = {n: rng.lognormal(-1.0, 0.5, (3,) + tuple(s.shape))
               for n, s in mc._surrogate.surrogates.items()}
    with torch.no_grad():
        xk = mk.unormalized_log_prob_parts(
            {"counts": x}, **{k: torch.as_tensor(v, device=cuda).float()
                              for k, v in samples.items()})["x"]
        xc = mc.unormalized_log_prob_parts(
            {"counts": x.astype(np.float64)},
            **{k: torch.as_tensor(v) for k, v in samples.items()})["x"]
        rk = mk._row_log_likelihood({"counts": x}, {
            k: torch.as_tensor(v, device=cuda).float()
            for k, v in samples.items()})
        rc = mc._row_log_likelihood({"counts": x.astype(np.float64)}, {
            k: torch.as_tensor(v) for k, v in samples.items()})
    assert mk.fusion_active
    assert _rel_max(xk.cpu(), xc) < 1e-5
    assert _rel_max(rk.cpu(), rc) < 1e-5
    for d_ in (tig.LAUNCHES, tfp.LAUNCHES):
        for k in d_:
            d_[k] = 0
    losses = mk.fit(batched_data_factory={"counts": x}, num_steps=1,
                    sample_size=4, verbose=False, rel_tol=None)
    assert np.isfinite(losses).all()
    assert tfp.LAUNCHES["stats"] > 0 and tig.LAUNCHES["fwd"] > 0


def test_autoencoder_mesh_forward_on_the_card(cuda):
    """The autoencoder's mesh-aware forward (``assemble_networks(mesh=)``,
    its prior and tile sums) in one process on a trivial dp x fp mesh: the
    energy on the card equals the float64 CPU path on the same weights,
    and a step with fused_normals draws the block through K6. (The split
    forward over two ranks on the card: phase M (f) of chip_smoke.py.)"""
    from spmf_tpu_torch import PoissonAutoencoder

    x = np.random.default_rng(4).poisson(1.0, (64, 12)).astype(np.float32)
    data = {"counts": x, "indices": np.arange(64)}

    def model(dev, dtype):
        return PoissonAutoencoder(data, latent_dim=4, device=dev, dtype=dtype,
                                  mesh=_trivial_fp_mesh())

    mk, mc = model(cuda, "float32"), model("cpu", "float64")
    rng = np.random.default_rng(6)
    w = {n: rng.normal(0.0, 0.3, (2,) + tuple(s.shape))
         for n, s in mc._surrogate.surrogates.items()}
    with torch.no_grad():
        pk = mk.unormalized_log_prob_parts(
            data, **{k: torch.as_tensor(v, device=cuda).float()
                     for k, v in w.items()})
        pc = mc.unormalized_log_prob_parts(
            {"counts": x.astype(np.float64)},
            **{k: torch.as_tensor(v) for k, v in w.items()})
    for k, v in pc.items():
        assert _rel_max(pk[k].cpu(), v) < 1e-5, k
    sur = mk._surrogate
    sur.gamma_sampler, sur.fused_normals = "fused", True
    for k in tfn.LAUNCHES:
        tfn.LAUNCHES[k] = 0
    losses = mk.fit(batched_data_factory=data, num_steps=1, sample_size=4,
                    verbose=False, rel_tol=None)
    assert np.isfinite(losses).all()
    assert tfn.LAUNCHES["fwd"] > 0 and tfn.LAUNCHES["bwd"] > 0
