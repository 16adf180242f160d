"""The fused Poisson likelihood's twin (the CPU side of kernel K1/K2)
against spmf_tpu: the plain reference in float64 and the Pallas kernel run
interpreted in float32."""
import _torch_threads  # noqa: F401  (first: one torch thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmf_tpu.ops import fused_poisson as jfp

from spmf_tpu_torch.ops import fused_poisson as tfp

S, B, K, D = 3, 40, 4, 300   # ragged: neither B nor D a tile multiple


def _inputs(seed=0, rescue=False, latent=K):
    """``latent`` past K: v scaled by sqrt(K / latent), so that theta . v
    keeps the spread it has at K."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, (S, B, latent))
    v = rng.uniform(0.0, 0.5, (S, latent, D)) * min(1.0, (K / latent) ** 0.5)
    phi = rng.uniform(0.05, 0.5, (S, 1, D))
    x = rng.poisson(1.0, (B, D)).astype(float)
    eta = rng.uniform(0.5, 2.0, (1, D))
    if rescue:
        # negative rates in a few columns: NaN cells the clip replaces by m
        phi[:, :, ::37] = -5.0
        theta[:, ::7] = 0.0
    return theta, v, phi, x, eta


def _combine(ssum, cnt, gmin, dtype):
    m = tfp._floor_min_val(gmin - 10.0)
    return ssum + cnt.to(dtype) * m[0]


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("rescue", [False, True])
def test_twin_matches_reference_f64(log_transform, rescue):
    """Twin stats combined through the clip decomposition == the plain
    clip-then-sum reference (float64, 1e-10)."""
    args = _inputs(rescue=rescue)
    ref = jfp.poisson_loglik_reference(*map(jnp.asarray, args),
                                       log_transform=log_transform)
    t = [torch.tensor(a) for a in args]
    ssum, cnt, gmin, *_ = tfp.stats_twin(*t, log_transform=log_transform)
    np.testing.assert_allclose(_combine(ssum, cnt, gmin, torch.float64),
                               np.asarray(ref), rtol=1e-10)
    ref_t = tfp.poisson_loglik_reference(*t, log_transform=log_transform)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref), rtol=1e-10)


def _jax_kernel(args, log_transform, clip):
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    codes = jnp.zeros((1, D), jnp.float32)

    def f(theta, v, phi):
        return jfp.fused_poisson_loglik(theta, v, phi, jargs[3], jargs[4],
                                        log_transform, interpret=True,
                                        clip=clip)

    return f, jargs, codes


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("clip", ["reference", "static"])
def test_matches_interpreted_pallas_kernel_f32(log_transform, clip):
    """Values (1e-5 relative: f32 sums over the tile in another order and
    another lgamma) and the unit-cotangent gradients through the
    autograd.Function (1e-4 of the largest entry) vs jax.grad of the
    interpreted kernel."""
    _check_against_interpreted_kernel(_inputs(seed=1), log_transform, clip)


@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("clip", ["reference", "static"])
def test_matches_interpreted_pallas_kernel_f32_at_k128(log_transform, clip):
    """The same at K = 128, a latent dimension past the whole-K tiles of
    the port's K1/K2 (its K-chunked kernel on the card); the TPU kernel
    takes the whole of K in one block."""
    _check_against_interpreted_kernel(_inputs(seed=4, latent=128),
                                      log_transform, clip)


def _check_against_interpreted_kernel(args, log_transform, clip):
    f, jargs, codes = _jax_kernel(args, log_transform, clip)
    g = np.array([0.7, -1.3, 2.0], np.float32)
    val_j, vjp = jax.vjp(f, *jargs[:3])
    grads_j = vjp(jnp.asarray(g))

    t = [torch.tensor(a, dtype=torch.float32) for a in args]
    for a in t[:3]:
        a.requires_grad_(True)
    val_t = tfp.fused_poisson_loglik(*t, log_transform=log_transform,
                                     clip=clip)
    (val_t * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(val_t.detach().numpy(), np.asarray(val_j),
                               rtol=1e-5)
    for a, gj in zip(t[:3], grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(a.grad.numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max())

    if clip == "reference":
        ssum_j, cnt_j, gmin_j = jfp._fused_stats(
            *jargs, codes, log_transform, True, "poisson")
        ssum_t, cnt_t, gmin_t, *_ = tfp.stats_twin(
            *[a.detach() for a in t], log_transform=log_transform)
        np.testing.assert_allclose(ssum_t.numpy(), np.asarray(ssum_j),
                                   rtol=1e-5)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_allclose(gmin_t.numpy(), np.asarray(gmin_j),
                                   rtol=1e-5)


def test_rescue_batch_counts_and_bound_f32():
    """Negative rates: the clipped-cell counts match the kernel's exactly,
    the clip bound m to f32 rounding, and the total to 1e-5."""
    args = _inputs(seed=2, rescue=True)
    jargs = [jnp.asarray(a, jnp.float32) for a in args]
    codes = jnp.zeros((1, D), jnp.float32)
    ssum_j, cnt_j, gmin_j = jfp._fused_stats(*jargs, codes, False, True,
                                             "poisson")
    t = [torch.tensor(a, dtype=torch.float32) for a in args]
    ssum_t, cnt_t, gmin_t, *_ = tfp.stats_twin(*t)
    assert int(cnt_t.sum()) > 0
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    m_j = np.asarray(jfp._floor_min_val(gmin_j - 10.0))
    m_t = tfp._floor_min_val(gmin_t - 10.0).numpy()
    np.testing.assert_allclose(m_t, m_j, rtol=1e-6)
    out_j = jfp.fused_poisson_loglik(*jargs, interpret=True)
    out_t = tfp.fused_poisson_loglik(*t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5)


def test_static_clip_equals_reference_on_healthy_data():
    t = [torch.tensor(a, dtype=torch.float32) for a in _inputs(seed=3)]
    np.testing.assert_allclose(
        tfp.fused_poisson_loglik(*t, clip="static").numpy(),
        tfp.fused_poisson_loglik(*t, clip="reference").numpy(), rtol=1e-6)


def test_other_likelihoods_and_clip_modes_raise():
    t = [torch.tensor(a, dtype=torch.float32) for a in _inputs()]
    for bad in ("gamma", "mixed", "normal", ("gamma", 1.0), 7):
        with pytest.raises(ValueError, match="unknown likelihood"):
            tfp.fused_poisson_loglik(*t, likelihood=bad)
    with pytest.raises(ValueError, match="codes"):
        tfp.fused_poisson_loglik(*t, likelihood=("mixed", 1.0))
    with pytest.raises(ValueError):
        tfp.fused_poisson_loglik(*t, clip="dynamic")


# ------------------------------------------------ the kernels' launch geometry
GEOMETRY_SHAPES = [(8, 4096, 32, 20000), (8, 32768, 32, 20000),
                   (3, 200, 8, 1000), (2, 37, 5, 130), (8, 1000, 20, 20000)]


@pytest.mark.parametrize("kind", ["stats", "row_ll", "expsum"])
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_launch_geometry_covers_the_batch(shape, kind):
    """Padded K is a multiple of the k-step and >= K, the tiles fit a
    Hopper block's shared memory, and the grid's blocks own every (sample,
    row) exactly once and every column through their tile loop."""
    S, B, K, D = shape
    g = tfp.launch_geometry(kind, S, B, K, D)
    assert g.k_padded % g.k_step == 0 and K <= g.k_padded < K + g.k_step
    assert g.smem_bytes + g.static_smem_bytes <= 232448
    assert g.blocks_per_sm >= 1
    assert g.threads == 256 and g.stages == (1 if kind == "stats" else 2)
    assert g.grid == S * g.row_tiles
    assert g.col_tiles * g.col_tile >= D > (g.col_tiles - 1) * g.col_tile
    owned = np.zeros((S, B), np.int64)
    for i in range(g.grid):
        s, r0, r1 = g.block(i)
        assert 0 <= s < S and 0 <= r0 < r1 <= B and r1 - r0 <= g.row_tile
        owned[s, r0:r1] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("kind", ["stats", "row_ll", "expsum"])
def test_launch_geometry_at_the_model_widths(kind):
    """K = 16 and K = 32 leave room for two blocks on an SM (233,472 bytes,
    1 KB reserved per block); a latent dimension whose whole-K tiles cannot
    fit one block gets the K-chunked geometry; only K < 1 raises."""
    for K in (16, 32):
        g = tfp.launch_geometry(kind, 8, 4096, K, 20000)
        assert g.blocks_per_sm == 2 and g.chunks == 1
        assert 2 * (g.smem_bytes + g.static_smem_bytes + 1024) <= 233472
    wide = tfp.launch_geometry(kind, 8, 4096, 64, 20000)
    assert wide.blocks_per_sm == 1 and wide.chunks == 1
    chunked = tfp.launch_geometry(kind, 8, 4096, 512, 20000)
    assert chunked.chunks > 1 and chunked.k_padded == 512
    with pytest.raises(ValueError, match="K >= 1"):
        tfp.launch_geometry(kind, 8, 4096, 0, 20000)
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tfp.launch_geometry("k7", 8, 4096, 32, 20000)


#: the latent dimensions past one kernel's whole-K tiles or another (K4's
#: and K5's whole-K kernels end at their switch, 64, K1/K2's tiles at padded
#: K = 124); 153 past the wide K4's first design, 257 and past where the
#: wide K4's theta streams
WIDE_K = (65, 125, 128, 153, 256, 257, 512, 1024)
WHOLE_K_LIMIT = {"stats": 124, "row_ll": 64, "expsum": 64}


@pytest.mark.parametrize("kind", ["stats", "row_ll", "expsum"])
@pytest.mark.parametrize("K", WIDE_K)
def test_launch_geometry_past_the_whole_k_tiles(K, kind):
    """Every K gets a geometry that fits a Hopper block's shared memory,
    whose chunks cover the padded latent dimension, and whose blocks own
    every (sample, row) once. Past the whole-K kernels the split-TF32 wide
    K1/K2, K4 and K5 take chunks of 32 (four mma k-steps), two stages of
    them where they stream (K1/K2 and K5 past padded K = 128; K4's raw v
    always, its theta past 256), and one block an SM (231,552, 225,280 and
    228,672 bytes of the SM's 233,472 with the 1 KB each block reserves);
    the wide K4 runs 16 warps, the others 8."""
    S, B, D = 2, 1000, 19997
    g = tfp.launch_geometry(kind, S, B, K, D)
    assert g.k_padded % g.k_step == 0 and K <= g.k_padded < K + g.k_step
    assert g.chunks * g.k_chunk >= g.k_padded > (g.chunks - 1) * g.k_chunk
    assert g.smem_bytes + g.static_smem_bytes <= 232448
    assert (g.chunks > 1) == (g.k_padded > WHOLE_K_LIMIT[kind])
    if g.chunks > 1:
        assert g.stages == 2 and g.k_chunk % g.k_step == 0
        assert g.k_chunk == 32 and g.blocks_per_sm == 1
        assert g.smem_bytes + g.static_smem_bytes + 1024 <= 233472
        assert g.threads == (512 if kind == "row_ll" else 256)
    assert g.grid == S * g.row_tiles
    owned = np.zeros((S, B), np.int64)
    for i in range(g.grid):
        s, r0, r1 = g.block(i)
        owned[s, r0:r1] += 1
    assert (owned == 1).all()


def test_lgamma_table_is_the_rounded_float64_value():
    """The table the kernels look up: 64 entries, lgamma(n + 1) in float64
    rounded to float32, bit for bit."""
    tab = tfp.lgamma_table()
    assert tab.shape == (64,) and tab.dtype == torch.float32
    n = torch.arange(64, dtype=torch.float64)
    assert torch.equal(tab, torch.lgamma(n + 1.0).to(torch.float32))
    assert float(tab[0]) == 0.0 and float(tab[1]) == 0.0
    np.testing.assert_allclose(float(tab[5]), np.log(120.0), rtol=1e-7)


def test_lgamma_table_agrees_with_the_stirling_series():
    """Against the series the kernels keep for every other x (the JAX
    package's ``_lgamma_xp1``), evaluated in float64: 2e-7 relative (the
    float32 rounding of the table; the series itself is exact to 1e-10
    there), with 1e-9 absolute for the two zeros, lgamma(1) and lgamma(2)."""
    n = np.arange(64, dtype=np.float64)
    series = np.asarray(jfp._lgamma_xp1(jnp.asarray(n)))
    assert series.dtype == np.float64
    np.testing.assert_allclose(tfp.lgamma_table().double().numpy(), series,
                               rtol=2e-7, atol=1e-9)


# ------------------------------------- ragged latent dimensions, float64
@pytest.mark.parametrize("log_transform", [False, True])
@pytest.mark.parametrize("latent", [20, 33])
def test_twin_at_ragged_latent_dims_f64(latent, log_transform):
    """K = 20 and K = 33 (not multiples of the kernels' k-step or tile) with
    B = 37, D = 130: the twin's combined value and its explicit gradients
    against the plain JAX reference and its autodiff in float64, 1e-9 (healthy
    data: no cell on the clip bound, so the reference's gradient is the
    unit-cotangent gradient of the sum)."""
    rng = np.random.default_rng(latent)
    Sr, Br, Dr = 2, 37, 130
    args = (rng.uniform(0.0, 0.5, (Sr, Br, latent)),
            rng.uniform(0.0, 0.1, (Sr, latent, Dr)),
            rng.uniform(0.05, 0.5, (Sr, 1, Dr)),
            rng.poisson(1.0, (Br, Dr)).astype(float),
            rng.uniform(0.5, 2.0, (1, Dr)))
    j = [jnp.asarray(a) for a in args]

    def ref(theta, v, phi):
        return jnp.sum(jfp.poisson_loglik_reference(
            theta, v, phi, j[3], j[4], log_transform=log_transform))

    val_j = jfp.poisson_loglik_reference(*j, log_transform=log_transform)
    grads_j = jax.grad(ref, argnums=(0, 1, 2))(*j[:3])
    ssum, cnt, gmin, *grads = tfp.stats_twin(
        *[torch.tensor(a) for a in args], log_transform=log_transform)
    assert ssum.dtype == torch.float64 and int(cnt.sum()) == 0
    np.testing.assert_allclose(_combine(ssum, cnt, gmin, torch.float64),
                               np.asarray(val_j), rtol=1e-9)
    for g, gj in zip(grads, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-9,
                                   atol=1e-9 * np.abs(gj).max())
