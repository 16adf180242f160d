"""The arithmetic of K5's tensor-core kernel (csrc/fused_expsum.cu), emulated
on the CPU: is a three-way split TF32 product accurate enough for the
tolerances the kernel is held to on the card?

The kernel's products run on ``mma.sync.m16n8k8`` with TF32 operands (10
explicit mantissa bits) and float32 accumulators. Each float32 operand x
splits as hi = cvt.rna.tf32.f32(x) and lo = cvt.rna.tf32.f32(x - hi), and
each product of a k-step of 8 is lo.hi + hi.lo + hi.hi, added to the
float32 accumulator in that order (the small terms first; lo.lo is
dropped). ``tf32_rna`` emulates cvt.rna (round to nearest, ties away from
zero, to 10 explicit mantissa bits) on the float32 bit pattern. The three
products are emulated in the kernel's order:
  decode  T = theta @ v, k-steps of 8 along the latent dimension;
  dtheta  += G @ v^T, k-steps of 8 along the columns, a fresh float32
          partial per 32 columns added into the sums in float32;
  dv      += theta^T @ G, k-steps of 8 along a block's 128 rows, each
          block's partial added in float32 (the kernel's atomics).
G = exp(T eta) eta in float32; R sums the float32 cells in float64.
Past K = 64 the kernel walks the latent dimension in chunks of 32 (the
wide kernel): the decode takes a fresh partial per chunk (4 k-steps) into
T in float32, and dtheta adds a column tile's two partials (32 columns
each) in float32 before adding them into its sums; dv is cut along the
latent dimension only, which leaves its arithmetic as it was.

Tolerances (the card's: tests/test_torch_gpu.py, chip_smoke.py phase 5):
R 1e-5 relative per sample, gradients 1e-4 of their largest entry, against
``expsum_twin`` in float64. A single TF32 pass (hi.hi only) fails them at
the larger loadings and barely meets them at the smaller ones, which is
why the kernel pays for three.

The tensor cores do not round their float32 accumulation to nearest: with
a truncating accumulator (``truncate``: the exact sum of the products and
the accumulator, rounded toward zero) a single dtheta accumulator over all
of D = 20,000 drifts 1.6e-4 low (such an accumulator on the card read
2.1e-4 at D = 19,997); the kernel's fresh partial per 32 columns reads
1.5e-6.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch
from _torch_split_tf32 import KSTEP, mma_steps, pad_to, split, tf32_rna

from spmf_tpu_torch.ops import fused_poisson as tfp

ROW_BLOCK, COL_TILE = 128, 64
PARTIAL = 4     # k-steps of dtheta's partial sums: half a column tile
WHOLE_K = 64    # past it the wide kernel, in chunks of PARTIAL k-steps


def emulated_expsum(theta, v, eta, passes=3):
    """(R (S,) float64, dtheta (S,B,K), dv (S,K,D)) as the kernel computes
    them, from float32 inputs: K padded with zeros to a multiple of 8, B to
    the row block, D to the column tile (padded cells are exact zeros)."""
    S, B, K = theta.shape
    D = v.shape[-1]
    th = pad_to(pad_to(theta, 2, KSTEP), 1, ROW_BLOCK)
    vv = pad_to(pad_to(v, 1, KSTEP), 2, COL_TILE)
    et = pad_to(eta.reshape(1, 1, D), 2, COL_TILE)
    wide = th.shape[-1] > WHOLE_K
    e = torch.exp(mma_steps(th, vv, passes,
                            partial=PARTIAL if wide else None) * et)
    e[:, B:, :] = 0.0
    e[:, :, D:] = 0.0
    g = e * et
    r = e.double().sum((1, 2))
    dth = mma_steps(g, vv.transpose(1, 2), passes, partial=PARTIAL,
                    group=2 if wide else 1)
    dv = torch.zeros(vv.shape, dtype=torch.float32)
    for r0 in range(0, th.shape[1], ROW_BLOCK):
        rows = slice(r0, r0 + ROW_BLOCK)
        dv = dv + mma_steps(th[:, rows].transpose(1, 2), g[:, rows], passes)
    return r, dth[:, :B, :K], dv[:, :K, :D]


def inputs(S, B, K, D, v_scale, seed):
    """chip_smoke.py's batches (stats_inputs) at a smaller size: theta in
    [0, 0.5), v in [0, v_scale), eta in [0.5, 2), float32, from numpy."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, (S, B, K)).astype(np.float32)
    v = (rng.uniform(0.0, 1.0, (S, K, D)) * v_scale).astype(np.float32)
    eta = rng.uniform(0.5, 2.0, (1, D)).astype(np.float32)
    return [torch.from_numpy(a) for a in (theta, v, eta)]


def errors(out, ref):
    """(R's largest relative error, the gradients' largest error relative
    to their largest entry)."""
    e_r = float(((out[0] - ref[0]).abs() / ref[0].abs()).max())
    e_g = max(float((o.double() - t).abs().max() / t.abs().max())
              for o, t in zip(out[1:], ref[1:]))
    return e_r, e_g


#: (S, B, K, D, v_scale): phase 5's main shape (K=32) and its ragged one (K=20,
#: B and D no multiples of the tiles, D % 4 != 0) cut to B <= 256, D <= 512,
#: at phase 5's loadings (0.05) and at the log-link rescue batches' (0.2:
#: exp(.) up to about 6); then the wide kernel at K = 128 and 256 at phase
#: W's loadings (0.05 min(1, sqrt(8 / K)))
CASES = [(2, 256, 32, 512, 0.05), (2, 200, 20, 499, 0.05),
         (2, 256, 32, 512, 0.2), (1, 131, 20, 509, 0.2),
         (2, 256, 128, 512, 0.05 * (8 / 128) ** 0.5),
         (2, 200, 256, 499, 0.05 * (8 / 256) ** 0.5)]


@pytest.mark.parametrize("S,B,K,D,v_scale", CASES)
def test_three_way_split_meets_the_kernel_tolerances(S, B, K, D, v_scale):
    theta, v, eta = inputs(S, B, K, D, v_scale, seed=B + K)
    ref = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    e_r, e_g = errors(emulated_expsum(theta, v, eta), ref)
    assert e_r < 1e-5 and e_g < 1e-4, (e_r, e_g)


@pytest.mark.parametrize("S,B,K,D,v_scale", CASES[2:4])
def test_a_single_tf32_pass_misses_them(S, B, K, D, v_scale):
    """At the rescue batches' loadings one pass (hi.hi) reads gradients
    1.6e-4 to 1.9e-4 off; at phase 5's it reads 8.7e-5 to 9.0e-5, within 15%
    of the bound, where three passes read 7e-7."""
    theta, v, eta = inputs(S, B, K, D, v_scale, seed=B + K)
    ref = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    e_r, e_g = errors(emulated_expsum(theta, v, eta, passes=1), ref)
    assert e_r > 1e-5 or e_g > 1e-4, (e_r, e_g)


@pytest.mark.parametrize("partial,ok", [(None, False), (PARTIAL, True)])
def test_dtheta_partials_under_a_truncating_accumulator(partial, ok):
    """dtheta over D = 20,000 columns (one sample, one row block, phase 5's
    loadings): one truncating accumulator over all of D drifts past the
    1e-4 tolerance; a fresh partial per 32 columns stays well inside it."""
    theta, v, eta = inputs(1, ROW_BLOCK, 32, 20000, 0.05, seed=3)
    g = torch.exp((theta @ v) * eta) * eta          # float32 G
    want = g.double() @ v.double().transpose(1, 2)
    got = mma_steps(g, v.transpose(1, 2), 3, partial=partial, truncate=True)
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert (err < 1e-5) if ok else (err > 1e-4), err


def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 explicit mantissa bits kept; a tie (bit 12 set, bits 0-11 clear)
    rounds away from zero for either sign; the split is exact to about
    2^-22 relative."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 0.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(10000)
                         .astype(np.float32))
    hi, lo = split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(hi, dtype=torch.int32))
    rel = ((hi.double() + lo.double() - y.double()).abs() / y.double().abs())
    assert float(rel.max()) < 2.0 ** -21
