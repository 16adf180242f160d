#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (spmf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines; any failure raises and exits non-zero:
  1 device   the card, its power limit, TF32 off
  2 build    nvcc builds csrc/*.cu (six libraries) for sm_90a, one process
             per source, at once
             (two threads meanwhile set up the small float64 CPU models of
             the plain path); a register spill in any library's build log
             fails the run
  3 K1/K2    fused Poisson kernel vs its twin (float64 on the card) at the
             main-path shape S=8, B=1024, D=20000, K=32, with and without a
             rescue batch, and at a ragged one (B=1000, K=20: no multiple of
             the row tile or the k-step), both links each
  4 K3f/K3b  fused IG sampler vs its float64 twin in its three modes
             (independent, antithetic, stratified) at total=1,400,064, S=8,
             and at a ragged total at S=6 and S=2, plus independent S=5
  5 K4/K5    row log-likelihood kernel (both links, and a rescue batch whose
             NaN rows must match) and exp-rate-sum kernel (split-TF32 tensor
             cores) vs their float64 twins at S=8, B=1024, D=20000, K=32 and
             at the ragged shape; two K4 launches give the same bits
  6 dense    PoissonFactorization(latent_dim=32, feature_dim=20000).fit(...)
             through the kernels, with launch counters, also with
             antithetic='stratified' at S=8 and S=4; one step at a small
             size checked against the plain float64 path on the same draws,
             and one stratified step on the same Philox and lattice draws
  7 sparse   scRNA-like counts (N=32768 x D=20000 at 3%), configured as the
             scRNA CLI does (log link, column means as norms); one epoch each
             of the blocked COO energy (K5), the flat COO energy (K5) and the
             dense scatter (K1), with launch counters and the dispatch
             record; the densify's scatter kernel (csrc/coo_scatter.cu) on
             a batch of the flat layout with its pad (B=4096) against its
             twin, bit for bit, timed beside the twin, zeros + scatter_add_
             and scatter_add_ with a sink slot for each pad slot; one
             blocked-COO step at a small size against the plain float64
             path on the same draws
  C 0.1%     the scRNA width at 0.1% density (N=32768 x D=20000, 655,360
             nonzeros expected), flat decode, log link: one epoch under the
             auto dispatch, which takes the COO energy (K5), and one with
             sparse_dense_scatter=True (K1)
  8 scoring  log_likelihood of 4096 held-out rows (100 samples) and
             waic(subsample='batch') through K4; the COO row log-likelihood
             at a small size against the plain float64 path
  K6 sampler fused Normal sampler (K6f/K6b) vs its float64 twin at
             total=1,340,000, S=8, with the Gaussian family's mask (u, v, w
             Identity, s Softplus) and an all-Softplus one; the KS distance
             of the recovered draws from N(0, 1); the replay backward against
             autograd through the twin
  lik        K1, K2 and K4 at 'bernoulli', ('normal', 1), 'poisson_softplus'
             and ('mixed', 1), both links, vs their float64 twins at S=8,
             B=1024, D=20000, K=32, plus a batch whose softplus rates
             underflow, and at the ragged shape
  A          the K6 path: the dense PoissonFactorization with
             surrogate.fused_normals = True, with launch counters; one small
             step against the plain float64 path on the same Philox draws;
             ms/step with and without fused_normals, interleaved, and the
             device time (profile) of the Normal block and its backward
             with and without it
  B          the families at full width (D=20000, K=32, S=8, B=4096):
             MixedFactorization (12000 poisson, 6000 bernoulli, 2000 normal
             columns; both clips; log_likelihood and waic through K4),
             BernoulliFactorization on binarised counts,
             GaussianFactorization(observation_model='normal') on
             standardised log counts with fused_normals = True; one small
             step per family against the plain float64 path
  P persist  the dense PoissonFactorization at full width (D=20000, K=32,
             S=8, B=4096, N=8192): fits with checkpoint_dir (files hold the
             returned params bit for bit) against fits without, in turn; a
             resume from the directory (the checkpoint's learning rate, the
             Adam count continued, tags above the old ones); a
             KeyboardInterrupt in the second epoch (the best params come
             back); save then load_model on the card (encode bit-equal);
             encode_batched of 16,384 rows in chunks of 4096 against encode;
             predictive_distribution at S=8, B=1024 against float64 on the
             same draws; surrogate_distribution.sample(250). Prints the
             checkpoint's bytes, ms a write, ms/step with and without
             checkpoints, encode_batched rows/s and the sample's ms
  G scan     the whole-epoch scan path (fit over a device-resident
             source; each batch's gather and step replayed from a CUDA
             graph): captured against eager bit for bit at float64 and at
             float32 through K1 and K3 (3 batches, a remainder, a plateau
             restore); at the dense scRNA width (B=4096, N=32768 resident)
             the captured scan, the eager scan twice, and the general loop
             over the same DeviceArrayDataset and over a host ArrayDataset,
             in turns; the 3% blocked, 3% flat dense-scatter and 0.1% flat
             sparse sets captured against epoch_scan=False; fused_normals on and off under
             capture. Each arm prints ms/step, rows/s, peak GB, and from a
             profiled turn its busy share and host launches a step.
             epoch_chunk: at the small size, captured chunks of 4 against
             captured single epochs and eager chunks, bit for bit at
             float64 and through K3 (1e-5 through K1); at the dense width
             26-epoch fits with epoch_chunk=1 and the default (2 singles,
             3 chunks of 8), with and without checkpoints, in turns, with
             device-to-host fetches an epoch and the checkpoints written;
             the 0.1% flat set in chunks of 4 against single epochs. The
             general loop over the host dataset with prefetch=2 against
             prefetch=0; a captured fit with profile_dir, whose trace must
             name the kernels
  AE         horshoe_plus=False at the scRNA width (D=20000, K=32, S=8,
             B=4096, 16,384 rows resident): fit on the captured scan through
             K1, then with fused_normals through K1 and K6, with launch
             counters, ms/step and a profiled turn; one small step each of
             PoissonFactorization and GaussianFactorization(observation_model=
             'normal') at horshoe_plus=False against the plain float64 path.
             The PoissonAutoencoder at its bench width (D=2000, latent 32,
             one encoder and one decoder layer, S=8, B=1024, 8192 rows
             resident): fits on the captured scan and the general loop, then
             with fused_normals (K6 over the 8,134,032-element Identity
             block, also held against its float64 twin at that total);
             ms/step, rows/s, peak GB, busy share, host launches a step; a
             profiler breakdown of one step (log_exp1 forward and backward,
             the matmuls; the prior, the network and the surrogate draw run
             alone; what the prior's autograd graph keeps); one small step
             (D=12, S=2) against the plain float64 path on the same Philox
             draws; save then load_model(data=..., device='cuda') with
             encode bit-equal, waic and a held-out log_likelihood
  O options  the engine options at the dense scRNA width (D=20000, K=32,
             S=8, B=4096, 16,384 rows resident, the captured scan), arms in
             turns with ms/step, rows/s, peak GB, busy share and host
             launches a step: the default, elbo_estimator='stl',
             aux_broadcast (K3 at S=1), gamma_sampler='exact',
             remat_sampling=True with 'fused' (K3 re-runs), with 'fused' and
             fused_normals (K3 and K6 re-run), with 'fast', and
             remat_sampling=False with 'fast'; remat on the captured scan
             against no remat on the eager scan (bit for bit through K3 and
             K6, 1e-5 through K1); K3 at S=1 against its float64 twin and
             its time beside S=8; the exact sampler over S x the IG block
             (KS distance from Gamma(a), gradient against the float64
             formula); one small STL step on shared draws and one small
             aux_broadcast step on the same Philox draws against the plain
             float64 path
  CLI        the entry points at full width: a synthetic 10x directory
             (8,192 cells x 24,000 genes at 3%) through
             preprocess_scrnaseq_counts (numpy backend, the native
             MatrixMarket parser, 20,000 top genes), factorize_scrnaseq_counts
             -d 32 -b 4096 -e 3 dense (the captured scan) and --sparse, and
             factorize_csv on an 8,192 x 500 CSV (the native CSV parser):
             parse and preprocessing times, ms/step, encode_batched rows/s,
             launches; every artifact of tests/test_cli.py, and the CSV
             run's model file reloaded with encode bit-equal
  M mesh     multi-rank training (spmf_tpu_torch.parallel): the
             one-process arms first, then this script run twice more with
             --mesh-rank as two gloo ranks on card 0 (a rank that exits
             non-zero or writes no result fails the run), then once with
             --nccl-check. (a) at phase 3's inputs, on dp=2 and fp=2: K1 /
             K2 on each rank's tile with the statistics combined over the
             ranks and K4 summed over fp, against the float64 twin on the
             full tile; K3 on the fp slices (seed base + fp index) bit for
             bit against per-slice calls. (b) at the dense width (B=4096,
             16,384 rows resident, 3 epochs): one process (twice, for the
             spread of K1's atomic sums), dp=2, fp=2 with 'fused' (the
             ranks' traces bit for bit, decreasing) and with 'fast', and
             fp=2 at horshoe_plus=False with fused_normals (K6 at full
             width, then sliced); each but fp=2 'fused' against one
             process at the same settings: losses within 1e-6 relative,
             and the first step's loss (1e-6) and gradients (1e-4 of each
             leaf's largest entry) at the initial parameters. (c) the 0.1%
             flat set, one epoch at dp=2 through the COO energy and K5,
             within 1e-6. (d) log_likelihood of 4096 held-out rows and waic
             at dp=2 through the sharded K4, within 1e-6. (e) NCCL at world
             size 1: the collectives on CUDA tensors. (f)-(i), each within
             1e-6 of one process (losses, and the first step's loss and
             gradients where taken): (f) the PoissonAutoencoder at its
             bench width (D=2000, B=1024, latent 32, 3 steps) on fp=2 with
             fused_normals, every w_l split, the forward column-parallel,
             K6 on each rank; (g) PoissonFactorization at D=19,999 on fp=2,
             3 steps: nothing split, K3 whole, no K1 (the fusion check's
             reason names ('fp',)); (h) the dense scan at dp=2 over 16,384
             + 1,025 rows at B=4096, the remainder whole on both ranks, K1
             on the full batches alone; (i) data_parallel_mesh(1) in the
             world of two: rank 0 trains as one process, rank 1's fit
             raises. Each arm: ms/step, peak GB and kernel launches per
             rank, the gradient all-reduce's ms and bytes a step, every
             collective's bytes a step; two ranks on one card are no
             scaling numbers
  EX         the six example modules (spmf_tpu_torch.examples) on the card,
             each over a host ArrayDataset through the general loop (the
             corpus through the CLIs' captured scan): the random-noise,
             linear and nonlinear examples at their full published size
             (N=50,000, D=30, the JAX scripts' steps and tolerances), each
             converged average-batch loss held to spmf_tpu's record
             (noise <= 40.60, linear <= 47.12 x 1.01, nonlinear <= 49.04 x
             1.01), the noise encoding's max |A| < 0.1, the linear
             example's signal / noise column mass > 10, every WAIC finite;
             simulation_figure (10,000 rows, 20 epochs), rnaseq_walkthrough
             (30 epochs) and corpus_walkthrough (20 epochs) reduced, each
             writing its artifacts with finite, falling losses. One line
             an example: loss, epochs, wall s, ms/step, launches, peak GB
             (above what was allocated when the example began)
  W wide     the latent dimensions past the whole-K kernels (K1/K2 past
             padded K=124, K4 and K5 past 64: the K-chunked kernels). (a)
             K1, K2 and K4 (both links) and K5 against their float64 twins
             at S=2, B=1000, D=19,997 for K = 65, 125, 128, 153, 256 and
             1024 (v scaled by min(1, sqrt(8 / K))), at the K=32
             tolerances; K4 also at the four other likelihoods (both
             links), twice for the same bits, and on a rescue batch (NaN
             rows at the twin's positions). (b) at S=8, B=4096, D=20000,
             K=128 and 256: kernel and twin times, registers, shared
             memory, blocks an SM, the bound (K1/K2, K4 and K5: the share
             of both routes' bounds, three TF32 passes and one FP32 pass).
             (c) at K=128 end to end:
             the dense captured-scan fit (16,384 rows resident, B=4096, 3
             epochs; ms/step, busy share, peak GB, launches) and a
             clip='static' epoch; one dense step through K1 and one COO step
             through K5 against the float64 plain path on the same draws;
             the 0.1% flat COO set two epochs through K5 (ms/step of the
             second); log_likelihood of the 4096 held-out rows through
             the wide K4, their per-row log-likelihood at 100 samples
             against the float64 plain path (1e-5), and log_likelihood at
             K=256
  9 times    kernel vs twin times and bounds; ms/step, rows/s, peak memory
             and a torch.profiler breakdown (device-busy share, device
             kernels per step, costliest kernels) of the dense and the three
             sparse steps, of the two 0.1% arms (with K5's ms a step), and of
             the dense S4 antithetic and S4 stratified arms; log_likelihood
             rows/s; K1 and K4 per likelihood and at B=32768, K5 at B=32768,
             with their registers, shared memory and blocks per SM;
             K3f / K3b and the twin in each mode, the bound per pipe, their
             registers, shared memory and blocks per SM; K6f / K6b with
             their bound per pipe (and on a Philox call a sample), registers
             and blocks per SM; the mixed step
Then the kernels as one JSON line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

S, D, K = 8, 20000, 32
IG_TOTAL = 2 * D * K + 2 * 2 * D + 2 * D + 2 * K  # u_eta(_a), s_eta(_a), ...
N_TOTAL = 2 * D * K + D + 2 * D                   # the Normal block: u, v, w, s
MIXED_COLUMNS = (("poisson", 12000), ("bernoulli", 6000), ("normal", 2000))
LIKELIHOODS = {"bernoulli": "bernoulli", "normal": ("normal", 1.0),
               "poisson_softplus": "poisson_softplus",
               "mixed": ("mixed", 1.0)}
N_SPARSE, DENSITY, B_SPARSE = 32768, 0.03, 4096
DENSITY_COO = 0.001   # under the auto dispatch's COO-energy bound (0.15%)
# Peak rates from NVIDIA's H100 SXM data sheet
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 494.7e12    # dense, on the tensor cores
# ... and per pipe, at the clock that data-sheet rate implies (128 float32
# multiply-adds a clock on each of 132 SMs): the special-function unit's
# transcendentals, 16 a clock and SM, and the 32-bit integer multiplies,
# 64 a clock and SM (CUDA programming guide, arithmetic instructions, 9.0)
SM_CLOCKS_PER_S = PEAK_F32_OPS_PER_S / 2 / 128
PEAK_FMA_PER_S = 128 * SM_CLOCKS_PER_S
PEAK_MUFU_PER_S = 16 * SM_CLOCKS_PER_S
PEAK_IMUL_PER_S = 64 * SM_CLOCKS_PER_S
IG_MODES = (False, True, "stratified")
#: the kernels with a K-chunked variant past their whole-K tiles (csrc/
#: fused_poisson_wide.cu, and K5's expsum_wide_kernel): their launches count
#: as "<kernel>_wide"
WIDE_KERNELS = ("stats", "static", "row_ll", "expsum")
#: phase G's and phase O's small scan: rows, columns, batch (3 full batches
#: and a remainder)
SMALL_SCAN = (350, 300, 100)
#: phase O's resident rows and batch at the dense width
OPT_ROWS, OPT_BATCH = 16384, 4096
#: phase CLI's synthetic 10x matrix (3% nonzero: 720 genes a cell), its
#: top genes kept and the fits' batch
CLI_CELLS, CLI_GENES, CLI_TOP, CLI_BATCH = 8192, 24000, 20000, 4096
#: phase EX: the converged average-batch loss each convergence example must
#: reach, from spmf_tpu's records in examples/artifacts/README.md (one-sided:
#: the two packages' draws differ; noise: tests/test_parity.py's bound)
EX_LOSS_LIMITS = {"factorizing_random_noise": 40.60,
                  "factorize_linear_structure": 47.12 * 1.01,
                  "factorize_nonlinear_structure": 49.04 * 1.01}
#: ... and the reduced sizes of the other three (the JAX defaults: 50,000
#: rows and 100 epochs; 100 epochs; 80 epochs)
EX_REDUCED = {"simulation_figure": ["--rows", "10000", "--steps", "20"],
              "rnaseq_walkthrough": ["--steps", "30"],
              "corpus_walkthrough": ["--steps", "20"]}


_START = time.perf_counter()
_PHASE = [None]


def say(phase, msg):
    if phase != _PHASE[0]:   # where the script's time goes, phase by phase
        _PHASE[0] = phase
        print(f"[{phase}] begins {time.perf_counter() - _START:.1f} s after "
              f"the start", flush=True)
    print(f"[{phase}] {msg}", flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_max(a, b):
    """max |a - b| / max |b| (the 'of max-abs' tolerance)."""
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def rel_elem(a, b):
    """max elementwise |a - b| / |b|."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def abs_max(pairs):
    return max(float((k.double() - t.double()).abs().max()) for k, t in pairs)


def cuda_ms(fn, iters=10, warmup=2):
    """Median ms of ``fn`` over ``iters`` runs, CUDA events, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def bound(n_bytes, n_ops):
    """(ms, 'bytes' | 'operations'): the least time for the work at the
    card's published peaks, 3.35 TB/s and 67 TFLOP/s float32 outside the
    tensor cores (every operation counted at that rate)."""
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_o = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bounds(B, total, n_total, k=K, s=S, d=D):
    """Per-kernel bounds at the timed shapes (S=8, D=20000 and K=32 unless
    ``s``, ``d`` and ``k`` say otherwise; B rows for the Poisson kernels,
    ``total`` elements for the IG sampler, ``n_total`` for the Normal
    sampler). Bytes: each
    input read once, each output written once, float32. Operations: the
    K-deep products, 2 per multiply-add (decode, dv and dtheta for K1/K2/K5;
    the decode for K4), plus one per transcendental or division of a cell
    and sample at the timed link (K1/K2, identity: log and x/rate; K4, log
    link: exp and log; K5: exp), plus lgamma(x+1)'s 3 logs and 1 reciprocal
    once per cell of x for K1/K2 and K4 (it does not depend on the sample:
    the least any implementation must do); for
    K3 and K6 the least work per pipe (``ig_bound``, independent mode, and
    ``normal_bound``). K5: ``expsum_bound``'s tensor route; K1/K2 and K4:
    ``stats_bound``'s and ``row_ll_bound``'s route of the kernel that runs
    at k (the tensor route past the whole-K kernels, the FP32 one within
    them)."""
    from spmf_tpu_torch.ops import fused_poisson as tfp

    def route(kind):
        # split-TF32 tensor cores past the whole-K kernels
        return ("tf32x3" if tfp.launch_geometry(kind, s, B, k, d).chunks > 1
                else "fp32")

    k1 = stats_bound(B, k, s, d)[route("stats")][:2]
    out = {"stats": k1, "static": k1,
           "row_ll": row_ll_bound(B, k, s, d)[route("row_ll")][:2],
           "expsum": expsum_bound(B, k, s, d)["tf32x3"][:2],
           "fwd": ig_bound("fwd", total, S, False)[:2],
           "bwd": ig_bound("bwd", total, S, False)[:2],
           "nfwd": normal_bound("fwd", n_total, S)[:2],
           "nbwd": normal_bound("bwd", n_total, S)[:2]}
    return out


def stats_bound(B, k=K, s=S, d=D):
    """K1/K2's least time at B rows (S=8, D=20000, K=32 unless ``s``,
    ``d`` and ``k`` say otherwise) by route, as ``expsum_bound``: 'tf32x3',
    the products (6 S B D K flops: decode, dtheta, dv) as three TF32 passes
    on the tensor cores at 494.7 TFLOP/s (the route of the K-chunked kernel
    past the whole-K tiles), against the transcendentals at the timed
    identity link (log and x / rate a cell and sample, lgamma's 3 logs and a
    reciprocal once a cell of x; 16 a clock and SM); 'fp32', ``bound``'s
    count: the products once on the FP32 pipes at 67 TFLOP/s, with 2
    operations a cell and sample and lgamma's 4 a cell of x. Bytes: theta,
    v, phi, eta and x read, dtheta, dv, dphi and the sums written."""
    cells = s * B * d
    flops = 6 * k * cells
    n_bytes = 4 * (2 * s * B * k + 2 * s * k * d + 2 * s * d + B * d + d)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    pipe, t_o = max((("tensor cores, 3 TF32 passes",
                      3 * flops / PEAK_TF32_OPS_PER_S * 1e3),
                     ("transcendentals",
                      (2 * cells + 4 * B * d) / PEAK_MUFU_PER_S * 1e3)),
                    key=lambda p: p[1])
    fp32 = bound(n_bytes, cells * (6 * k + 2) + 4 * B * d)
    return {"tf32x3": (t_o, "operations", pipe) if t_o >= t_b
            else (t_b, "bytes", "memory"),
            "fp32": fp32 + ("FP32 pipes" if fp32[1] == "operations"
                            else "memory",)}


def row_ll_bound(B, k=K, s=S, d=D):
    """K4's least time at B rows (S=8, D=20000, K=32 unless ``s``, ``d``
    and ``k`` say otherwise) by route, as ``expsum_bound``: 'tf32x3', the
    decode (2 S B D K flops) as three TF32 passes on the tensor cores at
    494.7 TFLOP/s (the route of the wide kernel past K = 64), against the
    transcendentals at the timed log link (exp and log a cell and sample,
    lgamma's 3 logs and a reciprocal once a cell of x; 16 a clock and SM);
    'fp32', ``bound``'s count: the decode once on the FP32 pipes at 67
    TFLOP/s, with 2 operations a cell and sample and lgamma's 4 a cell of x
    (the whole-K kernel's route). Bytes: theta, v, phi, eta and x read, the
    row sums written."""
    cells = s * B * d
    flops = 2 * k * cells
    n_bytes = 4 * (s * B * k + s * k * d + s * d + B * d + d + s * B)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    pipe, t_o = max((("tensor cores, 3 TF32 passes",
                      3 * flops / PEAK_TF32_OPS_PER_S * 1e3),
                     ("transcendentals",
                      (2 * cells + 4 * B * d) / PEAK_MUFU_PER_S * 1e3)),
                    key=lambda p: p[1])
    fp32 = bound(n_bytes, flops + 2 * cells + 4 * B * d)
    return {"tf32x3": (t_o, "operations", pipe) if t_o >= t_b
            else (t_b, "bytes", "memory"),
            "fp32": fp32 + ("FP32 pipes" if fp32[1] == "operations"
                            else "memory",)}


def expsum_bound(B, k=K, s=S, d=D):
    """K5's least time at B rows (S=8, D=20000, K=32 unless ``s``, ``d``
    and ``k`` say otherwise) by route: (ms,
    'bytes' | 'operations', what bounds it). 'tf32x3': its products (6 S B
    D K flops: decode, dtheta, dv) as three TF32 passes on the tensor cores
    at 494.7 TFLOP/s, the float32 accuracy its kernel buys with the split,
    against the exps (one special-function operation a cell and sample, 16
    a clock and SM); 'fp32': the products once on the FP32 pipes at 67
    TFLOP/s with an operation per exp (how ``bound`` counted K5 before it
    moved to the tensor cores). Bytes: theta, v and eta read, dtheta, dv
    and S sums written."""
    cells = s * B * d
    flops = 6 * k * cells
    n_bytes = 4 * (2 * s * B * k + 2 * s * k * d + d + s)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    pipe, t_o = max((("tensor cores, 3 TF32 passes",
                      3 * flops / PEAK_TF32_OPS_PER_S * 1e3),
                     ("transcendentals", cells / PEAK_MUFU_PER_S * 1e3)),
                    key=lambda p: p[1])
    fp32 = bound(n_bytes, flops + cells)
    return {"tf32x3": (t_o, "operations", pipe) if t_o >= t_b
            else (t_b, "bytes", "memory"),
            "fp32": fp32 + ("FP32 pipes" if fp32[1] == "operations"
                            else "memory",)}


def ig_bound(kind, total, n_samples, antithetic):
    """(ms, 'bytes' | 'operations', what bounds it) of K3f (``'fwd'``) or
    K3b (``'bwd'``) at ``total`` elements and ``n_samples`` samples in a
    mode: the least work of each pipe at that pipe's rate, the slowest pipe
    (or the bytes) bounding.
    Integer multiplies: 120 a Philox stream (3 calls of 10 rounds, 2 mul.hi
    and 2 mul.lo each); a stream per sample (independent), per pair
    (antithetic) or per element (stratified).
    Transcendentals, one special-function operation each: per sample the 8
    logs of the boost uniforms, exp(s1), log g, exp(-x), and log1p and 1/g
    in the forward, 1/g, 1/(1 + exp(-x)) and 1/max(c, 0.05) in the
    backward; one erfinv per draw (the mirror negates it); per element 12
    in the forward (log b, lgamma, the 8 weights, sqrt, 1/(9(a+8))) and 20
    in the backward (log b, digamma's log and up to 6 reciprocals, the 8
    weights, sqrt and the other reciprocals).
    Float32 operations: 45 per sample in the forward (the uniforms, the
    Stuart sum, the cube, the softplus pair, log q), 60 in the backward
    (also s2 and the derivatives); the transcendentals' polynomials are not
    counted.
    Bytes: a and b read and y written (forward); a, b and the cotangent gy
    read and ga, gb written (backward)."""
    S_ = n_samples
    mode = IG_MODES.index(antithetic)
    streams = (S_, S_ / 2, 1)[mode]
    draws = S_ if mode == 0 else S_ / 2
    if kind == "fwd":
        mufu, fma = 13 * S_ + draws + 12, 45 * S_
        n_bytes = 4 * (2 * total + S_ * total) + 8 * S_
    else:
        mufu, fma = 14 * S_ + draws + 20, 60 * S_
        n_bytes = 4 * (4 * total + S_ * total + S_)
    times = {"integer multiplies": 120 * streams * total / PEAK_IMUL_PER_S,
             "transcendentals": mufu * total / PEAK_MUFU_PER_S,
             "float32": fma * total / PEAK_FMA_PER_S}
    pipe = max(times, key=times.get)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    if t_b >= times[pipe] * 1e3:
        return t_b, "bytes", "memory"
    return times[pipe] * 1e3, "operations", pipe


def normal_bound(kind, total, n_samples, samples_per_call=4):
    """(ms, 'bytes' | 'operations', what bounds it) of K6f (``'fwd'``) or
    K6b (``'bwd'``) at ``total`` elements and ``n_samples`` samples, counted
    per pipe as ``ig_bound`` counts K3.
    Integer multiplies: 40 a Philox call (10 rounds, 2 mul.hi and 2 mul.lo
    each), ceil(S / samples_per_call) calls an element: 4 samples a call
    on the stream of csrc/fused_normal.cu, 1 on the stream before it.
    Transcendentals, one special-function operation each: per sample the
    erfinv (its log), exp(-|x|) and log1p (forward) or 1/(1 + exp(-|x|))
    (backward); per element softplus(raw_scale)'s exp and log1p and log
    scale (forward), or those two, 1/(1 + exp(-|rs|)) and 1/scale
    (backward).
    Float32 operations: 15 per sample each way (the uniform, x, the softplus
    pair or the sigmoid, log q or the cotangent sums); the transcendentals'
    polynomials are not counted.
    Bytes: loc, raw_scale and mask read and y and lq written (forward);
    those three, gy and glq read and gloc, graw_scale written (backward)."""
    S_ = n_samples
    calls = -(-S_ // samples_per_call)
    if kind == "fwd":
        mufu = 3 * S_ + 3
        n_bytes = 4 * (3 * total + S_ * total + S_)
    else:
        mufu = 3 * S_ + 4
        n_bytes = 4 * (3 * total + S_ * total + S_ + 2 * total)
    times = {"integer multiplies": 40 * calls * total / PEAK_IMUL_PER_S,
             "transcendentals": mufu * total / PEAK_MUFU_PER_S,
             "float32": 15 * S_ * total / PEAK_FMA_PER_S}
    pipe = max(times, key=times.get)
    t_b = n_bytes / PEAK_BYTES_PER_S * 1e3
    if t_b >= times[pipe] * 1e3:
        return t_b, "bytes", "memory"
    return times[pipe] * 1e3, "operations", pipe


#: a full-width shape no tile divides: B is no multiple of the kernels' row
#: tile (128) and the latent dimension none of their k-step (4, padded: 20
#: is one, so the k-groups of the products are 5, not a power of two)
B_RAGGED, K_RAGGED = 1000, 20


def stats_inputs(B, dev, seed=0, rescue=False, k=K, s=S, d=D, v_scale=1.0):
    """theta (s, B, k) in [0, 0.5), v (s, k, d) in [0, 0.05 v_scale), phi,
    Poisson(1) counts x (B, d) and eta (1, d)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    theta = torch.rand(s, B, k, generator=g, device=dev) * 0.5
    v = torch.rand(s, k, d, generator=g, device=dev) * (0.05 * v_scale)
    phi = torch.rand(s, 1, d, generator=g, device=dev) * 0.5 + 0.05
    x = torch.poisson(torch.ones(B, d, device=dev), generator=g)
    eta = torch.rand(1, d, generator=g, device=dev) * 1.5 + 0.5
    if rescue:
        phi[:, :, ::37] = -5.0   # negative rates: NaN cells the clip replaces
    return theta, v, phi, x, eta


def mixed_codes(dev):
    """The (1, D) codes lane of MIXED_COLUMNS, three contiguous blocks."""
    import torch

    from spmf_tpu_torch.ops import fused_poisson as tfp

    code_of = {"poisson": tfp.CODE_POISSON, "bernoulli": tfp.CODE_BERNOULLI,
               "normal": tfp.CODE_NORMAL}
    return torch.cat([torch.full((n,), code_of[t]) for t, n in MIXED_COLUMNS]
                     )[None].to(dev)


def likelihood_x(name, n, dev, g):
    """n x D observations for a likelihood: Poisson(1) counts, binarised for
    'bernoulli', standard normals for 'normal', and the three column blocks
    of MIXED_COLUMNS for 'mixed'."""
    import torch

    from spmf_tpu_torch.ops import fused_poisson as tfp

    counts = torch.poisson(torch.ones(n, D, device=dev), generator=g)
    if name in ("poisson", "poisson_softplus"):
        return counts
    if name == "bernoulli":
        return counts.clamp_max(1.0)
    real = torch.randn(n, D, generator=g, device=dev)
    if name == "normal":
        return real
    codes = mixed_codes(dev)
    return torch.where(codes == tfp.CODE_BERNOULLI, counts.clamp_max(1.0),
                       torch.where(codes == tfp.CODE_NORMAL, real, counts))


def likelihood_inputs(name, B, dev, seed=0, rescue=False, k=K):
    """stats_inputs for the other likelihoods: signed operands (the rate is a
    logit or a location) and observations from ``likelihood_x``; the codes
    lane for 'mixed', else None. ``rescue``: rates of -2000 in every 37th
    column, whose softplus underflows to 0 in either precision (clipped
    cells under a softplus link, large finite values elsewhere)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    theta = torch.randn(S, B, k, generator=g, device=dev) * 0.1
    v = torch.randn(S, k, D, generator=g, device=dev) * 0.1
    phi = torch.randn(S, 1, D, generator=g, device=dev) * 0.3
    eta = torch.rand(1, D, generator=g, device=dev) * 1.5 + 0.5
    x = likelihood_x(name, B, dev, g)
    if rescue:
        phi[:, :, ::37] = -2000.0
    return (theta, v, phi, x, eta), (mixed_codes(dev) if name == "mixed"
                                     else None)


def ks_distance(eps):
    """Kolmogorov-Smirnov distance of a flat float64 tensor from N(0, 1)."""
    import torch

    n = eps.numel()
    cdf = 0.5 * (1.0 + torch.erf(torch.sort(eps).values / 2.0 ** 0.5))
    i = torch.arange(n, dtype=torch.float64, device=eps.device)
    return float(torch.maximum((cdf - i / n).abs(),
                               (cdf - (i + 1) / n).abs()).max())


def sparse_counts(n, d, density, seed, dev):
    """A SparseCounts of n x d counts, 1 + Poisson(1) at a ``density``
    share of cells chosen uniformly, drawn on the card from ``seed``; and
    its column means (zero columns as 1, as the scRNA CLI does)."""
    import torch

    from spmf_tpu_torch.data import SparseCounts

    g = torch.Generator(device=dev).manual_seed(seed)
    rows, cols, vals = [], [], []
    colsum = torch.zeros(d, dtype=torch.float64, device=dev)
    for r0 in range(0, n, 4096):
        m = min(4096, n - r0)
        r, c = (torch.rand(m, d, generator=g, device=dev) < density).nonzero(
            as_tuple=True)
        val = 1.0 + torch.poisson(torch.ones(r.numel(), device=dev),
                                  generator=g)
        colsum.index_add_(0, c, val.double())
        rows.append((r + r0).cpu())
        cols.append(c.cpu())
        vals.append(val.cpu())
    rows = torch.cat(rows).numpy()
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    sp = SparseCounts(indptr, torch.cat(cols).numpy(),
                      torch.cat(vals).numpy(), (n, d))
    means = (colsum / n).cpu().numpy()[None, :]
    return sp, np.where(means > 0, means, 1.0)


def lognormal_samples(model, n, seed):
    """Positive values of every surrogate variable's shape with a leading
    axis of n, from numpy (valid inputs to any energy or scorer)."""
    rng = np.random.default_rng(seed)
    return {k: rng.lognormal(-1.0, 0.5, (n,) + tuple(s.shape))
            for k, s in model._surrogate.surrogates.items()}


def perturbed_init(model, seed):
    from spmf_tpu_torch.utils import params_to_numpy

    rng = np.random.default_rng(seed)
    return {n: {k: v + 0.1 * rng.standard_normal(v.shape)
                for k, v in sub.items()}
            for n, sub in params_to_numpy(model.surrogate_params).items()}


def numpy_draws(model, seed):
    """Base draws of one sample_and_log_prob call (the WH 'fast' sampler's
    normals and uniforms), from numpy, so that two models draw alike."""
    rng = np.random.default_rng(seed)
    sur = model._surrogate
    tot_n = sum(sur._sizes[n] for n in sur._normal_names)
    tot_g = sum(sur._sizes[n] for n in sur._ig_names)
    return {"normal_eps": rng.standard_normal((S, tot_n)),
            "ig_eps": rng.standard_normal((S, tot_g)),
            "ig_u": rng.uniform(1e-6, 1.0, (8, S, tot_g))}


def philox_draws(model, seed, dev, stratified=False, sample_size=S):
    """The base draws that one sample_and_log_prob call of a model with both
    fused samplers makes from a generator seeded with ``seed`` on ``dev``
    (the Normal block's Philox seed is drawn first, then the IG block's), in
    float64, in the form the plain samplers take: K6's standard normals,
    and K3's eps and 8 uniforms for the WH 'fast' sampler. ``stratified``:
    those of antithetic='stratified', where the Normal block draws its
    lattice's base integers from the generator (K6 takes no antithetic
    mode) and K3 its stratified stream. ``sample_size`` samples. With
    aux_broadcast (every IG variable broadcast) K3 draws the IG block once,
    at S=1, as ``bc_ig_eps`` / ``bc_ig_u``."""
    import torch

    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops import fused_normal as tfn
    from spmf_tpu_torch.ops.gamma import lattice_uniform

    g = torch.Generator(device=dev).manual_seed(seed)
    sur = model._surrogate
    tot_n = sum(sur._sizes[n] for n in sur._normal_names)
    tot_g = sum(sur._sizes[n] for n in sur._ig_names)
    broadcast = bool(sur.broadcast_names)
    check(not broadcast or (set(sur._ig_names) == set(sur.broadcast_names)
                            and not stratified),
          "philox_draws: a broadcast block other than the whole IG block")
    f64 = torch.float64
    half = sample_size // 2
    if stratified:
        base = torch.randint(0, 1 << 23, (tot_n,), generator=g,
                             dtype=torch.int64, device=dev)
        eps_h = torch.special.ndtri(lattice_uniform(None, half, (tot_n,),
                                                    f64, device=dev,
                                                    bits=base))
        normal_eps = torch.cat([eps_h, -eps_h])
    seeds = [int(torch.randint(0, 2**31 - 1, (1,), generator=g,
                               dtype=torch.int32, device=dev))
             for _ in range(1 if stratified else 2)]
    if stratified:
        u = torch.stack([tig.uniforms(tot_g, 0, seeds[0], f64, dev,
                                      pair=s % half, half=half)
                         for s in range(sample_size)], dim=1)  # (9, S, tot_g)
        u[:, half:] = 1.0 - u[:, half:]
    else:
        u = torch.stack([tig.uniforms(tot_g, s, seeds[1], f64, dev)
                         for s in range(1 if broadcast else sample_size)],
                        dim=1)
        normal_eps = torch.stack([tfn.draw_eps(tot_n, s, seeds[0], f64, dev)
                                  for s in range(sample_size)])
    if broadcast:
        return {"normal_eps": normal_eps.cpu().numpy(),
                "bc_ig_eps": (2.0 ** 0.5 * torch.erfinv(2.0 * u[0, 0] - 1.0)
                              ).cpu().numpy(),
                "bc_ig_u": u[1:, 0].cpu().numpy()}
    return {"normal_eps": normal_eps.cpu().numpy(),
            "ig_eps": (2.0 ** 0.5 * torch.erfinv(2.0 * u[0] - 1.0)
                       ).cpu().numpy(),
            "ig_u": u[1:].cpu().numpy()}


def step_grads(model, p0, batch, draws, generator=None, antithetic=False,
               sample_size=S, stl=False):
    """(loss, flat gradients) of one ELBO step of ``model`` from params p0
    on ``batch`` with injected base draws, or with ``generator``'s;
    ``stl``: log q at the parameters detached (elbo_estimator='stl')."""
    import torch

    from spmf_tpu_torch.utils import params_from_numpy
    from spmf_tpu_torch.vi.minibatch import elbo_loss

    params = params_from_numpy(p0, model.device, model.dtype)
    for sub in params.values():
        for t in sub.values():
            t.requires_grad_(True)
    def draw(p, j):
        stopped = {n: {k: t.detach() for k, t in sub.items()}
                   for n, sub in p.items()}
        return model._surrogate.sample_and_log_prob(
            p, generator, (sample_size,), antithetic=antithetic, draws=draws,
            logq_params=stopped if stl else None)

    loss = elbo_loss(model._surrogate, model._energy, params, batch,
                     generator, sample_size, draw=draw)
    loss.backward()
    grads = torch.cat([t.grad.reshape(-1).double().cpu()
                       for sub in params.values() for t in sub.values()])
    return float(loss.detach()), grads


def step_timer(model, batch, sample_size=S, antithetic=False):
    """A function running one full training step (sample, energy, backward,
    clip, Adam) of ``model`` on ``batch`` from a copy of its params."""
    import torch

    from spmf_tpu_torch.vi.minibatch import (clip_and_step, elbo_loss,
                                             make_optimizer)

    params = {n: {k: t.clone().requires_grad_(True) for k, t in sub.items()}
              for n, sub in model.surrogate_params.items()}
    opt = make_optimizer(params, 0.01)
    gen = torch.Generator(device=model.device).manual_seed(0)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = elbo_loss(model._surrogate, model._energy, params, batch, gen,
                         sample_size, antithetic=antithetic)
        loss.backward()
        clip_and_step(opt, 5.0)

    return step


def normal_block_step(model, fused):
    """A function drawing the Normal block (u, v, w, s) of ``model``'s
    surrogate S times, with and without the fused sampler K6, and running
    its backward: the draw, the transform, log q and their gradients, what
    ``fused_normals`` changes in a step."""
    import torch

    sur = model._surrogate
    names = sur._normal_names
    params = {n: {k: t.clone().requires_grad_(True)
                  for k, t in model.surrogate_params[n].items()}
              for n in names}
    leaves = [t for sub in params.values() for t in sub.values()]
    gen = torch.Generator(device=model.device).manual_seed(0)
    cot = []

    def step():
        sur.fused_normals = fused
        values, logq = sur._sample_normals(names, params, gen, (S,))
        outs = [values[n] for n in names] + [logq]
        if not cot:
            cot.extend(torch.ones_like(o) for o in outs)
        for t in leaves:
            t.grad = None
        torch.autograd.backward(outs, cot)

    return step


def time_steps(step, n=13, skip=3):
    """Median wall ms of ``step`` (synchronised) and the peak device memory
    in GB over the run."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= skip:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 1e9


def profile_steps(step, n=5):
    """torch.profiler over ``n`` steps after one warm-up: (wall ms/step,
    device-busy ms/step, the six costliest device kernels as (name,
    ms/step), device kernels launched per step, {kernel name: ms/step},
    {host op: ms/step of the device kernels it launched, its children's
    included}); busy is None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def dev_total_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    # device-side events only: a CPU op (an autograd Function, aten::bmm)
    # also reports the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3 / n
    top = sorted(events, key=dev_us, reverse=True)[:6]
    count = sum(e.count for e in events) / n
    ops = {e.key: dev_total_us(e) / 1e3 / n for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and dev_total_us(e) > 0}
    return wall, (busy or None), [(e.key[:70], dev_us(e) / 1e3 / n)
                                  for e in top], count, {
        e.key: dev_us(e) / 1e3 / n for e in events}, ops


def say_profile(tag, prof, smi):
    wall, busy, top, count = prof[:4]
    share = f"{busy:.2f} ms/step busy ({busy / wall:.1%})" if busy else \
        "device time not measured (the profiler saw none)"
    say(9, f"profile {tag}: {wall:.2f} ms/step wall, {share}, {count:.0f} "
           f"device kernels a step; top "
           + "; ".join(f"{k} {ms:.2f} ms" for k, ms in top) + f" ({smi})")


def epoch_windows(prof, names=("fit epoch",), skip=1):
    """From a torch.profiler run over a fit: (wall ms, device-busy ms, host
    launches, device kernels, device-to-host copies, and busy ms and copies
    attributed by the host call that issued them) summed over the engine's
    ``names`` ranges ("fit epoch" a single epoch, "fit chunk" a chunk)
    after the first ``skip`` (the first holds the capture). Host
    launches are the CUDA runtime's kernel and graph launch calls; busy is
    the device events' time, None when the profiler saw none. Reads the
    profiler's raw events: building its FunctionEvents takes minutes for
    the 10^5 kernels of a 26-epoch fit."""
    import bisect

    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()

    def ns(e, what):
        f = getattr(e, what + "_ns", None)
        return f() if f is not None else getattr(e, what + "_us")() * 1000

    # the host's ranges (the profiler mirrors each on the device timeline)
    wins = sorted((ns(e, "start"), ns(e, "start") + ns(e, "duration"))
                  for e in events if e.name() in names
                  and e.device_type() == DeviceType.CPU)[skip:]
    starts = [a for a, _ in wins]

    def inside(e):
        i = bisect.bisect_right(starts, ns(e, "start")) - 1
        return i >= 0 and ns(e, "start") < wins[i][1]

    launches = Counter(e.name() for e in events
                       if e.device_type() == DeviceType.CPU
                       and "Launch" in e.name() and e.name().startswith("cu")
                       and inside(e))
    dev_events = [e for e in events if e.device_type() == DeviceType.CUDA
                  and e.name() not in names and inside(e)]
    busy = sum(ns(e, "duration") for e in dev_events) / 1e6
    wall = sum(b - a for a, b in wins) / 1e6
    # the same read by the host call that issued each device event (the
    # runtime call and its device work share a correlation id): immune to
    # an offset between the two clocks, which a virtualised host's
    # profiler may show, and which (device start - host call start) of
    # the copies to the host measures
    calls = {e.correlation_id(): ns(e, "start") for e in events
             if e.device_type() == DeviceType.CPU and e.correlation_id()
             and e.name().startswith("cu") and inside(e)}
    issued = [e for e in events if e.device_type() == DeviceType.CUDA
              and e.correlation_id() in calls]
    copies = [e for e in issued if "DtoH" in e.name()]
    offsets = sorted(ns(e, "start") - calls[e.correlation_id()]
                     for e in copies)
    by_call = {"busy": sum(ns(e, "duration") for e in issued) / 1e6,
               "fetches": len(copies),
               "offset_ms": (offsets[len(offsets) // 2] / 1e6 if offsets
                             else None)}
    fetches = sum("DtoH" in e.name() for e in dev_events)
    return wall, (busy or None), launches, len(dev_events), fetches, by_call


def clone_params(params):
    return {n: {k: t.clone() for k, t in sub.items()}
            for n, sub in params.items()}


def run_fit(m, init, data, capture=True, profiled=False, windows=None,
            first=1, **kw):
    """One fit of ``m`` from ``init`` over ``data``: (losses, ms/step of
    the epochs from ``first`` on (0-based), peak GB, epoch_windows or None,
    whether the scan ran, the FitResult, the fit's wall s). ``capture``:
    the scan's CUDA graphs (False runs the scan eagerly); ``windows``: the
    ``names`` and ``skip`` of epoch_windows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spmf_tpu_torch.vi import epoch_scan

    epoch_scan._CAPTURE = capture
    m.surrogate_params = clone_params(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(dict(learning_rate=0.01, sample_size=S, rel_tol=None,
                   verbose=False, seed=0), **kw)
    prof = None
    t_fit = time.perf_counter()
    try:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                losses = m.fit(batched_data_factory=data, **kw)
                torch.cuda.synchronize()
        else:
            losses = m.fit(batched_data_factory=data, **kw)
    finally:
        epoch_scan._CAPTURE = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_fit
    r = m.last_fit
    steps = steps_of(data)
    ms = float(np.median(r.extras["epoch_seconds"][first:])) / steps * 1e3
    win = (epoch_windows(prof, **(windows or {})) if prof is not None
           else None)
    return (losses, ms, torch.cuda.max_memory_allocated() / 1e9, win,
            r.extras["epoch_scan"], r, wall)


def steps_of(data):
    """Steps an epoch of a batched dataset."""
    from spmf_tpu_torch.data import ArrayDataset, DeviceArrayDataset

    bs = data._batch_size
    if getattr(data, "block_rows", None):
        return data.n_blocks // (bs // data.block_rows)
    if isinstance(data, (ArrayDataset, DeviceArrayDataset)) and not \
            data._drop_remainder:
        return -(-data.num_rows // bs)
    return data.num_rows // bs


def report_arm(phase, smi, tag, rows, ms, peak, win, steps):
    """Print one fit arm: ms/step, rows/s, peak GB and, from a profiled
    turn's epoch_windows, the busy share, host launches and device kernels
    a step."""
    if win is None:
        prof_part = "not profiled"
    else:
        wall, busy, launches, kernels = win[:4]
        n = steps
        share = (f"busy {busy / n:.2f} ms/step ({busy / wall:.1%} of "
                 f"the profiled wall)" if busy else
                 "device time not measured")
        names = ", ".join(f"{k} {v / n:.2f}"
                          for k, v in launches.most_common(3))
        prof_part = (f"{share}, {sum(launches.values()) / n:.2f} host "
                     f"launches a step ({names}), {kernels / n:.0f} "
                     "device kernels a step")
    say(phase, f"{tag}: {ms:.2f} ms/step, {rows / ms * 1e3:.0f} rows/s, "
               f"peak {peak:.2f} GB; {prof_part} ({smi})")


def scan_phase(dev, smi, zero_launches, read_launches, sparse_arms):
    """Phase G: the whole-epoch scan path (a device-resident source; each
    batch's gather and step replayed from a CUDA graph). The captured scan
    against the same scan run eagerly, bit for bit at float64 (the plain
    path) and at float32 through K1 and K3 at one row tile, across plateau
    restores and a remainder batch; at the dense scRNA width the captured
    scan, the eager scan (twice: the spread of K1's atomic sums) and the
    general loop over the same DeviceArrayDataset and over a host
    ArrayDataset, in turns; the two sparse configurations (``sparse_arms``:
    tag -> a model bound to its DeviceSparseCounts) captured against
    ``epoch_scan=False``; and ``fused_normals`` on and off under capture.
    Each arm prints ms/step, rows/s, peak GB, and from a profiled turn its
    busy share and host launches a step. Returns the kernel launches."""
    import torch

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset, DeviceArrayDataset
    from spmf_tpu_torch.vi import epoch_scan

    t_phase = time.perf_counter()
    zero_launches()

    # (a) the captured scan against the eager scan on the card: bit for bit
    # at float64 (the plain path) and at float32 through K3 (plain
    # likelihood); through K1 its float32 atomic sums (dv across warps,
    # dphi in shared memory) vary from run to run even at one row tile, so
    # there the two are held to 1e-5 relative beside two eager runs' spread
    n_b, d_b, b_b = SMALL_SCAN             # 3 full batches and 50 rows

    def small_scan_g(capture, dtype, fit_kw=None, **kw):
        return small_scan(dev, capture, dtype, fit_kw, **kw)

    for dtype, kw in (("float64", dict(fused_likelihood=False,
                                       gamma_sampler="fast")),
                      ("float32", dict(fused_likelihood=False,
                                       gamma_sampler="fused"))):
        (lc, lrc, pc, _), (le, lre, pe, _) = (small_scan_g(c, dtype, **kw)
                                              for c in (True, False))
        same = all(torch.equal(pc[n][k], pe[n][k]) for n in pc for k in pc[n])
        check(lc == le and lrc == lre and same,
              f"G {dtype}: the captured scan differs from the eager scan "
              f"(losses {lc} vs {le}, lr {lrc} vs {lre}, params equal "
              f"{same})")
        check(lrc < 2.0, f"G {dtype}: no restore happened (lr {lrc})")
        say("G", f"{dtype} captured scan == eager scan bit for bit (losses, "
                 f"every parameter, lr {lrc}; a restore decayed the lr; "
                 f"N={n_b}, B={b_b}: 3 full batches and a remainder; "
                 f"{'K3' if dtype == 'float32' else 'the plain path'})")
    k1 = dict(fused_likelihood=True, gamma_sampler="fused")
    (lc, lrc, _, _), (le, lre, _, _), (le2, _, _, _) = (
        small_scan_g(c, "float32", **k1) for c in (True, False, False))
    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b))  # noqa: E731
                                    / np.abs(b)))
    check(lrc == lre and rel(lc, le) < 1e-5,
          f"G float32 K1: captured {lc} (lr {lrc}) against eager {le} (lr "
          f"{lre})")
    say("G", f"float32 through K1 and K3: captured scan against eager "
             f"{rel(lc, le):.2e} relative at most, two eager runs "
             f"{rel(le, le2):.2e} (K1's atomic sums), lr {lrc} both")

    # (b) the dense scRNA width, arms in turns
    n_g, b_g = 32768, 4096
    gg = torch.Generator(device=dev).manual_seed(31)
    xg = torch.poisson(torch.ones(n_g, D, device=dev), generator=gg)
    dds = DeviceArrayDataset(
        {"counts": xg, "indices": torch.arange(n_g, device=dev)},
        batch_size=b_g, shuffle=True, seed=0, device=dev)
    xh = xg.cpu().numpy()

    def host_ds():
        """The host ArrayDataset, new for each fit: its shuffle moves on
        with each pass, and the two prefetch arms must see one order."""
        return ArrayDataset({"counts": xh, "indices": np.arange(n_g)}
                            ).shuffle(seed=0).batch(b_g)

    m = PoissonFactorization(latent_dim=K, feature_dim=D, dtype="float32",
                             device=dev)
    # the column and row norms compute_scales would set, from the device
    colsum = xg.sum(0, keepdim=True, dtype=torch.float64)
    cm = (colsum / (xg > 0).sum(0, keepdim=True)).cpu().numpy()
    m.eta_i = m._const(np.where(cm > 1, cm, 1.0))
    m.xi_u_global = m._const(np.nansum(cm))
    init = clone_params(m.surrogate_params)
    # the host arms (about 0.2 s a step) take 2 epochs, to keep the phase
    # short: their second epoch is the one measured. (g): the batches'
    # assembly and copy in line (prefetch=0, the earlier arm) and in the
    # prefetch worker (prefetch=2, the default)
    host = "general loop, host dataset"
    arms = {"captured scan": dict(data=dds),
            "eager scan": dict(data=dds, capture=False),
            "general loop, device dataset": dict(data=dds, epoch_scan=False),
            host: dict(data=host_ds, num_steps=2, prefetch=0),
            host + ", prefetch=2": dict(data=host_ds, num_steps=2,
                                        prefetch=2)}
    res = {tag: [] for tag in arms}
    for profiled in (False, True):
        for tag, kw in arms.items():
            kw = dict(dict(num_steps=3), **kw)
            if kw["data"] is host_ds:
                kw["data"] = host_ds()
            res[tag].append(run_fit(m, init, profiled=profiled, **kw))
    steps = steps_of(dds)
    for tag, turns in res.items():
        check(all(np.isfinite(t[0]).all() for t in turns),
              f"G {tag}: non-finite losses")
        check(turns[0][4] == (tag in ("captured scan", "eager scan")),
              f"G {tag}: epoch_scan {turns[0][4]}")
        report_arm("G", smi, f"dense B={b_g} {tag} (second turn profiled: "
                   f"{turns[1][1]:.2f} ms/step)", b_g, turns[0][1],
                   turns[0][2], turns[1][3],
                   (arms[tag].get("num_steps", 3) - 1) * steps)
    # (g) prefetch=2 draws the in-line loop's samples on the same batches:
    # the traces differ only by K1's atomic sums
    pf = max(rel(a[0], b[0]) for a, b in zip(res[host],
                                                 res[host + ", prefetch=2"]))
    check(pf < 1e-4, f"G prefetch=2 losses {res[host + ', prefetch=2']} off "
                     f"prefetch=0's {res[host]} by {pf:.2e}")
    say("G", f"(g) general loop over the host dataset: prefetch=2 "
             f"{res[host + ', prefetch=2'][0][1]:.2f} / "
             f"{res[host + ', prefetch=2'][1][1]:.2f} ms/step against "
             f"prefetch=0 {res[host][0][1]:.2f} / {res[host][1][1]:.2f} "
             f"(turns in order, the second profiled); loss traces "
             f"{pf:.2e} relative apart; the worker copies on the caller's "
             f"stream ({smi})")
    cap = [np.array(t[0][1:]) for t in res["captured scan"]]
    eag = [np.array(t[0][1:]) for t in res["eager scan"]]
    err = max(float(np.max(np.abs(c - e) / np.abs(e))) for c in cap
              for e in eag)
    spread = float(np.max(np.abs(eag[0] - eag[1]) / np.abs(eag[1])))
    check(err < 1e-4, f"G: captured epoch losses {cap} off the eager scan's "
                      f"{eag} by {err:.2e} (relative)")
    say("G", f"dense epoch losses, captured against eager scan: {err:.2e} "
             f"relative at most (two eager runs: {spread:.2e}; K1's atomic "
             f"sums); captured {[round(x, 4) for x in cap[0]]}")
    win = res["captured scan"][1][3]
    per_step = sum(win[2].values()) / (2 * steps)
    check(per_step <= 4, f"G: the captured dense scan made {per_step:.2f} "
                         "host launches a step (at most 4)")

    # (c) the sparse configurations: captured scan against the general loop
    for tag, (ms_, data) in sparse_arms.items():
        init_s = clone_params(ms_.surrogate_params)
        out = {}
        for profiled in (False, True):
            for arm, kw in (("captured scan", {}),
                            ("general loop", dict(epoch_scan=False))):
                out.setdefault(arm, []).append(run_fit(
                    ms_, init_s, data, num_steps=2, profiled=profiled, **kw))
        st = steps_of(data)
        for arm, turns in out.items():
            check(all(np.isfinite(t[0]).all() for t in turns),
                  f"G {tag} {arm}: non-finite losses")
            check(turns[0][4] == (arm == "captured scan"),
                  f"G {tag} {arm}: epoch_scan {turns[0][4]}")
            report_arm("G", smi, f"{tag} B={data._batch_size} {arm} "
                       f"(second turn profiled: {turns[1][1]:.2f} ms/step)",
                       data._batch_size, turns[0][1], turns[0][2],
                       turns[1][3], st)
        ms_.surrogate_params = init_s

    # (d) fused_normals on and off under capture, in turns
    ab = {True: [], False: []}
    for fused in (True, False, False, True):
        m._surrogate.fused_normals = fused
        ab[fused].append(run_fit(m, init, dds, num_steps=3)[1])
    m._surrogate.fused_normals = False
    say("G", f"fused_normals under capture (dense B={b_g}, captured scan): "
             f"on {ab[True][0]:.3f} / {ab[True][1]:.3f} ms/step, off "
             f"{ab[False][0]:.3f} / {ab[False][1]:.3f} (in turns on, off, "
             f"off, on; {smi})")

    # (e) chunks, bit for bit: at the size of (a), 8 epochs (two chunks of
    # 4, restores inside them: patience=1), the captured chunks against the
    # captured single epochs and the eager chunks; through K1 within 1e-5
    # beside two eager runs' spread, as (a)
    def chunk_runs(dtype, kw, arms):
        return [small_scan_g(c, dtype,
                             fit_kw=dict(num_steps=8, epoch_chunk=e), **kw)
                for c, e in arms]

    for dtype, kw in (("float64", dict(fused_likelihood=False,
                                       gamma_sampler="fast")),
                      ("float32", dict(fused_likelihood=False,
                                       gamma_sampler="fused"))):
        base, *others = chunk_runs(dtype, kw, ((True, 4), (True, 1),
                                               (False, 4)))
        check(base[3]["epoch_chunk"] == 4 and base[1] < 2.0,
              f"G (e) {dtype}: chunk {base[3]['epoch_chunk']}, lr {base[1]}")
        for name, o in zip(("captured single epochs", "eager chunks"),
                           others):
            same = all(torch.equal(base[2][n][k], o[2][n][k])
                       for n in base[2] for k in base[2][n])
            check(base[0] == o[0] and base[1] == o[1] and same,
                  f"G (e) {dtype}: captured chunks differ from {name} "
                  f"(losses {base[0]} vs {o[0]}, lr {base[1]} vs {o[1]}, "
                  f"params equal {same})")
        say("G", f"(e) {dtype}: captured epoch_chunk=4 == captured "
                 f"epoch_chunk=1 == eager epoch_chunk=4 bit for bit (losses, "
                 f"every parameter, lr {base[1]}; restores inside the "
                 f"chunks; {'K3' if dtype == 'float32' else 'the plain path'})")
    cc, cs, ce, ce2 = chunk_runs("float32", k1, ((True, 4), (True, 1),
                                                 (False, 4), (False, 4)))
    check(cc[1] == cs[1] == ce[1] and rel(cc[0], cs[0]) < 1e-5
          and rel(cc[0], ce[0]) < 1e-5,
          f"G (e) K1: captured chunks {cc[0]} (lr {cc[1]}), captured "
          f"singles {cs[0]} (lr {cs[1]}), eager chunks {ce[0]} (lr {ce[1]})")
    say("G", f"(e) float32 through K1 and K3: captured chunks against "
             f"captured singles {rel(cc[0], cs[0]):.2e}, against eager "
             f"chunks {rel(cc[0], ce[0]):.2e} relative at most; two eager "
             f"runs {rel(ce[0], ce2[0]):.2e}; lr {cc[1]} in all")

    # (f) the dense width over 26 epochs: epoch_chunk=1 against the default
    # (2 single epochs, then 3 chunks of 8), without and with checkpoints,
    # in turns, the second turn profiled. ms/step, busy, launches and
    # fetches over epochs 11-26: the single arm's last 16 epochs, the
    # default's last two chunks (the first holds the decisions' capture)
    n_f = 26
    farms = {"epoch_chunk=1": dict(epoch_chunk=1, windows=dict(skip=10)),
             "default": dict(windows=dict(names=("fit chunk",), skip=1))}

    def fit_arm(m_, init_, data, ckpt, profiled, **kw):
        root = tempfile.mkdtemp(prefix="chip_smoke_G_") if ckpt else None
        try:
            out = run_fit(m_, init_, data, profiled=profiled,
                          checkpoint_dir=root, **kw)
            files = (len(glob.glob(os.path.join(root, "**", "*.npz"),
                                   recursive=True)) if ckpt else 0)
        finally:
            if root is not None:
                shutil.rmtree(root, ignore_errors=True)
        return out, files

    def report_f(tag, turns, steps_f, rows, epochs_win):
        (out, files), (pout, _) = turns
        r, wall = out[5], out[6]
        win = pout[3]
        check(np.isfinite(out[0]).all() and np.isfinite(pout[0]).all(),
              f"G (f) {tag}: non-finite losses")
        check(files == len(r.extras["checkpoint_seconds"]),
              f"G (f) {tag}: {files} files, "
              f"{len(r.extras['checkpoint_seconds'])} writes")
        wall_w, busy, launches, kernels, fetches, by_call = win
        n = epochs_win * steps_f
        share = (f"busy {busy / n:.2f} ms/step ({busy / wall_w:.1%}; by "
                 f"issuing call {by_call['busy'] / n:.2f}, "
                 f"{by_call['busy'] / wall_w:.1%})"
                 if busy else "device time not measured")
        names = ", ".join(f"{k} {v / n:.3f}"
                          for k, v in launches.most_common(3))
        offset = by_call["offset_ms"]
        say("G", f"(f) {tag}: {out[1]:.2f} ms/step ({pout[1]:.2f} "
                 f"profiled), {rows / out[1] * 1e3:.0f} rows/s, peak "
                 f"{out[2]:.2f} GB; {share}, "
                 f"{sum(launches.values()) / n:.3f} host launches a step "
                 f"({names}), {kernels / n:.1f} device kernels a step, "
                 f"{by_call['fetches'] / epochs_win:.3f} device-to-host "
                 f"fetches an epoch by issuing call ("
                 f"{fetches / epochs_win:.3f} by device time; device - host "
                 f"clock on them "
                 f"{'n/a' if offset is None else f'{offset:.3f} ms'}; over "
                 f"{epochs_win} epochs); "
                 f"epoch_chunk {r.extras['epoch_chunk']}; {files} "
                 f"checkpoint files, checkpoint_seconds "
                 f"{sum(r.extras['checkpoint_seconds']):.3f} s; fit wall "
                 f"{wall:.2f} s, {wall / len(r.losses[1:]) * 1e3:.1f} ms an "
                 f"epoch over all {len(r.losses[1:])} ({smi})")
        return out

    fres = {}
    for profiled in (False, True):
        for ckpt in (False, True):
            for tag, kw in farms.items():
                fres.setdefault((tag, ckpt), []).append(fit_arm(
                    m, init, dds, ckpt, profiled, num_steps=n_f, first=10,
                    **kw))
    fl = {}
    for (tag, ckpt), turns in fres.items():
        label = f"dense B={b_g} {tag}" + (", checkpoints" if ckpt else "")
        out = report_f(label, turns, steps, b_g, 16)
        want = 8 if tag == "default" else 0
        check(out[5].extras["epoch_chunk"] == want,
              f"G (f) {label}: epoch_chunk {out[5].extras['epoch_chunk']}")
        fl[(tag, ckpt)] = out[0]
    drift = max(rel(fl[("default", c)], fl[("epoch_chunk=1", c)])
                for c in (False, True))
    check(drift < 1e-3, f"G (f): the default's losses off epoch_chunk=1's "
                        f"by {drift:.2e}")
    say("G", f"(f) dense losses, default against epoch_chunk=1: {drift:.2e} "
             f"relative at most (K1's atomic sums)")

    # the 0.1% flat sparse set: chunks of 4 against single epochs, 8 epochs
    # each, in turns; epochs 5-8 read (the second chunk)
    ms_, data = sparse_arms["sparse 0.1% flat"]
    init_s = clone_params(ms_.surrogate_params)
    st = steps_of(data)
    sres = {}
    for profiled in (False, True):
        for tag, kw in (("epoch_chunk=1", dict(epoch_chunk=1,
                                               windows=dict(skip=4))),
                        ("epoch_chunk=4", dict(epoch_chunk=4, windows=dict(
                            names=("fit chunk",), skip=1)))):
            sres.setdefault(tag, []).append(fit_arm(
                ms_, init_s, data, False, profiled, num_steps=8, first=4,
                **kw))
    for tag, turns in sres.items():
        out = report_f(f"sparse 0.1% flat B={data._batch_size} {tag}", turns,
                       st, data._batch_size, 4)
        check(out[5].extras["epoch_chunk"] == (4 if "4" in tag else 0),
              f"G (f) sparse {tag}: epoch_chunk "
              f"{out[5].extras['epoch_chunk']}")
    sd = rel(sres["epoch_chunk=4"][0][0][0], sres["epoch_chunk=1"][0][0][0])
    check(sd < 1e-3, f"G (f) sparse: chunked losses off single by {sd:.2e}")
    say("G", f"(f) 0.1% flat losses, chunks of 4 against single epochs: "
             f"{sd:.2e} relative at most")
    ms_.surrogate_params = init_s

    # (g) profile_dir: a captured 3-epoch fit writes its trace, which names
    # the kernels of the step
    root = tempfile.mkdtemp(prefix="chip_smoke_G_prof_")
    try:
        run_fit(m, init, dds, num_steps=3, profile_dir=root)
        traces = glob.glob(os.path.join(root, "*.json"))
        check(len(traces) == 1, f"G (g) profile_dir holds {traces}")
        with open(traces[0]) as f:
            text = f.read()
        named = {k: k in text for k in ("stats_kernel", "ig_fwd_kernel",
                                        "fit epoch")}
        check(all(named.values()), f"G (g) the trace names {named}")
        say("G", f"(g) profile_dir: {os.path.basename(traces[0])}, "
                 f"{len(text) / 1e6:.1f} MB, names {sorted(named)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del dds, xh, xg, m
    say("G", f"phase G took {time.perf_counter() - t_phase:.1f} s")
    return read_launches()


def persistence_phase(dev, smi, zero_launches, read_launches):
    """Phase P: checkpoints, resume, the interrupt return, save / load_model,
    encode_batched, predictive_distribution and the bound surrogate at the
    full width. Returns the kernel launches of its fits."""
    import torch

    from spmf_tpu_torch import PoissonFactorization, load_model
    from spmf_tpu_torch.data import ArrayDataset
    from spmf_tpu_torch.utils import (adam_state_from_numpy,
                                      adam_state_to_numpy, flatten_jax_order,
                                      load_fit_state)
    from spmf_tpu_torch.utils.checkpoint import to_numpy
    from spmf_tpu_torch.vi.minibatch import make_optimizer

    n_p, b_p = 8192, 4096
    gp = torch.Generator(device=dev).manual_seed(21)
    xp = torch.poisson(torch.ones(2 * n_p, D, device=dev),
                       generator=gp).cpu().numpy()
    ds = ArrayDataset({"counts": xp[:n_p], "indices": np.arange(n_p)}) \
        .batch(b_p)
    m = PoissonFactorization(latent_dim=K, feature_dim=D, dtype="float32",
                             device=dev, data=ds)
    init = {n: {k: t.clone() for k, t in sub.items()}
            for n, sub in m.surrogate_params.items()}
    root = tempfile.mkdtemp(prefix="chip_smoke_P_")
    fit_kw = dict(num_steps=3, learning_rate=0.01, sample_size=S,
                  rel_tol=None, verbose=False)
    steps = 3 * (n_p // b_p)

    def tags(d):
        return {p: int(re.search(r"-(\d+)\.npz$", p).group(1))
                for p in glob.glob(os.path.join(d, "**", "*.npz"),
                                   recursive=True)}

    try:
        # (a) fits with and without checkpoints, from the same start, in turn
        zero_launches()
        ms_step = {"without": [], "with": []}
        for arm in ("without", "with", "without", "with"):
            m.surrogate_params = {n: {k: t.clone() for k, t in sub.items()}
                                  for n, sub in init.items()}
            ckpt = os.path.join(root, "a") if arm == "with" else None
            if ckpt is not None:
                shutil.rmtree(ckpt, ignore_errors=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = m.fit(checkpoint_dir=ckpt, **fit_kw)
            torch.cuda.synchronize()
            ms_step[arm].append((time.perf_counter() - t0) / steps * 1e3)
            check(np.isfinite(losses).all(), f"P fit losses {losses}")
        r = m.last_fit
        files = tags(os.path.join(root, "a"))
        check(len(files) >= 1, "P: no checkpoint written")
        newest = max(files, key=files.get)
        saved, opt_leaves, meta = load_fit_state(newest, r.params)
        for a, b in zip(flatten_jax_order(r.params),
                        flatten_jax_order(saved)):
            check(np.array_equal(a.cpu().numpy(), b),
                  "P: the newest checkpoint differs from FitResult.params")
        write_ms = [t * 1e3 for t in r.extras["checkpoint_seconds"]]
        # the write's two parts, timed apart on the newest file's state
        pt = {n: {k: t.clone() for k, t in sub.items()}
              for n, sub in r.params.items()}
        opt = make_optimizer(pt, 0.01)
        adam_state_from_numpy(opt_leaves, opt, pt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = ([to_numpy(t) for t in flatten_jax_order(pt)]
                + adam_state_to_numpy(opt, pt))
        d2h_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        np.savez(os.path.join(root, "split.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        savez_ms = (time.perf_counter() - t0) * 1e3
        del pt, opt, host
        ckpt_bytes = os.path.getsize(newest)
        param_bytes = sum(t.numel() * t.element_size()
                          for t in flatten_jax_order(r.params))
        say("P", f"fit with checkpoint_dir: {len(files)} files, newest "
                 f"{os.path.basename(newest)} equals FitResult.params bit "
                 f"for bit; {ckpt_bytes} bytes a full-state checkpoint "
                 f"({ckpt_bytes / param_bytes:.3f} x the {param_bytes} "
                 f"parameter bytes); write (device to host + np.savez) "
                 f"{[round(t, 2) for t in write_ms]} ms, apart "
                 f"{d2h_ms:.2f} + {savez_ms:.2f} ms; ms/step (fit wall "
                 f"over {steps} steps) with checkpoints "
                 f"{[round(t, 2) for t in ms_step['with']]}, without "
                 f"{[round(t, 2) for t in ms_step['without']]} ({smi})")

        # (b) resume from the directory with another learning rate
        saved_count = int(opt_leaves[2])
        old_max = max(files.values())
        m.fit(checkpoint_dir=os.path.join(root, "b"),
              resume_from=os.path.join(root, "a"),
              **dict(fit_kw, num_steps=2, learning_rate=0.05))
        r = m.last_fit
        lr_used = r.opt_state["param_groups"][0]["lr"]
        count = int(r.opt_state["state"][0]["step"])
        new_tags = tags(os.path.join(root, "b"))
        check(r.learning_rate == meta["lr"] and lr_used == meta["lr"],
              f"P resume: lr {r.learning_rate} / {lr_used}, checkpoint "
              f"{meta['lr']}")
        check(count == saved_count + 2 * (n_p // b_p),
              f"P resume: Adam count {count}, saved {saved_count}")
        check(new_tags and min(new_tags.values()) > old_max,
              f"P resume: tags {sorted(new_tags.values())} after {old_max}")
        say("P", f"resume: lr {lr_used} (checkpoint {meta['lr']}, argument "
                 f"0.05), Adam count {saved_count} + {2 * (n_p // b_p)} = "
                 f"{count}, new tags {sorted(new_tags.values())} > "
                 f"{old_max}")

        # (c) a KeyboardInterrupt in the second epoch's second batch
        calls = [0]

        def interrupting():
            calls[0] += 1    # the first call is the initial-loss batch
            for i, b in enumerate(ds):
                if calls[0] == 3 and i == 1:
                    raise KeyboardInterrupt
                yield b

        m.fit(batched_data_factory=interrupting,
              checkpoint_dir=os.path.join(root, "c"),
              **dict(fit_kw, num_steps=5))
        r = m.last_fit
        written = tags(os.path.join(root, "c"))
        check(r.extras["interrupted"] and len(r.losses) == 2
              and len(written) == 1,
              f"P interrupt: {r.extras['interrupted']}, losses {r.losses}, "
              f"files {written}")
        best, _, _ = load_fit_state(next(iter(written)), r.params)
        for a, b in zip(flatten_jax_order(r.params),
                        flatten_jax_order(best)):
            check(np.array_equal(a.cpu().numpy(), b),
                  "P interrupt: params differ from the best before it")
        say("P", "KeyboardInterrupt in epoch 2: interrupted=True, the params "
                 "are epoch 1's checkpoint bit for bit")
        launches = read_launches()

        # (d) save, then load_model on the card
        path = os.path.join(root, "model.npz")
        m.save(path)
        loaded = load_model(path, device=dev)
        x_enc = xp[:b_p]
        for a, b in zip(flatten_jax_order(m.surrogate_params),
                        flatten_jax_order(loaded.surrogate_params)):
            check(b.device == a.device and torch.equal(a, b),
                  "P load_model: params")
        check(torch.equal(loaded.encode(x_enc), m.encode(x_enc)),
              "P load_model: encode not bit-equal")
        say("P", f"save + load_model(device={dev.type!r}): params and "
                 f"encode of {b_p} rows bit-equal")

        # (e) encode_batched: each chunk is encode of its rows (the same
        # M, so the same bits); it and the one-shot encode (another M, so
        # maybe another cuBLAS reduction order over D) are each held to the
        # float64 encode of the same rows
        m64 = load_model(path, device=dev, dtype="float64")
        u = m.calibrated_expectations["u"]
        s_ = m.calibrated_expectations["s"]
        with torch.no_grad():
            full = m.encode(xp).cpu().numpy()
            per_chunk = np.concatenate([m.encode(xp[lo:lo + b_p]).cpu().numpy()
                                        for lo in range(0, 2 * n_p, b_p)])
            ref64 = m64.encode(xp, u.double(), s_.double()).cpu().numpy()
        m.encode_batched(xp[:b_p], row_chunk=b_p)     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunked = m.encode_batched(xp, row_chunk=b_p)
        enc_s = time.perf_counter() - t0

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())

        e_chunk, e_full = rel(chunked, ref64), rel(full, ref64)
        check(chunked.shape == (2 * n_p, K)
              and np.array_equal(chunked, per_chunk),
              "P encode_batched differs from encode of its chunks")
        # float32 sums of D=20000 terms: ~sqrt(D) * 2^-24 = 8.4e-6 of the
        # largest entry
        check(e_chunk <= 1e-5 and e_full <= 1e-5,
              f"P encode vs float64: chunked {e_chunk}, one-shot {e_full}")
        say("P", f"encode_batched({2 * n_p} rows, row_chunk={b_p}): the "
                 f"chunks' encode bit for bit; rel-of-max vs float64 "
                 f"{e_chunk:.2e}, one-shot encode {e_full:.2e}, chunked vs "
                 f"one-shot {rel(chunked, full):.2e}; {2 * n_p / enc_s:.0f} "
                 f"rows/s ({enc_s * 1e3:.1f} ms, host in and out; {smi})")
        del full, per_chunk, ref64

        # (f) predictive_distribution against float64 on the same draws
        b_f = 1024
        g = torch.Generator(device=dev).manual_seed(5)
        with torch.no_grad():
            draws = m._surrogate.sample(m.surrogate_params, g, (S,))
            pred = m.predictive_distribution(data=xp[:b_f], **draws)
            ref = m64.predictive_distribution(
                data=xp[:b_f], **{k: v.double() for k, v in draws.items()})
        e_ll = rel_max(pred["log_likelihood"], ref["log_likelihood"])
        e_rate = rel_max(pred["rate"], ref["rate"])
        check(tuple(pred["log_likelihood"].shape) == (b_f, D)
              and e_ll <= 1e-5 and e_rate <= 1e-5,
              f"P predictive_distribution rel {e_ll} / {e_rate}")
        say("P", f"predictive_distribution S={S}, B={b_f}: log_likelihood "
                 f"{tuple(pred['log_likelihood'].shape)} rel-of-max "
                 f"{e_ll:.2e}, rate rel-of-max {e_rate:.2e} vs float64")
        del draws, pred, ref, m64

        # (g) the bound surrogate
        view = m.surrogate_distribution
        view.sample(250)     # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            s = view.sample(250)
        torch.cuda.synchronize()
        sample_ms = (time.perf_counter() - t0) * 1e3
        check(set(s) == set(m.surrogate_params)
              and all(v.shape[0] == 250 and bool(torch.isfinite(v).all())
                      for v in s.values())
              and tuple(s["u"].shape) == (250, D, K),
              "P surrogate_distribution.sample(250)")
        say("P", f"surrogate_distribution.sample(250): {len(s)} variables, "
                 f"u {tuple(s['u'].shape)}, finite, {sample_ms:.1f} ms "
                 f"({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


#: the autoencoder of benchmarks/autoencoder_ablation.py and
#: docs/model_bench.json: D=2000, B=1024, latent 32, one encoder and one
#: decoder layer; its Normal block (every weight and bias) has 8,134,032
#: elements
AE_D, AE_B, AE_K = 2000, 1024, 32
AE_TOTAL = 2 * AE_D * AE_D + 2 * AE_D * AE_K + 3 * AE_D + AE_K


def autoencoder_phase(dev, smi, zero_launches, read_launches):
    """Phase AE: horshoe_plus=False at the scRNA width (AbsHorseshoe priors
    on u and s, no InverseGamma block) through K1, then with fused_normals
    through K6; the PoissonAutoencoder at its bench width on the captured
    scan and the general loop, then with fused_normals (K6 over the
    8.1 M-element Identity block, held against its float64 twin at that
    total); a profiler breakdown of one autoencoder step (the exact-E1
    weight prior, the matmuls, the surrogate draw); one small autoencoder
    step against the plain float64 path on the same Philox draws; save /
    load_model (encode bit-equal), waic and held-out log_likelihood.
    Returns the kernel launches of its fits."""
    import torch

    from spmf_tpu_torch import (PoissonAutoencoder, PoissonFactorization,
                                load_model)
    from spmf_tpu_torch.data import DeviceArrayDataset
    from spmf_tpu_torch.ops import fused_normal as tfn

    t_phase = time.perf_counter()
    launches = {}
    g = torch.Generator(device=dev).manual_seed(31)

    # (a) horshoe_plus=False at D=20000, K=32, B=4096, 16,384 rows resident:
    # 3 epochs an arm on the captured scan, the second turn profiled
    n_f, b_f = 16384, 4096
    xf = torch.poisson(torch.ones(n_f, D, device=dev), generator=g)
    dsf = DeviceArrayDataset({"counts": xf,
                              "indices": torch.arange(n_f, device=dev)},
                             batch_size=b_f, device=dev)
    mf = PoissonFactorization(latent_dim=K, feature_dim=D,
                              horshoe_plus=False, dtype="float32",
                              device=dev, data=dsf)
    check(list(mf.surrogate_params) == ["v", "w", "s", "u"]
          and not mf._surrogate._ig_names and mf.gamma_sampler == "fused",
          f"AE non-plus surrogate {list(mf.surrogate_params)}")
    init_f = clone_params(mf.surrogate_params)
    steps_f = n_f // b_f
    for fused in (False, True):
        mf._surrogate.fused_normals = fused
        zero_launches()
        turns = [run_fit(mf, init_f, dsf, num_steps=3, profiled=p)
                 for p in (False, True)]
        got = launches[f"non-plus fused_normals={fused}"] = read_launches()
        n_steps = 2 * 3 * steps_f
        check(all(np.isfinite(t[0]).all() and t[4] for t in turns),
              f"AE non-plus fused_normals={fused}: losses "
              f"{[t[0] for t in turns]}, scan {[t[4] for t in turns]}")
        check(got["stats"] >= n_steps and got["fwd"] == got["bwd"] == 0
              and (got["nfwd"] >= n_steps and got["nbwd"] >= n_steps
                   if fused else got["nfwd"] == got["nbwd"] == 0),
              f"AE non-plus fused_normals={fused}: launches {got}")
        report_arm("AE", smi, f"horshoe_plus=False D={D} K={K} B={b_f} "
                              f"captured scan, fused_normals={fused} "
                              f"(second turn profiled: {turns[1][1]:.2f} "
                              "ms/step)", b_f, turns[0][1], turns[0][2],
                   turns[1][3], 2 * steps_f)
        say("AE", f"  losses {[round(x, 4) for x in turns[0][0]]}; "
                  f"launches {got}")
    mf._surrogate.fused_normals = False
    del mf, dsf, xf, init_f

    # (b) the autoencoder at D=2000, B=1024, S=8, 8192 rows resident (8
    # batches an epoch): the captured scan and the general loop in turns,
    # the second turn profiled
    n_a = 8192
    xa = torch.poisson(torch.ones(n_a + AE_B, AE_D, device=dev), generator=g)
    dsa = DeviceArrayDataset({"counts": xa[:n_a],
                              "indices": torch.arange(n_a, device=dev)},
                             batch_size=AE_B, device=dev)
    held = DeviceArrayDataset({"counts": xa[n_a:],
                               "indices": torch.arange(AE_B, device=dev)},
                              batch_size=AE_B, device=dev)
    t0 = time.perf_counter()
    ma = PoissonAutoencoder(dsa, latent_dim=AE_K, dtype="float32",
                            device=dev)
    build_s = time.perf_counter() - t0
    sur = ma._surrogate
    names = sur._normal_names
    check(sum(sur._sizes.values()) == AE_TOTAL and not sur._ig_names
          and ma.neural_network_model.layer_sizes == [AE_D, AE_K, AE_D, AE_D],
          f"AE autoencoder: {sur._sizes}")
    init_a = clone_params(ma.surrogate_params)
    steps_a = n_a // AE_B
    zero_launches()
    res = {}
    for profiled in (False, True):
        for arm, kw in (("captured scan", {}),
                        ("general loop", dict(epoch_scan=False))):
            res.setdefault(arm, []).append(run_fit(
                ma, init_a, dsa, num_steps=3, profiled=profiled, **kw))
    got = launches["autoencoder"] = read_launches()
    check(not any(got.values()), f"AE autoencoder launches {got}")
    say("AE", f"PoissonAutoencoder(D={AE_D}, latent {AE_K}, layers "
              f"{ma.neural_network_model.layer_sizes}) built in "
              f"{build_s:.1f} s; Normal block {AE_TOTAL} elements")
    for arm, turns in res.items():
        check(all(np.isfinite(t[0]).all() for t in turns)
              and turns[0][4] == (arm == "captured scan"),
              f"AE autoencoder {arm}: losses {turns[0][0]}, scan "
              f"{turns[0][4]}")
        report_arm("AE", smi, f"autoencoder D={AE_D} B={AE_B} S={S} {arm} "
                              f"(second turn profiled: {turns[1][1]:.2f} "
                              "ms/step)", AE_B, turns[0][1], turns[0][2],
                   turns[1][3], 2 * steps_a)
        say("AE", f"  losses {[round(x, 4) for x in turns[0][0]]}")

    # with fused_normals: K6 draws the whole Identity block
    sur.gamma_sampler, sur.fused_normals = "fused", True
    zero_launches()
    turns = [run_fit(ma, init_a, dsa, num_steps=3, profiled=p)
             for p in (False, True)]
    got = launches["autoencoder fused_normals"] = read_launches()
    n_steps = 2 * 3 * steps_a
    check(all(np.isfinite(t[0]).all() and t[4] for t in turns)
          and got["nfwd"] >= n_steps and got["nbwd"] >= n_steps
          and got["stats"] == 0, f"AE autoencoder fused_normals: launches "
                                 f"{got}, losses {turns[0][0]}")
    report_arm("AE", smi, f"autoencoder D={AE_D} B={AE_B} S={S} captured "
                          f"scan, fused_normals=True (second turn profiled: "
                          f"{turns[1][1]:.2f} ms/step)", AE_B, turns[0][1],
               turns[0][2], turns[1][3], 2 * steps_a)
    say("AE", f"  losses {[round(x, 4) for x in turns[0][0]]}; launches "
              f"{got}")

    # (c) K6 at the autoencoder's total against its float64 twin, on the
    # fitted loc / raw_scale and the all-Identity mask; tolerances as in
    # phase K6
    loc = torch.cat([ma.surrogate_params[n]["loc"].reshape(-1)
                     for n in names]).detach()
    rs = torch.cat([ma.surrogate_params[n]["raw_scale"].reshape(-1)
                    for n in names]).detach()
    mask = sur._normal_mask(names)
    check(not bool(mask.any()), "AE: the autoencoder's mask is not Identity")
    seed = torch.tensor([24680], dtype=torch.int32, device=dev)
    gy = torch.randn(S, AE_TOTAL, generator=g, device=dev)
    glq = torch.randn(S, generator=g, device=dev)
    y_k, lq_k = tfn._kernel_fwd(loc, rs, mask, seed, S)
    gl_k, gr_k = tfn._kernel_bwd(loc, rs, mask, seed, S, gy, glq)
    y_t, lq_t = tfn.normal_twin_fwd(loc.double(), rs.double(),
                                    mask.double(), seed, S)
    gl_t, gr_t = tfn.normal_twin_bwd(loc.double(), rs.double(),
                                     mask.double(), seed, S, gy.double(),
                                     glq.double())
    torch.cuda.synchronize()
    e_y, e_lq = rel_max(y_k, y_t), rel_elem(lq_k, lq_t)
    e_g = max(rel_max(gl_k, gl_t), rel_max(gr_k, gr_t))
    check(e_y < 1e-5, f"AE K6f y rel err {e_y}")
    check(e_lq < 1e-6, f"AE K6f lq rel err {e_lq}")
    check(e_g < 1e-5, f"AE K6b grads rel err {e_g}")
    err_f = abs_max([(y_k, y_t)])
    err_b = abs_max([(gl_k, gl_t), (gr_k, gr_t)])
    del y_k, lq_k, gl_k, gr_k, y_t, lq_t, gl_t, gr_t
    k6 = (cuda_ms(lambda: tfn._kernel_fwd(loc, rs, mask, seed, S)),
          cuda_ms(lambda: tfn._kernel_bwd(loc, rs, mask, seed, S, gy, glq)))
    twin = (cuda_ms(lambda: tfn.normal_twin_fwd(loc, rs, mask, seed, S),
                    iters=3, warmup=1),
            cuda_ms(lambda: tfn.normal_twin_bwd(loc, rs, mask, seed, S, gy,
                                                glq), iters=3, warmup=1))
    bnd = (normal_bound("fwd", AE_TOTAL, S), normal_bound("bwd", AE_TOTAL, S))
    say("AE", f"K6 at total={AE_TOTAL} (all Identity), S={S}, against its "
              f"float64 twin: y rel-of-max {e_y:.2e}, lq rel {e_lq:.2e}, "
              f"gloc/grs rel-of-max {e_g:.2e}, max abs err K6f {err_f:.2e} "
              f"K6b {err_b:.2e}; K6f {k6[0]:.3f} ms, K6b {k6[1]:.3f} ms "
              f"(CUDA events around the call, median of 10; float32 twin "
              f"{twin[0]:.2f} / {twin[1]:.2f} ms); bound {bnd[0][0]:.4f} / "
              f"{bnd[1][0]:.4f} ms ({bnd[0][2]} / {bnd[1][2]}) ({smi})")
    sur.gamma_sampler, sur.fused_normals = "fast", False
    del gy, glq, loc, rs

    # (d) one step's breakdown: the step timed and profiled; inside its
    # profile the device time of log_exp1 forward and backward (the host
    # ops _LogExp1 / _LogExp1Backward) and of the matmul kernels; then the
    # weight and bias prior, the network with its likelihood, and the
    # surrogate draw each run alone (forward and backward), and what the
    # prior's autograd graph keeps
    batch = dsa.peek_batch()
    step = step_timer(ma, batch)
    ms_step, mem = time_steps(step)
    wall, busy, top, count, by_kernel, ops = profile_steps(step, n=3)
    e1 = ops.get("_LogExp1", 0.0) + ops.get("_LogExp1Backward", 0.0)
    mm = sum(v for k, v in by_kernel.items() if "gemm" in k.lower())
    del step
    with torch.no_grad():
        samples = sur.sample(ma.surrogate_params,
                             torch.Generator(device=dev).manual_seed(5), (S,))
    leaves = {k: v.requires_grad_(True) for k, v in samples.items()}
    saved = {}

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        lp = ma.joint_prior.log_prob(leaves)
    del lp

    def part(fn):
        def run_part():
            for t in leaves.values():
                t.grad = None
            fn().sum().backward()
        return profile_steps(run_part, n=3)[1]

    prior_ms = part(lambda: ma.joint_prior.log_prob(leaves))
    net_ms = part(lambda: ma.log_likelihood_components(
        batch, **leaves)["log_likelihood"])
    draw_ms = profile_steps(normal_block_step(ma, False), n=3)[1]
    del leaves, samples
    if busy:
        parts = (f"inside the step's profile: log_exp1 forward and backward "
                 f"{e1:.2f} ms ({e1 / busy:.1%} of busy), matmul kernels "
                 f"{mm:.2f} ms ({mm / busy:.1%}); run alone: the prior "
                 f"{prior_ms or 0:.2f} ms ({(prior_ms or 0) / busy:.1%}), "
                 f"network and likelihood {net_ms or 0:.2f} ms "
                 f"({(net_ms or 0) / busy:.1%}), surrogate draw "
                 f"{draw_ms or 0:.2f} ms ({(draw_ms or 0) / busy:.1%})")
    else:
        parts = "device time not measured (the profiler saw none)"
    say("AE", f"one autoencoder step B={AE_B} S={S}: {ms_step:.2f} ms/step "
              f"(median of 10), {AE_B / ms_step * 1e3:.0f} rows/s, peak "
              f"{mem:.2f} GB; profiled {wall:.2f} ms wall, "
              + (f"{busy:.2f} ms busy ({busy / wall:.1%}), " if busy else "")
              + f"{count:.0f} device kernels a step; {parts}; the prior's "
              f"autograd graph keeps {len(saved)} tensors, "
              f"{sum(saved.values()) / 1e6:.0f} MB (one sampled-weight "
              f"tensor is {S * AE_TOTAL * 4 / 1e6:.0f} MB); top "
              + "; ".join(f"{k} {v:.2f} ms" for k, v in top) + f" ({smi})")

    # (e) one small step (D=12, S=2) through K6 against the plain float64
    # path on the same Philox draws: loss 1e-4, gradients 1e-4 of the
    # largest entry. Not 1e-5: a drawn weight x = loc + scale * eps that
    # cancels to near 0 carries the float32 rounding of loc relative to
    # x (3.3e-6 for one weight of this step), and the horseshoe prior's
    # gradient, about 1 / (x log(1 / x^2)), is largest at exactly such a
    # weight: 1.05e-5 of the largest entry for the float32 plain path on
    # the CPU, no kernel involved
    x12 = np.random.default_rng(41).poisson(1.0, (64, 12)).astype(np.float32)
    data12 = {"counts": x12, "indices": np.arange(64)}
    mk = PoissonAutoencoder(data12, latent_dim=3, dtype="float32",
                            device=dev)
    mk._surrogate.gamma_sampler, mk._surrogate.fused_normals = "fused", True
    mp = PoissonAutoencoder(data12, latent_dim=3, dtype="float64",
                            device="cpu")
    p0 = perturbed_init(mp, 41)
    before = read_launches()
    res_k = step_grads(mk, p0, {"counts": torch.as_tensor(x12, device=dev)},
                       None, generator=torch.Generator(device=dev)
                       .manual_seed(41), sample_size=2)
    after = read_launches()
    ran = [k for k in after if after[k] == before[k] + 1]
    check(ran == ["nfwd", "nbwd"], f"AE small step launched {ran}")
    res_p = step_grads(mp, p0, {"counts": torch.as_tensor(x12).double()},
                       philox_draws(mp, 41, dev, sample_size=2),
                       sample_size=2)
    e_loss = abs(res_k[0] - res_p[0]) / abs(res_p[0])
    e_grad = rel_max(res_k[1], res_p[1])
    check(e_loss < 1e-4, f"AE small-step loss rel err {e_loss}")
    check(e_grad < 1e-4, f"AE small-step grads rel err {e_grad}")
    say("AE", f"small autoencoder step (D=12, S=2) through K6 vs float64 "
              f"plain path on the same draws: loss {res_k[0]:.6f} vs "
              f"{res_p[0]:.6f} (rel {e_loss:.2e}), grads rel-of-max "
              f"{e_grad:.2e}")

    # (f) save / load_model on the card, encode bit-equal; waic and the
    # held-out log_likelihood of the loaded model
    ma.set_calibration_expectations()
    root = tempfile.mkdtemp(prefix="chip_smoke_AE_")
    try:
        path = os.path.join(root, "ae.npz")
        t0 = time.perf_counter()
        ma.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mb = load_model(path, data=dsa, device=dev)
        load_s = time.perf_counter() - t0
        xe = xa[n_a:n_a + 256]
        z_a, z_b = ma.encode(xe), mb.encode(xe)
        check(torch.equal(ma.column_norm_factor, mb.column_norm_factor),
              "AE load_model: other column norms")
        check(tuple(z_b.shape) == (xe.shape[0], AE_K)
              and torch.equal(z_a, z_b),
              "AE save / load_model: encode not bit-equal")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = mb.waic(num_samples=8)
        waic_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ll = mb.log_likelihood(held, num_samples=8)
        ll_s = time.perf_counter() - t0
        check(w["n_rows"] == n_a and np.isfinite(
            [w["waic"], w["se"], w["lppd"], w["pwaic"]]).all(),
            f"AE waic {w}")
        check(ll["n_rows"] == AE_B and np.isfinite(ll["total"]),
              f"AE log_likelihood {ll}")
        say("AE", f"save {save_s:.2f} s ({os.path.getsize(path)} bytes), "
                  f"load_model(data=..., device={dev.type!r}) "
                  f"{load_s:.2f} s, encode of {xe.shape[0]} rows "
                  f"bit-equal; waic(num_samples=8) over "
                  f"{n_a} rows {w['waic']:.1f} (se {w['se']:.1f}) in "
                  f"{waic_s:.2f} s; log_likelihood of {AE_B} held-out rows "
                  f"(8 samples) per_row {ll['per_row']:.4f} in {ll_s:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = {k: sum(p[k] for p in launches.values())
             for k in read_launches()}
    say("AE", f"phase AE took {time.perf_counter() - t_phase:.1f} s")
    return total


def small_scan(dev, capture, dtype, fit_kw=None, fused_normals=False, **kw):
    """A fit over a small DeviceArrayDataset through the scan path, captured
    in CUDA graphs or run eagerly on the card: N=350, D=300, B=100 (3 full
    batches and a 50-row remainder), patience 1 and a learning rate that
    forces plateau restores. Returns (losses, lr, params, extras)."""
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset
    from spmf_tpu_torch.vi import epoch_scan

    n_b, d_b, b_b = SMALL_SCAN
    xb = np.random.default_rng(7).poisson(1.0, (n_b, d_b))
    ds = DeviceArrayDataset({"counts": xb, "indices": np.arange(n_b)},
                            batch_size=b_b, shuffle=True, seed=3,
                            dtype=dtype, device=dev)
    m = PoissonFactorization(latent_dim=4, feature_dim=d_b, dtype=dtype,
                             device=dev,
                             u_tau_scale=1.0 / np.sqrt(n_b * d_b), **kw)
    m._surrogate.fused_normals = fused_normals
    epoch_scan._CAPTURE = capture
    try:
        losses = m.fit(batched_data_factory=ds, **dict(dict(
            num_steps=4, learning_rate=2.0, sample_size=4, patience=1,
            rel_tol=None, verbose=False, seed=5), **(fit_kw or {})))
    finally:
        epoch_scan._CAPTURE = True
    return (losses, m.last_fit.learning_rate, m.surrogate_params,
            m.last_fit.extras)


def options_phase(dev, smi, zero_launches, read_launches):
    """Phase O: the engine options at the dense scRNA width (D=20000, K=32,
    S=8, B=4096, float32, N=16384 resident, the captured scan, 3 epochs an
    arm, epochs 2-3 read), arms in turns, the second turn profiled: the
    default, elbo_estimator='stl', aux_broadcast, gamma_sampler='exact',
    remat_sampling=True with 'fused' (K3 re-runs), with 'fused' and
    fused_normals (K3 and K6 re-run), with 'fast', and remat_sampling=False
    with 'fast'. Then on the card: rematerialised captured fits against
    eager fits without remat (bit for bit through K3 and K6, 1e-5 through
    K1's atomic sums), K3 at S=1 (the broadcast block) against its float64
    twin and its time beside S=8, and the exact sampler over the IG block
    at S=8 (11.2 M values): its draws' KS distance from Gamma(a) and its
    gradient against the float64 formula. Returns the kernel launches of
    its fits, summed over the arms."""
    import torch
    from scipy import stats

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset
    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops.gamma import sample_gamma

    t_phase = time.perf_counter()
    launches = {}
    g = torch.Generator(device=dev).manual_seed(41)

    # (a) the arms
    n_o, b_o = OPT_ROWS, OPT_BATCH
    xo = torch.poisson(torch.ones(n_o, D, device=dev), generator=g)
    ds = DeviceArrayDataset({"counts": xo,
                             "indices": torch.arange(n_o, device=dev)},
                            batch_size=b_o, device=dev)
    m = PoissonFactorization(latent_dim=K, feature_dim=D, dtype="float32",
                             device=dev, data=ds)
    sur = m._surrogate
    aux = frozenset(n for n in sur.names if "_eta" in n or "_tau" in n)
    init = clone_params(m.surrogate_params)
    steps = n_o // b_o
    fits = 2 * 3 * steps       # steps of an arm's two fits
    # (tag, surrogate settings, fit options, launch check)
    arms = (
        ("default", {}, {},
         lambda c: c["fwd"] >= fits and c["bwd"] >= fits),
        ("stl", {}, dict(elbo_estimator="stl"),
         lambda c: c["bwd"] == c["nbwd"] == 0),
        ("aux_broadcast", dict(broadcast_names=aux), {},
         lambda c: c["fwd"] >= fits and c["bwd"] >= fits),
        ("exact", dict(gamma_sampler="exact"), {},
         lambda c: c["bwd"] == c["nbwd"] == 0),
        ("remat fused", {}, dict(remat_sampling=True),
         lambda c: c["fwd"] >= 2 * fits and c["bwd"] >= fits),
        ("remat fused + fused_normals", dict(fused_normals=True),
         dict(remat_sampling=True),
         lambda c: c["fwd"] >= 2 * fits and c["nfwd"] >= 2 * fits
         and c["nbwd"] >= fits),
        ("remat fast", dict(gamma_sampler="fast"), dict(remat_sampling=True),
         lambda c: c["bwd"] == c["nbwd"] == 0),
        ("no remat fast", dict(gamma_sampler="fast"),
         dict(remat_sampling=False),
         lambda c: c["bwd"] == c["nbwd"] == 0))
    base = dict(gamma_sampler="fused", broadcast_names=frozenset(),
                fused_normals=False)
    res = {}
    counts = {tag: Counter() for tag, *_ in arms}
    for profiled in (False, True):
        for tag, settings, fit_kw, _ in arms:
            for k, v in dict(base, **settings).items():
                setattr(sur, k, v)
            zero_launches()
            res.setdefault(tag, []).append(run_fit(
                m, init, ds, num_steps=3, profiled=profiled, **fit_kw))
            counts[tag].update(read_launches())
    for k, v in base.items():
        setattr(sur, k, v)
    for tag, settings, fit_kw, launched in arms:
        turns = res[tag]
        got = launches[tag] = dict(counts[tag])
        check(all(np.isfinite(t[0]).all() and t[4] for t in turns)
              and got["stats"] >= fits and launched(got),
              f"O {tag}: losses {turns[0][0]}, scan "
              f"{[t[4] for t in turns]}, launches {got}")
        report_arm("O", smi, f"{tag} D={D} K={K} B={b_o} captured scan "
                             f"(second turn profiled: {turns[1][1]:.2f} "
                             "ms/step)", b_o, turns[0][1], turns[0][2],
                   turns[1][3], 2 * steps)
        say("O", f"  losses {[round(x, 4) for x in turns[0][0]]}; "
                 f"launches {got}")
    del m, ds, xo, init, res

    # (b) remat on the captured scan against no remat on the eager scan
    for dtype, kw, fn in (
            ("float64", dict(fused_likelihood=False, gamma_sampler="fast"),
             False),
            ("float32", dict(fused_likelihood=False, gamma_sampler="fused"),
             True)):
        (lc, lrc, pc, _), (le, lre, pe, _) = (
            small_scan(dev, c, dtype, fit_kw=dict(remat_sampling=r),
                       fused_normals=fn, **kw)
            for c, r in ((True, True), (False, False)))
        same = all(torch.equal(pc[n][k], pe[n][k]) for n in pc for k in pc[n])
        check(lc == le and lrc == lre < 2.0 and same,
              f"O remat {dtype}: captured remat {lc} (lr {lrc}) against "
              f"eager without {le} (lr {lre}), params equal {same}")
        say("O", f"{dtype} remat_sampling=True on the captured scan == "
                 f"remat_sampling=False on the eager scan bit for bit "
                 f"(losses, every parameter, lr {lrc}; "
                 f"{'K3 and K6' if fn else 'the plain path'})")
    # through K1 as phase G holds it (K1 and K3; with fused_normals this
    # trajectory diverges by epoch 4 and amplifies K1's atomic-sum noise
    # past 1e-5, remat or not), beside two eager runs' spread
    k1 = dict(fused_likelihood=True, gamma_sampler="fused")
    (lc, lrc, _, _), (le, lre, _, _), (le2, _, _, _) = (
        small_scan(dev, c, "float32", fit_kw=dict(remat_sampling=r), **k1)
        for c, r in ((True, True), (False, False), (False, False)))
    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b))  # noqa: E731
                                    / np.abs(b)))
    check(lrc == lre and rel(lc, le) < 1e-5,
          f"O remat through K1: {lc} (lr {lrc}) against {le} (lr {lre})")
    say("O", f"float32 through K1 and K3: captured remat against eager "
             f"without, losses {rel(lc, le):.2e} relative at most, two "
             f"eager runs without {rel(le, le2):.2e} (K1's atomic sums), lr "
             f"{lrc} both")

    # (c) K3 at S=1, the broadcast block's draw, against its float64 twin
    # (tolerances as phase 4) and its time beside S=8
    a = torch.rand(IG_TOTAL, generator=g, device=dev) * 5 + 0.3
    b = torch.rand(IG_TOTAL, generator=g, device=dev) * 3 + 0.1
    seed = torch.tensor([24680], dtype=torch.int32, device=dev)
    gy = torch.randn(1, IG_TOTAL, generator=g, device=dev)
    glq = torch.randn(1, generator=g, device=dev)
    y_k, lq_k = tig._kernel_fwd(a, b, seed, 1, False)
    y_t, lq_t = tig.ig_twin_fwd(a.double(), b.double(), seed, 1, False)
    ga_k, gb_k = tig._kernel_bwd(a, b, seed, 1, False, gy, glq)
    ga_t, gb_t = tig.ig_twin_bwd(a.double(), b.double(), seed, 1, False,
                                 gy.double(), glq.double())
    e_y, e_lq = rel_elem(y_k, y_t), rel_elem(lq_k, lq_t)
    e_g = max(rel_max(ga_k, ga_t), rel_max(gb_k, gb_t))
    check(e_y < 1e-5 and e_lq < 1e-5 and e_g < 1e-4,
          f"O K3 S=1: y {e_y}, lq {e_lq}, grads {e_g}")
    ms1 = (cuda_ms(lambda: tig._kernel_fwd(a, b, seed, 1, False)),
           cuda_ms(lambda: tig._kernel_bwd(a, b, seed, 1, False, gy, glq)))
    gy8 = torch.randn(S, IG_TOTAL, generator=g, device=dev)
    glq8 = torch.randn(S, generator=g, device=dev)
    ms8 = (cuda_ms(lambda: tig._kernel_fwd(a, b, seed, S, False)),
           cuda_ms(lambda: tig._kernel_bwd(a, b, seed, S, False, gy8, glq8)))
    say("O", f"K3 at S=1 (total={IG_TOTAL}): y rel {e_y:.2e}, lq rel "
             f"{e_lq:.2e}, ga/gb rel-of-max {e_g:.2e} against the float64 "
             f"twin; K3f {ms1[0]:.4f} ms, K3b {ms1[1]:.4f} ms against "
             f"{ms8[0]:.4f} / {ms8[1]:.4f} at S={S} (CUDA events; {smi})")
    del y_k, y_t, ga_k, gb_k, ga_t, gb_t, gy8

    # (d) the exact sampler at the IG block's size: S x IG_TOTAL draws
    conc = a.expand(S, IG_TOTAL).clone().requires_grad_(True)
    gen = torch.Generator(device=dev).manual_seed(43)
    x = sample_gamma(gen, conc, "exact")
    w = torch.randn(x.shape, generator=g, device=dev)
    (x * w).sum().backward()
    pick = torch.randperm(x.numel(), generator=g, device=dev)[:200_000]
    xs = x.detach().reshape(-1)[pick].double().cpu().numpy()
    a_s = conc.detach().reshape(-1)[pick].double().cpu().numpy()
    ks = stats.kstest(stats.gamma.cdf(xs, a_s), "uniform").statistic
    ref = w.double() * torch._standard_gamma_grad(conc.detach().double(),
                                                  x.detach().double())
    e_grad = rel_max(conc.grad, ref)
    check(ks < 0.01 and e_grad < 1e-4,
          f"O exact sampler: KS {ks}, gradient rel-of-max {e_grad}")
    draw_ms = cuda_ms(lambda: sample_gamma(gen, conc.detach(), "exact"))

    def draw_and_grad():
        conc.grad = None
        (sample_gamma(gen, conc, "exact") * w).sum().backward()

    both_ms = cuda_ms(draw_and_grad)
    say("O", f"exact sampler over {x.numel()} values (S={S} x "
             f"{IG_TOTAL}): KS distance of Gamma(a)'s CDF at the draws from "
             f"U(0, 1) {ks:.2e} (200,000 draws), gradient rel-of-max "
             f"{e_grad:.2e} against the float64 formula at the same (a, x); "
             f"the draw {draw_ms:.3f} ms, draw and gradient {both_ms:.3f} "
             f"ms (CUDA events; {smi})")
    del conc, x, w, ref
    say("O", f"phase O took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(p[k] for p in launches.values())
            for k in next(iter(launches.values()))}


#: phase M's two gloo ranks on card 0, and its time limit for them
MESH_RANKS, MESH_TIMEOUT = 2, 900
#: phase M (h): the scan's remainder past OPT_ROWS, which dp=2 does not divide
MESH_REM = 1025
#: the kernels phase M counts, as the JSON line names them
MESH_KERNELS = ("stats", "static", "fwd", "bwd", "row_ll", "expsum",
                "nfwd", "nbwd")
MESH_NOTE = ("two ranks share one card through gloo: not a scaling "
             "measurement")


def mesh_kernel_checks(mesh, dev, layout):
    """Phase M (a) on one rank: K1 / K2 / K4 on this rank's tile of phase
    3's inputs (S=8, B=1024, D=20000, K=32, a rescue batch) with the
    statistics combined over the ranks, against the float64 twin on the
    full tile; on the fp layout K3's sharded assembly against per-slice
    calls. Returns the errors (checks raise)."""
    import torch

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops import fused_poisson as tfp
    from spmf_tpu_torch.vi.minibatch import _MeshPlan
    from spmf_tpu_torch.vi.surrogates import _softplus

    B = 1024
    full = stats_inputs(B, dev, seed=1, rescue=True)
    r0, r1 = mesh.local_rows(B)
    c0, c1 = mesh.feature_slice(D)
    tile = [full[0][:, r0:r1], full[1][..., c0:c1], full[2][..., c0:c1],
            full[3][r0:r1, c0:c1], full[4][..., c0:c1]]
    tile = [t.contiguous() for t in tile]
    out = {}
    axes = tuple(mesh.live_axes)
    for static in (False, True):
        twin = tfp.stats_twin(*[a.double() for a in full], static=static)
        want = (twin[0] if static else
                twin[0] + twin[1].double()
                * tfp._floor_min_val(twin[2] - 10.0)[0])
        th, vv, ph = (t.clone().requires_grad_(True) for t in tile[:3])
        got = tfp.fused_poisson_loglik_sharded(
            th, vv, ph, tile[3], tile[4], mesh,
            clip="static" if static else "reference")
        # every rank holds the global sums: each backpropagates its share,
        # and the copies' gradients are summed (theta's over fp, v's and
        # phi's over the row ranks), as the engine's reduction does
        (got.sum() / mesh.size).backward()
        if mesh.fp_axis is not None:
            mesh.all_sum_(th.grad, (mesh.fp_axis,))
        if mesh.row_axes:
            mesh.all_sum_(vv.grad, mesh.row_axes)
            mesh.all_sum_(ph.grad, mesh.row_axes)
        e_sum = rel_elem(got, want)
        e_grad = max(rel_max(th.grad, twin[3][:, r0:r1]),
                     rel_max(vv.grad, twin[4][..., c0:c1]),
                     rel_max(ph.grad, twin[5][..., c0:c1]))
        check(e_sum < 1e-5 and e_grad < 1e-4,
              f"M {layout} {'K2' if static else 'K1'}: sums {e_sum}, "
              f"gradients {e_grad}")
        key = "static" if static else "stats"
        out[key] = {"sum": e_sum, "grad": e_grad}
        if not static:
            # the statistics themselves, combined as the wrapper does
            _, cnt, gmin, *_ = tfp._kernel_stats(*tile, False, False)
            cnt = mesh.all_sum_(cnt.clone(), axes)
            gmin = mesh.all_min_(gmin.clone(), axes)
            check(torch.equal(cnt.cpu(), twin[1].cpu())
                  and rel_elem(gmin, twin[2]) < 1e-6,
                  f"M {layout} K1 statistics: counts {cnt.tolist()} vs "
                  f"{twin[1].tolist()}, gmin {gmin.item()} vs "
                  f"{twin[2].item()}")
            out["stats"]["counts"] = cnt.tolist()
        torch.cuda.synchronize()
    # K4 on the healthy inputs (the rescue batch's rows are all NaN)
    full = stats_inputs(B, dev, seed=1)
    tile = [full[0][:, r0:r1], full[1][..., c0:c1], full[2][..., c0:c1],
            full[3][r0:r1, c0:c1], full[4][..., c0:c1]]
    rows = tfp.fused_poisson_row_loglik_sharded(
        *[t.contiguous() for t in tile], mesh, log_transform=True)
    want = tfp.row_loglik_twin(*[a.double() for a in full],
                               log_transform=True)[:, r0:r1]
    out["row_ll"] = rel_max(rows, want)
    check(out["row_ll"] < 1e-5, f"M {layout} K4: {out['row_ll']}")

    if mesh.fp_axis is not None:
        m = PoissonFactorization(latent_dim=K, feature_dim=D, dtype="float32",
                                 device=dev, mesh=mesh, gamma_sampler="fused")
        sur = m._surrogate
        names = sur._ig_names
        params = _MeshPlan(mesh, sur, "fp").local_params(m.surrogate_params)
        with torch.no_grad():
            g = torch.Generator(device=dev).manual_seed(123)
            values, logq = sur._sample_igs(names, params, g, (S,))
            g = torch.Generator(device=dev).manual_seed(123)
            split = [n for n in names if sur._split_axis(n) is not None]
            repl = [n for n in names if n not in split]

            def flat(ns, key):
                return torch.cat([_softplus.forward(params[n][key])
                                  .reshape(-1) for n in ns])

            seed_r = torch.randint(0, 2**31 - 1, (1,), generator=g,
                                   dtype=torch.int32, device=dev)
            y_r, lq_r = tig.fused_ig_sample_logq(
                flat(repl, "raw_concentration"), flat(repl, "raw_scale"),
                seed_r, S)
            seed_s = torch.randint(0, 2**31 - 1, (1,), generator=g,
                                   dtype=torch.int32, device=dev) \
                + mesh.fp_index
            y_s, lq_s = tig.fused_ig_sample_logq(
                flat(split, "raw_concentration"), flat(split, "raw_scale"),
                seed_s, S)
            ys = torch.cat([y_r, y_s], dim=1)
            got = torch.cat([values[n].reshape(S, -1) for n in repl + split],
                            dim=1)
            bits = torch.equal(got, ys)
            e_lq = rel_elem(logq, lq_r + mesh.all_sum(lq_s, ("fp",)))
        check(bits and e_lq < 1e-6,
              f"M {layout} K3: bit for bit {bits}, log q {e_lq}")
        out["ig"] = {"bit_for_bit": bits, "logq": e_lq,
                     "local_elements": int(y_s.shape[1])}
    return out


def first_step_grads(model, mesh, batch):
    """One training step's loss and the gradient of every surrogate
    parameter, whole, at the model's initial parameters on ``batch`` (the
    global batch) and a fixed seed, as the fit engine computes them on
    ``mesh`` (None: one process): this rank's part of the batch, the
    gradient reduction, the fp slices gathered."""
    import torch

    from spmf_tpu_torch.parallel import collectives
    from spmf_tpu_torch.vi.minibatch import _MeshPlan

    plan = None if mesh is None else _MeshPlan(mesh, model._surrogate,
                                               "fp")
    params = (model.surrogate_params if plan is None
              else plan.local_params(model.surrogate_params))
    params = {n: {k: t.detach().clone().requires_grad_(True)
                  for k, t in sub.items()} for n, sub in params.items()}
    gen = torch.Generator(device=model.device).manual_seed(0)
    samples, logq = model._surrogate.sample_and_log_prob(params, gen, (S,))
    lp = model.unormalized_log_prob(
        data=batch if plan is None else plan.batch(batch), **samples)
    loss = -torch.mean(lp - logq) / len(batch["indices"])
    if plan is None:
        loss.backward()
    else:
        (loss / mesh.size).backward()
        collectives.reduce_gradients(plan.buckets(params))
    grads = {n: {k: t.grad for k, t in sub.items()}
             for n, sub in params.items()}
    if plan is not None:
        grads = plan.full_params(grads)
    return float(loss.detach()), grads


def mesh_arms(mesh_dp, mesh_fp, mesh_sub, dev, zero_launches, read_launches,
              outdir):
    """Phase M (b)-(d) and (f)-(i) on one rank (the meshes) or in one
    process (no mesh): the fits at full width, the 0.1% COO epoch, the
    scoring, the autoencoder on fp=2, a feature dim fp=2 does not divide,
    a scan remainder dp=2 does not divide, and a mesh over one of the two
    ranks (``mesh_sub``). Each arm: its losses, ms/step, peak GB, kernel
    launches, the gradient reduction's calls, bytes and seconds, and every
    collective's calls and bytes. The arms held to one process also take
    their first step's loss and gradients at the initial parameters: one
    process writes them to ``outdir``, each rank compares its own (each
    leaf's largest difference over its largest entry)."""
    import torch

    from spmf_tpu_torch import PoissonAutoencoder, PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset
    from spmf_tpu_torch.parallel import collectives

    collectives.TIME_GRADIENTS = True
    n_m, b_m = OPT_ROWS, OPT_BATCH
    g = torch.Generator(device=dev).manual_seed(41)
    xm = torch.poisson(torch.ones(n_m, D, device=dev), generator=g)
    ds = DeviceArrayDataset({"counts": xm,
                             "indices": torch.arange(n_m, device=dev)},
                            batch_size=b_m, device=dev)
    arms = {}

    def arm(tag, mesh, source, steps, first=None, make=None, **kw):
        """``make(mesh, **kw)``: the model (default: the dense
        factorization); ``first``: the batch of the first-step check
        (default: the first rows of the dense set)."""
        fit_kw = kw.pop("fit", {})
        grads_as = kw.pop("grads_as", None)
        normals = kw.pop("fused_normals", False)
        if make is None:
            m = PoissonFactorization(latent_dim=K, feature_dim=D,
                                     dtype="float32", device=dev, mesh=mesh,
                                     **kw)
        else:
            m = make(mesh, **kw)
        m._surrogate.fused_normals = normals
        step_grads = None
        if grads_as is not None:
            path = os.path.join(outdir, f"grads_{grads_as}.pt")
            if first is None:
                first = {"counts": xm[:b_m],
                         "indices": torch.arange(b_m, device=dev)}
            loss1, g1 = first_step_grads(m, mesh, first)
            if mesh is None:
                torch.save({"loss": loss1, "grads": g1}, path)
            else:
                ref = torch.load(path, map_location=dev)
                step_grads = {
                    "loss": abs(loss1 - ref["loss"]) / abs(ref["loss"]),
                    "grads": max(
                        float((g1[n][k] - r).abs().max() / r.abs().max())
                        for n, sub in ref["grads"].items()
                        for k, r in sub.items())}
            del g1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_stats()
        zero_launches()
        losses = m.fit(batched_data_factory=source, **dict(dict(
            num_steps=3, learning_rate=0.01, sample_size=S, rel_tol=None,
            verbose=False, seed=0), **fit_kw))
        torch.cuda.synchronize()
        ex = m.last_fit.extras
        first = 1 if len(ex["epoch_seconds"]) > 1 else 0
        arms[tag] = {
            "losses": [float(x) for x in losses],
            "ms": float(np.median(ex["epoch_seconds"][first:])) / steps * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": read_launches(),
            "grad": dict(collectives.STATS),
            "steps": steps * len(ex["epoch_seconds"]),
            "dispatch": getattr(m, "fusion_inactive_reason", None),
            "scan": ex["epoch_scan"], "captured": ex.get("captured"),
            "first_step": step_grads}
        return m

    steps = n_m // b_m
    # K6 on the mesh: horshoe_plus=False has no IG block, so with
    # fused_normals every draw of an fp=2 step is K6's at full width (the
    # one-process seed), then sliced
    k6 = dict(horshoe_plus=False, fused_normals=True, grads_as="k6")
    if mesh_dp is None:
        arm("one process, fused", None, ds, steps, grads_as="fused")
        # a second run: the spread K1's atomic sums leave between two runs
        arm("one process, fused, again", None, ds, steps)
        arm("one process, fast", None, ds, steps, gamma_sampler="fast",
            grads_as="fast")
        arm("one process, non-plus, fused_normals", None, ds, steps, **k6)
    else:
        arm("dp=2, fused", mesh_dp, ds, steps, grads_as="fused")
        arm("fp=2, fused, param_sharding='fp'", mesh_fp, ds, steps,
            fit=dict(param_sharding="fp"))
        arm("fp=2, fast, param_sharding='fp'", mesh_fp, ds, steps,
            gamma_sampler="fast", fit=dict(param_sharding="fp"),
            grads_as="fast")
        arm("fp=2, non-plus, fused_normals, param_sharding='fp'", mesh_fp,
            ds, steps, fit=dict(param_sharding="fp"), **k6)
    # (i) data_parallel_mesh(1) in the world of two: rank 0 trains on its
    # one-rank mesh as one process does ('fast': no atomic sums in the
    # draw; a world of two keeps the general loop, as spmf_tpu keeps it
    # for several processes); rank 1 is outside it, and fit raises there
    tag = "(i) data_parallel_mesh(1) of two, fast"
    if mesh_dp is None:
        arm("(i) one process, fast, general loop", None, ds, steps,
            gamma_sampler="fast", fit=dict(epoch_scan=False))
    elif mesh_sub.member:
        arm(tag, mesh_sub, ds, steps, gamma_sampler="fast")
    else:
        m_i = PoissonFactorization(latent_dim=K, feature_dim=D,
                                   dtype="float32", device=dev, mesh=mesh_sub)
        try:
            m_i.fit(batched_data_factory=ds, num_steps=1, verbose=False)
            refused = "no error"
        except ValueError as exc:
            refused = str(exc)
        arms[tag] = {"refused": refused, "launches": read_launches()}
        del m_i
    del ds, xm

    # (f) the autoencoder at its bench width on fp=2: every w_l split over
    # its output axis (2000 and 32 divide), the forward column-parallel,
    # K6 drawing the Normal block whole on each rank, then sliced
    n_a = 3 * AE_B
    xa = torch.poisson(torch.ones(n_a, AE_D, device=dev), generator=g)
    dsa = DeviceArrayDataset({"counts": xa,
                              "indices": torch.arange(n_a, device=dev)},
                             batch_size=AE_B, device=dev)

    def autoencoder(mesh):
        m = PoissonAutoencoder(dsa, latent_dim=AE_K, dtype="float32",
                               device=dev, mesh=mesh)
        m._surrogate.gamma_sampler = "fused"
        return m

    arm("(f) autoencoder, " + ("one process" if mesh_fp is None
                               else "fp=2"), mesh_fp, dsa, n_a // AE_B,
        first={"counts": xa[:AE_B],
               "indices": torch.arange(AE_B, device=dev)},
        make=autoencoder, fused_normals=True, grads_as="ae",
        fit=dict(num_steps=1))
    del dsa, xa

    # (g) D=19,999, which fp=2 does not divide: every variable and column
    # whole on both ranks, K3 whole with one seed, and the fusion check
    # sends the batches to the plain path (one process takes it too)
    d_g = D - 1
    xg = torch.poisson(torch.ones(3 * b_m, d_g, device=dev), generator=g)
    dsg = DeviceArrayDataset({"counts": xg,
                              "indices": torch.arange(3 * b_m, device=dev)},
                             batch_size=b_m, device=dev)

    def odd_width(mesh, **kw):
        return PoissonFactorization(latent_dim=K, feature_dim=d_g,
                                    dtype="float32", device=dev, mesh=mesh,
                                    **kw)

    first_g = {"counts": xg[:b_m], "indices": torch.arange(b_m, device=dev)}
    if mesh_fp is None:
        arm(f"(g) D={d_g}, one process, plain", None, dsg, 3, first=first_g,
            make=odd_width, fused_likelihood=False, grads_as="odd_width",
            fit=dict(num_steps=1))
    else:
        arm(f"(g) D={d_g}, fp=2", mesh_fp, dsg, 3, first=first_g,
            make=odd_width, grads_as="odd_width", fit=dict(num_steps=1))
    del dsg, xg, first_g
    torch.cuda.empty_cache()

    # (h) the dense scan over 16,384 + 1,025 rows at B=4096: dp=2 does not
    # divide the remainder, which every rank trains on whole (fusion off
    # for it alone); the full batches keep K1 on their tiles
    n_h = OPT_ROWS + MESH_REM
    xh = torch.poisson(torch.ones(n_h, D, device=dev), generator=g)
    dsh = DeviceArrayDataset({"counts": xh,
                              "indices": torch.arange(n_h, device=dev)},
                             batch_size=b_m, device=dev)
    arm(f"(h) remainder {MESH_REM}, " + ("one process" if mesh_dp is None
                                  else "dp=2"), mesh_dp, dsh,
        n_h // b_m + 1)
    del dsh, xh

    # (c) the 0.1% flat set, one epoch through the COO energy and K5 (the
    # general loop: a sparse source keeps it on a mesh)
    sp_c, norms_c = sparse_counts(N_SPARSE, D, DENSITY_COO, 41, dev)
    sp_c.shuffle(seed=0).batch(B_SPARSE, drop_remainder=True).as_coo()
    flat_c = sp_c.to_device(device=dev)
    coo = dict(log_transform=True, column_norms=norms_c,
               u_tau_scale=1.0 / np.sqrt(N_SPARSE * D), data=flat_c)
    tag = "COO 0.1%, " + ("one process" if mesh_dp is None else "dp=2")
    m_c = arm(tag, mesh_dp, flat_c, N_SPARSE // B_SPARSE,
              fit=dict(num_steps=1, epoch_scan=False), **coo)
    arms[tag]["dispatch"] = m_c.fusion_inactive_reason
    del flat_c, sp_c

    # (d) scoring: 4096 held-out sparse rows, 100 samples, and waic
    held, _ = sparse_counts(B_SPARSE, D, DENSITY, 13, dev)
    held.batch(B_SPARSE).as_coo()
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = m_c.log_likelihood(held, num_samples=100, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    w = m_c.waic(held, num_samples=32)
    tag = "scoring, " + ("one process" if mesh_dp is None else "dp=2")
    arms[tag] = {"log_likelihood": ll, "waic": w, "seconds": ll_s,
                 "launches": read_launches()}
    torch.cuda.empty_cache()
    return arms


def mesh_rank_main(rank, port, outdir):
    """One of phase M's gloo ranks on card 0: (a), then (b)-(d) with the
    counters zeroed first; writes rank{rank}.json."""
    import torch

    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops import fused_normal as tfn
    from spmf_tpu_torch.ops import fused_poisson as tfp
    from spmf_tpu_torch.parallel import (data_parallel_mesh,
                                         initialize_distributed, make_mesh)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    initialize_distributed(f"127.0.0.1:{port}", MESH_RANKS, rank,
                           backend="gloo")
    counters = {"stats": (tfp.LAUNCHES, "stats"),
                "static": (tfp.LAUNCHES, "static"),
                "row_ll": (tfp.LAUNCHES, "row_ll"),
                "expsum": (tfp.LAUNCHES, "expsum"),
                "fwd": (tig.LAUNCHES, "fwd"), "bwd": (tig.LAUNCHES, "bwd"),
                "nfwd": (tfn.LAUNCHES, "fwd"), "nbwd": (tfn.LAUNCHES, "bwd")}

    def zero():
        for d, k in counters.values():
            d[k] = 0

    def read():
        return {n: d[k] for n, (d, k) in counters.items()}

    mesh_dp = make_mesh((MESH_RANKS,), ("dp",))
    mesh_fp = make_mesh((1, MESH_RANKS), ("dp", "fp"))
    mesh_sub = data_parallel_mesh(1)
    out = {"rank": rank, "checks": {}}
    t0 = time.perf_counter()
    for layout, mesh in (("dp=2", mesh_dp), ("fp=2", mesh_fp)):
        out["checks"][layout] = mesh_kernel_checks(mesh, dev, layout)
    out["checks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["arms"] = mesh_arms(mesh_dp, mesh_fp, mesh_sub, dev, zero, read,
                            outdir)
    out["arms_s"] = time.perf_counter() - t0
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"M rank {rank}: done", flush=True)


def nccl_main(outdir):
    """Phase M (e): NCCL at world size 1 on the card: the collectives
    module's SUM (with its backward), MIN, broadcast and bucketed gradient
    reduction on CUDA tensors against their expected values."""
    import torch

    from spmf_tpu_torch.parallel import collectives as coll
    from spmf_tpu_torch.parallel import free_port, initialize_distributed
    from spmf_tpu_torch.parallel.mesh import make_mesh

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                           backend="nccl")
    dev = torch.device("cuda", 0)
    group = torch.distributed.group.WORLD
    x = torch.arange(6.0, device=dev).requires_grad_(True)
    y = coll.all_reduce_sum(x * 2.0, group)
    y.sum().backward()
    res = {"sum": torch.equal(y.detach(), torch.arange(6.0, device=dev) * 2),
           "sum_grad": torch.equal(x.grad, torch.full((6,), 2.0, device=dev))}
    m = torch.tensor([3.0, -1.0], device=dev)
    res["min"] = torch.equal(coll.all_min_(m.clone(), group), m)
    b = torch.tensor([7.0], device=dev)
    res["broadcast"] = torch.equal(coll.broadcast_(b.clone(), group, 0), b)
    p = [torch.ones(3, device=dev, requires_grad=True),
         torch.ones(2, 2, device=dev, requires_grad=True)]
    p[0].grad = torch.full((3,), 1.5, device=dev)
    coll.reduce_gradients([(group, p)])
    res["buckets"] = (torch.equal(p[0].grad, torch.full((3,), 1.5,
                                                        device=dev))
                      and torch.equal(p[1].grad, torch.zeros(2, 2,
                                                             device=dev)))
    res["gather"] = torch.equal(coll.gather_full(m, 0, 1, 0, group), m)
    res["mesh"] = make_mesh((1,), ("dp",)).trivial
    res["backend"] = torch.distributed.get_backend()
    with open(os.path.join(outdir, "nccl.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def mesh_phase(dev, smi, zero_launches, read_launches):
    """Phase M: multi-rank training. The one-process arms here first (the
    card to themselves), then two gloo ranks on card 0 (this script run
    with --mesh-rank; a rank that exits non-zero or writes no result fails
    the phase), then NCCL at world size 1. Returns the main path's kernel
    launches: this process's arms and both ranks'."""
    from spmf_tpu_torch.parallel import free_port

    import torch

    t_phase = time.perf_counter()
    outdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        single = mesh_arms(None, None, None, dev, zero_launches,
                           read_launches, outdir)
        # the ranks' arms need the card's memory this process cached
        torch.cuda.empty_cache()
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), port, outdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(MESH_RANKS)]
        try:
            outs = [p.communicate(timeout=MESH_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            path = os.path.join(outdir, f"rank{r}.json")
            check(p.returncode == 0 and os.path.exists(path),
                  f"M rank {r} exited {p.returncode}:\n{out[-6000:]}")
            with open(path) as f:
                ranks.append(json.load(f))
        nccl = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--nccl-check", outdir], capture_output=True,
                              text=True, timeout=300)
        path = os.path.join(outdir, "nccl.json")
        check(nccl.returncode == 0 and os.path.exists(path),
              f"M NCCL check exited {nccl.returncode}:\n"
              f"{(nccl.stdout + nccl.stderr)[-4000:]}")
        with open(path) as f:
            nccl_res = json.load(f)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    r0 = ranks[0]
    for layout, c in r0["checks"].items():
        say("M", f"(a) {layout}, rank 0 of {MESH_RANKS}, phase 3's inputs "
                 f"(S={S}, B=1024, D={D}, K={K}, rescue batch): K1 on the "
                 f"tile, statistics combined: sums {c['stats']['sum']:.2e}, "
                 f"gradients {c['stats']['grad']:.2e}, counts "
                 f"{c['stats']['counts']} = the float64 twin's; K2 "
                 f"{c['static']['sum']:.2e} / {c['static']['grad']:.2e}; K4 "
                 f"{c['row_ll']:.2e}" + (
                     f"; K3 on {c['ig']['local_elements']} local elements, "
                     f"seed base + fp index: bit for bit "
                     f"{c['ig']['bit_for_bit']}, log q {c['ig']['logq']:.2e}"
                     if "ig" in c else ""))
    for r in ranks[1:]:
        check(r["checks"].keys() == r0["checks"].keys(), "M checks differ")

    def same(tag):
        traces = [r["arms"][tag]["losses"] for r in ranks]
        check(all(t == traces[0] for t in traces),
              f"M {tag}: the ranks' traces differ {traces}")
        return traces[0]

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    def first_step(tag):
        """The largest first-step loss and gradient differences from one
        process over the ranks (gradients: each leaf's largest difference
        over its largest entry; K1's atomic sums leave about 1e-6, a
        different draw about 1e-1)."""
        fs = [r["arms"][tag]["first_step"] for r in ranks]
        return (max(f["loss"] for f in fs), max(f["grads"] for f in fs))

    # loss traces within 1e-6 relative: two sound runs read at most
    # 1.1e-7, and the fp=2 'fused' trace (other IG draws by design) reads
    # 6.5e-6 from dp=2
    dp_l = same("dp=2, fused")
    e_dp = rel(dp_l, single["one process, fused"]["losses"])
    e_again = rel(single["one process, fused, again"]["losses"],
                  single["one process, fused"]["losses"])
    g_dp = first_step("dp=2, fused")
    check(e_dp < 1e-6 and g_dp[0] < 1e-6 and g_dp[1] < 1e-4,
          f"M dp=2 against one process: losses {e_dp} ({dp_l}), first "
          f"step loss and gradients {g_dp}")
    fp_l = same("fp=2, fused, param_sharding='fp'")
    check(np.isfinite(fp_l).all() and fp_l[2] < fp_l[1] and fp_l[3] < fp_l[2],
          f"M fp=2 fused: not finite and decreasing {fp_l}")
    e_fused = rel(fp_l, dp_l)
    fpf_l = same("fp=2, fast, param_sharding='fp'")
    e_fp = rel(fpf_l, single["one process, fast"]["losses"])
    g_fp = first_step("fp=2, fast, param_sharding='fp'")
    check(e_fp < 1e-6 and g_fp[0] < 1e-6 and g_fp[1] < 1e-4,
          f"M fp=2 fast against one process: losses {e_fp}, first step "
          f"loss and gradients {g_fp}")
    k6_l = same("fp=2, non-plus, fused_normals, param_sharding='fp'")
    e_k6 = rel(k6_l, single["one process, non-plus, fused_normals"]["losses"])
    g_k6 = first_step("fp=2, non-plus, fused_normals, param_sharding='fp'")
    check(e_k6 < 1e-6 and g_k6[0] < 1e-6 and g_k6[1] < 1e-4,
          f"M fp=2 K6 (fused_normals) against one process: losses {e_k6}, "
          f"first step loss and gradients {g_k6}")
    coo_l = same("COO 0.1%, dp=2")
    e_coo = rel(coo_l, single["COO 0.1%, one process"]["losses"])
    check(e_coo < 1e-6
          and "COO" in str(r0["arms"]["COO 0.1%, dp=2"]["dispatch"]),
          f"M COO dp=2 against one process: {e_coo}, dispatch "
          f"{r0['arms']['COO 0.1%, dp=2']['dispatch']}")
    sc, sc1 = r0["arms"]["scoring, dp=2"], single["scoring, one process"]
    e_ll = rel(sc["log_likelihood"]["total"], sc1["log_likelihood"]["total"])
    e_w = max(rel(sc["waic"][k], sc1["waic"][k]) for k in ("waic", "lppd"))
    check(e_ll < 1e-6 and e_w < 1e-6 and sc["log_likelihood"]["n_rows"]
          == B_SPARSE, f"M scoring dp=2 against one process: "
          f"log_likelihood {e_ll}, waic {e_w}")
    check(all(nccl_res[k] for k in ("sum", "sum_grad", "min", "broadcast",
                                    "buckets", "gather", "mesh")),
          f"M NCCL checks {nccl_res}")

    # (f)-(i): the meshes spmf_tpu trains on that the port refused before
    # PR 18, each within 1e-6 of one process
    def held(tag, one):
        traces = same(tag)
        e = rel(traces, single[one]["losses"])
        fs = first_step(tag) if r0["arms"][tag]["first_step"] else (0, 0)
        check(e < 1e-6 and fs[0] < 1e-6 and fs[1] < 1e-4,
              f"M {tag} against one process: losses {e} ({traces} vs "
              f"{single[one]['losses']}), first step loss and gradients "
              f"{fs}")
        return e, fs

    gap = {}
    tag_f = "(f) autoencoder, fp=2"
    gap["f"] = held(tag_f, "(f) autoencoder, one process")
    tag_g = f"(g) D={D - 1}, fp=2"
    gap["g"] = held(tag_g, f"(g) D={D - 1}, one process, plain")
    tag_h = f"(h) remainder {MESH_REM}, dp=2"
    gap["h"] = held(tag_h, f"(h) remainder {MESH_REM}, one process")
    n_full = 3 * (OPT_ROWS // OPT_BATCH)
    for who, arms in [("one process", single)] + [
            (f"rank {r['rank']}", r["arms"]) for r in ranks]:
        meshed = who != "one process"
        a_f = arms["(f) autoencoder, " + ("fp=2" if meshed
                                          else "one process")]["launches"]
        check(a_f["nfwd"] > 0 and a_f["nbwd"] > 0 and a_f["stats"] == 0,
              f"M (f) {who}: K6 did not launch, or K1 did: {a_f}")
        if meshed:
            a_g = arms[tag_g]
            check(a_g["launches"]["stats"] == 0
                  and a_g["launches"]["fwd"] > 0
                  and a_g["launches"]["bwd"] > 0
                  and "mesh axes ('fp',)" in str(a_g["dispatch"]),
                  f"M (g) {who}: launches {a_g['launches']}, dispatch "
                  f"{a_g['dispatch']}")
        a_h = arms[f"(h) remainder {MESH_REM}, " + ("dp=2" if meshed
                                             else "one process")]
        # a rank: the initial loss and the full batches alone; one process
        # also the remainders (and the captured scan's warm-up steps)
        n_h = a_h["launches"]["stats"]
        check((n_h == 1 + n_full and f"batch dim {MESH_REM} does not "
               "divide mesh axes ('dp',)" in str(a_h["dispatch"])) if meshed
              else n_h >= 1 + n_full + 3,
              f"M (h) {who}: K1 launches {n_h} ({1 + n_full} full-batch "
              f"steps and the initial loss), dispatch {a_h['dispatch']}")
    tag_i = "(i) data_parallel_mesh(1) of two, fast"
    e_i = rel(r0["arms"][tag_i]["losses"],
              single["(i) one process, fast, general loop"]["losses"])
    refused = ranks[1]["arms"][tag_i]["refused"]
    check(e_i < 1e-6 and refused.startswith(
        "fit: rank 1 is not in this mesh (ranks [0])"),
        f"M (i): rank 0 against one process {e_i}; rank 1: {refused}")
    say("M", f"(f) autoencoder (D={AE_D}, B={AE_B}, latent {AE_K}) on "
             f"fp=2, every w_l split, K6 whole then sliced: losses "
             f"{gap['f'][0]:.2e} from one process, first step "
             f"{gap['f'][1][0]:.2e} / {gap['f'][1][1]:.2e}; (g) D={D - 1} "
             f"on fp=2, nothing split, the plain path "
             f"({r0['arms'][tag_g]['dispatch']}): {gap['g'][0]:.2e}, first "
             f"step {gap['g'][1][0]:.2e} / {gap['g'][1][1]:.2e}; (h) the "
             f"scan's remainder of {MESH_REM} whole on both dp ranks: "
             f"{gap['h'][0]:.2e}, first step {gap['h'][1][0]:.2e} / "
             f"{gap['h'][1][1]:.2e}; (i) data_parallel_mesh(1): rank 0 "
             f"{e_i:.2e} from one process, rank 1 refused: {refused}")
    say("M", f"(b) dp=2 against one process: losses {e_dp:.2e} relative "
             f"(K1's atomic sums; two one-process runs {e_again:.2e}), first "
             f"step loss {g_dp[0]:.2e}, gradients {g_dp[1]:.2e}; fp=2 "
             f"fused: the ranks' traces bit for "
             f"bit, decreasing {[round(x, 4) for x in fp_l]}, {e_fused:.2e} "
             f"from dp=2 (its split IG block draws other seeds); fp=2 fast "
             f"against one process fast: {e_fp:.2e}, first step "
             f"{g_fp[0]:.2e} / {g_fp[1]:.2e}; fp=2 non-plus fused_normals "
             f"(K6 at full width, sliced) against one process: "
             f"{e_k6:.2e}, first step {g_k6[0]:.2e} / {g_k6[1]:.2e}; "
             f"(c) COO 0.1% dp=2: "
             f"{e_coo:.2e}; (d) log_likelihood {e_ll:.2e}, waic {e_w:.2e}; "
             f"(e) NCCL ({nccl_res['backend']}) at world size 1: SUM, its "
             f"backward, MIN, broadcast, buckets, gather all equal")

    launches = Counter()
    rows = [("this process", single)] + [(f"rank {r['rank']}", r["arms"])
                                         for r in ranks]
    for who, arms in rows:
        note = f"{MESH_NOTE}; {smi}" if who.startswith("rank") else smi
        for tag, a in arms.items():
            launches.update(a["launches"])
            lc = {k: a["launches"][k] for k in MESH_KERNELS}
            if "refused" in a:
                continue
            if tag.startswith("scoring"):
                say("M", f"{who}, {tag}: log_likelihood of {B_SPARSE} "
                         f"held-out rows (100 samples) in {a['seconds']:.3f} "
                         f"s ({B_SPARSE / a['seconds']:.0f} rows/s); "
                         f"launches {lc} ({note})")
                continue
            gr = a["grad"]
            n = max(a["steps"], 1)
            grad = (f"gradient all-reduce {gr['grad_seconds'] / n * 1e3:.2f} "
                    f"ms and {gr['grad_bytes'] / n / 1e6:.2f} MB a step "
                    f"({gr['grad_calls'] / n:.0f} call)"
                    if gr["grad_calls"] else "no gradient all-reduce")
            grad += (f", every collective {gr['bytes'] / n / 1e6:.2f} MB "
                     f"a step ({gr['calls'] / n:.1f} calls)")
            say("M", f"{who}, {tag}: {a['ms']:.2f} ms/step, peak "
                     f"{a['peak_gb']:.2f} GB, {grad}; scan {a['scan']} "
                     f"captured {a['captured']}; launches {lc}; losses "
                     f"{[round(x, 4) for x in a['losses']]} ({note})")
    for who, arms in rows[1:]:
        got = Counter()
        for a in arms.values():
            got.update(a["launches"])
        check(all(got[k] > 0 for k in MESH_KERNELS if k != "static"),
              f"M {who}: a kernel of the path never launched {dict(got)}")
    say("M", f"phase M took {time.perf_counter() - t_phase:.1f} s (rank "
             f"checks {r0['checks_s']:.1f} s, rank arms {r0['arms_s']:.1f} "
             f"s)")
    return dict(launches)


def fixed_width_lines(cols, widths):
    """Rows of non-negative integer columns as right-aligned decimal text,
    one line each, as bytes: digit by digit in numpy (the millions of
    lines of a synthetic MatrixMarket file in about a second)."""
    n = len(cols[0])
    buf = np.full((n, sum(widths) + 1), ord(" "), np.uint8)
    pos = 0
    for col, width in zip(cols, widths):
        v = np.asarray(col, np.int64)
        for k in range(width):
            p = 10 ** k
            digit = (v // p % 10 + ord("0")).astype(np.uint8)
            buf[:, pos + width - 1 - k] = np.where((v >= p) | (k == 0),
                                                   digit, ord(" "))
        pos += width
    buf[:, -1] = ord("\n")
    return buf.tobytes()


def write_10x(path, cells, genes, per_cell, dev, seed):
    """A synthetic 10x directory: matrix.mtx (genes x cells, 1-based
    integer coordinates, cell by cell) with ``per_cell`` distinct genes a
    cell holding Poisson(1) + 1 counts, and features.tsv (no MT- gene).
    Returns the nonzero count."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.rand(cells, genes, generator=g, device=dev).argsort(
        dim=1)[:, :per_cell].sort(dim=1).values.cpu().numpy()
    vals = np.random.default_rng(seed).poisson(1.0, rows.shape) + 1
    cols = np.repeat(np.arange(cells), per_cell)
    nnz = rows.size
    with open(os.path.join(path, "matrix.mtx"), "wb") as f:
        f.write(b"%%MatrixMarket matrix coordinate integer general\n")
        f.write(f"{genes} {cells} {nnz}\n".encode())
        f.write(fixed_width_lines((rows.reshape(-1) + 1, cols + 1,
                                   vals.reshape(-1)), (7, 7, 4)))
    with open(os.path.join(path, "features.tsv"), "w") as f:
        f.writelines(f"ENSG{i:05d}\tGENE{i}\tGene Expression\n"
                     for i in range(genes))
    return nnz


def cli_phase(dev, smi, zero_launches, read_launches):
    """Phase CLI: the port's entry points at full width, as a user runs
    them (``python -m spmf_tpu_torch.cli.*``, here their ``main``): a
    synthetic 10x directory of CLI_CELLS cells x CLI_GENES genes at 3%
    (720 genes a cell, inside the QC gates, no MT- gene) through
    preprocess_scrnaseq_counts (numpy backend, 20,000 top genes, the native
    MatrixMarket parser), then factorize_scrnaseq_counts -d 32 -b 4096 -e 3
    dense (the captured scan) and --sparse, and factorize_csv on an
    8,192 x 500 Poisson CSV (the native CSV parser). Prints the parse and
    preprocessing times, each fit's ms/step, encode_batched rows/s and the
    kernels each run launched; checks every artifact of tests/test_cli.py
    (name, shape, finite) and that the CSV run's model file reloads through
    load_model with encode bit-equal. Returns the kernel launches of its
    three runs, summed."""
    import torch

    from spmf_tpu_torch import load_model
    from spmf_tpu_torch.cli import (factorize_csv, factorize_scrnaseq_counts,
                                    preprocess_scrnaseq_counts)
    from spmf_tpu_torch.data import native

    t_phase = time.perf_counter()
    launches = {}
    cells, genes, top, P, bs = CLI_CELLS, CLI_GENES, CLI_TOP, K, CLI_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        nnz = write_10x(tmp, cells, genes, int(round(0.03 * genes)), dev, 51)
        say("CLI", f"wrote a 10x directory: {cells} cells x {genes} genes, "
                   f"{nnz} nonzeros, in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        rows, _, vals, shape = native.load_mtx_coo(
            os.path.join(tmp, "matrix.mtx"))
        parse_s = time.perf_counter() - t0
        check(native.native_available() and len(rows) == nnz
              and shape == (genes, cells) and vals.min() >= 1,
              f"CLI native mtx parse: {len(rows)} of {nnz}, shape {shape}")
        del rows, vals
        say("CLI", f"native MatrixMarket parse: {parse_s:.2f} s "
                   f"({nnz / parse_s:.3e} entries/s; the g++ build "
                   f"{native.BUILD_SECONDS.get('fastio', 0.0):.1f} s)")
        t0 = time.perf_counter()
        preprocess_scrnaseq_counts.main([
            "--datapath", tmp, "--dataset", "cli", "--backend", "numpy",
            "--n-top-genes", str(top)])
        say("CLI", f"preprocess_scrnaseq_counts: "
                   f"{time.perf_counter() - t0:.1f} s")
        X = np.load(os.path.join(tmp, "cli_counts.npy"))
        check(X.shape == (cells, top)
              and np.load(os.path.join(tmp, "cli_PCA.npy")).shape
              == (cells, 2), f"CLI preprocess: counts {X.shape}")

        for tag, extra in (("dense", []), ("sparse", ["--sparse"])):
            zero_launches()
            t0 = time.perf_counter()
            f = factorize_scrnaseq_counts.main([
                "--datapath", tmp, "--dataset", "cli", "-d", str(P), "-b",
                str(bs), "-e", "3", "--no-figures"] + extra)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            got = launches[f"scrna {tag}"] = read_launches()
            r = f.last_fit
            steps = cells // bs
            ms = float(np.median(r.extras["epoch_seconds"][1:])) / steps * 1e3
            check(r.extras["epoch_scan"] == (tag == "dense")
                  and f.device.type == "cuda" and got["stats"] >= 3 * steps
                  and got["fwd"] >= 3 * steps and got["bwd"] >= 3 * steps,
                  f"CLI scrna {tag}: scan {r.extras['epoch_scan']}, "
                  f"launches {got}")
            for art, shape in (
                    ("U", (top, P)), ("V", (P, top)), ("W", (1, top)),
                    ("Z", (cells, P)), ("cellscore", (cells, P)),
                    ("genescore", (P, top)), ("interceptscore", (1, top))):
                arr = np.load(os.path.join(tmp, f"cli_{art}_{P}.npy"))
                check(arr.shape == shape and np.isfinite(arr).all(),
                      f"CLI scrna {tag}: cli_{art}_{P}.npy {arr.shape}")
            losses = np.load(os.path.join(tmp, f"cli_losses_{P}.npy"))
            check(losses.size == 4 and np.isfinite(losses).all(),
                  f"CLI scrna {tag}: losses {losses}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f.encode_batched(X, row_chunk=cells)
            torch.cuda.synchronize()
            enc_s = time.perf_counter() - t0
            say("CLI", f"factorize_scrnaseq_counts {tag} -d {P} -b {bs} -e "
                       f"3: {run_s:.1f} s, {ms:.2f} ms/step (epochs 2-3), "
                       f"epoch_scan {r.extras['epoch_scan']}, "
                       f"{len(r.extras['epoch_seconds'])} epochs, losses "
                       f"{[round(x, 3) for x in losses]}; encode_batched "
                       f"{cells / enc_s:.0f} rows/s; launches {got} ({smi})")
            del f

        # factorize_csv on an 8,192 x 500 Poisson CSV
        Xc = np.random.default_rng(52).poisson(1.0, (cells, 500))
        csv_file = os.path.join(tmp, "counts.csv")
        np.savetxt(csv_file, Xc, fmt="%d", delimiter=",")
        t0 = time.perf_counter()
        parsed = native.load_csv(csv_file)
        csv_s = time.perf_counter() - t0
        check(np.array_equal(parsed, Xc), "CLI native CSV parse differs")
        zero_launches()
        t0 = time.perf_counter()
        f = factorize_csv.main(["-f", csv_file, "-e", "3", "-b", str(bs)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        got = launches["csv"] = read_launches()
        r = f.last_fit
        ms = float(np.median(r.extras["epoch_seconds"][1:])) / (
            cells // bs) * 1e3
        base, suffix = f"{csv_file}_2D", "lt_False_rn_False"
        enc = np.loadtxt(f"{base}_encoding_{suffix}.csv", delimiter=",")
        rep = np.loadtxt(f"{base}_representation_{suffix}.csv",
                         delimiter=",")
        check(enc.shape == (2, 500) and np.isfinite(enc).all()
              and rep.shape == (cells, 3) and np.isfinite(rep).all()
              and r.extras["epoch_scan"] and got["stats"] >= 3 * (cells // bs),
              f"CLI csv: encoding {enc.shape}, representation {rep.shape}, "
              f"scan {r.extras['epoch_scan']}, launches {got}")
        restored = load_model(f"{base}_model_{suffix}.npz", device="cuda")
        check(restored.device.type == "cuda" and torch.equal(
            restored.encode(Xc[:bs]), f.encode(Xc[:bs])),
            "CLI csv: the reloaded model's encode differs")
        say("CLI", f"factorize_csv {cells} x 500 -e 3 -b {bs}: native CSV "
                   f"parse {csv_s:.2f} s, {run_s:.1f} s, {ms:.2f} ms/step "
                   f"(epochs 2-3), epoch_scan {r.extras['epoch_scan']}; "
                   f"encoding {enc.shape}, representation {rep.shape}; the "
                   f"model file reloads with encode bit-equal; launches "
                   f"{got} ({smi})")
    say("CLI", f"phase CLI took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(p[k] for p in launches.values())
            for k in next(iter(launches.values()))}


def examples_phase(dev, smi, zero_launches, read_launches):
    """Phase EX: the six example modules (``python -m
    spmf_tpu_torch.examples.<name>``, here their ``main``) on the card. The
    three convergence examples run at their full published size and are
    held to spmf_tpu's records (EX_LOSS_LIMITS; noise max |A| < 0.1, the
    linear example's signal / noise column mass > 10, every WAIC finite);
    the other three run at EX_REDUCED's sizes and must write their
    artifacts with finite losses that fall. Prints one line an example:
    converged loss and epochs, wall seconds, ms/step, kernel launches, peak
    GB. Returns the launches of the six runs, summed."""
    import importlib

    t_phase = time.perf_counter()
    launches = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_EX_")
    try:
        for name in ("factorizing_random_noise", "factorize_linear_structure",
                     "factorize_nonlinear_structure", "simulation_figure",
                     "rnaseq_walkthrough", "corpus_walkthrough"):
            module = importlib.import_module(f"spmf_tpu_torch.examples.{name}")
            outdir = os.path.join(root, name)
            argv = ["--outdir", outdir] + EX_REDUCED.get(name, [])
            zero_launches()
            out = module.main(argv)
            got = launches[name] = read_launches()
            check(out["device"].startswith("cuda"),
                  f"EX {name} ran on {out['device']}")
            # the figures need matplotlib, which this machine may lack
            files = [p for p in out["artifacts"] if p is not None]
            check(files and all(os.path.getsize(p) > 0 for p in files),
                  f"EX {name}: artifacts {out['artifacts']}")
            for fit in out["fits"]:
                ls = np.asarray(fit["losses"], dtype=np.float64)
                check(np.isfinite(ls).all() and len(ls) > 2
                      and ls[2:].min() < ls[1],
                      f"EX {name}: losses not finite and falling {ls}")
            fit = out["fits"][-1]
            loss = fit["losses"][-1]
            limit = EX_LOSS_LIMITS.get(name)
            extra = ""
            if limit is not None:
                check(loss <= limit,
                      f"EX {name}: converged loss {loss} above {limit}")
                check(np.isfinite(out["waic"]), f"EX {name}: waic "
                                                f"{out['waic']}")
                # the dense float32 path: K1 and K3 each step, K4 in waic
                check(got["stats"] >= fit["steps"] and got["fwd"] > 0
                      and got["bwd"] > 0 and got["row_ll"] > 0,
                      f"EX {name}: launches {got}")
                extra = f" (limit {limit:.4f}); waic {out['waic']:.1f}"
            if name == "factorizing_random_noise":
                check(out["max_abs_encoding"] < 0.1,
                      f"EX noise: max |A| {out['max_abs_encoding']}")
                extra += f", max |A| {out['max_abs_encoding']:.4f}"
            if name == "factorize_linear_structure":
                ratio = out["signal_mass"] / out["noise_mass"]
                check(ratio > 10, f"EX linear: signal / noise mass {ratio}")
                extra += (f", signal / noise column mass "
                          f"{out['signal_mass']:.4f} / "
                          f"{out['noise_mass']:.4f} = {ratio:.1f}x")
            steps = sum(f["steps"] for f in out["fits"])
            secs = sum(f["fit_seconds"] for f in out["fits"])
            say("EX", f"{name} {' '.join(EX_REDUCED.get(name, []))}: "
                      f"converged loss {loss:.4f} after {fit['epochs']} "
                      f"epochs, best {min(fit['losses'][1:]):.4f}{extra}; "
                      f"{out['wall_seconds']:.1f} s wall, {steps} steps at "
                      f"{1e3 * secs / max(steps, 1):.2f} ms/step; launches "
                      f"{got}; peak {out['peak_gb']:.3f} GB above the "
                      f"run's start ({smi})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("EX", f"phase EX took {time.perf_counter() - t_phase:.1f} s")
    return {k: sum(p[k] for p in launches.values())
            for k in next(iter(launches.values()))}


#: phase W: (a)'s latent dimensions, past one whole-K kernel or another
#: (K4's and K5's end at their switch, 64, K1/K2's tiles at 124), at a ragged
#: shape (B no multiple of the row tile, D odd); (b) and (c)'s width
W_LATENT = (65, 125, 128, 153, 256, 1024)
W_S, W_B, W_D = 2, 1000, 19997
W_K = 128


def w_scale(k):
    """v's scale at latent dimension k in phase W: theta . v keeps the
    spread it has at K = 8."""
    return min(1.0, (8.0 / k) ** 0.5)


def wide_phase(dev, smi, zero_launches, read_launches, coo, held):
    """Phase W: the latent dimensions past the whole-K kernels. (a) K1, K2
    (both links), K4 (both links) and K5 against their float64 twins at
    S=2, B=1000, D=19,997 for each K of W_LATENT, at the K=32 tolerances;
    K4 also at the four other likelihoods (both links, D=20000), twice for
    the same bits, and on a rescue batch (NaN rows at the twin's
    positions).
    (b) at the full width S=8, B=4096, D=20000 and K = 128 and 256: each
    kernel's time (CUDA events), its twin's, its registers, shared memory,
    blocks an SM and bound (K1/K2, K4 and K5: the share of both routes'
    bounds, three TF32 passes and one FP32 pass); at 256 K1/K2 and K5 take
    their streaming route. (c) end to end at K=128: the
    dense captured-scan fit (16,384 rows resident, B=4096, 3 epochs, in two turns,
    the second profiled), a clip='static' epoch, one step's loss and
    gradients through K1 against the float64 plain path on the same draws;
    the 0.1% flat COO set ``coo`` (data, column norms) two epochs through K5
    (ms/step of the second), and one small COO step against the float64 plain path; log_likelihood
    of the 4096 held-out rows ``held`` (100 samples) through K4, and their
    per-row log-likelihood at 100 samples against the float64 plain path
    (1e-5 relative); log_likelihood at K=256, also through the wide K4.
    Returns
    the main path's launches, the wide kernels' largest absolute errors,
    their (ms, twin ms) and bounds."""
    import torch

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset, DeviceArrayDataset
    from spmf_tpu_torch.ops import fused_poisson as tfp
    from spmf_tpu_torch.vi.minibatch import _device_batch

    t_phase = time.perf_counter()
    errs = {}

    def kernel_key(kind, name, k, s=W_S, b=W_B, d=W_D):
        wide = tfp.launch_geometry(kind, s, b, k, d).chunks > 1
        return name + ("_wide" if wide else "")

    def note(key, err):
        if key.endswith("_wide"):
            errs[key] = max(errs.get(key, 0.0), err)

    # (a) every kernel against its float64 twin past the whole-K kernels
    for k_w in W_LATENT:
        args = stats_inputs(W_B, dev, seed=k_w, k=k_w, s=W_S, d=W_D,
                            v_scale=w_scale(k_w))
        args64 = [a.double() for a in args]
        worst = {"sums": 0.0, "grads": 0.0, "gmin": 0.0, "rows": 0.0,
                 "lik": 0.0}
        for log_w in (False, True):
            for static in (False, True):
                out_k = tfp._kernel_stats(*args, log_w, static)
                out_t = tfp.stats_twin(*args64, log_transform=log_w,
                                       static=static)
                torch.cuda.synchronize()
                e_sum = rel_elem(out_k[0], out_t[0])
                e_grad = max(rel_max(k, t)
                             for k, t in zip(out_k[3:], out_t[3:]))
                e_min = rel_elem(out_k[2], out_t[2]) if not static else 0.0
                what = (f"W K={k_w} {'K2' if static else 'K1'} "
                        f"log_transform={log_w}")
                check(e_sum < 1e-5, f"{what}: sums rel err {e_sum}")
                check(e_grad < 1e-4, f"{what}: grads rel err {e_grad}")
                check(e_min < 1e-6, f"{what}: gmin rel err {e_min}")
                check(torch.equal(out_k[1].cpu(), out_t[1].cpu()),
                      f"{what}: counts {out_k[1].tolist()} vs "
                      f"{out_t[1].tolist()}")
                note(kernel_key("stats", "static" if static else "stats",
                                k_w), abs_max(zip(out_k[3:], out_t[3:])))
                worst.update(sums=max(worst["sums"], e_sum),
                             grads=max(worst["grads"], e_grad),
                             gmin=max(worst["gmin"], e_min))
            out_k = tfp._kernel_row_ll(*args, log_w)
            again = tfp._kernel_row_ll(*args, log_w)
            out_t = tfp.row_loglik_twin(*args64, log_transform=log_w)
            torch.cuda.synchronize()
            e_row = rel_elem(out_k, out_t)
            check(e_row < 1e-5, f"W K={k_w} K4 log_transform={log_w}: row "
                                f"sums rel err {e_row}")
            check(torch.equal(out_k, again),
                  f"W K={k_w} K4 log_transform={log_w}: two launches gave "
                  f"different bits")
            note(kernel_key("row_ll", "row_ll", k_w),
                 abs_max([(out_k, out_t)]))
            worst["rows"] = max(worst["rows"], e_row)
        # K4 at the four other likelihoods, both links (S=2 of
        # likelihood_inputs' batches: signed operands, D=20000)
        for lname, lik in LIKELIHOODS.items():
            largs, codes = likelihood_inputs(lname, W_B, dev, seed=k_w + 1,
                                             k=k_w)
            largs = [a[:W_S] if a.dim() == 3 else a for a in largs]
            for log_w in (False, True):
                out_k = tfp._kernel_row_ll(*largs, log_w, lik, codes)
                out_t = tfp.row_loglik_twin(*[a.double() for a in largs],
                                            log_w, lik, codes)
                torch.cuda.synchronize()
                e_lik = rel_elem(out_k, out_t)
                check(e_lik < 1e-5, f"W K={k_w} K4 {lik} log_transform="
                                    f"{log_w}: row sums rel err {e_lik}")
                note(kernel_key("row_ll", "row_ll", k_w),
                     abs_max([(out_k, out_t)]))
                worst["lik"] = max(worst["lik"], e_lik)
        # the rescue batch: a negative intercept in column 7 of every sample,
        # the rate of every 97th row there: those rows NaN, as in the twin
        phi_r, theta_r = args[2].clone(), args[0].clone()
        phi_r[:, :, 7] = -1e-3
        theta_r[:, ::97] = 0.0
        out_k = tfp._kernel_row_ll(theta_r, args[1], phi_r, args[3], args[4],
                                   False)
        out_t = tfp.row_loglik_twin(theta_r.double(), args64[1],
                                    phi_r.double(), args64[3], args64[4])
        torch.cuda.synchronize()
        nan_t = torch.isnan(out_t)
        check(int(nan_t.sum()) == W_S * len(range(0, W_B, 97))
              and torch.equal(torch.isnan(out_k), nan_t),
              f"W K={k_w} K4 rescue: NaN rows {int(torch.isnan(out_k).sum())}"
              f" against the twin's {int(nan_t.sum())}")
        e_nan = rel_elem(out_k[~nan_t], out_t[~nan_t])
        check(e_nan < 1e-5, f"W K={k_w} K4 rescue rows rel err {e_nan}")
        del phi_r, theta_r, largs
        th, vv, ee = args[0], args[1], args[4]
        out_k = tfp._kernel_expsum(th, vv, ee)
        out_t = tfp.expsum_twin(th.double(), vv.double(), ee.double())
        torch.cuda.synchronize()
        e_r = rel_elem(out_k[0], out_t[0])
        e_g = max(rel_max(k, t) for k, t in zip(out_k[1:], out_t[1:]))
        check(e_r < 1e-5 and e_g < 1e-4,
              f"W K={k_w} K5: R rel err {e_r}, grads rel err {e_g}")
        note(kernel_key("expsum", "expsum", k_w), abs_max(zip(out_k, out_t)))
        chunks = {kind: tfp.launch_geometry(kind, W_S, W_B, k_w, W_D).chunks
                  for kind in ("stats", "row_ll", "expsum")}
        say("W", f"(a) K={k_w} (chunks: K1/K2 {chunks['stats']}, K4 "
                 f"{chunks['row_ll']}, K5 {chunks['expsum']}), S={W_S} "
                 f"B={W_B} D={W_D}, both links: K1/K2 sums rel "
                 f"{worst['sums']:.2e}, gmin rel {worst['gmin']:.2e}, "
                 f"grads rel-of-max {worst['grads']:.2e}, counts exact; K4 "
                 f"rows rel {worst['rows']:.2e} (two launches bit-equal), "
                 f"the four other likelihoods {worst['lik']:.2e}, rescue "
                 f"{int(nan_t.sum())} NaN rows at the twin's positions, the "
                 f"others {e_nan:.2e}; K5 R rel {e_r:.2e}, grads rel-of-max "
                 f"{e_g:.2e}")
    del args, args64, out_k, out_t

    # (b) the full width at K=128, and at K=256 (the streaming route of
    # the wide K1/K2 and K5; the wide K4 keeps theta on chip to 256); the
    # JSON line takes each wide kernel's first time
    kt = {}
    bd = {}
    for k_b in (W_K, 256):
        kinds = ("stats", "static", "row_ll", "expsum")
        args = stats_inputs(4096, dev, seed=6, k=k_b, v_scale=w_scale(k_b))
        th, vv, ee = args[0], args[1], args[4]
        calls = {
            "stats": (lambda: tfp._kernel_stats(*args, False, False),
                      lambda: tfp.stats_twin(*args)),
            "static": (lambda: tfp._kernel_stats(*args, False, True),
                       lambda: tfp.stats_twin(*args, static=True)),
            "row_ll": (lambda: tfp._kernel_row_ll(*args, True),
                       lambda: tfp.row_loglik_twin(*args, True)),
            "expsum": (lambda: tfp._kernel_expsum(th, vv, ee),
                       lambda: tfp.expsum_twin(th, vv, ee))}
        bk = bounds(4096, IG_TOTAL, N_TOTAL, k=k_b)
        routes = {"stats": stats_bound(4096, k_b),
                  "static": stats_bound(4096, k_b),
                  "row_ll": row_ll_bound(4096, k_b),
                  "expsum": expsum_bound(4096, k_b)}
        for name in kinds:
            kind = "stats" if name == "static" else name
            key = kernel_key(kind, name, k_b, S, 4096, D)
            k_ms = cuda_ms(calls[name][0])
            t_ms = cuda_ms(calls[name][1], iters=3, warmup=1)
            geom = tfp.launch_geometry(kind, S, 4096, k_b, D)
            info = tfp.kernel_info(kind, k_b)
            ms_b, by = bk[name]
            if key.endswith("_wide") and key not in kt:
                kt[key], bd[key] = (k_ms, t_ms), (ms_b, by)
            # the share of each route's bound: three TF32 passes on the
            # tensor cores and one pass on the FP32 pipes
            shares = "; ".join(
                f"{r} bound {b[0]:.3f} ms ({b[2]}), {b[0] / k_ms:.1%} of it"
                for r, b in routes.get(name, {}).items())
            say("W", f"(b) {key} K={k_b}: kernel {k_ms:.3f} ms, twin "
                     f"{t_ms:.3f} ms, bound {ms_b:.3f} ms ({by}; "
                     f"{ms_b / k_ms:.1%} of it){'; ' if shares else ''}"
                     f"{shares}; {info['registers']} "
                     f"registers a thread, {info['smem_bytes']} + "
                     f"{info['static_smem_bytes']} bytes of shared memory a "
                     f"block, {info['blocks_per_sm']} blocks an SM "
                     f"(occupancy API), {geom.chunks} chunk(s) of "
                     f"{geom.k_chunk} (float32, B=4096, S={S}, D={D}; "
                     f"{smi})")
        del args, th, vv, ee, calls

    # (c) the slice end to end at K=128
    launches = Counter()
    g = torch.Generator(device=dev).manual_seed(51)
    n_w, b_w = OPT_ROWS, OPT_BATCH
    xw = torch.poisson(torch.ones(n_w, D, device=dev), generator=g)
    ds = DeviceArrayDataset({"counts": xw,
                             "indices": torch.arange(n_w, device=dev)},
                            batch_size=b_w, device=dev)
    m = PoissonFactorization(latent_dim=W_K, feature_dim=D, dtype="float32",
                             device=dev, data=ds)
    init = clone_params(m.surrogate_params)
    steps = n_w // b_w
    turns = []
    for profiled in (False, True):
        zero_launches()
        turns.append(run_fit(m, init, ds, num_steps=3, profiled=profiled))
        launches.update(read_launches())
    got = dict(launches)
    check(all(np.isfinite(t[0]).all() and t[4] for t in turns)
          and got["stats_wide"] >= 2 * 3 * steps and got["stats"] == 0
          and got["fwd"] >= 2 * 3 * steps and got["bwd"] >= 2 * 3 * steps,
          f"W dense K={W_K}: losses {turns[0][0]}, scan "
          f"{[t[4] for t in turns]}, launches {got}")
    report_arm("W", smi, f"(c) dense K={W_K} D={D} B={b_w} captured scan, "
                         f"{n_w} rows resident (second turn profiled: "
                         f"{turns[1][1]:.2f} ms/step)", b_w, turns[0][1],
               turns[0][2], turns[1][3], 2 * steps)
    say("W", f"  losses {[round(x, 4) for x in turns[0][0]]}; launches "
             f"{got}")
    m_static = PoissonFactorization(latent_dim=W_K, feature_dim=D,
                                    dtype="float32", device=dev, data=ds,
                                    likelihood_clip="static")
    zero_launches()
    res = run_fit(m_static, init, ds, num_steps=1)
    got = read_launches()
    launches.update(got)
    check(np.isfinite(res[0]).all() and got["static_wide"] >= steps
          and got["static"] == 0,
          f"W static K={W_K}: losses {res[0]}, launches {got}")
    say("W", f"(c) clip='static' K={W_K}: one epoch, losses "
             f"{[round(x, 4) for x in res[0]]}, launches {got}")
    del m, m_static, ds, xw, init, turns, res

    # one step at K=128 through K1 (float32, card) against the plain
    # float64 path on the card on the same draws; phase 6's small-step
    # tolerances (loss 1e-4, gradients 1e-3 of the largest entry)
    n_s, d_s = 256, 3000
    xs = np.random.default_rng(52).poisson(1.0, (n_s, d_s)).astype(
        np.float32)

    def small(dtype, **kw):
        return PoissonFactorization(
            latent_dim=W_K, feature_dim=d_s, gamma_sampler="fast",
            u_tau_scale=1.0 / np.sqrt(n_s * d_s), dtype=dtype, device=dev,
            **kw)

    pair = {"kernel": small("float32", fused_likelihood=True,
                            data=ArrayDataset({"counts": xs}).batch(n_s)),
            "plain": small("float64", fused_likelihood=False,
                           data=ArrayDataset({"counts": xs}).batch(n_s))}
    p0 = perturbed_init(pair["plain"], 53)
    draws = numpy_draws(pair["plain"], 53)
    res = {}
    for tag, mm in pair.items():
        before = tfp.LAUNCHES["stats_wide"]
        res[tag] = step_grads(mm, p0, {"counts": torch.as_tensor(
            xs, device=dev).to(mm.dtype)}, draws)
        check(tfp.LAUNCHES["stats_wide"] == before + (tag == "kernel"),
              f"W small dense step {tag}: wide K1 launches")
    e_loss = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    e_grad = rel_max(res["kernel"][1], res["plain"][1])
    check(e_loss < 1e-4 and e_grad < 1e-3,
          f"W small dense step: loss rel err {e_loss}, grads {e_grad}")
    say("W", f"(c) one dense step K={W_K} (B={n_s}, D={d_s}) through the "
             f"wide K1 vs the float64 plain path on the same draws: loss "
             f"{res['kernel'][0]:.6f} vs {res['plain'][0]:.6f} (rel "
             f"{e_loss:.2e}), grads rel-of-max {e_grad:.2e}")
    del pair, res

    # the 0.1% flat COO set two epochs at K=128 through K5 (the scan)
    flat_c, norms_c = coo

    def coo_model(data, dtype="float32", n_rows=N_SPARSE, d=D, **kw):
        return PoissonFactorization(
            latent_dim=W_K, feature_dim=d, log_transform=True,
            u_tau_scale=1.0 / np.sqrt(n_rows * d), dtype=dtype, device=dev,
            data=data, **kw)

    m_c = coo_model(flat_c, column_norms=norms_c)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = m_c.fit(num_steps=2, learning_rate=0.01, sample_size=S,
                   verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    got = read_launches()
    launches.update(got)
    n_steps = N_SPARSE // B_SPARSE
    coo_ms = m_c.last_fit.extras["epoch_seconds"][-1] / n_steps * 1e3
    check(np.isfinite(loss).all() and got["expsum_wide"] >= n_steps
          and got["expsum"] == 0 and m_c.last_fit.extras["epoch_scan"]
          and m_c.fusion_inactive_reason.startswith(
              "sparse COO gather energy"),
          f"W COO K={W_K}: losses {loss}, launches {got}, dispatch "
          f"{m_c.fusion_inactive_reason!r}")
    say("W", f"(c) 0.1% flat COO K={W_K}: two epochs of {n_steps} steps "
             f"on the scan in {fit_s:.1f} s (capture included), the second "
             f"{coo_ms:.2f} ms/step; losses {[round(x, 4) for x in loss]}; "
             f"launches {got} ({smi})")
    # ... and one COO step at a small size through K5 against the float64
    # plain path on the card on the same draws
    sp_w, _ = sparse_counts(512, 3000, DENSITY_COO, 54, dev)
    sp_w.batch(256, drop_remainder=True)
    pair = {tag: coo_model(sp_w.to_device(dtype=dtype, device=dev), dtype,
                           512, 3000, gamma_sampler="fast",
                           fused_likelihood=True,
                           sparse_dense_scatter=False)
            for tag, dtype in (("kernel", "float32"), ("plain", "float64"))}
    p0 = perturbed_init(pair["plain"], 55)
    draws = numpy_draws(pair["plain"], 55)
    res = {}
    for tag, mm in pair.items():
        before = tfp.LAUNCHES["expsum_wide"]
        res[tag] = step_grads(mm, p0, next(iter(mm.data())), draws)
        check(tfp.LAUNCHES["expsum_wide"] == before + (tag == "kernel")
              and mm.fusion_inactive_reason.startswith("sparse COO gather"),
              f"W small COO step {tag}: dispatch "
              f"{mm.fusion_inactive_reason!r}, K5 launches")
    e_loss = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    e_grad = rel_max(res["kernel"][1], res["plain"][1])
    check(e_loss < 1e-4 and e_grad < 1e-3,
          f"W small COO step: loss rel err {e_loss}, grads {e_grad}")
    say("W", f"(c) one COO step K={W_K} (B=256, D=3000, 0.1%) through the "
             f"wide K5 vs the float64 plain path on the same draws: loss "
             f"{res['kernel'][0]:.6f} vs {res['plain'][0]:.6f} (rel "
             f"{e_loss:.2e}), grads rel-of-max {e_grad:.2e}")
    del pair, res, sp_w

    # log_likelihood of the held-out rows at K=128 through K4, and their
    # per-row log-likelihood at 100 samples against the float64 plain path
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = m_c.log_likelihood(held, num_samples=100, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    got = read_launches()
    launches.update(got)
    k4 = kernel_key("row_ll", "row_ll", W_K, S, B_SPARSE, D)
    check(got[k4] >= 13 and ll["n_rows"] == B_SPARSE
          and np.isfinite(ll["total"]),
          f"W log_likelihood K={W_K}: {ll}, launches {got} ({k4})")
    # the samples as phase 8's small check takes them (lognormal, valid for
    # any scorer; the posterior after one epoch has rates near 0, where the
    # log link's exp(.) - 1 cancels in float32 in any implementation), made
    # on the card in float64; the plain model takes m_c's row and column
    # scales (computed from its data at construction)
    plain = coo_model(None, "float64", column_norms=norms_c,
                      fused_likelihood=False)
    plain.xi_u_global = m_c.xi_u_global.double()
    plain.eta_i = m_c.eta_i.double()
    batch = next(iter(held))
    gen = torch.Generator(device=dev).manual_seed(56)
    e_row = 0.0
    for _ in range(25):          # 100 samples, 4 at a time
        smp = {k: torch.exp(torch.randn(
            (4,) + tuple(v.shape), generator=gen, device=dev,
            dtype=torch.float64) * 0.5 - 1.0)
            for k, v in m_c._surrogate.surrogates.items()}
        with torch.no_grad():
            out_k = m_c._row_log_likelihood(
                _device_batch(batch, m_c.dtype, dev),
                {k: t.float() for k, t in smp.items()})
            out_p = plain._row_log_likelihood(
                _device_batch(batch, plain.dtype, dev), smp)
        e_c = rel_elem(out_k, out_p)
        check(bool(torch.isfinite(out_p).all()) and e_c < 1e-5,
              f"W held-out rows K={W_K}: rel err {e_c}, "
              f"{int((~torch.isfinite(out_p)).sum())} rows not finite")
        e_row = max(e_row, e_c)
    say("W", f"(c) log_likelihood K={W_K} ({B_SPARSE} held-out rows, 100 "
             f"samples): per_row {ll['per_row']:.4f} in {ll_s:.2f} s, "
             f"launches {got}; per-row log-likelihood at 100 samples "
             f"through {k4} vs the float64 plain path: rel {e_row:.2e}")
    del plain, batch, smp, out_k, out_p, gen
    # ... and at K=256 through the wide K4
    m_256 = PoissonFactorization(
        latent_dim=256, feature_dim=D, log_transform=True,
        column_norms=norms_c, u_tau_scale=1.0 / np.sqrt(N_SPARSE * D),
        dtype="float32", device=dev, data=flat_c)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = m_256.log_likelihood(held, num_samples=100, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    got = read_launches()
    launches.update(got)
    k4 = kernel_key("row_ll", "row_ll", 256, S, B_SPARSE, D)
    check(got[k4] >= 13 and np.isfinite(ll["total"]),
          f"W log_likelihood K=256: {ll}, launches {got} ({k4})")
    say("W", f"(c) log_likelihood K=256 through {k4}: per_row "
             f"{ll['per_row']:.4f} in {ll_s:.2f} s, launches {got}")
    del m_c, m_256
    say("W", f"phase W took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches), errs, kt, bd


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spmf_tpu_torch import (BernoulliFactorization, GaussianFactorization,
                                MixedFactorization, PoissonFactorization)
    from spmf_tpu_torch.data import ArrayDataset, SparseCounts
    from spmf_tpu_torch.ops import _build
    from spmf_tpu_torch.ops import coo_scatter as tcs
    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops import fused_normal as tfn
    from spmf_tpu_torch.ops import fused_poisson as tfp
    from spmf_tpu_torch.utils import params_from_numpy
    from spmf_tpu_torch.vi.minibatch import _device_batch
    from spmf_tpu_torch.vi.waic import waic

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(1, f"device {name}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}; matmul.allow_tf32="
           f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
           f"{torch.backends.cudnn.allow_tf32}")
    print(smi.splitlines()[0], flush=True)

    # The small-size float64 models of the plain path (phases 6, 7, A, B, AE)
    # live on the CPU and need no kernel, and each takes seconds to set up
    # (its posterior means, 250 draws): two threads build them from here on,
    # under the nvcc build and the kernel checks.
    n_s, d_s, k_s, b_s = 512, 3000, 16, 256
    rng = np.random.default_rng(4)
    Xs = rng.poisson(1.0, (n_s, d_s)).astype(np.float32)
    types_s = [t for t in ("poisson", "bernoulli", "normal")
               for _ in range(d_s // 3)]
    Xs_mixed = Xs.copy()
    Xs_mixed[:, d_s // 3:2 * (d_s // 3)] %= 2
    Xs_mixed[:, 2 * (d_s // 3):] = np.random.default_rng(16).standard_normal(
        (n_s, d_s - 2 * (d_s // 3))).astype(np.float32)
    Xs_log = np.log1p(Xs)
    Xs_log = ((Xs_log - Xs_log.mean(0)) / Xs_log.std(0)).astype(np.float32)
    sp_s, _ = sparse_counts(n_s, d_s, DENSITY, 12, dev)
    sp_s.batch(b_s, drop_remainder=True)

    def plain_model(cls, data, **kw):
        return cls(latent_dim=k_s, feature_dim=d_s, gamma_sampler="fast",
                   u_tau_scale=1.0 / np.sqrt(n_s * d_s), dtype="float64",
                   device="cpu", fused_likelihood=False, data=data, **kw)

    def dense_data(x):
        return ArrayDataset({"counts": x}).batch(b_s)

    plain_pool = ThreadPoolExecutor(2)
    plain = {tag: plain_pool.submit(plain_model, cls, data, **kw)
             for tag, cls, data, kw in (
        ("poisson", PoissonFactorization, dense_data(Xs), {}),
        ("blocked", PoissonFactorization,
         sp_s.to_device(block_rows=128, dtype="float64", device="cpu"),
         dict(log_transform=True)),
        ("B mixed", MixedFactorization, dense_data(Xs_mixed),
         dict(column_types=types_s, scale_columns=False)),
        ("B bernoulli", BernoulliFactorization,
         dense_data(np.minimum(Xs, 1.0)), {}),
        ("B gaussian normal", GaussianFactorization, dense_data(Xs_log),
         dict(observation_model="normal", scale_columns=False,
              scale_rows=False)),
        ("AE poisson non-plus", PoissonFactorization, dense_data(Xs),
         dict(horshoe_plus=False)),
        ("AE gaussian non-plus", GaussianFactorization, dense_data(Xs_log),
         dict(observation_model="normal", scale_columns=False,
              scale_rows=False, horshoe_plus=False)),
        ("O aux_broadcast", PoissonFactorization, dense_data(Xs),
         dict(aux_broadcast=True)))}
    plain_pool.shutdown(wait=False)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        for f in [pool.submit(tfp._lib), pool.submit(tfp._wide_lib),
                  pool.submit(tfp._expsum_lib), pool.submit(tig._lib),
                  pool.submit(tfn._lib), pool.submit(tcs._lib)]:
            f.result()
    say(2, f"built {sorted(_build.BUILD_SECONDS)} in "
           f"{time.perf_counter() - t0:.1f} s (nvcc {_build.NVCC_FLAGS})")
    for lib in ("fused_poisson", "fused_poisson_wide", "fused_expsum",
                "fused_ig", "fused_normal", "coo_scatter"):
        # ptxas -v: one (name, spill, registers) triple of lines per kernel
        with open(os.path.join(_build.BUILD_DIR, f"{lib}.log")) as f:
            lines = [ln.strip() for ln in f]
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "Used " in ln and "registers" in ln]
        spills = [ln for ln in lines
                  if "spill" in ln and "0 bytes spill stores" not in ln]
        say(2, f"{lib}: {len(regs)} kernels, registers {sorted(regs)}, "
               f"spilling kernels: {spills or 'none'}")
        check(not spills, f"{lib} spills registers: {spills}")
    for kind in ("stats", "row_ll", "expsum"):
        for k_2 in (K,) + W_LATENT:
            geom = tfp.launch_geometry(kind, S, 4096, k_2, D)
            lib_smem = (tfp._expsum_lib().expsum_smem_bytes(k_2)
                        if kind == "expsum" else tfp._lib().poisson_smem_bytes(
                            int(kind == "row_ll"), k_2))
            check(geom.smem_bytes == lib_smem,
                  f"{kind} K={k_2}: launch_geometry and the library disagree "
                  f"on shared memory ({geom}, library {lib_smem})")

    #: launch counters by kernel, as the JSON line names them
    counters = {"stats": (tfp.LAUNCHES, "stats"),
                "static": (tfp.LAUNCHES, "static"),
                "row_ll": (tfp.LAUNCHES, "row_ll"),
                "expsum": (tfp.LAUNCHES, "expsum"),
                "fwd": (tig.LAUNCHES, "fwd"), "bwd": (tig.LAUNCHES, "bwd"),
                "nfwd": (tfn.LAUNCHES, "fwd"), "nbwd": (tfn.LAUNCHES, "bwd")}
    counters.update({f"{k}_wide": (tfp.LAUNCHES, f"{k}_wide")
                     for k in WIDE_KERNELS})
    counters["coo_scatter"] = (tcs.LAUNCHES, "coo_scatter")
    kernels = tuple(counters)

    def zero_launches():
        for d, k in counters.values():
            d[k] = 0

    def read_launches():
        return {name: d[k] for name, (d, k) in counters.items()}

    path_launches = {}
    errs = {}
    # ---- 3: K1 / K2 at the main-path shape
    B = 1024
    # (rows, latent dimension, link, rescue batch): the main-path shape and
    # the ragged one, each under both links
    for b_3, k_3, log_3, rescue in ((B, K, False, False), (B, K, False, True),
                                    (B, K, True, False), (B, K, True, True),
                                    (B_RAGGED, K_RAGGED, False, True),
                                    (B_RAGGED, K_RAGGED, True, False)):
        args = stats_inputs(b_3, dev, seed=1, rescue=rescue, k=k_3)
        for static in (False, True):
            out_k = tfp._kernel_stats(*args, log_3, static)
            out_t = tfp.stats_twin(*[a.double() for a in args],
                                   log_transform=log_3, static=static)
            torch.cuda.synchronize()
            e_sum = rel_elem(out_k[0], out_t[0])
            e_grad = max(rel_max(k, t) for k, t in zip(out_k[3:], out_t[3:]))
            check(e_sum < 1e-5, f"K1 sums rel err {e_sum}")
            check(e_grad < 1e-4, f"K1 grads rel err {e_grad}")
            check(torch.equal(out_k[1].cpu(), out_t[1].cpu()),
                  f"K1 counts {out_k[1].tolist()} vs {out_t[1].tolist()}")
            e_min = rel_elem(out_k[2], out_t[2]) if not static else 0.0
            check(e_min < 1e-6, f"K1 gmin rel err {e_min}")
            key = "static" if static else "stats"
            if not rescue and b_3 == B:
                errs[key] = abs_max(zip(out_k[3:], out_t[3:]))
            say(3, f"{'K2' if static else 'K1'} B={b_3} K={k_3} "
                   f"log_transform={log_3} rescue={rescue}: sums rel "
                   f"{e_sum:.2e}, counts {out_k[1].tolist()}, gmin rel "
                   f"{e_min:.2e}, grads rel-of-max {e_grad:.2e}")

    # ---- 4: K3f / K3b at the IG block of D=20000, K=32, in the three modes,
    # and at a ragged total (no multiple of the 256-thread block) with S=6
    # (3 pairs, no power of two), S=2 and, independent only, S=5. The kernel
    # and the float64 twin draw the same Philox bits: y and log q 1e-5
    # relative (erfinvf / logf against float64 in the tails of a 23-bit
    # uniform), gradients 1e-4 of their largest entry
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.rand(IG_TOTAL, generator=g, device=dev) * 5 + 0.3
    b = torch.rand(IG_TOTAL, generator=g, device=dev) * 3 + 0.1
    seed = torch.tensor([987654], dtype=torch.int32, device=dev)
    gy = torch.randn(S, IG_TOTAL, generator=g, device=dev)
    glq = torch.randn(S, generator=g, device=dev)
    ragged = IG_TOTAL - 101
    ig_cases = ([(IG_TOTAL, S, m) for m in IG_MODES]
                + [(ragged, n, m) for n in (6, 2) for m in IG_MODES]
                + [(ragged, 5, False)])
    errs["fwd"] = errs["bwd"] = 0.0
    for n_el, s_c, anti in ig_cases:
        a_c, b_c = a[:n_el], b[:n_el]
        gy_c, glq_c = gy[:s_c, :n_el].contiguous(), glq[:s_c].contiguous()
        y_k, lq_k = tig._kernel_fwd(a_c, b_c, seed, s_c, anti)
        y_t, lq_t = tig.ig_twin_fwd(a_c.double(), b_c.double(), seed, s_c,
                                    anti)
        ga_k, gb_k = tig._kernel_bwd(a_c, b_c, seed, s_c, anti, gy_c, glq_c)
        ga_t, gb_t = tig.ig_twin_bwd(a_c.double(), b_c.double(), seed, s_c,
                                     anti, gy_c.double(), glq_c.double())
        torch.cuda.synchronize()
        e_y, e_lq = rel_elem(y_k, y_t), rel_elem(lq_k, lq_t)
        e_g = max(rel_max(ga_k, ga_t), rel_max(gb_k, gb_t))
        what = f"K3 total={n_el} S={s_c} antithetic={anti!r}"
        check(e_y < 1e-5, f"{what}: y rel err {e_y}")
        check(e_lq < 1e-5, f"{what}: lq rel err {e_lq}")
        check(e_g < 1e-4, f"{what}: grads rel err {e_g}")
        if n_el == IG_TOTAL:
            errs["fwd"] = max(errs["fwd"], abs_max([(y_k, y_t)]))
            errs["bwd"] = max(errs["bwd"],
                              abs_max([(ga_k, ga_t), (gb_k, gb_t)]))
        say(4, f"{what}: y rel {e_y:.2e}, lq rel {e_lq:.2e}, ga/gb "
               f"rel-of-max {e_g:.2e}")
    del y_k, y_t, ga_t, gb_t, gy_c

    # ---- 5: K4 / K5 at the main-path shape
    errs["row_ll"] = 0.0
    for b_5, k_5 in ((B_RAGGED, K_RAGGED), (B, K)):
        theta, v, phi, x, eta = stats_inputs(b_5, dev, seed=7, k=k_5)
        for log_transform in (False, True):
            out_k = tfp._kernel_row_ll(theta, v, phi, x, eta, log_transform)
            again = tfp._kernel_row_ll(theta, v, phi, x, eta, log_transform)
            out_t = tfp.row_loglik_twin(
                theta.double(), v.double(), phi.double(), x.double(),
                eta.double(), log_transform)
            torch.cuda.synchronize()
            e_row = rel_elem(out_k, out_t)
            check(e_row < 1e-5, f"K4 row sums rel err {e_row}")
            check(torch.equal(out_k, again),
                  "K4: two launches gave different bits")
            if b_5 == B:
                errs["row_ll"] = max(errs["row_ll"],
                                     abs_max([(out_k, out_t)]))
            say(5, f"K4 B={b_5} K={k_5} log_transform={log_transform}: row "
                   f"sums rel {e_row:.2e}, two launches bit-equal")
        if b_5 == B:
            continue
        out_k = tfp._kernel_expsum(theta, v, eta)
        out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
        torch.cuda.synchronize()
        e_sum = rel_elem(out_k[0], out_t[0])
        e_grad = max(rel_max(k, t) for k, t in zip(out_k[1:], out_t[1:]))
        check(e_sum < 1e-5, f"K5 ragged sums rel err {e_sum}")
        check(e_grad < 1e-4, f"K5 ragged grads rel err {e_grad}")
        say(5, f"K5 B={b_5} K={k_5}: sums rel {e_sum:.2e}, grads "
               f"rel-of-max {e_grad:.2e}")
    phi_r, theta_r = phi.clone(), theta.clone()
    phi_r[:, :, 7] = -1e-3        # column 7 of every sample: a negative
    theta_r[:, ::97] = 0.0        # intercept, the rate of these rows there
    out_k = tfp._kernel_row_ll(theta_r, v, phi_r, x, eta, False)
    out_t = tfp.row_loglik_twin(theta_r.double(), v.double(), phi_r.double(),
                                x.double(), eta.double())
    nan_t = torch.isnan(out_t)
    check(int(nan_t.sum()) == S * len(range(0, B, 97)),
          f"rescue batch NaN rows {int(nan_t.sum())}")
    check(torch.equal(torch.isnan(out_k), nan_t), "K4 NaN rows differ")
    e_row = rel_elem(out_k[~nan_t], out_t[~nan_t])
    check(e_row < 1e-5, f"K4 rescue row sums rel err {e_row}")
    say(5, f"K4 rescue: {int(nan_t.sum())} NaN rows at the same positions, "
           f"other rows rel {e_row:.2e}")
    out_k = tfp._kernel_expsum(theta, v, eta)
    out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
    torch.cuda.synchronize()
    e_sum = rel_elem(out_k[0], out_t[0])
    e_grad = max(rel_max(k, t) for k, t in zip(out_k[1:], out_t[1:]))
    check(e_sum < 1e-5, f"K5 sums rel err {e_sum}")
    check(e_grad < 1e-4, f"K5 grads rel err {e_grad}")
    errs["expsum"] = abs_max(zip(out_k, out_t))
    say(5, f"K5: sums rel {e_sum:.2e} (R ~ {float(out_t[0][0]):.4e}), "
           f"grads rel-of-max {e_grad:.2e}")
    del theta, v, phi, x, eta, phi_r, theta_r, out_k, out_t

    # ---- K6: the fused Normal sampler at the Normal block of D=20000, K=32.
    # Tolerances: the kernel and its float64 twin draw the same Philox bits;
    # y and the gradients 1e-5 of their largest entry (erfinvf against
    # float64 erfinv in the tails of a 23-bit uniform, as for K3; x = loc +
    # scale eps may cancel to near 0, so not elementwise); log q 1e-6
    # relative (a double-accumulated sum of 1.3 M float terms)
    g = torch.Generator(device=dev).manual_seed(8)
    n_loc = torch.randn(N_TOTAL, generator=g, device=dev) * 2.0
    n_rs = torch.randn(N_TOTAL, generator=g, device=dev) * 1.5 - 2.0
    n_gy = torch.randn(S, N_TOTAL, generator=g, device=dev)
    n_glq = torch.randn(S, generator=g, device=dev)
    n_seed = torch.tensor([13579], dtype=torch.int32, device=dev)
    # the surrogate's order is v, w, u, s: Identity but for the last 2 D
    masks = {"gaussian": torch.cat([torch.zeros(N_TOTAL - 2 * D),
                                    torch.ones(2 * D)]).to(dev),
             "softplus": torch.ones(N_TOTAL, device=dev)}
    errs["nfwd"] = errs["nbwd"] = 0.0
    for tag, mask in masks.items():
        y_k, lq_k = tfn._kernel_fwd(n_loc, n_rs, mask, n_seed, S)
        y_t, lq_t = tfn.normal_twin_fwd(n_loc.double(), n_rs.double(),
                                        mask.double(), n_seed, S)
        gl_k, gr_k = tfn._kernel_bwd(n_loc, n_rs, mask, n_seed, S, n_gy,
                                     n_glq)
        gl_t, gr_t = tfn.normal_twin_bwd(
            n_loc.double(), n_rs.double(), mask.double(), n_seed, S,
            n_gy.double(), n_glq.double())
        torch.cuda.synchronize()
        e_y, e_lq = rel_max(y_k, y_t), rel_elem(lq_k, lq_t)
        e_g = max(rel_max(gl_k, gl_t), rel_max(gr_k, gr_t))
        check(e_y < 1e-5, f"K6f {tag} y rel err {e_y}")
        check(e_lq < 1e-6, f"K6f {tag} lq rel err {e_lq}")
        check(e_g < 1e-5, f"K6b {tag} grads rel err {e_g}")
        errs["nfwd"] = max(errs["nfwd"], abs_max([(y_k, y_t)]))
        errs["nbwd"] = max(errs["nbwd"],
                           abs_max([(gl_k, gl_t), (gr_k, gr_t)]))
        say("K6", f"total={N_TOTAL} mask={tag}: y rel-of-max {e_y:.2e}, lq "
                  f"rel {e_lq:.2e}, gloc/grs rel-of-max {e_g:.2e}")
        if tag == "gaussian":
            # the draws themselves, without the twin: eps = (x - loc) / scale
            # over all S * total draws (x = softplus^-1(y) under the mask)
            y64 = y_k.double()
            x64 = torch.where(mask > 0,
                              y64 + torch.log(-torch.expm1(-y64)), y64)
            scale = torch.nn.functional.softplus(n_rs.double())
            ks = ks_distance(((x64 - n_loc.double()) / scale).reshape(-1))
            # 2.5 / sqrt(n), 7.6e-4 at n = 10.7 M: a true N(0, 1) sample
            # exceeds it with probability 7e-6 (the 23-bit uniform grid
            # adds 1e-7)
            check(ks < 2.5 / y64.numel() ** 0.5,
                  f"K6f draws: KS distance {ks} from N(0, 1)")
            say("K6", f"KS distance of {y64.numel()} recovered draws from "
                      f"N(0, 1): {ks:.2e}")
            del y64, x64
        del y_t, gl_t, gr_t
    # forward / backward replay through the wrapper: K6b against autograd
    # through the float64 twin
    mask = masks["gaussian"]
    leaves = [n_loc.clone().requires_grad_(True),
              n_rs.clone().requires_grad_(True)]
    y, lq = tfn.fused_normal_sample_logq(*leaves, mask, n_seed, S)
    ((y * n_gy).sum() + (lq * n_glq).sum()).backward()
    ref = [t.detach().double().requires_grad_(True) for t in leaves]
    y_t, lq_t = tfn.normal_twin_fwd(*ref, mask.double(), n_seed, S)
    ((y_t * n_gy.double()).sum() + (lq_t * n_glq.double()).sum()).backward()
    e_g = max(rel_max(t.grad, r.grad) for t, r in zip(leaves, ref))
    check(e_g < 1e-5, f"K6 replay grads rel err {e_g}")
    say("K6", f"replay: K6b through the wrapper vs autograd through the "
              f"twin, rel-of-max {e_g:.2e}")
    del y, lq, y_t, lq_t, leaves, ref, y_k, gl_k, gr_k

    # ---- lik: K1, K2 and K4 at the other likelihoods, the Poisson
    # tolerances (sums 1e-5, counts exact, minimum 1e-6, gradients 1e-4 of
    # the largest entry, row sums 1e-5)
    lik_errs = {}
    for lname, lik in LIKELIHOODS.items():
        soft = lname in ("poisson_softplus", "mixed")
        for log_transform in (False, True):
            for rescue in (False, True):
                args, codes = likelihood_inputs(lname, B, dev, seed=21,
                                                rescue=rescue)
                args64 = [t.double() for t in args]
                for static in (False, True):
                    out_k = tfp._kernel_stats(*args, log_transform, static,
                                              lik, codes)
                    out_t = tfp.stats_twin(*args64, log_transform, static,
                                           lik, codes)
                    torch.cuda.synchronize()
                    e_sum = rel_elem(out_k[0], out_t[0])
                    e_grad = max(rel_max(k, t)
                                 for k, t in zip(out_k[3:], out_t[3:]))
                    e_min = (rel_elem(out_k[2], out_t[2]) if not static
                             else 0.0)
                    what = (f"{'K2' if static else 'K1'} {lname} "
                            f"log={log_transform} rescue={rescue}")
                    check(e_sum < 1e-5, f"{what} sums rel err {e_sum}")
                    check(e_grad < 1e-4, f"{what} grads rel err {e_grad}")
                    check(e_min < 1e-6, f"{what} gmin rel err {e_min}")
                    check(torch.equal(out_k[1].cpu(), out_t[1].cpu()),
                          f"{what} counts {out_k[1].tolist()} vs "
                          f"{out_t[1].tolist()}")
                    check(static or not rescue
                          or (int(out_t[1].sum()) > 0) == soft,
                          f"{what} clipped cells {out_t[1].tolist()}")
                    key = (lname, "static" if static else "stats")
                    lik_errs[key] = max(lik_errs.get(key, 0.0), e_grad)
                    say("lik", f"{what}: sums rel {e_sum:.2e}, counts "
                               f"{out_k[1].tolist()}, gmin rel {e_min:.2e}, "
                               f"grads rel-of-max {e_grad:.2e}")
                if rescue:
                    continue
                out_k = tfp._kernel_row_ll(*args, log_transform, lik, codes)
                out_t = tfp.row_loglik_twin(*args64, log_transform, lik,
                                            codes)
                torch.cuda.synchronize()
                e_row = rel_elem(out_k, out_t)
                check(e_row < 1e-5,
                      f"K4 {lname} log={log_transform} rows rel err {e_row}")
                lik_errs[(lname, "row_ll")] = max(
                    lik_errs.get((lname, "row_ll"), 0.0), e_row)
                say("lik", f"K4 {lname} log_transform={log_transform}: row "
                           f"sums rel {e_row:.2e}")
        # the ragged shape, both links: K1, K2 and K4 at the same tolerances
        for log_transform in (False, True):
            args, codes = likelihood_inputs(lname, B_RAGGED, dev, seed=23,
                                            k=K_RAGGED)
            args64 = [t.double() for t in args]
            what = (f"{lname} B={B_RAGGED} K={K_RAGGED} "
                    f"log={log_transform}")
            for static in (False, True):
                out_k = tfp._kernel_stats(*args, log_transform, static, lik,
                                          codes)
                out_t = tfp.stats_twin(*args64, log_transform, static, lik,
                                       codes)
                torch.cuda.synchronize()
                e_sum = rel_elem(out_k[0], out_t[0])
                e_grad = max(rel_max(k, t)
                             for k, t in zip(out_k[3:], out_t[3:]))
                e_min = rel_elem(out_k[2], out_t[2]) if not static else 0.0
                check(e_sum < 1e-5 and e_grad < 1e-4 and e_min < 1e-6
                      and torch.equal(out_k[1].cpu(), out_t[1].cpu()),
                      f"{'K2' if static else 'K1'} {what}: sums {e_sum}, "
                      f"grads {e_grad}, gmin {e_min}, counts "
                      f"{out_k[1].tolist()} vs {out_t[1].tolist()}")
            out_k = tfp._kernel_row_ll(*args, log_transform, lik, codes)
            out_t = tfp.row_loglik_twin(*args64, log_transform, lik, codes)
            torch.cuda.synchronize()
            e_row = rel_elem(out_k, out_t)
            check(e_row < 1e-5, f"K4 {what} rows rel err {e_row}")
            say("lik", f"{what}: K1/K2 sums rel {e_sum:.2e}, grads "
                       f"rel-of-max {e_grad:.2e}; K4 row sums rel "
                       f"{e_row:.2e}")
        if soft:
            # sample 0 alone has an underflowed rate, in column 7: its rows
            # are -inf (x > 0 there) or NaN (x = 0), the others finite
            args, codes = likelihood_inputs(lname, B, dev, seed=22)
            args[2][0, :, 7] = -2000.0
            out_k = tfp._kernel_row_ll(*args, False, lik, codes)
            out_t = tfp.row_loglik_twin(*[t.double() for t in args], False,
                                        lik, codes)
            nan_t, inf_t = torch.isnan(out_t), torch.isinf(out_t)
            check(bool((nan_t | inf_t)[0].all())
                  and not bool((nan_t | inf_t)[1:].any())
                  and bool(nan_t.any()) and bool(inf_t.any()),
                  f"K4 {lname} rescue batch: {int(nan_t.sum())} NaN, "
                  f"{int(inf_t.sum())} inf rows")
            check(torch.equal(torch.isnan(out_k), nan_t)
                  and torch.equal(torch.isinf(out_k), inf_t),
                  f"K4 {lname} NaN / inf rows differ")
            e_row = rel_elem(out_k[1:], out_t[1:])
            check(e_row < 1e-5, f"K4 {lname} rescue rows rel err {e_row}")
            say("lik", f"K4 {lname} rescue: {int(nan_t.sum())} NaN and "
                       f"{int(inf_t.sum())} -inf rows at the same positions, "
                       f"other rows rel {e_row:.2e}")
    say("lik", "largest relative errors by (likelihood, kernel): "
               + ", ".join(f"{k}: {v:.2e}" for k, v in lik_errs.items()))
    del args, args64, codes, out_k, out_t

    def small_step_check(tag, cls, Xs, seed, plain_side, signed_vw=False,
                         stratified=False, stl=False, **kw):
        """One ELBO step at a small size through every kernel (float32 on
        the card, both samplers fused) against ``plain_side``, the plain
        float64 model of the same arguments (CPU, unfused, the WH 'fast'
        sampler), fed the same Philox draws.
        ``signed_vw``: start v and w near 0 (see ``start_vw_near_zero``).
        ``stratified``: the step with antithetic='stratified' (K3's
        stratified stream; the Normal block's lattice from the generator,
        since K6 takes no antithetic mode). ``stl``: the STL step, which
        takes the plain samplers: both sides get the same numpy draws, and
        only K1 runs.
        Tolerances as phase 6's first small step: loss 1e-4, gradients
        1e-3 of the largest entry."""
        pair = {"kernel": cls(
            latent_dim=k_s, feature_dim=d_s,
            u_tau_scale=1.0 / np.sqrt(n_s * d_s), data=dense_data(Xs),
            dtype="float32", device="cuda", fused_likelihood=True,
            gamma_sampler="fused", **kw), "plain": plain_side}
        pair["kernel"]._surrogate.fused_normals = True
        p0 = perturbed_init(pair["plain"], seed)
        if signed_vw:
            rng = np.random.default_rng(seed)
            for name in ("v", "w"):
                p0[name]["loc"] = 0.05 * rng.standard_normal(
                    p0[name]["loc"].shape)
        anti = "stratified" if stratified else False
        shared = numpy_draws(pair["plain"], seed) if stl else None
        before = read_launches()
        res_k = step_grads(
            pair["kernel"], p0,
            {"counts": torch.as_tensor(Xs[:b_s], device=dev).float()},
            shared, generator=torch.Generator(device=dev).manual_seed(seed),
            antithetic=anti, stl=stl)
        after = read_launches()
        ran = [k for k in kernels if after[k] == before[k] + 1]
        # K3 draws the InverseGamma block, which horshoe_plus=False lacks
        igs = (["fwd", "bwd"] if pair["kernel"]._surrogate._ig_names
               and not stl else [])
        check(ran == ["stats"] + igs + ([] if stratified or stl
                                        else ["nfwd", "nbwd"]),
              f"{tag}: small step launched {ran}")
        check(pair["kernel"].fusion_active, f"{tag}: small step unfused")
        res_p = step_grads(pair["plain"], p0,
                           {"counts": torch.as_tensor(Xs[:b_s]).double()},
                           shared if stl else philox_draws(
                               pair["plain"], seed, dev, stratified),
                           antithetic=anti, stl=stl)
        e_loss = abs(res_k[0] - res_p[0]) / abs(res_p[0])
        e_grad = rel_max(res_k[1], res_p[1])
        check(e_loss < 1e-4, f"{tag}: small-step loss rel err {e_loss}")
        check(e_grad < 1e-3, f"{tag}: small-step grads rel err {e_grad}")
        say(tag, f"small step (antithetic={anti!r}, stl={stl}) through K1"
                 f"{', K3' if igs else ''}"
                 f"{'' if stratified or stl else ', K6'} vs "
                 f"float64 plain path on "
                 f"the same draws: loss {res_k[0]:.6f} vs "
                 f"{res_p[0]:.6f} (rel {e_loss:.2e}), grads rel-of-max "
                 f"{e_grad:.2e}")

    # ---- 6: the dense slice through the normal entry point
    N = 8192    # two steps an epoch: depth cut to keep the script short
    gx = torch.Generator(device=dev).manual_seed(3)
    X = torch.poisson(torch.ones(N, D, device=dev), generator=gx).cpu().numpy()
    ds = ArrayDataset({"counts": X, "indices": np.arange(N)}).batch(4096)
    models = {
        "reference": PoissonFactorization(latent_dim=K, feature_dim=D,
                                          dtype="float32", device="cuda",
                                          data=ds),
        "static": PoissonFactorization(latent_dim=K, feature_dim=D,
                                       dtype="float32", device="cuda",
                                       data=ds, likelihood_clip="static"),
    }
    epochs = {"reference": 2, "static": 1}
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = {k: m.fit(num_steps=epochs[k], learning_rate=0.01,
                       sample_size=S, verbose=False)
              for k, m in models.items()}
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = path_launches["dense"] = read_launches()
    steps = {k: epochs[k] * (N // 4096) for k in models}
    check(all(np.isfinite(v).all() for v in losses.values()),
          f"non-finite losses {losses}")
    check(launches["stats"] >= steps["reference"], f"K1 launches {launches}")
    check(launches["static"] >= steps["static"], f"K2 launches {launches}")
    check(launches["fwd"] >= sum(steps.values()), f"K3f launches {launches}")
    check(launches["bwd"] >= sum(steps.values()), f"K3b launches {launches}")
    for m in models.values():
        check(m.fusion_active and m.gamma_sampler == "fused",
              "fused paths inactive")
        check(all(t.is_cuda for sub in m.surrogate_params.values()
                  for t in sub.values()), "params left the card")
    say(6, f"fit: {sum(steps.values())} steps in {fit_s:.1f} s; losses "
           f"{ {k: [round(x, 4) for x in v] for k, v in losses.items()} }; "
           f"launches {launches}")
    # antithetic='stratified' at S=8 and at S=4 (the arm of
    # docs/stratified_experiment.json), one epoch each from the fitted model
    for s_arm in (S, 4):
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = models["reference"].fit(num_steps=1, learning_rate=0.01,
                                       sample_size=s_arm,
                                       antithetic="stratified",
                                       verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = path_launches[f"dense stratified S={s_arm}"] = \
            read_launches()
        n_steps = N // 4096
        check(np.isfinite(loss).all(), f"stratified S={s_arm}: losses {loss}")
        check(launches["fwd"] >= n_steps and launches["bwd"] >= n_steps
              and launches["stats"] >= n_steps,
              f"stratified S={s_arm}: launches {launches}")
        say(6, f"fit(antithetic='stratified', sample_size={s_arm}): "
               f"{n_steps} steps in {fit_s:.1f} s; losses "
               f"{[round(x, 4) for x in loss]}; launches {launches}")

    # one step at a small size, same draws: kernels (f32, card) vs the plain
    # float64 path (unfused, WH 'fast' sampler fed the same draws)
    small = {"kernel": PoissonFactorization(
        latent_dim=k_s, feature_dim=d_s, gamma_sampler="fast",
        u_tau_scale=1.0 / np.sqrt(n_s * d_s), dtype="float32", device="cuda",
        fused_likelihood=True, data=dense_data(Xs)),
        "plain": plain["poisson"].result()}
    p0 = perturbed_init(small["plain"], 5)
    draws = numpy_draws(small["plain"], 5)
    res = {}
    for tag, m in small.items():
        batch = {"counts": torch.as_tensor(Xs[:b_s], device=m.device)
                 .to(m.dtype)}
        before = tfp.LAUNCHES["stats"]
        res[tag] = step_grads(m, p0, batch, draws)
        if tag == "kernel":
            check(tfp.LAUNCHES["stats"] == before + 1, "small step skipped K1")
    e_loss = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    e_grad = rel_max(res["kernel"][1], res["plain"][1])
    check(e_loss < 1e-4, f"small-step loss rel err {e_loss}")
    check(e_grad < 1e-3, f"small-step grads rel err {e_grad}")
    say(6, f"small step vs float64 plain path: loss {res['kernel'][0]:.6f} vs "
           f"{res['plain'][0]:.6f} (rel {e_loss:.2e}), grads rel-of-max "
           f"{e_grad:.2e}")
    small_step_check(6, PoissonFactorization, Xs, 14,
                     plain["poisson"].result(), stratified=True)
    dense_model = models["reference"]
    del models, small

    # ---- A: the K6 path. The same dense model with the surrogate's
    # fused_normals seam on: K6f, K6b, K3f, K3b and K1 in every step
    model_a = PoissonFactorization(latent_dim=K, feature_dim=D,
                                   dtype="float32", device="cuda", data=ds)
    model_a._surrogate.fused_normals = True
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_a = model_a.fit(num_steps=1, learning_rate=0.01, sample_size=S,
                         verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = path_launches["A fused_normals"] = read_launches()
    # what fit launches besides its steps: the initial loss, and the
    # posterior means it takes at its end (forward only)
    zero_launches()
    model_a.set_calibration_expectations()
    calib = read_launches()["nfwd"]
    steps_a = N // 4096
    check(np.isfinite(loss_a).all(), f"A: non-finite losses {loss_a}")
    check(launches["nfwd"] == steps_a + 1 + calib,
          f"A: K6f launches {launches}, {steps_a} steps, calibration {calib}")
    check(launches["nbwd"] == steps_a, f"A: K6b launches {launches}")
    check(launches["fwd"] == launches["nfwd"]
          and launches["bwd"] == steps_a and launches["stats"] == steps_a + 1,
          f"A: K3 / K1 launches {launches}")
    say("A", f"fit with fused_normals: {steps_a} steps in {fit_s:.1f} s; "
             f"losses {[round(x, 4) for x in loss_a]}; launches {launches} "
             f"(K6f: {steps_a} steps + 1 initial loss + {calib} for the "
             f"posterior means; K6b: one per step)")

    small_step_check("A", PoissonFactorization, Xs, 15,
                     plain["poisson"].result())

    # the A/B this kernel exists for: the same model and batch with and
    # without fused_normals, in turns
    xb = torch.as_tensor(X[:4096], device=dev)
    step = step_timer(model_a, {"counts": xb,
                                "indices": torch.arange(4096, device=dev)})
    ab_ms = {True: [], False: []}
    for i in range(13):
        for on in ((True, False) if i % 2 else (False, True)):
            model_a._surrogate.fused_normals = on
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 3:
                ab_ms[on].append((time.perf_counter() - t0) * 1e3)
    ab_on, ab_off = (float(np.median(ab_ms[k])) for k in (True, False))
    say("A", f"dense step B=4096, fused_normals on {ab_on:.2f} ms/step, off "
             f"{ab_off:.2f} ms/step (medians of 10, interleaved; on/off "
             f"{ab_on / ab_off:.3f}; {smi})")
    # what the option changes on the device: the Normal block's draw,
    # transform, log q and backward, its kernels' summed time (profile)
    block = {}
    for on in (True, False):
        prof = profile_steps(normal_block_step(model_a, on))
        block[on] = prof
        say("A", f"Normal block (u, v, w, s: {N_TOTAL} elements, S={S}) "
                 f"and its backward, fused_normals={on}: "
                 + (f"{prof[1]:.4f} ms of device kernels a call"
                    if prof[1] else "device time not measured")
                 + f", {prof[3]:.0f} device kernels, {prof[0]:.3f} ms wall; "
                 "top " + "; ".join(f"{k} {ms:.4f} ms" for k, ms in prof[2])
                 + f" ({smi})")
    if block[True][1] and block[False][1]:
        say("A", f"Normal block device time on / off "
                 f"{block[True][1] / block[False][1]:.3f}")
    del model_a, step, xb, X, ds

    # ---- 7: the sparse slice, configured as the scRNA CLI does
    t0 = time.perf_counter()
    sp, col_means = sparse_counts(N_SPARSE, D, DENSITY, 11, dev)
    sp.shuffle(seed=0).batch(B_SPARSE, drop_remainder=True).as_coo()
    blocked = sp.to_device(block_rows=128, device="cuda")
    flat = sp.to_device(device="cuda")
    say(7, f"data: {N_SPARSE} x {D}, {len(sp.data)} nonzeros (density "
           f"{sp.density:.4f}), blocked layout {blocked.n_blocks} blocks of "
           f"{blocked.block_nnz} slots; built in "
           f"{time.perf_counter() - t0:.1f} s")

    def scrna_model(data, norms=col_means, **kw):
        return PoissonFactorization(
            latent_dim=K, feature_dim=D, log_transform=True,
            column_norms=norms, u_tau_scale=1.0 / np.sqrt(N_SPARSE * D),
            dtype="float32", device="cuda", data=data, **kw)

    sparse = {"blocked": scrna_model(blocked),
              "flat": scrna_model(flat, sparse_dense_scatter=False),
              "scatter": scrna_model(flat)}
    sparse_steps = N_SPARSE // B_SPARSE
    for tag, m in sparse.items():
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = m.fit(num_steps=1, learning_rate=0.01, sample_size=S,
                     verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = path_launches[tag] = read_launches()
        check(np.isfinite(loss).all(), f"{tag}: non-finite losses {loss}")
        if tag == "scatter":
            check(launches["stats"] >= sparse_steps
                  and launches["coo_scatter"] >= sparse_steps,
                  f"{tag}: {launches}")
            check(m.fusion_active and m.fusion_inactive_reason is None,
                  f"{tag}: dispatch {m.fusion_inactive_reason}")
        else:
            check(launches["expsum"] >= sparse_steps
                  and launches["coo_scatter"] == 0, f"{tag}: {launches}")
            expect = {"blocked": "blocked COO energy",
                      "flat": "sparse COO gather energy"}[tag]
            check(not m.fusion_active
                  and m.fusion_inactive_reason.startswith(expect),
                  f"{tag}: dispatch {m.fusion_inactive_reason}")
        say(7, f"{tag}: {sparse_steps} steps in {fit_s:.1f} s, losses "
               f"{[round(x, 4) for x in loss]}; dispatch "
               f"{m.fusion_inactive_reason!r}; launches {launches}")

    # the densify's scatter on a batch of the flat layout with its pad (the
    # triplets _densify_coo takes): the kernel against its twin (zeros + the
    # accumulating index_put_), bit for bit on counts; timed beside the
    # twin, zeros + scatter_add_ on the flattened slab (the library's one
    # computation of the slab) and scatter_add_ with a sink slot of its own
    # for each zero slot, past the slab (no run of adds on cell (0, 0))
    rows_c, cols_c, vals_c, _ = sparse["scatter"]._coo_arrays(
        next(iter(flat)))
    shape_c, n_c = (B_SPARSE, D), int(vals_c.shape[0])
    nnz_c = int((vals_c != 0).sum())
    flat_idx = rows_c.long() * D + cols_c.long()

    def scatter_add():
        x = torch.zeros(B_SPARSE * D, dtype=vals_c.dtype, device=dev)
        return x.scatter_add_(0, flat_idx, vals_c).view(shape_c)

    def scatter_add_sink():
        idx = torch.where(vals_c != 0, flat_idx, B_SPARSE * D
                          + torch.arange(n_c, device=dev))
        x = torch.zeros(B_SPARSE * D + n_c, dtype=vals_c.dtype, device=dev)
        return x.scatter_add_(0, idx, vals_c)[:B_SPARSE * D].view(shape_c)

    before = tcs.LAUNCHES["coo_scatter"]
    x_k = tcs.coo_scatter(rows_c, cols_c, vals_c, shape_c)
    check(tcs.LAUNCHES["coo_scatter"] == before + 1,
          "coo_scatter: the wrapper did not launch the kernel")
    x_t = tcs.coo_scatter_twin(rows_c, cols_c, vals_c, shape_c)
    for tag, x in (("twin", x_t), ("scatter_add_", scatter_add()),
                   ("scatter_add_ with sinks", scatter_add_sink())):
        check(torch.equal(x_k, x), f"coo_scatter: the kernel's slab differs "
                                   f"from {tag}'s")
    errs["coo_scatter"] = float((x_k - x_t).abs().max())
    del x_k, x_t
    ms_cs = {tag: cuda_ms(fn) for tag, fn in (
        ("kernel", lambda: tcs.coo_scatter(rows_c, cols_c, vals_c, shape_c)),
        ("twin", lambda: tcs.coo_scatter_twin(rows_c, cols_c, vals_c,
                                              shape_c)),
        ("scatter_add_", scatter_add),
        ("scatter_add_ with sinks", scatter_add_sink))}
    kt_cs = (ms_cs["kernel"], ms_cs["twin"])
    # the slab written once, the slots read once; the adds' sectors are left
    # out, so the bound is a floor
    bd_cs = bound(B_SPARSE * D * vals_c.element_size()
                  + n_c * (rows_c.element_size() + cols_c.element_size()
                           + vals_c.element_size()), 0)
    library_cs = ms_cs["scatter_add_"]
    say(7, f"coo_scatter B={B_SPARSE} D={D}: {nnz_c} nonzeros in {n_c} "
           f"slots; kernel == twin == scatter_add_ (with and without sinks) "
           f"bit for bit; " + ", ".join(f"{tag} {ms:.4f} ms" for tag, ms in
                                        ms_cs.items())
           + f" (CUDA events, median of 10, the fill included); bound "
             f"{bd_cs[0]:.4f} ms ({bd_cs[1]}; {bd_cs[0] / kt_cs[0]:.1%} of "
             f"the kernel) ({vals_c.dtype}, {rows_c.dtype}; {smi})")
    del rows_c, cols_c, vals_c, flat_idx

    # one blocked-COO step at a small size through the kernels (log link:
    # K5), against the plain float64 path on the same batch and draws
    data = sp_s.to_device(block_rows=128, dtype="float32", device="cuda")
    small = {"kernel": PoissonFactorization(
        latent_dim=k_s, feature_dim=d_s, gamma_sampler="fast",
        log_transform=True, u_tau_scale=1.0 / np.sqrt(n_s * d_s),
        dtype="float32", device="cuda", fused_likelihood=True, data=data),
        "plain": plain["blocked"].result()}
    small = {tag: (m, next(iter(m.data()))) for tag, m in small.items()}
    p0 = perturbed_init(small["plain"][0], 6)
    draws = numpy_draws(small["plain"][0], 6)
    res = {}
    for tag, (m, batch) in small.items():
        before = tfp.LAUNCHES["expsum"]
        res[tag] = step_grads(m, p0, batch, draws)
        check(m.fusion_inactive_reason.startswith("blocked COO"),
              f"small {tag} step dispatch {m.fusion_inactive_reason}")
        if tag == "kernel":
            check(tfp.LAUNCHES["expsum"] == before + 1,
                  "small blocked step skipped K5")
    e_loss = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    e_grad = rel_max(res["kernel"][1], res["plain"][1])
    check(e_loss < 1e-4, f"small blocked step loss rel err {e_loss}")
    check(e_grad < 1e-3, f"small blocked step grads rel err {e_grad}")
    say(7, f"small blocked-COO step vs float64 plain path: loss "
           f"{res['kernel'][0]:.6f} vs {res['plain'][0]:.6f} (rel "
           f"{e_loss:.2e}), grads rel-of-max {e_grad:.2e}")

    # ---- C: the scRNA width at 0.1% density, where the auto dispatch takes
    # the COO energy (K5 every step), and the same batches densified for K1
    t0 = time.perf_counter()
    sp_c, norms_c = sparse_counts(N_SPARSE, D, DENSITY_COO, 41, dev)
    sp_c.shuffle(seed=0).batch(B_SPARSE, drop_remainder=True).as_coo()
    flat_c = sp_c.to_device(device="cuda")
    say("C", f"data: {N_SPARSE} x {D}, {len(sp_c.data)} nonzeros (density "
             f"{sp_c.density:.5f}), flat decode; built in "
             f"{time.perf_counter() - t0:.1f} s")
    coo_arms = {"auto": scrna_model(flat_c, norms=norms_c),
                "scatter": scrna_model(flat_c, norms=norms_c,
                                       sparse_dense_scatter=True)}
    for tag, m in coo_arms.items():
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = m.fit(num_steps=1, learning_rate=0.01, sample_size=S,
                     verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = path_launches[f"C 0.1% {tag}"] = read_launches()
        check(np.isfinite(loss).all(), f"C {tag}: non-finite losses {loss}")
        if tag == "auto":
            check(launches["expsum"] >= sparse_steps, f"C {tag}: {launches}")
            check(not m.fusion_active and m.fusion_inactive_reason.startswith(
                "sparse COO gather energy"),
                f"C {tag}: the dispatch took {m.fusion_inactive_reason!r}")
        else:
            check(launches["stats"] >= sparse_steps
                  and launches["coo_scatter"] >= sparse_steps,
                  f"C {tag}: {launches}")
            check(m.fusion_active and m.fusion_inactive_reason is None,
                  f"C {tag}: dispatch {m.fusion_inactive_reason}")
        say("C", f"{tag}: {sparse_steps} steps in {fit_s:.1f} s, losses "
                 f"{[round(x, 4) for x in loss]}; dispatch "
                 f"{m.fusion_inactive_reason!r}; launches {launches}")

    # ---- 8: scoring through K4
    held, _ = sparse_counts(B_SPARSE, D, DENSITY, 13, dev)
    held.batch(B_SPARSE).as_coo()
    scorer = sparse["blocked"]
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = scorer.log_likelihood(held, num_samples=100, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    scoring = read_launches()
    w = scorer.waic(subsample="batch")
    path_launches["scoring"] = read_launches()
    check(scoring["row_ll"] >= 13 and scoring["fwd"] > 0,
          f"log_likelihood launches {scoring}")
    check(ll["n_rows"] == B_SPARSE and np.isfinite(ll["total"]),
          f"log_likelihood {ll}")
    check(w["n_rows"] == B_SPARSE and np.isfinite(
        [w["waic"], w["se"], w["lppd"], w["pwaic"]]).all(), f"waic {w}")
    check(scorer.fusion_inactive_reason.startswith("blocked COO"),
          "scoring clobbered the training dispatch record")
    say(8, f"log_likelihood(4096 held-out rows, 100 samples): per_row "
           f"{ll['per_row']:.4f} in {ll_s:.2f} s ({B_SPARSE / ll_s:.0f} "
           f"rows/s); launches {scoring}; waic(subsample='batch') "
           f"{ {k: round(v, 3) for k, v in w.items()} }")

    # waic with spmf_tpu's positional order (dtype 7th, sample_chunk 8th)
    # against the keyword call, from the same seed: K4 is deterministic, so
    # the two agree bit for bit
    held_batches = list(held)
    score_args = (scorer._row_log_likelihood, scorer._surrogate,
                  scorer.surrogate_params, lambda: iter(held_batches))
    k4 = [tfp.LAUNCHES["row_ll"]]
    w_pos = waic(*score_args, 20, 3, scorer.dtype, 8)
    k4.append(tfp.LAUNCHES["row_ll"])
    w_kw = waic(*score_args, num_samples=20, seed=3, sample_chunk=8,
                dtype=scorer.dtype, device=scorer.device)
    k4.append(tfp.LAUNCHES["row_ll"])
    k4 = np.diff(k4).tolist()
    check(k4[0] == k4[1] >= 3, f"positional waic: K4 launches {k4}")
    check(w_pos == w_kw and np.isfinite(w_pos["waic"]),
          f"positional waic {w_pos} against keywords {w_kw}")
    say(8, f"waic in spmf_tpu's positional order equals the keyword call "
           f"bit for bit: {w_pos}")

    # the COO row log-likelihood at a small size: K4 (f32, card) vs the
    # plain float64 path on the same samples
    coo = next(iter(SparseCounts(sp_s.indptr, sp_s.indices, sp_s.data,
                                 sp_s.shape).batch(b_s).as_coo()))
    samples = lognormal_samples(small["plain"][0], S, 7)
    out = {}
    for tag, (m, _) in small.items():
        before = tfp.LAUNCHES["row_ll"]
        out[tag] = m._row_log_likelihood(
            _device_batch(coo, m.dtype, m.device),
            params_from_numpy(samples, m.device, m.dtype))
        if tag == "kernel":
            check(tfp.LAUNCHES["row_ll"] == before + 1, "small rows skip K4")
    e_row = rel_elem(out["kernel"].cpu(), out["plain"])
    check(e_row < 1e-5, f"small COO row ll rel err {e_row}")
    say(8, f"small COO row log-likelihood vs float64 plain path: rel "
           f"{e_row:.2e}")
    del small, sp_s

    # ---- B: the other families at full width
    n_b = 8192
    types = [t for t, n in MIXED_COLUMNS for _ in range(n)]
    gb = torch.Generator(device=dev).manual_seed(31)
    counts_b = likelihood_x("poisson", n_b, dev, gb)
    col_std = lambda t: (t - t.mean(0)) / t.std(0).clamp_min(1e-6)  # noqa
    data_b = {
        "mixed": likelihood_x("mixed", n_b, dev, gb),
        "bernoulli": counts_b.clamp_max(1.0),
        "gaussian": col_std(torch.log1p(counts_b)),
    }
    held_b = likelihood_x("mixed", 4096, dev, gb).cpu().numpy()
    data_b = {k: ArrayDataset({"counts": t.cpu().numpy(),
                               "indices": np.arange(n_b)}).batch(4096)
              for k, t in data_b.items()}
    del counts_b
    common = dict(latent_dim=K, feature_dim=D, dtype="float32", device="cuda")
    # (class, data, learning rate, arguments). The learning rates: theta is
    # about 13.5 in every latent dimension at this width, and Adam's first
    # steps move all K loadings of a column by the learning rate in one
    # direction, so a logit moves by 432 learning rates a step: 5e-4 keeps
    # that at 0.2. The Gaussian family's rates start near 4e4 and shrink by
    # a relative step, so it takes 0.05.
    families = {
        "mixed": (MixedFactorization, "mixed", 5e-4, dict(
            column_types=types, obs_scale=1.0, scale_columns=False)),
        "mixed static": (MixedFactorization, "mixed", 5e-4, dict(
            column_types=types, obs_scale=1.0, scale_columns=False,
            likelihood_clip="static")),
        "bernoulli": (BernoulliFactorization, "bernoulli", 5e-4, {}),
        "gaussian normal": (GaussianFactorization, "gaussian", 0.05, dict(
            observation_model="normal", obs_scale=1.0, scale_columns=False,
            scale_rows=False)),
    }
    def start_vw_near_zero(m, seed):
        """The families' surrogates start v and w at loc -6, the Poisson
        model's value. Under the Identity bijector of the Bernoulli and
        Mixed families that is a loading of -6, and at D=20000 every logit
        and softplus rate then starts below -1000: Poisson columns begin as
        clipped cells, which pass no gradient. Start them near 0, as a
        user of these families at this width would."""
        g = torch.Generator(device=dev).manual_seed(seed)
        with torch.no_grad():
            v_loc = m.surrogate_params["v"]["loc"]
            v_loc.copy_(0.01 * torch.randn(v_loc.shape, generator=g,
                                           device=dev))
            m.surrogate_params["w"]["loc"].zero_()

    steps_b = 2 * (n_b // 4096)
    fitted = {}
    for tag, (cls, dkey, lr, kw) in families.items():
        m = fitted[tag] = cls(data=data_b[dkey], **common, **kw)
        if cls is not GaussianFactorization:
            start_vw_near_zero(m, 32)
        fused_normals = tag == "gaussian normal"
        m._surrogate.fused_normals = fused_normals
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = m.fit(num_steps=2, learning_rate=lr, sample_size=S,
                     verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = path_launches[f"B {tag}"] = read_launches()
        clip = "static" if tag == "mixed static" else "stats"
        check(np.isfinite(loss).all() and loss[-1] < loss[0],
              f"B {tag}: losses {loss}")
        check(launches[clip] == steps_b + 1, f"B {tag}: launches {launches}")
        check(launches["nbwd"] == (steps_b if fused_normals else 0)
              and launches["bwd"] == steps_b, f"B {tag}: launches {launches}")
        check(m.fusion_active and m.fusion_inactive_reason is None,
              f"B {tag}: dispatch {m.fusion_inactive_reason}")
        say("B", f"{tag} ({cls.__name__}, likelihood {m._fused_kind()}): "
                 f"{steps_b} steps in {fit_s:.1f} s, losses "
                 f"{[round(x, 4) for x in loss]}; launches {launches}")

    mixed = fitted["mixed"]
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ll = mixed.log_likelihood(
        ArrayDataset({"counts": held_b, "indices": np.arange(4096)}
                     ).batch(4096), num_samples=32, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    w = mixed.waic(subsample="batch", num_samples=32)
    launches = path_launches["B mixed scoring"] = read_launches()
    check(launches["row_ll"] == 8, f"B mixed scoring launches {launches}")
    check(ll["n_rows"] == 4096 and np.isfinite(ll["total"]),
          f"B mixed log_likelihood {ll}")
    check(w["n_rows"] == 4096 and np.isfinite(
        [w["waic"], w["se"], w["lppd"], w["pwaic"]]).all(), f"B waic {w}")
    say("B", f"mixed log_likelihood(4096 held-out rows, 32 samples): per_row "
             f"{ll['per_row']:.4f} in {ll_s:.2f} s; waic(subsample='batch') "
             f"{ {k: round(v, 3) for k, v in w.items()} }; launches "
             f"{launches}")

    # one small step per family through K1 (its likelihood), K3 and K6
    small_step_check("B mixed", MixedFactorization, Xs_mixed, 17,
                     plain["B mixed"].result(), signed_vw=True,
                     column_types=types_s, scale_columns=False)
    small_step_check("B bernoulli", BernoulliFactorization,
                     np.minimum(Xs, 1.0), 18, plain["B bernoulli"].result(),
                     signed_vw=True)
    small_step_check("B gaussian normal", GaussianFactorization, Xs_log, 19,
                     plain["B gaussian normal"].result(),
                     observation_model="normal", scale_columns=False,
                     scale_rows=False)
    mixed_model = fitted["mixed"]
    del fitted, data_b, held_b

    # ---- P: persistence at the full width
    path_launches["P persistence"] = persistence_phase(
        dev, smi, zero_launches, read_launches)
    say("P", f"launches {path_launches['P persistence']}")

    # ---- G: the whole-epoch scan path, each batch's step a CUDA graph
    path_launches["G scan"] = scan_phase(
        dev, smi, zero_launches, read_launches,
        {"sparse 3% blocked": (sparse["blocked"], blocked),
         "sparse 3% flat, dense scatter": (sparse["scatter"], flat),
         "sparse 0.1% flat": (coo_arms["auto"], flat_c)})
    say("G", f"launches {path_launches['G scan']}")
    check(path_launches["G scan"]["coo_scatter"] > 0,
          "G: the 3% flat set's captured scan never launched coo_scatter")

    # ---- AE: horshoe_plus=False at the scRNA width and the
    # PoissonAutoencoder at its bench width
    path_launches["AE"] = autoencoder_phase(dev, smi, zero_launches,
                                            read_launches)
    say("AE", f"launches {path_launches['AE']}")
    # one small non-plus step per family through K1 and K6 (no K3)
    small_step_check("AE poisson non-plus", PoissonFactorization, Xs, 23,
                     plain["AE poisson non-plus"].result(),
                     horshoe_plus=False)
    small_step_check("AE gaussian non-plus", GaussianFactorization, Xs_log,
                     24, plain["AE gaussian non-plus"].result(),
                     horshoe_plus=False, observation_model="normal",
                     scale_columns=False, scale_rows=False)

    # ---- O: the engine options at the dense width
    path_launches["O options"] = options_phase(dev, smi, zero_launches,
                                               read_launches)
    # one small step per option against the plain float64 path: STL on
    # shared numpy draws (K1), aux_broadcast on the same Philox draws (K1,
    # K3 at S=1, K6)
    small_step_check("O stl", PoissonFactorization, Xs, 25,
                     plain["poisson"].result(), stl=True)
    small_step_check("O aux_broadcast", PoissonFactorization, Xs, 26,
                     plain["O aux_broadcast"].result(), aux_broadcast=True)

    # ---- CLI: the entry points at full width
    path_launches["CLI"] = cli_phase(dev, smi, zero_launches, read_launches)

    # ---- M: multi-rank training, two gloo ranks on this card
    path_launches["M mesh"] = mesh_phase(dev, smi, zero_launches,
                                         read_launches)

    # ---- EX: the examples through the port
    path_launches["EX examples"] = examples_phase(dev, smi, zero_launches,
                                                  read_launches)

    # ---- W: the latent dimensions past the whole-K tiles, and the slice at
    # K=128 end to end
    path_launches["W wide"], errs_w, kt_w, bd_w = wide_phase(
        dev, smi, zero_launches, read_launches, (flat_c, norms_c), held)

    # ---- 9: times (medians of 10 after warmup)
    B = 4096
    for Bt in (B, 32768):
        xb = torch.poisson(torch.ones(Bt, D, device=dev), generator=gx)
        step = step_timer(dense_model, {
            "counts": xb, "indices": torch.arange(Bt, device=dev)})
        ms, mem = time_steps(step)
        say(9, f"dense step B={Bt}: {ms:.2f} ms/step, {Bt / ms * 1e3:.0f} "
               f"rows/s, peak {mem:.2f} GB (median of 10; {smi})")
        say_profile(f"dense B={Bt}", profile_steps(step), smi)
        if Bt == B:
            # the sampler arms of docs/stratified_experiment.json at S=4
            for s_arm, anti in ((4, True), (4, "stratified")):
                arm = step_timer(dense_model, {
                    "counts": xb, "indices": torch.arange(Bt, device=dev)},
                    sample_size=s_arm, antithetic=anti)
                ms, mem = time_steps(arm)
                tag = f"dense B={Bt} S={s_arm} antithetic={anti!r}"
                say(9, f"{tag}: {ms:.2f} ms/step, {Bt / ms * 1e3:.0f} "
                       f"rows/s, peak {mem:.2f} GB (median of 10; {smi})")
                say_profile(tag, profile_steps(arm), smi)
                del arm
        del xb, step
    del dense_model
    arms = [(f"sparse {tag}", m) for tag, m in sparse.items()] + [
        (f"sparse 0.1% {tag}", m) for tag, m in coo_arms.items()]
    for tag, m in arms:
        batch = _device_batch(next(iter(m.data())), m.dtype, m.device)
        step = step_timer(m, batch)
        ms, mem = time_steps(step)
        prof = profile_steps(step)
        k5 = sum(t for k, t in prof[4].items() if "expsum_kernel" in k)
        say(9, f"{tag} step B={B_SPARSE}: {ms:.2f} ms/step, "
               f"{B_SPARSE / ms * 1e3:.0f} rows/s, peak {mem:.2f} GB "
               f"(median of 10); K5 {k5:.3f} ms a step (profile) ({smi})")
        say_profile(f"{tag} B={B_SPARSE}", prof, smi)
        del step, batch
    t0 = time.perf_counter()
    scorer.log_likelihood(held, num_samples=100, sample_chunk=8)
    torch.cuda.synchronize()
    ll_s = time.perf_counter() - t0
    say(9, f"log_likelihood B={B_SPARSE}, 100 samples: {ll_s:.3f} s, "
           f"{B_SPARSE / ll_s:.0f} rows/s ({smi})")
    del sparse, scorer, blocked, flat, coo_arms, flat_c, sp_c

    args = stats_inputs(B, dev, seed=6)
    kt = {}
    for static, key in ((False, "stats"), (True, "static")):
        kt[key] = (cuda_ms(lambda: tfp._kernel_stats(*args, False, static)),
                   cuda_ms(lambda: tfp.stats_twin(*args, static=static)))
    kt["row_ll"] = (cuda_ms(lambda: tfp._kernel_row_ll(*args, True)),
                    cuda_ms(lambda: tfp.row_loglik_twin(*args, True)))
    th, vv, ee = args[0], args[1], args[4]
    kt["expsum"] = (cuda_ms(lambda: tfp._kernel_expsum(th, vv, ee)),
                    cuda_ms(lambda: tfp.expsum_twin(th, vv, ee)))
    # K3 in its three modes at S=8 (the JSON line's entry: independent, the
    # fit() default); twins beyond it timed 3 times after 1 warm-up
    for anti in IG_MODES:
        quick = dict(iters=3, warmup=1) if anti else {}
        ig_t = {
            "fwd": (cuda_ms(lambda: tig._kernel_fwd(a, b, seed, S, anti)),
                    cuda_ms(lambda: tig.ig_twin_fwd(a, b, seed, S, anti),
                            **quick)),
            "bwd": (cuda_ms(lambda: tig._kernel_bwd(a, b, seed, S, anti, gy,
                                                    glq)),
                    cuda_ms(lambda: tig.ig_twin_bwd(a, b, seed, S, anti, gy,
                                                    glq), **quick))}
        if not anti:
            kt.update(ig_t)
        for kind, (k_ms, t_ms) in ig_t.items():
            ms_b, by, pipe = ig_bound(kind, IG_TOTAL, S, anti)
            old = (600 if kind == "fwd" else 700) * S * IG_TOTAL \
                / PEAK_F32_OPS_PER_S * 1e3
            info = tig.kernel_info(kind, anti, S)
            say(9, f"K3{kind[0]} antithetic={anti!r}: kernel {k_ms:.3f} ms, "
                   f"twin {t_ms:.3f} ms, bound {ms_b:.3f} ms ({by}: {pipe}; "
                   f"{ms_b / k_ms:.1%} of it; {old:.3f} ms as 600 / 700 "
                   f"float32 operations an element and sample); "
                   f"{info['registers']} registers a "
                   f"thread, {info['smem_bytes']} + "
                   f"{info['static_smem_bytes']} bytes of shared memory a "
                   f"block, {info['blocks_per_sm']} blocks an SM (occupancy "
                   f"API) (float32, total={IG_TOTAL}, S={S}; {smi})")
    for anti in (True, "stratified"):
        k_f = cuda_ms(lambda: tig._kernel_fwd(a, b, seed, 4, anti))
        k_b = cuda_ms(lambda: tig._kernel_bwd(a, b, seed, 4, anti, gy[:4],
                                              glq[:4]))
        b_f, b_b = (ig_bound(kind, IG_TOTAL, 4, anti)[0]
                    for kind in ("fwd", "bwd"))
        say(9, f"K3 S=4 antithetic={anti!r}: K3f {k_f:.3f} ms (bound "
               f"{b_f:.3f}), K3b {k_b:.3f} ms (bound {b_b:.3f}) (float32, "
               f"total={IG_TOTAL}; {smi})")
    mask = masks["gaussian"]
    n_calls = {"nfwd": lambda: tfn._kernel_fwd(n_loc, n_rs, mask, n_seed, S),
               "nbwd": lambda: tfn._kernel_bwd(n_loc, n_rs, mask, n_seed, S,
                                               n_gy, n_glq)}
    kt["nfwd"] = (
        cuda_ms(n_calls["nfwd"]),
        cuda_ms(lambda: tfn.normal_twin_fwd(n_loc, n_rs, mask, n_seed, S)))
    kt["nbwd"] = (
        cuda_ms(n_calls["nbwd"]),
        cuda_ms(lambda: tfn.normal_twin_bwd(n_loc, n_rs, mask, n_seed, S,
                                            n_gy, n_glq)))
    for key, kind in (("nfwd", "fwd"), ("nbwd", "bwd")):
        ms_b, by, pipe = normal_bound(kind, N_TOTAL, S)
        old = normal_bound(kind, N_TOTAL, S, samples_per_call=1)
        info = tfn.kernel_info(kind, S)
        dev_ms = profile_steps(n_calls[key], n=20)[1]
        share = (f"{dev_ms:.4f} ms of device kernels a call (profile; "
                 f"{ms_b / dev_ms:.1%} of the bound)" if dev_ms
                 else "device time not measured")
        say(9, f"K6{kind[0]}: kernel {kt[key][0]:.4f} ms (CUDA events "
               f"around the call), {share}; bound {ms_b:.4f} "
               f"ms ({by}: {pipe}; {ms_b / kt[key][0]:.1%} of it); with a "
               f"Philox call a sample (the stream before four a call) "
               f"{old[0]:.4f} ms ({old[2]}); {info['registers']} registers "
               f"a thread, {info['smem_bytes']} + "
               f"{info['static_smem_bytes']} bytes of shared memory a "
               f"block, {info['blocks_per_sm']} blocks an SM (occupancy "
               f"API) (float32, total={N_TOTAL}, S={S}; {smi})")
    bd = bounds(B, IG_TOTAL, N_TOTAL)
    errs.update(errs_w)
    bd.update(bd_w)
    sizes = {"fwd": f"total={IG_TOTAL}", "bwd": f"total={IG_TOTAL}",
             "nfwd": f"total={N_TOTAL}", "nbwd": f"total={N_TOTAL}"}
    kt.update(kt_w)
    sizes.update({k: f"B={B}, K={W_K}" for k in kt_w})
    kt["coo_scatter"], bd["coo_scatter"] = kt_cs, bd_cs
    sizes["coo_scatter"] = f"B={B_SPARSE}, a 3% batch with its pad"
    library = {"coo_scatter": library_cs}
    for key, (k_ms, t_ms) in kt.items():
        say(9, f"{key}: kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms, bound "
               f"{bd[key][0]:.3f} ms ({bd[key][1]}; {bd[key][0] / k_ms:.1%} "
               f"of it) (float32, {sizes.get(key, 'B=' + str(B))}, S={S}; "
               f"{smi})")
    eb = expsum_bound(B)
    say(9, f"expsum bound by route: {eb['tf32x3'][0]:.3f} ms "
           f"({eb['tf32x3'][2]}), {eb['fp32'][0]:.3f} ms ({eb['fp32'][2]}: "
           f"the products once in float32); the kernel reads "
           f"{eb['tf32x3'][0] / kt['expsum'][0]:.1%} of the first and "
           f"{eb['fp32'][0] / kt['expsum'][0]:.1%} of the second (B={B})")

    # K1 and K4 at the other dense arm, B=32768, and what the build and the
    # occupancy API say of them
    big = stats_inputs(32768, dev, seed=6)
    bd_big = bounds(32768, IG_TOTAL, N_TOTAL)
    for key, fn in (("stats", lambda: tfp._kernel_stats(*big, False, False)),
                    ("row_ll", lambda: tfp._kernel_row_ll(*big, True)),
                    ("expsum", lambda: tfp._kernel_expsum(big[0], big[1],
                                                          big[4]))):
        k_ms = cuda_ms(fn, iters=5, warmup=1)
        say(9, f"{key} at B=32768: kernel {k_ms:.3f} ms, bound "
               f"{bd_big[key][0]:.3f} ms ({bd_big[key][1]}; "
               f"{bd_big[key][0] / k_ms:.1%} of it) (float32, S={S}; {smi})")
    del big
    for kind in ("stats", "row_ll", "expsum"):
        info = tfp.kernel_info(kind, K)
        what = "" if kind == "expsum" else "Poisson, identity link, "
        say(9, f"{kind}_kernel ({what}K={K}): "
               f"{info['registers']} registers a thread, "
               f"{info['smem_bytes']} + {info['static_smem_bytes']} bytes of "
               f"shared memory a block, {info['blocks_per_sm']} blocks an SM "
               f"(occupancy API); grid "
               f"{tfp.launch_geometry(kind, S, B, K, D).grid} blocks at "
               f"B={B}, {tfp.launch_geometry(kind, S, 32768, K, D).grid} at "
               f"B=32768")

    # K1 and K4 at the other likelihoods (identity link for K1, log link for
    # K4, as their Poisson rows above), and the mixed training step
    for lname in ("bernoulli", "normal", "mixed"):
        largs, codes = likelihood_inputs(lname, B, dev, seed=6)
        lik = LIKELIHOODS[lname]
        k1 = (cuda_ms(lambda: tfp._kernel_stats(*largs, False, False, lik,
                                                codes)),
              cuda_ms(lambda: tfp.stats_twin(*largs, False, False, lik,
                                             codes)))
        k4 = (cuda_ms(lambda: tfp._kernel_row_ll(*largs, True, lik, codes)),
              cuda_ms(lambda: tfp.row_loglik_twin(*largs, True, lik, codes)))
        say(9, f"likelihood {lik}: K1 kernel {k1[0]:.3f} ms (twin "
               f"{k1[1]:.3f} ms; Poisson {kt['stats'][0]:.3f} ms), K4 kernel "
               f"{k4[0]:.3f} ms (twin {k4[1]:.3f} ms; Poisson "
               f"{kt['row_ll'][0]:.3f} ms) (float32, B={B}, S={S}; {smi})")
    del largs, codes
    batch = _device_batch(next(iter(mixed_model.data())), mixed_model.dtype,
                          mixed_model.device)
    step = step_timer(mixed_model, batch)
    ms, mem = time_steps(step)
    say(9, f"mixed step B={B}: {ms:.2f} ms/step, {B / ms * 1e3:.0f} rows/s, "
           f"peak {mem:.2f} GB (median of 10; {smi})")
    say_profile(f"mixed B={B}", profile_steps(step), smi)
    del step, batch, mixed_model

    meta = {
        "stats": ("fused_poisson_stats (K1, clip='reference')",
                  "spmf_tpu_torch/csrc/fused_poisson.cu",
                  "spmf_tpu/ops/fused_poisson.py:323"),
        "static": ("fused_poisson_stats (K2, clip='static')",
                   "spmf_tpu_torch/csrc/fused_poisson.cu",
                   "spmf_tpu/ops/fused_poisson.py:387"),
        "row_ll": ("fused_poisson_row_ll (K4)",
                   "spmf_tpu_torch/csrc/fused_poisson.cu",
                   "spmf_tpu/ops/fused_poisson.py:768"),
        "expsum": ("fused_exp_rate_sum (K5)",
                   "spmf_tpu_torch/csrc/fused_expsum.cu",
                   "spmf_tpu/ops/fused_poisson.py:872"),
        "fwd": ("fused_ig_fwd (K3f)", "spmf_tpu_torch/csrc/fused_ig.cu",
                "spmf_tpu/ops/fused_ig.py:193"),
        "bwd": ("fused_ig_bwd (K3b)", "spmf_tpu_torch/csrc/fused_ig.cu",
                "spmf_tpu/ops/fused_ig.py:230"),
        "nfwd": ("fused_normal_fwd (K6f)",
                 "spmf_tpu_torch/csrc/fused_normal.cu",
                 "spmf_tpu/ops/fused_normal.py:80"),
        "nbwd": ("fused_normal_bwd (K6b)",
                 "spmf_tpu_torch/csrc/fused_normal.cu",
                 "spmf_tpu/ops/fused_normal.py:99"),
        "stats_wide": ("fused_poisson_stats_wide (K1 past K=124, "
                       "clip='reference')",
                       "spmf_tpu_torch/csrc/fused_poisson_wide.cu",
                       "spmf_tpu/ops/fused_poisson.py:323"),
        "static_wide": ("fused_poisson_stats_wide (K2 past K=124, "
                        "clip='static')",
                        "spmf_tpu_torch/csrc/fused_poisson_wide.cu",
                        "spmf_tpu/ops/fused_poisson.py:387"),
        "row_ll_wide": ("fused_poisson_row_ll_wide (K4 past K=64)",
                        "spmf_tpu_torch/csrc/fused_poisson_wide.cu",
                        "spmf_tpu/ops/fused_poisson.py:768"),
        "expsum_wide": ("fused_exp_rate_sum_wide (K5 past K=64)",
                        "spmf_tpu_torch/csrc/fused_expsum.cu",
                        "spmf_tpu/ops/fused_poisson.py:872"),
        "coo_scatter": ("coo_scatter (the densify's COO-to-dense slab)",
                        "spmf_tpu_torch/csrc/coo_scatter.cu",
                        "no Pallas kernel: .at[].add, "
                        "spmf_tpu/models/poisson.py:952"),
    }
    total = {k: sum(p.get(k, 0) for p in path_launches.values())
             for k in kernels}
    say(9, f"launches per path {path_launches}")
    check(all(total[k] > 0 for k in kernels), f"kernel never launched {total}")
    # no single PyTorch computation gives any of these functions but the
    # densify's slab (zeros + scatter_add_): library null elsewhere
    print(json.dumps({"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": total[k],
         "max_abs_err": errs[k], "ms": kt[k][0], "plain_ms": kt[k][1],
         "bound_ms": bd[k][0], "bound_by": bd[k][1],
         "library_ms": library.get(k)}
        for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-rank":
        mesh_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif len(sys.argv) > 1 and sys.argv[1] == "--nccl-check":
        nccl_main(sys.argv[2])
    else:
        main()
