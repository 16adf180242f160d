#!/usr/bin/env python3
"""What the lgamma(x + 1) table of the fused Poisson kernels of
spmf_tpu_torch (csrc/fused_poisson.cu) costs when counts miss it.

    python3 benchmarks/torch_poisson_lgamma_tail.py [--rows 4096]

K1 (fused_poisson_stats) and K4 (fused_poisson_row_ll, log link) read
lgamma(x + 1) from a 64-entry table for integer counts below 64 and fall to
an out-of-line Stirling series for any other cell, while the rest of the
cell's warp waits. Here both are timed at S=8, D=20000, K=32, float32 on
count matrices made from a seed whose share of misses is known (CUDA events,
median of 7 after 2 warm-ups):

  mix p       Poisson(1) counts with a share p of the cells, chosen
              uniformly, replaced by 64 + Poisson(30)
  nb m r      negative binomial counts of mean m and dispersion r (a
              Gamma(r, m / r) rate under a Poisson), the heavy tail of
              sequencing counts
  half        Poisson(1) + 0.5: no cell is an integer, every one misses

Prints one line per matrix with the share of cells that miss the table and
the card's name and power limit; exits 2 without a CUDA device.
"""
import argparse
import os
import subprocess
import sys

import numpy as np

S, D, K = 8, 20000, 32
TABLE_N = 64
MIXES = (0.0, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 1.0)
NEGATIVE_BINOMIALS = ((1.0, 0.1), (5.0, 0.2), (20.0, 0.5))


def count_matrices(B, dev, seed=6):
    """(label, (B, D) float32 counts) pairs, drawn on ``dev`` from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ones = torch.ones(B, D, device=dev)
    base = torch.poisson(ones, generator=g)
    for p in MIXES:
        big = TABLE_N + torch.poisson(30.0 * ones, generator=g)
        pick = torch.rand(B, D, generator=g, device=dev) < p
        yield f"mix {p:g}", torch.where(pick, big, base)
    for mean, r in NEGATIVE_BINOMIALS:
        # the Gamma rates come from the global generator, seeded here
        rate = torch.distributions.Gamma(
            torch.tensor(r, device=dev), torch.tensor(r / mean, device=dev))
        torch.manual_seed(seed)
        yield f"nb {mean:g} {r:g}", torch.poisson(rate.sample((B, D)),
                                                  generator=g)
    yield "half", base + 0.5


def cuda_ms(fn, iters=7, warmup=2):
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


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096, help="batch rows B")
    B = ap.parse_args().rows
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from spmf_tpu_torch.ops import fused_poisson as tfp

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(6)
    theta = torch.rand(S, B, K, generator=g, device=dev) * 0.5
    v = torch.rand(S, K, D, generator=g, device=dev) * 0.05
    phi = torch.rand(S, 1, D, generator=g, device=dev) * 0.5 + 0.05
    eta = torch.rand(1, D, generator=g, device=dev) * 1.5 + 0.5
    for label, x in count_matrices(B, dev):
        miss = float(((x != x.floor()) | (x >= TABLE_N)).float().mean())
        args = (theta, v, phi, x, eta)
        k1 = cuda_ms(lambda: tfp._kernel_stats(*args, False, False))
        k4 = cuda_ms(lambda: tfp._kernel_row_ll(*args, True))
        print(f"{label:12s} B={B}: misses {miss:.6f} of the cells (largest "
              f"count {float(x.max()):g}); K1 {k1:.3f} ms, K4 (log link) "
              f"{k4:.3f} ms ({smi})", flush=True)


if __name__ == "__main__":
    main()
