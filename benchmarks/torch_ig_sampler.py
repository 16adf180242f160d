#!/usr/bin/env python3
"""Times of the fused InverseGamma sampler of spmf_tpu_torch (K3f / K3b,
csrc/fused_ig.cu) in each antithetic mode, and the device kernels one
sampler call launches, for one checkout.

    python3 benchmarks/torch_ig_sampler.py [--root DIR] [--samples 8 4]
                                           [--passes 2]

At the IG block of the scRNA width (D=20000, K=32: total=1,400,064
elements, float32), for each sample count and each mode the checkout
supports (False, True, 'stratified'; a mode it refuses is reported so),
prints one JSON line with the median ms of K3f and K3b over 20 launches
after 3 warm-ups (CUDA events; ``--passes`` times over, in turns), and the
number of device kernels torch.profiler sees in one forward and backward
through ``fused_ig_sample_logq`` (the kernel itself and what its wrapper
launches around it). --root names the checkout whose spmf_tpu_torch is
timed (this one by default), so that two commits can be compared in one
run on one card: run parent, change, change, parent. Exits 2 without a
CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

D, K = 20000, 32
TOTAL = 2 * D * K + 2 * 2 * D + 2 * D + 2 * K
MODES = (False, True, "stratified")


def median_ms(fn, iters=20, warmup=3):
    import numpy as np
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


def launches_per_call(tig, a, b, seed, S, mode):
    """Device kernels in one forward and backward through the autograd
    Function (the cotangents' own fill kernels excluded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    leaf = a.detach().clone().requires_grad_(True)
    gy = torch.ones(S, a.shape[0], device=a.device)
    glq = torch.ones(S, device=a.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y, lq = tig.fused_ig_sample_logq(leaf, b, seed, S, mode)
        torch.autograd.backward([y, lq], [gy, glq])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return len(names), sorted({n[:60] for n in names})


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--samples", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ig_sampler: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.root))
    from spmf_tpu_torch.ops import fused_ig as tig

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.rand(TOTAL, generator=g, device=dev) * 5 + 0.3
    b = torch.rand(TOTAL, generator=g, device=dev) * 3 + 0.1
    seed = torch.tensor([987654], dtype=torch.int32, device=dev)
    tig._lib()
    for S in args.samples:
        gy = torch.randn(S, TOTAL, generator=g, device=dev)
        glq = torch.randn(S, generator=g, device=dev)
        for mode in MODES:
            row = {"root": os.path.abspath(args.root), "total": TOTAL,
                   "S": S, "antithetic": mode, "card": smi}
            try:
                tig._kernel_fwd(a, b, seed, S, mode)
            except NotImplementedError as e:
                row["supported"] = str(e)
                print(json.dumps(row), flush=True)
                continue
            row["fwd_ms"], row["bwd_ms"] = [], []
            for _ in range(args.passes):
                row["fwd_ms"].append(median_ms(
                    lambda: tig._kernel_fwd(a, b, seed, S, mode)))
                row["bwd_ms"].append(median_ms(
                    lambda: tig._kernel_bwd(a, b, seed, S, mode, gy, glq)))
            row["launches_per_call"], row["kernels"] = launches_per_call(
                tig, a, b, seed, S, mode)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
