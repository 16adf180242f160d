#!/usr/bin/env python3
"""Times of the fused Normal sampler of spmf_tpu_torch (K6f / K6b,
csrc/fused_normal.cu), and the device kernels one sampler call launches,
for one checkout.

    python3 benchmarks/torch_normal_sampler.py [--root DIR] [--samples 8 1]
                                               [--passes 2]

At the Normal block of the scRNA width (u, v, w, s at D=20000, K=32:
total=1,340,000 elements, float32; the Gaussian family's mask, u, v, w
Identity and s Softplus), for each sample count prints one JSON line with
the median ms of K6f and K6b over 20 calls after 3 warm-ups (CUDA events
around each wrapper call: the host's work before the launch and the
device's; ``--passes`` times over, in turns), the device kernels' own time
a call (torch.profiler, 20 calls) and the host's time a call (50 calls,
no synchronisation between them), the number of device kernels
torch.profiler sees in one forward and in one backward through
``fused_normal_sample_logq`` (the kernels and what the wrapper launches
around them), and the registers and blocks per SM of both kernels where the
checkout reports them. --root names the checkout whose spmf_tpu_torch is
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
TOTAL = 2 * D * K + D + 2 * D


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


def device_ms(fn, calls=20):
    """The device kernels' summed time a call of ``fn`` (ms), over ``calls``
    calls under torch.profiler: the kernels' own time, without what the
    host spends before each launch. None where the profiler sees no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls or None


def host_ms(fn, calls=50):
    """Host wall time a call of ``fn`` (ms) with the device kept busy
    behind it: what the wrapper costs the caller's thread."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / calls


def device_kernels(fn):
    """The device kernels torch.profiler sees while ``fn`` runs: (count,
    sorted names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return len(names), sorted({n[:60] for n in names})


def launches_per_call(tfn, loc, rs, mask, seed, S):
    """Device kernels of one forward and of its backward through the
    autograd Function (the cotangents are made before)."""
    import torch

    leaf = loc.detach().clone().requires_grad_(True)
    gy = torch.ones(S, loc.shape[0], device=loc.device)
    glq = torch.ones(S, device=loc.device)
    out = []
    fwd = device_kernels(
        lambda: out.extend(tfn.fused_normal_sample_logq(leaf, rs, mask, seed,
                                                        S)))
    bwd = device_kernels(lambda: torch.autograd.backward(out, [gy, glq]))
    return fwd, bwd


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--samples", type=int, nargs="+", default=[8, 1])
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_normal_sampler: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.root))
    from spmf_tpu_torch.ops import fused_normal as tfn

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(8)
    loc = torch.randn(TOTAL, generator=g, device=dev) * 2.0
    rs = torch.randn(TOTAL, generator=g, device=dev) * 1.5 - 2.0
    mask = torch.cat([torch.zeros(TOTAL - 2 * D), torch.ones(2 * D)]).to(dev)
    seed = torch.tensor([13579], dtype=torch.int32, device=dev)
    tfn._lib()
    for S in args.samples:
        gy = torch.randn(S, TOTAL, generator=g, device=dev)
        glq = torch.randn(S, generator=g, device=dev)
        row = {"root": os.path.abspath(args.root), "total": TOTAL, "S": S,
               "card": smi}
        calls = {"fwd": lambda: tfn._kernel_fwd(loc, rs, mask, seed, S),
                 "bwd": lambda: tfn._kernel_bwd(loc, rs, mask, seed, S, gy,
                                                glq)}
        for kind in calls:
            row.update({f"{kind}_ms": [], f"{kind}_device_ms": [],
                        f"{kind}_host_ms": []})
        for _ in range(args.passes):
            for kind, fn in calls.items():
                row[f"{kind}_ms"].append(median_ms(fn))
                row[f"{kind}_device_ms"].append(device_ms(fn))
                row[f"{kind}_host_ms"].append(host_ms(fn))
        (row["fwd_kernels"], row["fwd_names"]), \
            (row["bwd_kernels"], row["bwd_names"]) = launches_per_call(
                tfn, loc, rs, mask, seed, S)
        if hasattr(tfn, "kernel_info"):
            row["info"] = {kind: tfn.kernel_info(kind, S)
                           for kind in ("fwd", "bwd")}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
