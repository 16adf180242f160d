#!/usr/bin/env python3
"""Times of the exp-rate-sum kernel of spmf_tpu_torch (K5, the COO energies'
rate total under the log link, with its unit-cotangent gradients) for one
checkout.

    python3 benchmarks/torch_expsum.py [--root DIR] [--rows 4096 32768]
                                       [--passes 2]

At the scRNA width (S=8, D=20000, K=32, float32; theta in [0, 0.5), v in
[0, 0.05), eta in [0.5, 2), chip_smoke.py's batches) and each batch size,
prints one JSON line with the median ms of ``_kernel_expsum`` over 20
launches after 3 warm-ups (CUDA events; ``--passes`` times over, in turns),
its bound (three TF32 passes of the 6 S B D K flops of its products at
494.7 TFLOP/s, or one FP32 pass at 67 TFLOP/s, each the larger with the
exps at 16 a clock and SM and the bytes at 3.35 TB/s), and, at the first
batch size, R's and the gradients' errors against the float64 twin. --root
names the checkout whose spmf_tpu_torch is timed (this one by default), so
that two commits can be compared in one run on one card: run parent,
change, change, parent. Exits 2 without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

S, D, K = 8, 20000, 32
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 494.7e12
PEAK_MUFU_PER_S = 16 * PEAK_F32_OPS_PER_S / 2 / 128


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


def bound_ms(B):
    """{route: least ms}: the products on TF32 tensor cores in three passes,
    or on the FP32 pipes in one; each against the exps and the bytes."""
    flops = 6 * S * B * D * K
    rest = max(S * B * D / PEAK_MUFU_PER_S,
               4 * (2 * S * B * K + 2 * S * K * D + D + S) / PEAK_BYTES_PER_S)
    return {"tf32x3": max(3 * flops / PEAK_TF32_OPS_PER_S, rest) * 1e3,
            "fp32": max(flops / PEAK_F32_OPS_PER_S, rest) * 1e3}


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--rows", type=int, nargs="+", default=[4096, 32768])
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_expsum: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.root))
    from spmf_tpu_torch.ops import fused_poisson as tfp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for i, B in enumerate(args.rows):
        g = torch.Generator(device=dev).manual_seed(6)
        theta = torch.rand(S, B, K, generator=g, device=dev) * 0.5
        v = torch.rand(S, K, D, generator=g, device=dev) * 0.05
        eta = torch.rand(1, D, generator=g, device=dev) * 1.5 + 0.5
        row = {"root": os.path.abspath(args.root), "S": S, "B": B, "D": D,
               "K": K, "card": smi, "bound_ms": bound_ms(B), "ms": []}
        for _ in range(args.passes):
            row["ms"].append(median_ms(
                lambda: tfp._kernel_expsum(theta, v, eta)))
        if i == 0:
            out_k = tfp._kernel_expsum(theta, v, eta)
            out_t = tfp.expsum_twin(theta.double(), v.double(), eta.double())
            row["r_rel_err"] = float(((out_k[0].double() - out_t[0]).abs()
                                      / out_t[0].abs()).max())
            row["grad_rel_err"] = max(
                float((k.double() - t).abs().max() / t.abs().max())
                for k, t in zip(out_k[1:], out_t[1:]))
            del out_k, out_t
        print(json.dumps(row), flush=True)
        del theta, v, eta


if __name__ == "__main__":
    main()
