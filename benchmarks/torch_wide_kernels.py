#!/usr/bin/env python3
"""Times of the K-chunked (wide) kernels of spmf_tpu_torch for one checkout:
K1 and K2 (``_kernel_stats``, clip='reference' and 'static', identity link)
and K5 (``_kernel_expsum``) past their whole-K tiles, through that
checkout's own chip_smoke.py helpers.

    python3 benchmarks/torch_wide_kernels.py [--root DIR] [--latent 128 ...]
                                             [--passes 2] [--fit]

At phase W (b)'s full width and inputs (chip_smoke.stats_inputs: S=8,
B=4096, D=20000, float32, v scaled by chip_smoke.w_scale) and each latent
dimension, prints one JSON line with each kernel's ms (chip_smoke.cuda_ms:
the median of 10 launches after 2 warm-ups, CUDA events), ``--passes``
times over in turns, and the kernels' registers and shared memory.
``--fit`` also times phase W (c)'s captured dense fit at each latent
dimension (16,384 rows resident, B=4096, 3 epochs; ms/step of the epochs
after the first). ``--root`` names the checkout whose spmf_tpu_torch and
chip_smoke.py are used (this one by default), so that two commits can be
compared in one run on one card: run parent, change, change, parent.
Correctness is phase W (a)'s. Exits 2 without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

B = 4096


def fit_ms(cs, k, dev):
    """ms/step of phase W (c)'s captured dense fit at latent dimension k."""
    import torch

    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import DeviceArrayDataset

    g = torch.Generator(device=dev).manual_seed(51)
    n_w, b_w = cs.OPT_ROWS, cs.OPT_BATCH
    xw = torch.poisson(torch.ones(n_w, cs.D, device=dev), generator=g)
    ds = DeviceArrayDataset({"counts": xw,
                             "indices": torch.arange(n_w, device=dev)},
                            batch_size=b_w, device=dev)
    m = PoissonFactorization(latent_dim=k, feature_dim=cs.D,
                             dtype="float32", device=dev, data=ds)
    return cs.run_fit(m, cs.clone_params(m.surrogate_params), ds,
                      num_steps=3)[1]


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--latent", type=int, nargs="+", default=[128])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--fit", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_kernels: no CUDA device", file=sys.stderr)
        sys.exit(2)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from spmf_tpu_torch.ops import fused_poisson as tfp

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for k in args.latent:
        a = cs.stats_inputs(B, dev, seed=6, k=k, v_scale=cs.w_scale(k))
        th, vv, ee = a[0], a[1], a[4]
        calls = {"stats": lambda: tfp._kernel_stats(*a, False, False),
                 "static": lambda: tfp._kernel_stats(*a, False, True),
                 "expsum": lambda: tfp._kernel_expsum(th, vv, ee)}
        row = {"root": root, "S": cs.S, "B": B, "D": cs.D, "K": k,
               "card": smi, "ms": {name: [] for name in calls}}
        for _ in range(args.passes):
            for name, fn in calls.items():
                row["ms"][name].append(cs.cuda_ms(fn))
        row["info"] = {kind: tfp.kernel_info(kind, k)
                       for kind in ("stats", "expsum")}
        del a, th, vv, ee, calls
        if args.fit:
            row["fit_ms_per_step"] = fit_ms(cs, k, dev)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
