#!/usr/bin/env python3
"""Times of the wide kernels of spmf_tpu_torch for one checkout: K1 and K2
(``_kernel_stats``, clip='reference' and 'static', identity link), K4
(``_kernel_row_ll``, log link) and K5 (``_kernel_expsum``), through that
checkout's own chip_smoke.py helpers.

    python3 benchmarks/torch_wide_kernels.py [--root DIR] [--latent 128 ...]
        [--kernels stats static row_ll expsum] [--passes 2] [--fit]
        [--score]

At phase W (b)'s full width and inputs (chip_smoke.stats_inputs: S=8,
B=4096, D=20000, float32, v scaled by chip_smoke.w_scale) and each latent
dimension, prints one JSON line with each kernel's ms (chip_smoke.cuda_ms:
the median of 10 launches after 2 warm-ups, CUDA events), ``--passes``
times over in turns, and the kernels' registers and shared memory; at a
latent dimension a kernel's whole-K kernel takes (K4: K <= 64 since its
switch, 152 before) that is the kernel timed. ``--fit`` also times phase W
(c)'s captured dense fit at each latent dimension (16,384 rows resident,
B=4096, 3 epochs; ms/step of the epochs after the first). ``--score``
times phase W (c)'s ``log_likelihood`` at each latent dimension: the 4,096
held-out rows of phase 8 (3% Poisson(1), D=20000), 100 samples in chunks
of 8, on a log-link model over phase C's 0.1% set (its column norms),
initial parameters; seconds by the host clock around a synchronised call,
the median of 3 after one warm-up. ``--root`` names the checkout whose
spmf_tpu_torch and chip_smoke.py are used (this one by default), so that
two commits can be compared in one run on one card: run parent, change,
change, parent. Correctness is phase W (a)'s. Exits 2 without a CUDA
device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

B = 4096
KERNELS = ("stats", "static", "row_ll", "expsum")


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


def score_s(cs, k, dev, coo, held):
    """Seconds of phase W (c)'s log_likelihood at latent dimension k: the
    median of 3 synchronised calls after one warm-up."""
    import numpy as np
    import torch

    from spmf_tpu_torch import PoissonFactorization

    flat_c, norms_c = coo
    m = PoissonFactorization(
        latent_dim=k, feature_dim=cs.D, log_transform=True,
        column_norms=norms_c, u_tau_scale=1.0 / np.sqrt(cs.N_SPARSE * cs.D),
        dtype="float32", device=dev, data=flat_c)
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.log_likelihood(held, num_samples=100, sample_chunk=8)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:])


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--latent", type=int, nargs="+", default=[128])
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--score", action="store_true")
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
    if args.score:
        sp_c, norms_c = cs.sparse_counts(cs.N_SPARSE, cs.D, cs.DENSITY_COO,
                                         41, dev)
        sp_c.shuffle(seed=0).batch(cs.B_SPARSE, drop_remainder=True).as_coo()
        coo = (sp_c.to_device(device="cuda"), norms_c)
        held, _ = cs.sparse_counts(cs.B_SPARSE, cs.D, cs.DENSITY, 13, dev)
        held.batch(cs.B_SPARSE).as_coo()
    for k in args.latent:
        a = cs.stats_inputs(B, dev, seed=6, k=k, v_scale=cs.w_scale(k))
        th, vv, ee = a[0], a[1], a[4]
        calls = {"stats": lambda: tfp._kernel_stats(*a, False, False),
                 "static": lambda: tfp._kernel_stats(*a, False, True),
                 "row_ll": lambda: tfp._kernel_row_ll(*a, True),
                 "expsum": lambda: tfp._kernel_expsum(th, vv, ee)}
        calls = {name: calls[name] for name in args.kernels}
        row = {"root": root, "S": cs.S, "B": B, "D": cs.D, "K": k,
               "card": smi, "ms": {name: [] for name in calls}}
        for _ in range(args.passes):
            for name, fn in calls.items():
                row["ms"][name].append(cs.cuda_ms(fn))
        kinds = {"stats" if name == "static" else name for name in calls}
        row["info"] = {kind: tfp.kernel_info(kind, k) for kind in kinds}
        row["chunks"] = {kind: tfp.launch_geometry(kind, cs.S, B, k,
                                                   cs.D).chunks
                         for kind in row["info"]}
        del a, th, vv, ee, calls
        if args.fit:
            row["fit_ms_per_step"] = fit_ms(cs, k, dev)
        if args.score:
            row["score_s"] = score_s(cs, k, dev, coo, held)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
