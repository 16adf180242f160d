#!/usr/bin/env python3
"""How far float32 can follow the float64 twin of the fused Poisson kernel of
spmf_tpu_torch (K1/K2, csrc/fused_poisson.cu) under the log link when a rate
cancels to nearly zero.

    python3 benchmarks/torch_poisson_log_link_conditioning.py [--root DIR]

Under the log link rate = exp(theta.v eta) - 1 + phi. With an intercept of
-5 (every 37th column of a rescue batch) and loadings four times those of
chip_smoke.py's batches, exp(.) reaches 6 in some cells and the rate passes
through zero there: float32 spaces its values 4.8e-7 apart at 6, so a rate
of that size has no correct digit and x / rate, the cell's gradient, is
wrong by as much as it is large. No float32 implementation can agree with
float64 on such a batch; this script shows that it is the batch and not the
kernel. At S=8, D=20000 and (B, K) of (1024, 32) and (1000, 20), for
loadings v < 0.2 and v < 0.05, with and without the rescue columns, it
prints the number of cells whose float64 rate lies in (0, 1e-3 .. 1e-6), and
the errors against the float64 twin of (i) the kernel and (ii) the same
plain twin run in float32: sums and minimum relative, gradients relative to
their largest entry. --root names the checkout whose spmf_tpu_torch is
read (this one by default), so another commit's kernel can be held to the
same batches. Exits 2 without a CUDA device.
"""
import argparse
import os
import subprocess
import sys

S, D = 8, 20000


def rel_max(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def rel_elem(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-300)).max())


def inputs(B, K, v_scale, rescue, dev, seed=1):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    theta = torch.rand(S, B, K, generator=g) * 0.5
    v = torch.rand(S, K, D, generator=g) * v_scale
    phi = torch.rand(S, 1, D, generator=g) * 0.5 + 0.05
    x = torch.poisson(torch.ones(B, D), generator=g)
    eta = torch.rand(1, D, generator=g) * 1.5 + 0.5
    if rescue:
        phi[:, :, ::37] = -5.0
    return [t.to(dev) for t in (theta, v, phi, x, eta)]


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout holding spmf_tpu_torch")
    root = ap.parse_args().root
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, root)
    from spmf_tpu_torch.ops import fused_poisson as tfp

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"spmf_tpu_torch of {root} ({smi})")
    for B, K in ((1024, 32), (1000, 20)):
        for v_scale in (0.2, 0.05):
            for rescue in (False, True):
                args = inputs(B, K, v_scale, rescue, dev)
                args64 = [a.double() for a in args]
                theta, v, phi, _, eta = args64
                rate = torch.expm1(torch.einsum("sbk,skd->sbd", theta, v)
                                   * eta) + phi
                near = [int(((rate > 0) & (rate < t)).sum())
                        for t in (1e-3, 1e-4, 1e-5, 1e-6)]
                least = float(rate[rate > 0].min())
                del rate
                twin = tfp.stats_twin(*args64, True, False)
                report = []
                for tag, out in (
                        ("kernel", tfp._kernel_stats(*args, True, False)),
                        ("float32 twin", tfp.stats_twin(*args, True, False))):
                    grads = ", ".join(f"{rel_max(o, t):.1e}"
                                      for o, t in zip(out[3:], twin[3:]))
                    report.append(
                        f"{tag}: sums {rel_elem(out[0], twin[0]):.1e}, "
                        f"minimum {rel_elem(out[2], twin[2]):.1e}, dtheta / "
                        f"dv / dphi {grads}, counts equal "
                        f"{torch.equal(out[1].cpu(), twin[1].cpu())}")
                print(f"B={B} K={K} v<{v_scale} rescue={rescue}: cells with "
                      f"0 < rate < 1e-3, 1e-4, 1e-5, 1e-6: {near}, least "
                      f"positive rate {least:.2e}, largest |dv| "
                      f"{float(twin[4].abs().max()):.3e} | "
                      + " | ".join(report), flush=True)


if __name__ == "__main__":
    main()
