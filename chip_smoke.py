#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (spmf_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1 device   the card, its power limit, TF32 off
  2 build    nvcc builds csrc/*.cu for sm_90a
  3 K1/K2    fused Poisson kernel vs its twin (float64 on the card) at the
             main-path shape S=8, B=1024, D=20000, K=32, plus a rescue batch
  4 K3f/K3b  fused IG sampler vs its twin at total=1,400,064, S=8, both modes
  5 slice    PoissonFactorization(latent_dim=32, feature_dim=20000).fit(...)
             through the kernels, with launch counters; one step at a small
             size checked against the plain float64 path on the same draws
  6 times    ms/step and rows/s at B=4096 and B=32768; kernel vs twin times
Then a JSON line with the kernels, and as the last line
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and prints
no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

S, D, K = 8, 20000, 32
IG_TOTAL = 2 * D * K + 2 * 2 * D + 2 * D + 2 * K  # u_eta(_a), s_eta(_a), ...


def say(phase, msg):
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


def stats_inputs(B, dev, seed=0, rescue=False):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    theta = torch.rand(S, B, K, generator=g, device=dev) * 0.5
    v = torch.rand(S, K, D, generator=g, device=dev) * 0.05
    phi = torch.rand(S, 1, D, generator=g, device=dev) * 0.5 + 0.05
    x = torch.poisson(torch.ones(B, D, device=dev), generator=g)
    eta = torch.rand(1, D, generator=g, device=dev) * 1.5 + 0.5
    if rescue:
        phi[:, :, ::37] = -5.0   # negative rates: NaN cells the clip replaces
    return theta, v, phi, x, eta


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spmf_tpu_torch import PoissonFactorization
    from spmf_tpu_torch.data import ArrayDataset
    from spmf_tpu_torch.ops import _build
    from spmf_tpu_torch.ops import fused_ig as tig
    from spmf_tpu_torch.ops import fused_poisson as tfp
    from spmf_tpu_torch.utils import params_from_numpy, params_to_numpy
    from spmf_tpu_torch.vi.minibatch import (clip_and_step, elbo_loss,
                                             make_optimizer)

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

    t0 = time.perf_counter()
    tfp._lib()
    tig._lib()
    ptxas = []
    for lib in ("fused_poisson", "fused_ig"):
        with open(os.path.join(_build.BUILD_DIR, f"{lib}.log")) as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln
                      or "spill" in ln]
    say(2, f"built {sorted(_build.BUILD_SECONDS)} in "
           f"{time.perf_counter() - t0:.1f} s (nvcc {_build.NVCC_FLAGS}); "
           + " | ".join(ptxas))

    errs = {}
    # ---- 3: K1 / K2 at the main-path shape
    B = 1024
    for rescue in (False, True):
        args = stats_inputs(B, dev, seed=1, rescue=rescue)
        for static in (False, True):
            out_k = tfp._kernel_stats(*args, False, static)
            out_t = tfp.stats_twin(*[a.double() for a in args],
                                   static=static)
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
            if not rescue:
                errs[key] = max(float((k.double() - t.double()).abs().max())
                                for k, t in zip(out_k[3:], out_t[3:]))
            say(3, f"{'K2' if static else 'K1'} rescue={rescue}: sums rel "
                   f"{e_sum:.2e}, counts {out_k[1].tolist()}, gmin rel "
                   f"{e_min:.2e}, grads rel-of-max {e_grad:.2e}")

    # ---- 4: K3f / K3b at the IG block of D=20000, K=32
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.rand(IG_TOTAL, generator=g, device=dev) * 5 + 0.3
    b = torch.rand(IG_TOTAL, generator=g, device=dev) * 3 + 0.1
    seed = torch.tensor([987654], dtype=torch.int32, device=dev)
    gy = torch.randn(S, IG_TOTAL, generator=g, device=dev)
    glq = torch.randn(S, generator=g, device=dev)
    errs["fwd"] = errs["bwd"] = 0.0
    for anti in (False, True):
        y_k, lq_k = tig._kernel_fwd(a, b, seed, S, anti)
        y_t, lq_t = tig.ig_twin_fwd(a.double(), b.double(), seed, S, anti)
        ga_k, gb_k = tig._kernel_bwd(a, b, seed, S, anti, gy, glq)
        ga_t, gb_t = tig.ig_twin_bwd(a.double(), b.double(), seed, S, anti,
                                     gy.double(), glq.double())
        torch.cuda.synchronize()
        e_y, e_lq = rel_elem(y_k, y_t), rel_elem(lq_k, lq_t)
        e_g = max(rel_max(ga_k, ga_t), rel_max(gb_k, gb_t))
        check(e_y < 1e-5, f"K3f y rel err {e_y}")
        check(e_lq < 1e-5, f"K3f lq rel err {e_lq}")
        check(e_g < 1e-4, f"K3b grads rel err {e_g}")
        errs["fwd"] = max(errs["fwd"], float((y_k.double() - y_t).abs().max()))
        errs["bwd"] = max(errs["bwd"], float(max(
            (ga_k.double() - ga_t).abs().max(),
            (gb_k.double() - gb_t).abs().max())))
        say(4, f"K3 total={IG_TOTAL} antithetic={anti}: y rel {e_y:.2e}, "
               f"lq rel {e_lq:.2e}, ga/gb rel-of-max {e_g:.2e}")

    # ---- 5: the slice through the normal entry point
    N = 16384
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
    for d in (tfp.LAUNCHES, tig.LAUNCHES):
        for k in d:
            d[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = {k: m.fit(num_steps=epochs[k], learning_rate=0.01,
                       sample_size=S, verbose=False)
              for k, m in models.items()}
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(stats=tfp.LAUNCHES["stats"],
                    static=tfp.LAUNCHES["static"],
                    fwd=tig.LAUNCHES["fwd"], bwd=tig.LAUNCHES["bwd"])
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
    say(5, f"fit: {sum(steps.values())} steps in {fit_s:.1f} s; losses "
           f"{ {k: [round(x, 4) for x in v] for k, v in losses.items()} }; "
           f"launches {launches}")

    # one step at a small size, same draws: kernels (f32, card) vs the plain
    # float64 path (unfused, WH 'fast' sampler fed the same draws)
    n_s, d_s, k_s, b_s = 512, 3000, 16, 256
    Xs = np.random.default_rng(4).poisson(1.0, (n_s, d_s)).astype(np.float32)
    small = {}
    for tag, kw in (("kernel", dict(dtype="float32", device="cuda",
                                    fused_likelihood=True)),
                    ("plain", dict(dtype="float64", device="cpu",
                                   fused_likelihood=False))):
        small[tag] = PoissonFactorization(
            latent_dim=k_s, feature_dim=d_s, gamma_sampler="fast",
            u_tau_scale=1.0 / np.sqrt(n_s * d_s),
            data=ArrayDataset({"counts": Xs}).batch(b_s), **kw)
    rng = np.random.default_rng(5)
    p0 = {n: {k: v + 0.1 * rng.standard_normal(v.shape)
              for k, v in sub.items()}
          for n, sub in params_to_numpy(
              small["plain"].surrogate_params).items()}
    sur = small["plain"]._surrogate
    tot_n = sum(sur._sizes[n] for n in sur._normal_names)
    tot_g = sum(sur._sizes[n] for n in sur._ig_names)
    draws = {"normal_eps": rng.standard_normal((S, tot_n)),
             "ig_eps": rng.standard_normal((S, tot_g)),
             "ig_u": rng.uniform(1e-6, 1.0, (8, S, tot_g))}
    res = {}
    for tag, m in small.items():
        params = params_from_numpy(p0, m.device, m.dtype)
        for sub in params.values():
            for t in sub.values():
                t.requires_grad_(True)
        batch = {"counts": torch.as_tensor(Xs[:b_s], device=m.device)
                 .to(m.dtype)}
        before = tfp.LAUNCHES["stats"]
        loss = elbo_loss(m._surrogate, m._energy, params, batch, None, S,
                         draws=draws)
        loss.backward()
        grads = torch.cat([t.grad.reshape(-1).double().cpu()
                           for sub in params.values() for t in sub.values()])
        res[tag] = (float(loss.detach()), grads)
        if tag == "kernel":
            check(tfp.LAUNCHES["stats"] == before + 1, "small step skipped K1")
    e_loss = abs(res["kernel"][0] - res["plain"][0]) / abs(res["plain"][0])
    e_grad = rel_max(res["kernel"][1], res["plain"][1])
    check(e_loss < 1e-4, f"small-step loss rel err {e_loss}")
    check(e_grad < 1e-3, f"small-step grads rel err {e_grad}")
    say(5, f"small step vs float64 plain path: loss {res['kernel'][0]:.6f} vs "
           f"{res['plain'][0]:.6f} (rel {e_loss:.2e}), grads rel-of-max "
           f"{e_grad:.2e}")

    # ---- 6: times (medians of 10 after warmup)
    model = models["reference"]
    for Bt in (4096, 32768):
        xb = torch.poisson(torch.ones(Bt, D, device=dev),
                           generator=gx)
        batch = {"counts": xb, "indices": torch.arange(Bt, device=dev)}
        params = {n: {k: t.clone().requires_grad_(True)
                      for k, t in sub.items()}
                  for n, sub in model.surrogate_params.items()}
        opt = make_optimizer(params, 0.01)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            opt.zero_grad(set_to_none=True)
            loss = elbo_loss(model._surrogate, model._energy, params, batch,
                             gen, S)
            loss.backward()
            clip_and_step(opt, 5.0)

        times = []
        for i in range(13):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times))
        say(6, f"step B={Bt}: {ms:.2f} ms/step, {Bt / ms * 1e3:.0f} rows/s "
               f"(median of 10; {name}; {smi})")
        del xb, batch, params, opt

    B = 4096
    args = stats_inputs(B, dev, seed=6)
    kt = {}
    for static, key in ((False, "stats"), (True, "static")):
        kt[key] = (cuda_ms(lambda: tfp._kernel_stats(*args, False, static)),
                   cuda_ms(lambda: tfp.stats_twin(*args, static=static)))
    kt["fwd"] = (cuda_ms(lambda: tig._kernel_fwd(a, b, seed, S, False)),
                 cuda_ms(lambda: tig.ig_twin_fwd(a, b, seed, S, False)))
    kt["bwd"] = (cuda_ms(lambda: tig._kernel_bwd(a, b, seed, S, False, gy,
                                                 glq)),
                 cuda_ms(lambda: tig.ig_twin_bwd(a, b, seed, S, False, gy,
                                                 glq)))
    for key, (k_ms, t_ms) in kt.items():
        say(6, f"{key}: kernel {k_ms:.3f} ms, twin {t_ms:.3f} ms (float32, "
               f"{'B=4096' if key in ('stats', 'static') else 'total=' + str(IG_TOTAL)}"
               f", S={S})")

    meta = {
        "stats": ("fused_poisson_stats (K1, clip='reference')",
                  "spmf_tpu_torch/csrc/fused_poisson.cu",
                  "spmf_tpu/ops/fused_poisson.py:323"),
        "static": ("fused_poisson_stats (K2, clip='static')",
                   "spmf_tpu_torch/csrc/fused_poisson.cu",
                   "spmf_tpu/ops/fused_poisson.py:387"),
        "fwd": ("fused_ig_fwd (K3f)", "spmf_tpu_torch/csrc/fused_ig.cu",
                "spmf_tpu/ops/fused_ig.py:193"),
        "bwd": ("fused_ig_bwd (K3b)", "spmf_tpu_torch/csrc/fused_ig.cu",
                "spmf_tpu/ops/fused_ig.py:230"),
    }
    kernels = [{"name": meta[k][0], "route": "cuda", "source": meta[k][1],
                "replaces": meta[k][2], "launches": launches[k],
                "max_abs_err": errs[k], "ms": kt[k][0], "plain_ms": kt[k][1]}
               for k in ("stats", "static", "fwd", "bwd")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
