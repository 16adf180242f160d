#!/usr/bin/env python3
"""Where the time of the wide K4 goes: builds of
``csrc/fused_poisson_wide.cu``'s ``row_ll_wide_kernel`` with one part
changed or removed at a time, timed against the kernel as it is.

    python3 benchmarks/torch_row_ll_variants.py [--latent 128 256 ...]
                                                [--passes 2]

Each variant is the source with a text substitution, built with the
library's own nvcc flags into ``spmf_tpu_torch/_build/variants/`` and
called through its C entry ``poisson_row_ll_wide`` at phase W (b)'s inputs
(chip_smoke.stats_inputs: S=8, B=4096, D=20000, float32, v scaled by
chip_smoke.w_scale; the Poisson likelihood at the log link):

  kernel      the source as it is
  8 warps     RL_THREADS = 256 and RL_NJ = 8: 8 warps, each over all 64
              columns of a tile (the layout of K1/K5's wide kernels)
  no cells    the cells of a tile replaced by a plain sum of its decode
              sums (every product stays live)
  no decode   the decode's products skipped (the cells score T = 0)
  no loads    no v chunk, x or lanes requested and no v split after the
              first step (the steps reuse what is on chip)
  no barrier  as `no loads`, and no wait or barrier at the top of a step

Every variant but `kernel` and `8 warps` computes wrong row sums: they time
what is left, not a result. Prints one JSON line a latent dimension: each
variant's ms (chip_smoke.cuda_ms: the median of 10 launches after 2
warm-ups, CUDA events), ``--passes`` times over in turns, and the
registers and spills ptxas reports for the Poisson log-link instance.
Exits 2 without a CUDA device.
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = "      row_ll_cells_frag<LIK, LOG>(a, T, x_s, RL_XP, lane_s, tab_s, r0, rw, cb, col0, sum0,\n                                  sum8);"
DECODE = "    tf32x3::decode_step<RL_PART, RL_NJ>("
V_LOAD = "    if (Q + 2 < total) load_v_step(Q + 2);"
SPLIT = "    if (Q + 1 < total) split_step(Q + 1);"
X_LOAD = ("      load_x_tile<NT>(x_s, a.x, r0, col0, B, D, a.vec, RL_XP);\n"
          "      load_lanes(lane_s, a, phi_smp, col0);")
BARRIER = "    cp_async_wait_all();\n    __syncthreads();  // step Q's v"
NO_LOADS = [(V_LOAD, ""), (SPLIT, ""), (X_LOAD, "")]
VARIANTS = {
    "kernel": [],
    "8 warps": [("constexpr int RL_THREADS = 512;",
                 "constexpr int RL_THREADS = 256;"),
                ("constexpr int RL_NJ = 4;", "constexpr int RL_NJ = 8;")],
    "no cells": [(CELLS, "      for (int j = 0; j < RL_NJ; ++j)\n"
                         "        for (int i = 0; i < 4; ++i) sum0 += T[j][i];")],
    "no decode": [(DECODE, "    if (K < 0) tf32x3::decode_step<RL_PART, RL_NJ>(")],
    "no loads": NO_LOADS,
    "no barrier": NO_LOADS + [(BARRIER, "    // step Q's v")],
}


def build(name, edits, out_dir):
    """(library path, registers, spill lines) of one variant."""
    from spmf_tpu_torch.ops import _build

    src_dir = os.path.join(ROOT, "spmf_tpu_torch", "csrc")
    d = os.path.join(out_dir, name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(src_dir, d)
    path = os.path.join(d, "fused_poisson_wide.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: the source no longer has "
                               f"{old.splitlines()[0]!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(d, "lib.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, path],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name!r} did not build:\n{log}")
    # the Poisson (LIK 0) log-link instance's registers and spills
    block = re.search(r"row_ll_wide_kernelILi0ELb1E.*?(?=Compiling entry|\Z)",
                      log, re.S)
    regs = re.search(r"Used (\d+) registers", block.group(0)) if block else None
    spills = [ln.strip() for ln in (block.group(0) if block else "").splitlines()
              if "spill" in ln and "0 bytes spill stores" not in ln]
    return so, int(regs.group(1)) if regs else None, spills


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_row_ll_variants: no CUDA device", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from spmf_tpu_torch.ops import _build
    from spmf_tpu_torch.ops import fused_poisson as tfp

    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(
            lambda kv: build(kv[0], kv[1], out_dir), VARIANTS.items())))
    libs = {}
    for name, (so, _, _) in built.items():
        lib = ctypes.CDLL(so)
        lib.poisson_row_ll_wide.argtypes = tfp._WIDE_SIGNATURES[
            "poisson_row_ll_wide"]
        lib.poisson_row_ll_wide.restype = ctypes.c_int
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    table = tfp.lgamma_table().to(dev)
    for k in args.latent:
        theta, v, phi, x, eta = cs.stats_inputs(4096, dev, seed=6, k=k,
                                                v_scale=cs.w_scale(k))
        S, B, K = theta.shape
        D = x.shape[-1]
        codes = torch.zeros((1, D), device=dev)
        out = torch.empty((S, B), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def call(lib):
            _build.check(lib.poisson_row_ll_wide(
                theta.data_ptr(), v.data_ptr(), phi.data_ptr(), x.data_ptr(),
                eta.data_ptr(), codes.data_ptr(), table.data_ptr(),
                out.data_ptr(), S, B, K, D, 1, 0, 1.0,
                0.9189385332046727, stream), "poisson_row_ll_wide")

        row = {"S": S, "B": B, "D": D, "K": K, "card": smi,
               "ms": {name: [] for name in libs},
               "registers": {n: b[1] for n, b in built.items()},
               "spills": {n: b[2] for n, b in built.items()}}
        for _ in range(args.passes):
            for name, lib in libs.items():
                row["ms"][name].append(cs.cuda_ms(lambda: call(lib)))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
