"""One run of one cell of the benchmark of spmf_tpu_torch on an NVIDIA H100.

    python3 h100bench/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell's configuration, traffic mix,
per-layer metrics and limits are found by name (see README.md). The last
line of standard output is the result, one JSON object; the numbers that
decide ``correct`` are the last lines of standard error. A run needs the
cards its cell asks for and fails without them: it never falls back to the
CPU.
"""
import argparse
import json
import os
import sys
import time

_T_IMPORT = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start():
    """The wall time this process started, from /proc (the module's import
    time where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def say(msg):
    print(f"h100bench: {msg}", flush=True)


def main(argv=None):
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the CUDA driver's cache at a fixed path inside the checkout
    os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, "_cache", "nv")
    sys.path[:0] = [HERE, ROOT]
    from harness import guard, registry

    import torch

    cell = registry.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"h100bench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    say(f"{args.workload}: {cell.config_name} under {cell.traffic_name}, "
        f"seed {args.seed}, {args.seconds} s, trace {args.trace}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
              lambda: time.time() - t_start, say)
    guard.check_imports()

    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["peak"])}
    if args.trace:
        device_info["busy_s"] = out["busy_s"]
        device_info["window_s"] = out["window_s"]
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": out["metrics"],
              "device": device_info}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"h100bench check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
