"""The readings a cell's limits are set from, at the cell's own size, on the
card: for each seed the program's gaps (what a run's check compares), and
on the control seeds the control's (the reference computed in float32 with
TF32 products, put in the program's place) and each planted fault's, as
the cell's kind (``kinds/<kind>.py``, ``readings``) reads them. The
benchmark's own runs do not run this.

    python3 h100bench/calibrate.py --workload NAME --seeds 11 12 13 \\
        [--control-seeds 11 12 13] [--out FILE]

One JSON line a seed and reading goes to standard output (and to ``--out``).
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = os.path.join(HERE, "_cache", "nv")
    sys.path[:0] = [HERE, ROOT]
    import torch

    from harness import registry

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    for seed in args.seeds:
        for row in cell.driver.readings(cell, seed,
                                        seed in set(args.control_seeds),
                                        torch.device("cuda", 0)):
            line = json.dumps(dict(row, workload=args.workload, seed=seed))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
