"""Worker-seconds per test file from a pytest junit XML.

    python tests/_junit_seconds.py /tmp/_t1.xml [--match test_torch_]

With pytest-xdist each case's time is a worker's time, so the per-file sums
are worker-seconds (six workers share the wall). Prints the files whose
name holds ``--match`` (default: every file), costliest first, then their
total and the total of every file.
"""
import argparse
import collections
import xml.etree.ElementTree as ET


def file_seconds(path):
    """{test file: summed seconds of its cases} of a junit XML."""
    out = collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        # classname: tests.test_torch_options[.Class]
        parts = case.get("classname", "").split(".")
        name = next((p for p in parts if p.startswith("test_")), parts[-1])
        out[name + ".py"] += float(case.get("time", 0.0))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("junit")
    ap.add_argument("--match", default="")
    args = ap.parse_args(argv)
    secs = file_seconds(args.junit)
    chosen = {f: s for f, s in secs.items() if args.match in f}
    for f, s in sorted(chosen.items(), key=lambda kv: -kv[1]):
        print(f"{s:9.1f}  {f}")
    print(f"{sum(chosen.values()):9.1f}  total of {len(chosen)} files "
          f"matching {args.match!r}")
    print(f"{sum(secs.values()):9.1f}  total of all {len(secs)} files")


if __name__ == "__main__":
    main()
