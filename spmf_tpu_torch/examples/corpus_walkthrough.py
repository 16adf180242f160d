"""Real-data walkthrough on a bag-of-words corpus through the port's scRNA
command lines.

The port of examples/run_corpus_walkthrough.sh. Documents play cells and
vocabulary terms play genes: ``tools/make_corpus_10x.py`` (a subprocess)
counts the words of the installed Python packages' sources (``--src``,
default this interpreter's ``purelib``; nothing is downloaded) into a 10x
MatrixMarket directory; then, as ``python -m`` would run them,
``spmf_tpu_torch.cli.preprocess_scrnaseq_counts`` (numpy backend, 2,000
top terms) and ``spmf_tpu_torch.cli.factorize_scrnaseq_counts`` (P=10,
batches of 512, lr 0.05; on the card over a device-resident matrix, the
captured scan path); then ``bin/plot_scrnaseq_figures.py`` (a subprocess,
numpy and matplotlib only; skipped where matplotlib is not installed) and
the top enriched terms per factor. The
corpus and every artifact go to ``--outdir``/corpus_walkthrough.

    python -m spmf_tpu_torch.examples.corpus_walkthrough [--device cpu]
        [--max-docs 6000] [--vocab 5000] [--steps 80] [--batch-size 512]
"""
import importlib.util
import os
import subprocess
import sys
import sysconfig

import numpy as np

from spmf_tpu_torch.cli import factorize_scrnaseq_counts
from spmf_tpu_torch.cli import preprocess_scrnaseq_counts
from spmf_tpu_torch.examples import _common

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
P, N_TOP, LR = 10, 2000, 0.05


def _script(*parts):
    path = os.path.join(REPO, *parts)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: the walkthrough runs from a "
                                "checkout of the repository")
    return path


def main(argv=None):
    ap = _common.parser(__doc__, rows=None, steps=80)
    ap.add_argument("--max-docs", type=int, default=6000)
    ap.add_argument("--vocab", type=int, default=5000)
    ap.add_argument("-b", "--batch-size", type=int, default=512)
    ap.add_argument("--src", default=sysconfig.get_paths()["purelib"],
                    help="the source tree whose .py files are the corpus")
    args = ap.parse_args(argv)
    run = _common.Run(args.device)
    work = os.path.join(args.outdir, "corpus_walkthrough")
    device = str(run.device)

    subprocess.run([sys.executable, _script("tools", "make_corpus_10x.py"),
                    "--src", args.src, "--out", work,
                    "--vocab", str(args.vocab),
                    "--max-docs", str(args.max_docs)], check=True)
    print("-- preprocess (numpy backend: native mtx ingest, QC, HVG, PCA) --")
    preprocess_scrnaseq_counts.main([
        "--datapath", work, "--dataset", "corpus",
        "--n-top-genes", str(N_TOP), "--backend", "numpy",
        "--device", device])
    print("-- factorize --")
    factor = factorize_scrnaseq_counts.main([
        "--datapath", work, "--dataset", "corpus", "-d", str(P),
        "-b", str(args.batch_size), "-e", str(args.steps), "-lr", str(LR),
        "--no-figures", "--device", device])
    cells = np.load(os.path.join(work, "corpus_counts.npy"),
                    mmap_mode="r").shape[0]
    losses = run.record(factor, cells // args.batch_size)
    print("-- figures --")
    if importlib.util.find_spec("matplotlib") is None:
        print("matplotlib unavailable; skipping the figures")
    else:
        subprocess.run([sys.executable,
                        _script("bin", "plot_scrnaseq_figures.py"),
                        "--datapath", work, "--dataset", "corpus",
                        "-d", str(P)], check=True)

    print("-- top ENRICHED terms per factor (gene score relative to the "
          "cross-factor mean) --")
    gs = np.load(os.path.join(work, f"corpus_genescore_{P}.npy"))
    names = np.load(os.path.join(work, "corpus_genenames.npy"),
                    allow_pickle=True)
    rel = gs / (gs.mean(0, keepdims=True) + 1e-12)
    top_terms = []
    for j in range(gs.shape[0]):
        top = [str(names[t]) for t in np.argsort(-rel[j])[:8]]
        top_terms.append(top)
        print(f"factor {j:2d}: " + " ".join(top))
    artifacts = sorted(os.path.join(work, f) for f in os.listdir(work)
                       if f.startswith("corpus_"))
    return run.summary(artifacts=artifacts, losses=losses, cells=cells,
                       top_terms=top_terms)


if __name__ == "__main__":
    main()
