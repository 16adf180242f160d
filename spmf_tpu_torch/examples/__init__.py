"""The examples of spmf_tpu, through the port. Each module is the port of
one JAX script under ``examples/`` and runs as

    python -m spmf_tpu_torch.examples.<name> [--device cpu] [--outdir DIR]
        [--rows N] [--steps E]

on the card by default (``--device cpu`` on a host without one), building
its data from the same numpy seeds as its JAX script:

- ``factorizing_random_noise``: Poisson(1) noise; the encoding shrinks to 0;
- ``factorize_linear_structure``: 10 planted signal columns among 30;
- ``factorize_nonlinear_structure``: the same with a nonlinear signal;
- ``simulation_figure``: the three side by side;
- ``rnaseq_walkthrough``: a pbmc3k-shaped matrix (``--datapath``, or a
  synthetic stand-in), log link, row size factors, ``encode``;
- ``corpus_walkthrough``: a bag-of-words corpus of the installed Python
  packages through the scRNA command lines (``examples/
  run_corpus_walkthrough.sh``).

Each ``main(argv)`` returns the run's record (loss traces, ms a step,
kernel launches, peak device memory) and prints it as its last line.
"""
