"""One torch thread per test process.

pytest-xdist runs the suite in several workers, and torch starts each with
one intra-op thread per core, so the workers oversubscribe the host: on an
8-core host one remat case of tests/test_torch_options.py took 9.7 s
alone, 75-79 s as one of six copies at once, and 10.4-10.8 s as one of
six with one thread each. Every ``tests/test_torch_*.py`` imports
this module first. ``ENV`` is the environment for the processes those
tests start (CLIs, examples, gloo ranks). Imports no JAX.
"""
import os

import torch

torch.set_num_threads(1)

ENV = dict(os.environ, OMP_NUM_THREADS="1")
