"""Real multi-process training through the port: the four cases of
tests/test_multiprocess.py (the engine on a dp mesh, the flagship model on
dp x fp, the multi-slice dcn layout, and the checkpoint / resume drill) on
one world of four gloo ranks on the CPU (tests/_torch_multiprocess_worker.py,
suite 'multiprocess').

Every rank's loss trace equals every other's bit for bit (the loss is the
all-reduced global one), and equals the port's single-process fit on the
same data and seed at 1e-10 (float64: the sums only run in another order).
A JAX fit draws from threefry keys, so its traces are not the port's; the
port's sharded energies and gradients are held to the JAX package's on the
same draws in tests/test_torch_parallel.py.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import glob
import os

import numpy as np
import pytest

import _torch_multiprocess_worker as W
from test_torch_parallel import WORLD, join_world, start_world


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the four ranks' results, the single-process port's, the outdir)."""
    outdir = tmp_path_factory.mktemp("torch_multiprocess")
    procs = start_world(outdir, "multiprocess")
    try:
        single = {case: getattr(W, "case_" + case)(None, str(outdir))
                  for case in W.SUITES["multiprocess"]}
    finally:
        ranks = join_world(procs, outdir)
    return ranks, single, outdir


def _traces(run, case, layout, key="losses"):
    out = []
    for r in range(WORLD):
        out.append(run[0][r][(case, layout)][key])
    for r in range(1, WORLD):
        np.testing.assert_array_equal(out[r], out[0])
    return out[0]


def test_four_process_fit_matches_single_process(run):
    """:28: the engine over a dp mesh of four processes, each feeding its
    rows, equals one process's fit."""
    np.testing.assert_allclose(_traces(run, "gauss", "dp"),
                               run[1]["gauss"]["losses"], rtol=1e-10)


def test_four_process_dpxfp_model_fit_matches_single_process(run):
    """:56: PoissonFactorization over a (2, 2) dp x fp mesh: the fp slices
    of u/v/w/s live on different processes; the trace and the whole
    parameters after the fit equal one process's."""
    np.testing.assert_allclose(_traces(run, "pf", "dpfp"),
                               run[1]["pf"]["losses"], rtol=1e-10)
    np.testing.assert_allclose(_traces(run, "pf", "dpfp", "u"),
                               run[1]["pf"]["u"], rtol=1e-9)


def test_four_process_dcn_multislice_layout(run):
    """:86: make_multislice_mesh groups the ranks by node (two of two
    ranks), rows split over (dcn, dp): equal to one process."""
    np.testing.assert_allclose(_traces(run, "pf", "dcn"),
                               run[1]["pf"]["losses"], rtol=1e-10)


def test_four_process_checkpoint_resume_drill(run):
    """:115: the fp slices are gathered into whole checkpoints that rank 0
    alone writes, into one run directory every rank names; a fresh model
    resumes onto the same layout and its trace equals one process's
    save -> resume drill."""
    np.testing.assert_allclose(_traces(run, "ckpt", "dpfp"),
                               run[1]["ckpt"]["losses"], rtol=1e-10)
    np.testing.assert_allclose(_traces(run, "ckpt", "dpfp", "first"),
                               run[1]["ckpt"]["first"], rtol=1e-10)
    writes = [run[0][r][("ckpt", "dpfp")]["writes"] for r in range(WORLD)]
    assert writes[0] and not any(writes[1:]), writes
    paths = {run[0][r][("ckpt", "dpfp")]["path"] for r in range(WORLD)}
    assert len(paths) == 1
    files = glob.glob(os.path.join(run[2], "mp", "**", "*.npz"),
                      recursive=True)
    assert {os.path.dirname(f) for f in files} == paths
    assert sorted(os.path.basename(f) for f in files) == sorted(writes[0])
    np.testing.assert_allclose(_traces(run, "ckpt", "dpfp", "u"),
                               run[1]["ckpt"]["u"], rtol=1e-9)
