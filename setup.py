#!/usr/bin/env python
"""Package spmf_tpu (replaces reference setup.py:1-45: package
mederrata-spmf + external bayesianquilts dep — the inference engine is
vendored here, and dill is replaced by npz/json persistence)."""
from setuptools import find_packages, setup

setup(
    name="spmf-tpu",
    version="0.1.0",
    description=(
        "TPU-native sparse probabilistic matrix factorization "
        "(JAX/XLA/Pallas rebuild of mederrata/spmf)"
    ),
    license="MIT",
    packages=find_packages(include=["spmf_tpu", "spmf_tpu.*",
                                    "spmf_tpu_torch", "spmf_tpu_torch.*"]),
    # the native fast-ingest sources (compiled on demand by each package's
    # data/native.py, numpy fallback when no toolchain) must ship with the
    # packages, and so must the CUDA sources the port builds with nvcc on
    # first use
    package_data={"spmf_tpu.data": ["_native/*.cpp"],
                  "spmf_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "spmf_tpu_torch.data": ["_native/*.cpp"]},
    scripts=[
        "bin/factorize_csv.py",
        "bin/factorize_scrnaseq_counts.py",
        "bin/preprocess_scrnaseq_counts.py",
        "bin/plot_scrnaseq_figures.py",
    ],
    install_requires=["jax", "numpy", "optax"],
    python_requires=">=3.10",
)
