"""Kernels of the port and their plain PyTorch twins. The CUDA sources live
in ``spmf_tpu_torch/csrc`` and are built on first use (``_build``)."""
