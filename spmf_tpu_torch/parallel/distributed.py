"""Multi-process initialization (the port's counterpart of
spmf_tpu/parallel/distributed.py).

``initialize_distributed`` starts ``torch.distributed``: under ``torchrun``
from its environment (``env://``), or from an explicit
``coordinator_address`` (``tcp://``). The backend is NCCL for ranks on
cards and gloo on the CPU; ``backend='gloo'`` on cards is allowed, and is
how several ranks share one card (NCCL refuses two ranks on one device). A
backend that fails to start raises: nothing switches backend quietly. Then
build the mesh over the world (``global_mesh``) and feed each rank its rows
(``process_local_rows``).
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "global_mesh", "process_local_rows",
           "free_port"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           timeout: Optional[float] = None,
                           device=None) -> bool:
    """Join the process group; returns True when more than one process
    takes part. ``coordinator_address`` ('host:port') with
    ``num_processes`` and ``process_id``, or the variables ``torchrun``
    sets (MASTER_ADDR, WORLD_SIZE, RANK); with neither, a single process
    starts nothing and gets False. ``backend``: 'nccl' or 'gloo'; by
    default NCCL for ranks on cards and gloo for ranks on the CPU, as
    ``device`` says (None: the card where one is present). Under NCCL
    each rank takes the card ``LOCAL_RANK`` names. ``timeout``: seconds a
    collective waits for the other ranks before it raises (torch's
    default when None)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if backend is None:
        on_card = (torch.cuda.is_available() if device is None
                   else torch.device(device).type == "cuda")
        backend = "nccl" if on_card else "gloo"
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        kwargs = dict(init_method="env://")
    else:
        return False
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend=backend, **kwargs)
    return dist.get_world_size() > 1


def global_mesh(axis_names=("dp",), shape=None):
    """A mesh over every rank of the world (after
    ``initialize_distributed``)."""
    from spmf_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape=shape, axis_names=axis_names)


def process_local_rows(n_global_rows: int):
    """(start, stop) of the rows this process feeds of a global batch
    sharded over every process."""
    from spmf_tpu_torch.parallel.mesh import row_block

    world, rank = ((dist.get_world_size(), dist.get_rank())
                   if dist.is_initialized() else (1, 0))
    return row_block(n_global_rows, world, rank)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now (the address of a world
    started on this host)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
