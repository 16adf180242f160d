"""Multi-process training over ``torch.distributed``: rank meshes, the
collectives of hand-written SPMD, process-group start-up and a dry run of
the meshed step."""
from .distributed import (
    free_port,
    global_mesh,
    initialize_distributed,
    process_local_rows,
)
from .mesh import (
    Mesh,
    data_parallel_mesh,
    make_mesh,
    make_multislice_mesh,
    replicate,
    shard_batch,
    shard_params_feature_dim,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_multislice_mesh",
    "data_parallel_mesh",
    "shard_batch",
    "replicate",
    "shard_params_feature_dim",
    "initialize_distributed",
    "global_mesh",
    "process_local_rows",
    "free_port",
]
