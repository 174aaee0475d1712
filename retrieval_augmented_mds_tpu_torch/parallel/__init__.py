"""The (data, shard) mesh of the port on `torch.distributed`: the mesh and
its groups (`mesh`) and the collectives every sharded module calls
(`collectives`). A user starts one process per rank with ``torchrun``."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    SHARD_AXIS,
    Mesh,
    MeshSpec,
    best_mesh,
    build_mesh,
    init_distributed,
    make_mesh,
)
