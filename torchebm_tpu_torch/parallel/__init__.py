"""Distribution on ``torch.distributed``: mesh plumbing, the guarded shim,
sharded-buffer operations (counterpart of :mod:`torchebm_tpu.parallel`).

``DeviceMesh`` for the mesh, DTensor placements for shardings, FSDP2 for the
parameter axis; see :mod:`.mesh` for the axis conventions and what a sharded
tensor means at each boundary of the port.
"""

from .buffer import shard_replay_buffer, shuffle_sharded
from .mesh import (
    batch_sharding,
    fsdp_shard_params,
    init_distributed,
    local_shard_bounds,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from .shim import (
    all_gather_cat,
    broadcast_object,
    get_rank,
    get_world_size,
    is_distributed,
    psum_mean,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch",
    "replicate",
    "fsdp_shard_params",
    "init_distributed",
    "local_shard_bounds",
    "is_distributed",
    "get_rank",
    "get_world_size",
    "all_gather_cat",
    "broadcast_object",
    "psum_mean",
    "shard_replay_buffer",
    "shuffle_sharded",
]
