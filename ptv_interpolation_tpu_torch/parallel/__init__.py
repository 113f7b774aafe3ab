"""Multi-GPU parallelism over ``torch.distributed``: query sharding and
z-slab sharding of the grid path (one process per GPU)."""

from ptv_interpolation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    initialize_distributed,
    make_mesh,
    replicated,
    row_sharded,
    shard_fields,
)
from ptv_interpolation_tpu_torch.parallel.sharding import (
    sharded_interpolate_field,
    sharded_interpolate_values,
)

__all__ = [
    "DATA_AXIS",
    "initialize_distributed",
    "make_mesh",
    "replicated",
    "row_sharded",
    "shard_fields",
    "sharded_interpolate_field",
    "sharded_interpolate_values",
]
