"""Multi-GPU parallelism over ``torch.distributed``: query sharding,
z-slab sharding of the grid path, z-sharded cleaning and the pipeline
step (one process per GPU)."""

from ptv_interpolation_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    initialize_distributed,
    make_mesh,
    replicated,
    row_sharded,
    shard_fields,
)
from ptv_interpolation_tpu_torch.parallel.sharding import (
    make_pipeline_step,
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
    "make_pipeline_step",
    "sharded_interpolate_field",
    "sharded_interpolate_values",
]
