"""Devices in a mesh (counterpart of `f9tpu.parallel`): the mesh, the
single-controller runner and its collectives, and the sharded paths."""

from .mesh import (  # noqa: F401
    Mesh, NamedSharding, P, files_sharding, make_mesh, make_multislice_mesh,
)
from .shard import ShardAborted, run_sharded  # noqa: F401
from .sharding import (  # noqa: F401
    channels_shardable,
    process_batch_channels_sharded,
    process_files_sharded,
    required_frames_padding,
    resample_frames_sharded,
    shard_halos,
)
