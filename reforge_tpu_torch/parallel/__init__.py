"""Multi-device execution: meshes, row sharding with halo exchange,
data-parallel batches and pipeline stages (the port of
``reforge_tpu/parallel/``).

One host thread issues every device's work; the devices are a mesh's list
of torch devices, which may repeat one device (parallel/mesh.py).
"""

from .batch import BATCH_AXIS, BatchProgram, make_batch_mesh
from .halo import HaloShardedProgram, halo_pad
from .mesh import ROW_AXIS, make_row_mesh, replicated, row_sharding
from .spatial import ShardedProgram, shard_program

__all__ = [
    "BATCH_AXIS",
    "BatchProgram",
    "make_batch_mesh",
    "HaloShardedProgram",
    "halo_pad",
    "ROW_AXIS",
    "make_row_mesh",
    "replicated",
    "row_sharding",
    "ShardedProgram",
    "shard_program",
]

from .pipeline import PipelineStagedProgram, split_layers  # noqa: E402

__all__ += ["PipelineStagedProgram", "split_layers"]
