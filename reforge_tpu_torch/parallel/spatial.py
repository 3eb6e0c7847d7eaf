"""Row sharding behind the reference's GSPMD API (the port of
``reforge_tpu/parallel/spatial.py``).

The reference jits the whole graph with row-sharded inputs and outputs and
lets XLA partition every op and insert the halo exchanges.  PyTorch has no
auto-partitioner, so ``shard_program`` keeps that API and its results (a
row-sharded program equal to the unsharded one) and runs the explicit halo
executor of ``halo.py``, hand-written kernels included.  The reference's
warning that GSPMD drops its TPU kernels has no counterpart here.
"""

from __future__ import annotations

from ..graph.program import GraphProgram
from .halo import HaloShardedProgram
from .mesh import Mesh


class ShardedProgram(HaloShardedProgram):
    """A GraphProgram row-sharded over a mesh (the halo executor)."""


def shard_program(program: GraphProgram, mesh: Mesh) -> ShardedProgram:
    return ShardedProgram(program, mesh)
