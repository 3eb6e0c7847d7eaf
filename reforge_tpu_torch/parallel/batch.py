"""Data-parallel batches: many frames across the mesh (the port of
``reforge_tpu/parallel/batch.py``).

Frames are independent, so the batch splits into equal shares, one a mesh
device, and each device runs the single-frame program over its share in
order: no communication.  The CLI's batch mode uses it with ``--shard``.
As in the reference, a device's frames run one after another through the
ordinary single-frame forward, whole-graph kernels intact; the host
thread issues every share's launches before it waits on any, so shares on
different cards overlap.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ..graph.program import GraphProgram
from .mesh import Mesh, Sharding, make_mesh

BATCH_AXIS = "batch"


def make_batch_mesh(n: Optional[int] = None, devices: Optional[Sequence[Any]] = None) -> Mesh:
    return make_mesh(n, devices, BATCH_AXIS)


class BatchProgram:
    """A batch program: (B, 4, H, W) -> (B, 4, H, W), the frames shared out
    over ``mesh`` (None: all on the input's device, in order).

    ``t`` may be a scalar (every frame) or a (B,) vector of per-frame times
    (video batches want monotone timestamps)."""

    def __init__(self, program: GraphProgram, mesh: Optional[Mesh] = None):
        self.program = program
        self.mesh = mesh

    def _times(self, t, n: int) -> np.ndarray:
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        times = np.asarray(t, np.float32)
        if times.ndim == 0:
            return np.broadcast_to(times, (n,))
        if times.shape != (n,):
            raise ValueError(f"times shape {times.shape} != batch ({n},)")
        return times

    def __call__(self, batch: Union[torch.Tensor, list], t) -> torch.Tensor:
        """The outputs of every frame, stacked on the first share's device."""
        shares = batch if isinstance(batch, list) else [batch]
        if self.mesh is not None and not isinstance(batch, list):
            shares = self.shard_input(batch)
        times = self._times(t, sum(s.shape[0] for s in shares))
        outs, k = [], 0
        for share in shares:
            frames = []
            for frame in share:
                frames.append(self.program._forward(frame, float(times[k])))
                k += 1
            outs.append(torch.stack(frames))
        dev0 = shares[0].device
        return torch.cat([o.to(dev0, non_blocking=True) for o in outs])

    def shard_input(self, batch: torch.Tensor) -> list:
        """The batch's shares on the mesh's devices (the batch a whole
        number of shares: ``pad_batch``)."""
        if self.mesh is None:
            return [batch]
        return Sharding(self.mesh, 0).put(batch)

    def pad_batch(self, batch: torch.Tensor) -> tuple[torch.Tensor, int]:
        """Pad the batch to a multiple of the mesh size with copies of its
        first frame; returns (padded, n)."""
        n = batch.shape[0]
        if self.mesh is None:
            return batch, n
        rem = (-n) % self.mesh.size
        if rem:
            batch = torch.cat([batch, batch[:1].expand(rem, -1, -1, -1)])
        return batch, n
