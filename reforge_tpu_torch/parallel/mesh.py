"""Device meshes for multi-device execution (the port of
``reforge_tpu/parallel/mesh.py``).

A mesh is a 1-D list of torch devices under an axis name.  One host
thread issues every device's work, PyTorch's counterpart of JAX's single
controller: launches are asynchronous, so slabs, stages or batch shares on
different cards overlap.  There are no process groups and no NCCL; a
tensor moves between cards with ``Tensor.to(device, non_blocking=True)``
(a peer copy where the cards can reach each other).

A mesh may name one device several times (``["cuda:0"] * 4``, or
``["cpu"] * 8`` in the tests): the counterpart of the reference's virtual
CPU devices.  Every code path then runs on that one device, and only the
copies between two different cards wait for a machine that has two.  The
default devices are the distinct cards, so one card runs several slabs
only where the caller lists the devices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

ROW_AXIS = "rows"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a 1-D mesh, in order, and its axis name."""

    devices: tuple
    axis_name: str = ROW_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: len(self.devices)}


def available_devices(kind: str = "cuda") -> list[torch.device]:
    """The distinct devices of ``kind``: every card, or the one CPU."""
    if kind == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n: Optional[int], devices: Optional[Sequence[Any]], axis_name: str) -> Mesh:
    """The first ``n`` of ``devices`` (default: every card) under
    ``axis_name``; more than there are raises, as in the reference."""
    devs = available_devices() if devices is None else [torch.device(d) for d in devices]
    n = n or len(devs)
    if n > len(devs) or n < 1:
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(tuple(devs[:n]), axis_name)


def make_row_mesh(n: Optional[int] = None, devices: Optional[Sequence[Any]] = None) -> Mesh:
    return make_mesh(n, devices, ROW_AXIS)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: split along ``dim`` into equal blocks,
    one a device in order, or (``dim`` None) a whole copy on each."""

    mesh: Mesh
    dim: Optional[int]

    def put(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x``'s blocks (contiguous) on the mesh's devices."""
        devices = self.mesh.devices
        if self.dim is None:
            return [x.to(d, non_blocking=True) for d in devices]
        n, size = len(devices), x.shape[self.dim]
        if size % n:
            raise ValueError(f"dimension {self.dim} of size {size} does not split into {n} blocks")
        blocks = torch.split(x, size // n, dim=self.dim)
        return [b.to(d, non_blocking=True).contiguous() for b, d in zip(blocks, devices)]


def row_sharding(mesh: Mesh) -> Sharding:
    """(4, H, W) images split by rows across the mesh."""
    return Sharding(mesh, 1)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)
