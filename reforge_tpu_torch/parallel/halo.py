"""Row sharding with explicit halo exchange (the port of
``reforge_tpu/parallel/halo.py``).

The image is split by rows into equal slabs, one a mesh device, and each
node's declared halo drives the exchange it needs:

  * halo == 0    -- local compute on the slab (point and colour nodes).
  * halo == r    -- the slab gains r rows of its neighbours above and
    below (``halo_pad``; a radius wider than a slab chains over several
    neighbours), the node's ordinary kernel runs on the extended slab, and
    r rows are cropped from each side: an interior output depends only on
    real data, so any translation-invariant kernel of support <= r is
    exact.
  * halo is None -- data-dependent reads (warps, mosaics), a radius that
    spans the image, and storage-buffer nodes: the slabs are gathered, the
    node runs once on the whole image on the mesh's first device, and each
    slab takes its rows back; buffers stay whole, one identical copy on
    every slab's device.

Where the graph has a whole-graph strip plan (single or mc tier), a slab
instead exchanges the plan's input halo once and runs the one kernel
(``graph_strip`` or ``graph_strip_mc``) on its extended slab with the
slab's global row offset, then crops.  An mc plan whose conv or stencil
reads an intermediate (``McProgram.edge_hazard``) runs its edge slabs on
blocks that end at the image's edge, where the kernel clamps the
intermediates as the unsharded program does, and its inner slabs on
neighbour data both sides.  The route is chosen on the host per slab.

The image's top and bottom replicate their edge rows or read zeros, the
node's (or plan's) border mode, as the unsharded program does.

The reference's switches for TPU meshes and Pallas interpret mode have no
counterpart: on the CPU the strip route runs the kernels' plain versions,
on the card the kernels.  One host thread issues every slab's work.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..graph.program import GraphProgram
from ..kernels.base import KernelContext
from ..utils import warnln
from .mesh import Mesh, row_sharding


def halo_pad(slabs: Sequence[torch.Tensor], r: int, idx: int, mode: str = "edge") -> torch.Tensor:
    """Slab ``idx`` of a row-sharded (C, h, W) image with ``r`` rows of its
    neighbours above and below, on that slab's device.

    Rows past the image's top or bottom replicate its first or last row
    ("edge") or are zeros ("zero"), the single-device border convention.
    A radius past the slab height takes rows from several neighbours, as
    the reference's chained hops do (at most min(ceil(r/h), n - 1) of
    them: every image row within r of the slab), and rows past the whole
    mesh are the border's; the result is the reference's bit for bit."""
    x = slabs[idx]
    if r <= 0:
        return x
    n, h = len(slabs), x.shape[1]
    dev = x.device

    def rows(lo: int, hi: int) -> list:
        parts = []
        row = lo
        while row < hi:
            j = row // h
            end = min(hi, (j + 1) * h)
            parts.append(slabs[j][:, row - j * h:end - j * h].to(dev, non_blocking=True))
            row = end
        return parts

    def border(count: int, edge_row: torch.Tensor) -> torch.Tensor:
        if mode == "edge":
            return edge_row.to(dev, non_blocking=True).expand(-1, count, -1)
        return torch.zeros((x.shape[0], count, x.shape[2]), dtype=x.dtype, device=dev)

    lo, hi, end = idx * h - r, (idx + 1) * h + r, n * h
    parts = []
    if lo < 0:
        parts.append(border(-lo, slabs[0][:, :1]))
    parts += rows(max(lo, 0), idx * h) + [x] + rows((idx + 1) * h, min(hi, end))
    if hi > end:
        parts.append(border(hi - end, slabs[-1][:, -1:]))
    return torch.cat(parts, dim=1)


class HaloShardedProgram:
    """A graph program row-sharded over a mesh with explicit halo exchange.

    ``__call__`` takes the whole frame or its slabs (``shard_input``) and
    returns the whole output on the mesh's first device;
    ``forward_slabs`` returns the output slabs where they were computed."""

    def __init__(self, program: GraphProgram, mesh: Mesh):
        self.program = program
        self.mesh = mesh
        self.n = mesh.size
        h = program.height
        if h % self.n != 0:
            raise ValueError(f"image height {h} is not divisible by the {self.n}-device mesh")
        self.h_local = h // self.n
        self.devices = list(mesh.devices)
        self.slab_plans = [self._slab_route(i)[0] for i in range(self.n)]

    # ---- the whole-graph strip route -----------------------------------------------

    def _slab_route(self, idx: int) -> tuple[str, int, str]:
        """(route, halo rows, border mode) of slab ``idx``: "strip single",
        "strip mc", "strip mc top" / "mid" / "bottom" (an mc plan with an
        edge hazard), or "per node" (no whole-graph plan, a segments plan, a
        halo that spans the image, or a hazard slab thinner than its
        halo)."""
        prog = self.program
        plan = prog._strip_plan
        if plan is None or plan[0] == "segments":
            return "per node", 0, "edge"
        if plan[0] == "mc":
            mc = plan[1]
            rh, mode = mc.input_halo, mc.mode
            if mc.edge_hazard:
                if self.n == 1:
                    return "strip mc", 0, mode  # the slab is the image
                if rh >= self.h_local:
                    return "per node", 0, mode
                where = "top" if idx == 0 else "bottom" if idx == self.n - 1 else "mid"
                return f"strip mc {where}", rh, mode
            route = "strip mc"
        else:
            rh = max((len(wh) - 1) // 2 for _, (wh, _ww) in plan[1])
            mode, route = "edge", "strip single"
        if rh == 0 or rh >= prog.height:
            return "per node", 0, mode
        return route, rh, mode

    def _strip_slab(self, xs: list, t: float, idx: int) -> Optional[torch.Tensor]:
        """Slab ``idx``'s output through the whole-graph kernel, or None on
        the per-node route."""
        route, rh, mode = self._slab_route(idx)
        if route == "per node":
            return None
        prog, h = self.program, self.h_local
        row0 = idx * h
        if rh == 0:  # one slab: the image itself
            return prog._strip_fused_forward(xs[idx], t, row0_base=row0)
        ext = halo_pad(xs, rh, idx, mode)
        if route.endswith("top"):  # its top is the image's: no rows above
            block = ext[:, rh:].contiguous()
            return prog._strip_fused_forward(block, t, row0_base=row0)[:, :h]
        if route.endswith("bottom"):
            block = ext[:, :h + rh].contiguous()
            return prog._strip_fused_forward(block, t, row0_base=row0 - rh)[:, rh:]
        return prog._strip_fused_forward(ext, t, row0_base=row0 - rh)[:, rh:rh + h]

    # ---- the per-node route -------------------------------------------------------

    def _ctx(self, t, rows: int, row0: int, device) -> KernelContext:
        prog = self.program
        return KernelContext(width=prog.width, height=prog.height, time=t, fmt=prog.fmt,
                             device=device, row_offset=row0, local_height=rows)

    def _per_node(self, xs: list, t: float) -> list:
        prog, n, h = self.program, self.n, self.h_local
        dev0 = self.devices[0]
        res: list[dict[str, Any]] = [{FILE_INPUT: x} for x in xs]
        for node in prog.graph.ordered_nodes:
            spec = node.spec
            buffers = set(spec.ssbos_in) | set(spec.ssbos_out)
            r = spec.halo_for(node.params)
            if r is not None and r >= prog.height:
                warnln(f"node '{node.name}': halo {r} spans the whole {prog.height}-row "
                       f"image; falling back to all-gather (full-image collective per frame)")
                r = None
            if buffers:
                r = None  # buffers stay whole and identical on every slab
            ins = [(name, desc in buffers) for name, desc in node.inputs]
            if r is None:
                full = {name: res[0][name] if is_buf
                        else torch.cat([res[i][name].to(dev0, non_blocking=True)
                                        for i in range(n)], dim=1)
                        for name, is_buf in ins}
                written = prog._run_node(node, self._ctx(t, prog.height, 0, dev0), full)
                for name, desc in node.outputs:
                    value = written[name]
                    for i in range(n):
                        dev = self.devices[i]
                        part = value if desc in buffers else value[:, i * h:(i + 1) * h]
                        res[i][name] = part.to(dev, non_blocking=True)
                continue
            border = spec.border_for(node.params)
            for i in range(n):
                dev = self.devices[i]
                if r == 0:
                    res[i].update(prog._run_node(node, self._ctx(t, h, i * h, dev), res[i]))
                    continue
                padded = {name: res[i][name] if is_buf
                          else halo_pad([s[name] for s in res], r, i, border)
                          for name, is_buf in ins}
                written = prog._run_node(node, self._ctx(t, h + 2 * r, i * h - r, dev), padded)
                for name, desc in node.outputs:
                    value = written[name]
                    res[i][name] = value if desc in buffers else value[:, r:r + h]
        return [r_i[FINAL_OUTPUT] for r_i in res]

    # ---- execution ----------------------------------------------------------------

    def forward_slabs(self, slabs: list, t: float) -> list:
        """The output slabs of the input slabs (one (4, h_local, W) tensor a
        mesh device, in row order), each on its slab's device."""
        prog = self.program
        # The storage cast of GraphProgram._forward, so that the sharded and
        # unsharded programs round rgba16f alike before the first node.
        xs = [s.to(prog.storage_dtype) for s in slabs]
        if self.slab_plans[0] == "per node":
            return self._per_node(xs, t)
        return [self._strip_slab(xs, t, i) for i in range(self.n)]

    def __call__(self, file_input: Union[torch.Tensor, list], t: float) -> torch.Tensor:
        slabs = file_input if isinstance(file_input, list) else self.shard_input(file_input)
        outs = self.forward_slabs(slabs, float(t))
        dev0 = self.devices[0]
        return torch.cat([o.to(dev0, non_blocking=True) for o in outs], dim=1)

    def shard_input(self, file_input: torch.Tensor) -> list:
        """The frame's slabs on the mesh's devices."""
        return row_sharding(self.mesh).put(file_input)

    def compile(self) -> None:
        """Build what each slab's kernel reads on its device (the strip
        route's hoisted planes, the mc plan's tap tables), so that the first
        frame builds nothing (the Engine calls it where it builds, on its
        build thread with ``async_compile``)."""
        prog = self.program
        plan = prog._strip_plan
        if plan is None or plan[0] == "segments" or self.slab_plans[0] == "per node":
            return
        for i, dev in enumerate(self.devices):
            if plan[0] == "mc":
                plan[1].device_taps(torch.device(dev))
                continue
            _route, rh, _mode = self._slab_route(i)
            prog._strip_program_for(dev, i * self.h_local - rh, self.h_local + 2 * rh)
