"""GraphProgram: run a built graph on one device (the port of
``reforge_tpu/graph/program.py``: the per-node tier and the single strip
tier).

Execution modes:
  * ``__call__`` / ``_forward`` -- the single strip tier when the graph
    qualifies (every conv reads the input, every other node is
    channel-local): the whole graph in one ``graph_strip`` kernel.
    Otherwise layer by layer, with same-input convs of a layer bundled
    into one ``sep_conv_fused_multi`` launch.
  * ``run_unfused`` / ``run_per_node`` -- node by node, the second timing
    each node.
  * ``render_sequence`` -- a Python loop of ``_forward`` over frame times.

The planners keep the reference's structural gates and drop the gates
that modelled the TPU (VMEM tile models, lane-multiple widths, transpose
variants, ``REFORGE_STRIP_*`` knobs).  The mc and segments strip tiers
are not ported: a graph that needs them runs per node.
"""

from __future__ import annotations

import time as _time
from typing import Any, Optional

import torch

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..kernels import cuda_ops
from ..kernels.base import KernelContext, quantize_rgba8
from ..utils import warnln
from .builder import BuiltGraph, PipelineNode


class GraphTraceError(Exception):
    pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GraphProgram:
    # Inter-node storage type per format: rgba8 keeps f32 on the UNORM
    # grid, rgba16f stores bfloat16 (compute stays f32).
    STORAGE_DTYPES = {
        "rgba32f": torch.float32,
        "rgba8": torch.float32,
        "rgba16f": torch.bfloat16,
    }

    def __init__(
        self,
        graph: BuiltGraph,
        width: int,
        height: int,
        fmt: str = "rgba32f",
        *,
        device: Any = "cpu",
        plan_strips: bool = True,
    ):
        if fmt not in self.STORAGE_DTYPES:
            raise ValueError(f"unknown storage format {fmt!r}")
        self.graph = graph
        self.width = width
        self.height = height
        self.fmt = fmt
        self.device = torch.device(device)
        self.storage_dtype = self.STORAGE_DTYPES[fmt]
        # plan_strips=False (one-shot renders) skips strip planning.
        # Planning is lazy: see the _strip_plan property.
        self._strip_planned = not plan_strips
        self._strip_plan_cache = None
        self._strip_program: Optional[cuda_ops.StripProgram] = None
        # Interim/one-shot mode: __call__ runs node by node.
        self._use_unfused = False

    # ---- planning -------------------------------------------------------

    @property
    def _strip_plan(self):
        if not self._strip_planned:
            self._strip_planned = True
            self._strip_plan_cache = self._plan_strip_fusion()
        return self._strip_plan_cache

    def _ctx(self, t, device) -> KernelContext:
        return KernelContext(
            width=self.width, height=self.height, time=t, fmt=self.fmt, device=device
        )

    def compute_input(self, value):
        """Storage -> compute type for a kernel input (shaders compute in
        f32 whatever the storage format)."""
        if value.dtype == torch.bfloat16:
            return value.to(torch.float32)
        return value

    def store_output(self, value):
        """Compute -> storage type for a node's image output, including the
        rgba8 UNORM-grid quantization."""
        if self.fmt == "rgba8":
            value = quantize_rgba8(value)
        return value.to(self.storage_dtype)

    def _plan_strip_fusion(self):
        """``("single", conv_items, pointwise)`` when the whole graph can run
        as one graph_strip kernel, else None (per-node execution)."""
        single = self._plan_strip_single()
        if single is None:
            return None
        return ("single",) + single

    def _conv_plan_for(self, node):
        """(wh, ww) numpy tap vectors when this node is strip-fusable as a
        separable edge conv with these params, else None."""
        spec = node.spec
        if (
            spec.conv_weights is None
            or len(node.inputs) != 1
            or spec.border_for(node.params) != "edge"
        ):
            return None
        plan = spec.conv_weights(node.params)
        if plan is None or len(plan[0]) + len(plan[1]) < 4:
            return None
        return plan

    def _plan_strip_single(self):
        conv_items: list = []
        pointwise: list = []
        for layer in self.graph.layers:
            for node in layer:
                spec = node.spec
                if len(node.outputs) != 1 or spec.ssbos_in or spec.ssbos_out:
                    return None
                if (
                    spec.conv_epilogue_cw is not None
                    and spec.cw_op is not None
                    and node.inputs
                    and node.inputs[0][0] == FILE_INPUT
                ):
                    plan = self._conv_plan_for(node)
                    if plan is not None:
                        conv_items.append((node, plan))
                        continue
                if (
                    spec.cw_fn is not None
                    and spec.cw_op is not None
                    and spec.halo_for(node.params) == 0
                    and node.inputs
                    and len(spec.images_in) <= 2
                ):
                    pointwise.append(node)
                    continue
                return None
        if not conv_items:
            return None  # pointwise-only graphs have no conv to share
        n_slots = 1 + len(conv_items) + len(conv_items) + len(pointwise)
        if n_slots > cuda_ops.MAX_SLOTS:
            return None
        if not cuda_ops.plans_fit([p for _, p in conv_items], len(conv_items)):
            return None
        return (conv_items, pointwise)

    def _build_strip_program(self) -> cuda_ops.StripProgram:
        """The single plan's op list, conv plans and coordinate planes, built
        once per program: the device form of the reference's traced
        epilogue (program.py:1245-1266 there), keyed by the graph's
        structure and static params."""
        _tag, conv_items, pointwise = self._strip_plan
        device = self.device

        def ctx_at(t):
            return self._ctx(t, device)

        # Coordinate-plane hoist: data- and time-independent factors of
        # pointwise nodes (vignette's fade) are built once, here.
        plane_nodes = [
            n for n in pointwise
            if n.spec.cw_coord_plane is not None and n.spec.cw_plane_fn is not None
        ]
        aux = None
        if plane_nodes:
            ctx0 = ctx_at(0.0)
            aux = torch.stack(
                [n.spec.cw_coord_plane(ctx0, n.params).to(torch.float32) for n in plane_nodes]
            ).contiguous()
        plane_idx = {id(n): k for k, n in enumerate(plane_nodes)}

        slot_of = {FILE_INPUT: 0}
        next_slot = 1 + len(conv_items)
        ops = []
        for k, (node, _plan) in enumerate(conv_items):
            code, params = node.spec.cw_op(node.params, False)

            def plain(ci, t, ins, plane, _node=node):
                return _node.spec.conv_epilogue_cw(ctx_at(t), ci, ins[0], ins[1], _node.params)

            ops.append(cuda_ops.StripOp(code, (0, 1 + k), next_slot, tuple(params), -1, plain))
            slot_of[node.outputs[0][0]] = next_slot
            next_slot += 1
        for node in pointwise:
            plane = plane_idx.get(id(node), -1)
            code, params = node.spec.cw_op(node.params, plane >= 0)
            descs = node.spec.images_in
            by_desc = {desc: res for res, desc in node.inputs}
            try:
                ins = [slot_of[by_desc[d]] for d in descs]
            except KeyError as e:
                raise GraphTraceError(f"node '{node.name}' reads {e} before it is written")

            def plain(ci, t, vals, plane_v, _node=node, _descs=descs, _hoisted=plane >= 0):
                named = dict(zip(_descs, vals))
                if _hoisted:
                    return _node.spec.cw_plane_fn(ctx_at(t), ci, named, _node.params, plane_v)
                return _node.spec.cw_fn(ctx_at(t), ci, named, _node.params)

            ops.append(
                cuda_ops.StripOp(code, tuple((ins * 2)[:2]), next_slot, tuple(params), plane, plain)
            )
            slot_of[node.outputs[0][0]] = next_slot
            next_slot += 1
        return cuda_ops.StripProgram(
            plans=[plan for _, plan in conv_items],
            ops=ops,
            out_slot=slot_of[FINAL_OUTPUT],
            fmt=self.fmt,
            aux=aux,
        )

    def _strip_fused_forward(self, file_input, t):
        """Run the whole graph as one graph_strip kernel, or return None when
        the graph has no single-tier plan.  ``file_input`` is in storage
        type."""
        if self._strip_plan is None:
            return None
        if self._strip_program is None:
            self._strip_program = self._build_strip_program()
        return cuda_ops.graph_strip(file_input, t, self._strip_program)

    # ---- per-node tier --------------------------------------------------

    def _run_node(
        self, node: PipelineNode, ctx: KernelContext, resources: dict[str, Any]
    ) -> dict[str, Any]:
        images = {}
        for res, desc in node.inputs:
            value = resources.get(res)
            if value is None:
                raise GraphTraceError(
                    f"node '{node.name}' reads resource '{res}' before it is written"
                )
            images[desc] = self.compute_input(value)
        outs = node.spec(ctx, images, node.params)
        written = {}
        for res, desc in node.outputs:
            if desc not in outs:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' did not produce declared output "
                    f"'{desc}' (produced: {', '.join(outs)})"
                )
            value = outs[desc]
            expected = (4, self.height, self.width)
            if tuple(value.shape) != expected:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' output '{desc}' has shape "
                    f"{tuple(value.shape)}, expected {expected}"
                )
            written[res] = self.store_output(value)
        return written

    def _forward(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        x = file_input.to(self.storage_dtype)
        strip = self._strip_fused_forward(x, t)
        if strip is not None:
            return strip
        return self._forward_layers({FILE_INPUT: x}, self._ctx(t, x.device))

    def _forward_nostrip(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        """Per-node path only: make_program checks wiring with this, so
        building a program never plans strips."""
        x = file_input.to(self.storage_dtype)
        return self._forward_layers({FILE_INPUT: x}, self._ctx(t, x.device))

    def _forward_layers(self, resources: dict, ctx: KernelContext):
        for layer in self.graph.layers:
            bundles, singles = self._bundle_groups(layer)
            for res, items in bundles:
                self._run_bundle(res, items, ctx, resources)
            for node in singles:
                resources.update(self._run_node(node, ctx, resources))
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out

    def _bundle_groups(self, layer) -> tuple[list, list]:
        """Group same-layer separable-conv nodes by shared input resource;
        each group of two or more runs as one sep_conv_fused_multi launch
        that loads the input once.  rgba16f keeps per-node convs (the
        reference's rule: its bf16 convs took the MXU entry point)."""
        if len(layer) < 2 or self.fmt == "rgba16f":
            return [], list(layer)
        groups: dict[str, list] = {}
        singles: list = []
        for node in layer:
            spec = node.spec
            plan = None
            if (
                spec.conv_weights is not None
                and spec.conv_epilogue is not None
                and len(node.inputs) == 1
                and len(node.outputs) == 1
                and not spec.ssbos_in
                and not spec.ssbos_out
                and spec.border_for(node.params) == "edge"
            ):
                plan = spec.conv_weights(node.params)
            if plan is not None and len(plan[0]) + len(plan[1]) < 4:
                plan = None  # degenerate (identity) convs run as plain nodes
            if plan is None:
                singles.append(node)
            else:
                groups.setdefault(node.inputs[0][0], []).append((node, plan))
        bundles = []
        for res, items in groups.items():
            if len(items) >= 2 and cuda_ops.plans_fit([p for _, p in items]):
                bundles.append((res, items))
            else:
                singles.extend(node for node, _ in items)
        return bundles, singles

    def _run_bundle(self, res: str, items: list, ctx, resources: dict) -> None:
        value = resources.get(res)
        if value is None:
            raise GraphTraceError(f"bundled nodes read resource '{res}' before it is written")
        xin = self.compute_input(value)
        blurs = cuda_ops.sep_conv_fused_multi(xin, [plan for _, plan in items])
        for (node, _), blurred in zip(items, blurs):
            out = node.spec.conv_epilogue(ctx, xin, blurred, node.params)
            expected = (4, self.height, self.width)
            if tuple(out.shape) != expected:
                raise GraphTraceError(
                    f"bundled kernel '{node.spec.name}' output has shape "
                    f"{tuple(out.shape)}, expected {expected}"
                )
            resources[node.outputs[0][0]] = self.store_output(out)

    # ---- execution ------------------------------------------------------

    def __call__(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        if self._use_unfused:
            return self.run_unfused(file_input, t)
        return self._forward(file_input, t)

    def render_sequence(
        self, file_input: torch.Tensor, t0: float, dt: float, n: int, stack: bool = False
    ) -> torch.Tensor:
        """Render ``n`` frames; frame i sees ``_rf_time = t0 + i * dt``.

        Returns the last frame, or all of them as (n, 4, H, W) with
        ``stack``.  Launches are queued without waiting on the device."""
        if n < 1:
            raise ValueError("render_sequence needs n >= 1")
        frames = []
        out = None
        for i in range(n):
            out = self._forward(file_input, float(t0) + i * float(dt))
            if stack:
                frames.append(out)
        return torch.stack(frames) if stack else out

    def run_unfused(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        """Execute node by node, without bundling or waiting on the device."""
        x = file_input.to(self.storage_dtype)
        resources: dict[str, Any] = {FILE_INPUT: x}
        ctx = self._ctx(t, x.device)
        for node in self.graph.ordered_nodes:
            resources.update(self._run_node(node, ctx, resources))
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out

    def run_per_node(
        self, file_input: torch.Tensor, t: float
    ) -> tuple[torch.Tensor, dict[str, float]]:
        """Execute node by node, timing each node on the host clock after
        the device has finished it.  Returns (final_output, {node: ms})
        (reference: per-pipeline GPU timestamps, vkutils.rs:104-134)."""
        x = file_input.to(self.storage_dtype)
        resources: dict[str, Any] = {FILE_INPUT: x}
        ctx = self._ctx(t, x.device)
        times: dict[str, float] = {}
        _sync(x.device)
        for node in self.graph.ordered_nodes:
            start = _time.perf_counter()
            resources.update(self._run_node(node, ctx, resources))
            _sync(x.device)
            times[node.name] = (_time.perf_counter() - start) * 1000.0
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out, times


def make_program(
    graph: BuiltGraph, width: int, height: int, fmt: str = "rgba32f",
    plan_strips: bool = True, device: Any = "cpu",
) -> Optional[GraphProgram]:
    """Build a GraphProgram and check its wiring and shapes.

    The per-node path runs once on ``meta`` tensors (shapes only, no
    data, no kernel launch): the analog of the reference's
    ``jax.eval_shape`` check, so a bad edit is rejected before any frame
    renders."""
    program = GraphProgram(graph, width, height, fmt, device=device, plan_strips=plan_strips)
    try:
        x = torch.empty((4, height, width), dtype=torch.float32, device="meta")
        program._forward_nostrip(x, 0.0)
    except GraphTraceError as e:
        warnln(f"Graph build failed: {e}")
        return None
    except Exception as e:  # a kernel that cannot run on these shapes
        warnln(f"Graph build failed while checking kernels: {e}")
        return None
    return program
