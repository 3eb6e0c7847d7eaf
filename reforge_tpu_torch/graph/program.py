"""GraphProgram: run a built graph on one device (the port of
``reforge_tpu/graph/program.py``: the per-node tier and the three strip
tiers).

Execution modes:
  * ``__call__`` / ``_forward`` -- a strip tier when the graph qualifies,
    tried in the reference's order:
      - single: every conv reads the input and every other node is
        channel-local; the whole graph in one ``graph_strip`` kernel.
      - mc: convs of any image, small-radius stencils (sharpen, sobel,
        emboss, median3), channel-mixing point nodes, GLSL shaders whose
        body is an affine tap-sum (glsl/affine.py) and GLSL point shaders
        that lower to an op list (glsl/lower.py); the whole graph in one
        ``graph_strip_mc`` kernel, its border mode ("edge" or "zero") the
        plan's; refused where its halo recompute passes MC_MAX_HALO_WORK
        a stage.
      - segments: neither takes the whole graph, so the maximal contiguous
        node ranges that one of them takes run as child programs (one
        kernel each) and the nodes between them run per node.
    Otherwise layer by layer, with same-input convs of a layer bundled
    into one ``sep_conv_fused_multi`` launch; stencils run as
    ``stencil_apply`` and heavy f32 convs as ``sep_conv_fused_mxu_x3``.
  * ``run_unfused`` / ``run_per_node`` -- node by node, the second timing
    each node.
  * ``render_sequence`` -- a Python loop of ``_forward`` over frame times;
    stacked, each frame's strip kernel writes its slice of one output.

The planners keep the reference's structural gates and drop the gates
that modelled the TPU (VMEM tile models, lane-multiple widths, MXU
eligibility, transpose variants, ``REFORGE_STRIP_*``/``REFORGE_MC_*``
knobs).  A plan whose kernel fits no shared-memory tile is refused when
it is planned, so a planned segment never falls back at run time.

``make_program`` checks a graph's wiring and shapes on ``meta`` tensors
before any frame.  What a program builds on the host (the check and the
strip plan) is kept across programs by graph signature, and the check of
each node by the node's own signature: a rebuild back to a graph this
process has built checks and plans nothing, and a rebuild that changes
one node checks that node alone.
"""

from __future__ import annotations

import threading
import time as _time
from typing import Any, Optional

import numpy as np
import torch

from .. import trace
from ..config import FILE_INPUT, FINAL_OUTPUT
from ..glsl.affine import ConvSynth, StencilSynth, compose, synthesize_conv
from ..glsl.lower import PointProgram, lower_point, point_program_plain, reads_at_points
from ..kernels import cuda_ops
from ..kernels.base import KernelContext, quantize_rgba8
from ..kernels.ops import X3_MIN_TAPS
from ..utils import remember, warnln
from .builder import BuiltGraph, PipelineNode, _order_by_execution


class GraphTraceError(Exception):
    pass


# Structural gates of the mc tier: conv taps (H + W) and stencil radius.
MC_MAX_TAPS = 200
MC_MAX_RADIUS = cuda_ops.STENCIL_MAX_RADIUS
# The tier rule against halo recompute: an mc plan (a segment's child too)
# whose estimated halo work a stage (``McProgram.halo_work``, per output
# pixel) passes this bound is refused.  From ms a 4K frame in rgba32f on an
# H100 80GB HBM3 at 700 W (chip_smoke paths D and J): neon edges, 62.4 a
# stage, wins on mc, 2.912 against 3.462 per node, as blur_sharpen_blend,
# 57.2, does, 1.369 against 1.888 on segments; bloom_glow, 477.5, loses,
# 8.710 against 2.929 per node (6.811 against 1.985 with the builtin
# tonemap).  The bound sits between the two sides, near the middle on a
# log scale; no graph between them has been timed.
MC_MAX_HALO_WORK = 200.0
_MC_KINDS = {"conv": cuda_ops.MC_CONV, "stencil": cuda_ops.MC_STENCIL, "point": cuda_ops.MC_POINT}

# Frames of stacked sequences (render_sequence(stack=True)), each counted
# once: written in its slice of the stack by its strip kernel, or copied
# there.
SEQUENCE_FRAMES: dict[str, int] = {"in_place": 0, "copied": 0}
# Runs on a frame of GLSL nodes of halo None (shaders that read images at
# computed points; those with storage buffers, atomics or ``shared``
# arrays left out), by the path each took: a stage of a graph_strip_mc
# launch (its op list), or the interpreter per node.  Neither the shape
# check nor any other run on ``meta`` counts.
GLSL_GATHER_RUNS: dict[str, int] = {"op_list": 0, "interpreter": 0}


def _device_name(device) -> str:
    """A device's name with its index ("cuda" names the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return str(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---- caches across programs (reference: program.py:38-86) -----------------
#
# Keys name a kernel by the identity of its spec: the loader returns one
# spec per file path and source text, and builtins are registry objects, so
# an unchanged kernel, or an edit back to a text loaded before, keys the
# same.  Each value pins its specs, so an id() in a key is never reused.
# Past its bound a cache drops its oldest half (``utils.remember``).
_NODE_CHECKS: dict[tuple, tuple] = {}  # node key -> (spec, its meta outputs)
_NODE_CHECKS_MAX = 512
_PROGRAMS: dict[tuple, tuple] = {}  # program key -> (specs, _HostBuild)
_PROGRAMS_MAX = 64
# GLSL point shaders' op lists (glsl/lower.py), keyed by source text,
# params, frame and output: a PointProgram, or the reason there is none.
_POINT_PROGRAMS: dict[tuple, Any] = {}
_POINT_PROGRAMS_MAX = 256


def _node_key(node: PipelineNode, graph: BuiltGraph, width: int, height: int, fmt: str) -> tuple:
    """Everything a node's shape check depends on: its kernel, resolved
    params, wiring, the sizes of the buffers it touches, extent and format."""
    wired = list(node.inputs) + list(node.outputs)
    return (
        id(node.spec),
        tuple(sorted(node.params.items())),
        tuple(node.inputs),
        tuple(node.outputs),
        tuple(graph.buffer_sizes.get(res, 0) for res, _ in wired),
        width,
        height,
        fmt,
    )


class _HostBuild:
    """What a program builds on the host: its strip plan and, on the single
    tier, its StripProgram (and those of slabs and other devices).  Programs
    of one graph signature share one."""

    def __init__(self, planned: bool):
        self.lock = threading.Lock()
        self.planned = planned
        self.plan = None
        self.strip_program: Optional[cuda_ops.StripProgram] = None
        # StripPrograms of other devices and of row slabs, by (device, row0,
        # rows).
        self.strip_blocks: dict[tuple, cuda_ops.StripProgram] = {}


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
        device: Any = "cuda",
        plan_strips: bool = True,
        segments_ok: bool = True,
    ):
        if fmt not in self.STORAGE_DTYPES:
            raise ValueError(f"unknown storage format {fmt!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GraphProgram(device='cuda') but no CUDA device is available")
        self.graph = graph
        self.width = width
        self.height = height
        self.fmt = fmt
        self.storage_dtype = self.STORAGE_DTYPES[fmt]
        self.plan_strips = plan_strips
        # A segment's child plans the single and mc tiers only.
        self._segments_ok = segments_ok
        # plan_strips=False (one-shot renders) skips strip planning.
        # Planning is lazy: see the _strip_plan property.
        self._host = _HostBuild(planned=not plan_strips)
        # Interim/one-shot mode: __call__ runs node by node.
        self._use_unfused = False
        # Set by make_program: whether the program came from the cache,
        # and how many nodes its shape check ran.
        self.from_cache = False
        self.nodes_checked = 0
        # The Engine's multi-device form of this program, which takes its
        # frames (parallel/: HaloShardedProgram or PipelineStagedProgram).
        self.sharded = None
        # Where _forward's strip kernel writes the final output while
        # render_sequence renders a stacked frame (``.out``), per thread.
        self._frame_out = threading.local()
        # The GLSL nodes that GLSL_GATHER_RUNS counts (``_gather_nodes``).
        self._gathering: Optional[frozenset] = None

    # ---- planning -------------------------------------------------------

    @property
    def _strip_plan(self):
        host = self._host
        if not host.planned:
            with host.lock:  # a build thread and the render thread may both ask
                if not host.planned:
                    with trace.build_span("build.plan") as sp:
                        host.plan = self._plan_strip_fusion()
                        sp.attrs["tier"] = host.plan[0] if host.plan else None
                    host.planned = True
        return host.plan

    @property
    def tier(self) -> str:
        """How a frame runs: "single", "mc" or "segments" (the strip
        plan's tier), "per-node", or "unfused" (one-shot)."""
        if self._use_unfused:
            return "unfused"
        plan = self._strip_plan
        return plan[0] if plan else "per-node"

    @property
    def _strip_program(self) -> Optional[cuda_ops.StripProgram]:
        return self._host.strip_program

    @_strip_program.setter
    def _strip_program(self, value: Optional[cuda_ops.StripProgram]) -> None:
        self._host.strip_program = value

    def _gather_nodes(self) -> frozenset:
        """The names of the nodes that GLSL_GATHER_RUNS counts: GLSL
        shaders of halo None without storage buffers, atomics or ``shared``
        arrays (``glsl.lower.reads_at_points``)."""
        if self._gathering is None:
            self._gathering = frozenset(n.name for n in self.graph.ordered_nodes
                                        if reads_at_points(n.spec, n.params))
        return self._gathering

    def _program_key(self) -> tuple:
        """The graph signature of the program cache (reference:
        ``_fused_key``, program.py:1534-1542): each node's name and check
        key in execution order, plus device, planning and buffer sizes."""
        return (
            tuple((n.name,) + _node_key(n, self.graph, self.width, self.height, self.fmt)
                  for n in self.graph.ordered_nodes),
            str(self.device),
            self.plan_strips,
            tuple(sorted(self.graph.buffer_sizes.items())),
        )

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
        as one graph_strip kernel, else ``("mc", McProgram)`` when it can
        run as one graph_strip_mc kernel, else ``("segments", steps)`` when
        some of its node ranges can, else None (per-node execution)."""
        single = self._plan_strip_single()
        if single is not None:
            return ("single",) + single
        mc = self._plan_strip_mc()
        if mc is not None:
            return ("mc", mc)
        return self._plan_strip_segments()

    def _plan_strip_segments(self):
        """The third tier (reference: program.py:969-1110): the maximal
        contiguous node ranges, in execution order, with exactly one
        external image input and one exiting resource, each a child
        GraphProgram over a renamed subgraph whose own single/mc planner
        decides whether it fuses; the nodes between them run per node.

        Steps are ``("seg", child, r_in, r_out, nodes)`` and ``("node",
        node)``.  The whole graph is not a range (both tiers refused it),
        and a one-node range is taken only for a stencil or a GLSL node: a
        lone builtin conv or point node has its own per-node kernel.
        Graphs with storage buffers are refused (buffer resources do not
        rename), and a graph where no range fuses plans None."""
        if not self._segments_ok:
            return None
        order = self.graph.ordered_nodes
        if len(order) < 2 or any(n.spec.ssbos_in or n.spec.ssbos_out for n in order):
            return None
        produced_at = {res: i for i, n in enumerate(order) for res, _ in n.outputs}
        consumers: dict[str, list[int]] = {}
        for i, n in enumerate(order):
            for res, _ in n.inputs:
                consumers.setdefault(res, []).append(i)

        def segment_io(i: int, j: int):
            """(r_in, r_out) when order[i..j] has exactly one external input
            and one exiting resource that is not also read inside, else
            None."""
            inside = range(i, j + 1)
            ext_in = {res for k in inside for res, _ in order[k].inputs
                      if produced_at.get(res) not in inside}
            if len(ext_in) != 1:
                return None
            exits = []
            for k in inside:
                for res, _ in order[k].outputs:
                    readers = consumers.get(res, [])
                    if res == FINAL_OUTPUT or any(c not in inside for c in readers):
                        if any(c in inside for c in readers):
                            return None  # an exit read back inside: ambiguous
                        exits.append(res)
            if len(exits) != 1:
                return None
            return next(iter(ext_in)), exits[0]

        def child_for(i: int, j: int, r_in: str, r_out: str):
            def rename(res: str) -> str:
                return {r_in: FILE_INPUT, r_out: FINAL_OUTPUT}.get(res, res)

            nodes = {
                n.name: PipelineNode(
                    name=n.name, spec=n.spec, inputs=[(rename(r), d) for r, d in n.inputs],
                    outputs=[(rename(r), d) for r, d in n.outputs], params=n.params)
                for n in order[i:j + 1]
            }
            layers = _order_by_execution(nodes)
            if layers is None:
                return None
            kinds = {res: "image" for n in nodes.values() for res, _ in n.inputs + n.outputs}
            sub = BuiltGraph(nodes=nodes, layers=layers, resource_kinds=kinds)
            return GraphProgram(sub, self.width, self.height, self.fmt, device=self.device,
                                segments_ok=False)

        steps: list = []
        i, n = 0, len(order)
        while i < n:
            for j in range(n - 1, i - 1, -1):
                if i == 0 and j == n - 1:
                    continue  # the whole graph: both tiers said no
                if j == i and order[i].spec.mc_stencil_fn is None \
                        and order[i].spec.source_path is None:
                    continue
                io = segment_io(i, j)
                if io is None:
                    continue
                child = child_for(i, j, *io)
                if child is None or child._strip_plan is None:
                    continue
                steps.append(("seg", child, io[0], io[1], list(order[i:j + 1])))
                i = j + 1
                break
            else:
                steps.append(("node", order[i]))
                i += 1
        if not any(step[0] == "seg" for step in steps):
            return None
        return ("segments", steps)

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
        # Past the kernel's compiled limits, the graph takes another tier.
        if len(conv_items) > cuda_ops.MAX_PLANS:
            return None
        if len(conv_items) + len(pointwise) > cuda_ops.MAX_OPS:
            return None
        try:
            n_slots = self._strip_slots(conv_items, pointwise)[2]
        except GraphTraceError:
            return None
        if n_slots > cuda_ops.MAX_SLOTS:
            return None
        if not cuda_ops.plans_fit([p for _, p in conv_items]):
            return None
        return (conv_items, pointwise)

    @staticmethod
    def _strip_slots(conv_items, pointwise) -> tuple[list, int, int]:
        """The single plan's value slots, numbered by liveness: ([(in
        slots, out slot)] of each op in the order of the op list, the
        final output's slot, the slot count).

        Slot 0 holds the input and slot 1 + k conv k's result; each op's
        output takes the lowest slot free once the op has read its inputs
        (an input whose last read is this op frees its slot first, since
        the kernel reads both inputs of a pixel before it writes), and a
        value's slot frees after its last read.  The final output stays
        live to the end."""
        seq = []  # (input resources, output resource) of each op
        for k, (node, _plan) in enumerate(conv_items):
            seq.append(((FILE_INPUT, ("conv", k)), node.outputs[0][0]))
        written = {FILE_INPUT} | {node.outputs[0][0] for node, _ in conv_items}
        for node in pointwise:
            by_desc = {desc: res for res, desc in node.inputs}
            ins = [by_desc[d] for d in node.spec.images_in]
            for res in ins:
                if res not in written:
                    raise GraphTraceError(f"node '{node.name}' reads '{res}' before it is written")
            seq.append((tuple((ins * 2)[:2]), node.outputs[0][0]))
            written.add(node.outputs[0][0])
        last = {FINAL_OUTPUT: len(seq)}
        for j, (ins, _out) in enumerate(seq):
            for res in ins:
                last[res] = max(last.get(res, -1), j)
        slot_of: dict[Any, int] = {FILE_INPUT: 0}
        slot_of.update({("conv", k): 1 + k for k in range(len(conv_items))})
        taken = set(slot_of.values())
        ops = []
        for j, (ins, out) in enumerate(seq):
            in_slots = tuple(slot_of[res] for res in ins)
            for res in set(ins):
                if last[res] == j:
                    taken.discard(slot_of[res])
            slot = min(set(range(len(taken) + 1)) - taken)
            slot_of[out] = slot
            ops.append((in_slots, slot))
            if last.get(out, j) > j:
                taken.add(slot)
        n_slots = 1 + max([len(conv_items)] + [o for _, o in ops])
        return ops, slot_of[FINAL_OUTPUT], n_slots

    def _plan_strip_mc(self) -> Optional[cuda_ops.McProgram]:
        """The mc tier's stage list (the port of the reference's
        ``_plan_strip_mc``, program.py:339-967), or None.

        Node classes: separable edge convs of any image (4 to 200 taps,
        optionally after a node-internal pre-map such as bloom's mask),
        stencils of radius 1..16 with one input, and point nodes of halo
        0.  Every builtin node needs an ``mc_op`` whose kind matches its
        class.  A GLSL node of halo >= 1 needs a synthesized affine tap-sum
        (``_glsl_synth``), a conv or stencil stage; one of halo 0 an op list
        (``_glsl_point``: ``mc_block_ok`` and a lowering that succeeds), a
        point stage, as the reference evaluates its interpreter on the
        kernel's blocks; so does one of halo None whose op list lowers (its
        reads at computed points GATHERs), where it gathers only the plan's
        input, which lies whole in device memory before the launch.  The
        plan needs at least one conv or stencil, or a stage that gathers.
        Each resource is computed over the tile plus the extent its
        consumers read around it (a reverse-topological lift, exact); pool
        slots are reused by linear scan.  The border mode is whole-plan
        (the reference's rule, program.py:921-961): every conv and stencil
        shares one, and "zero" (a GLSL shader that reads out of bounds as
        zero) only where no conv or stencil reads an intermediate; else
        None, and the segments tier gives each conv a child of its own.  A
        plan whose op lists' register files fit no tile at the narrow
        forms' pixels a thread takes the wide form (``McProgram.widened``:
        one pixel a thread, the files in device memory); one that still
        fits nothing, or passes a limit of the launch (``McProgram.refusal``
        says which), is refused with a warning.  A
        plan whose estimated halo work a stage passes ``MC_MAX_HALO_WORK``
        is refused (the tier rule against halo recompute)."""
        nodes: list = []
        synth_of: dict[str, Any] = {}  # GLSL node -> its ConvSynth / StencilSynth
        point_of: dict[str, PointProgram] = {}  # GLSL point node -> its op list
        n_heavy = 0
        gathers = False
        for layer in self.graph.layers:
            for node in layer:
                spec = node.spec
                if len(node.outputs) != 1 or spec.ssbos_in or spec.ssbos_out:
                    return None
                if spec.source_hash is not None:
                    # A GLSL node: a point shader's op list (halo 0, or None
                    # with gathers of the input), or an affine tap-sum (halo
                    # >= 1, one input); else no device form, and the graph
                    # takes another tier.
                    if spec.halo_for(node.params) in (0, None):
                        point = self._glsl_point(node)
                        if point is None:
                            return None
                        by_desc = dict((desc, res) for res, desc in node.inputs)
                        if any(by_desc.get(name) != FILE_INPUT for name in point.gathers):
                            return None  # a gather of an image this launch writes
                        gathers = gathers or bool(point.gathers)
                        point_of[node.name] = point
                        nodes.append(("point", node, None))
                        continue
                    got = self._glsl_synth(node)
                    if got is None:
                        return None
                    synth_of[node.name] = got
                    if isinstance(got, StencilSynth):
                        nodes.append(("stencil", node, got.radius))
                    else:
                        nodes.append(("conv", node, (got.wh, got.ww)))
                    n_heavy += 1
                    continue
                if spec.mc_op is None:
                    return None
                plan = self._conv_plan_for(node) if spec.conv_epilogue is not None else None
                if plan is not None and len(plan[0]) + len(plan[1]) <= MC_MAX_TAPS:
                    nodes.append(("conv", node, plan))
                    n_heavy += 1
                    continue
                r = spec.halo_for(node.params)
                if spec.mc_stencil_fn is not None and r is not None and 1 <= r <= MC_MAX_RADIUS:
                    if spec.border_for(node.params) != "edge" or len(node.inputs) != 1:
                        return None
                    nodes.append(("stencil", node, r))
                    n_heavy += 1
                    continue
                if r == 0 and node.inputs:
                    nodes.append(("point", node, None))
                    continue
                return None
        if self.fmt == "rgba32f":
            # Only in f32 storage: a composed pair skips the rounding to
            # bf16 or to the rgba8 grid that the per-node tier makes
            # between its two nodes, and a stencil after it amplifies the
            # difference past the tier's bound (sharpen.comp at amount 0.7:
            # 6.6x, 0.023 against 2e-2 in rgba16f at 4K on the card).
            n_heavy -= self._compose_synth_chains(nodes, synth_of)
        if n_heavy == 0 and not gathers:
            return None  # point-only graphs have no halo work to share

        # Extents: reverse-topological lift, exact (no alignment).
        need_h: dict[str, int] = {}
        need_w: dict[str, int] = {}
        eh: dict[str, int] = {}
        ew: dict[str, int] = {}
        for kind, node, extra in reversed(nodes):
            out_res = node.outputs[0][0]
            oh, ow = need_h.get(out_res, 0), need_w.get(out_res, 0)
            eh[out_res], ew[out_res] = oh, ow
            if kind == "conv":
                lift_h, lift_w = (len(extra[0]) - 1) // 2, (len(extra[1]) - 1) // 2
            elif kind == "stencil":
                lift_h = lift_w = extra
            else:
                lift_h = lift_w = 0
            for res, _ in node.inputs:
                need_h[res] = max(need_h.get(res, 0), oh + lift_h)
                need_w[res] = max(need_w.get(res, 0), ow + lift_w)
        eh[FILE_INPUT] = need_h.get(FILE_INPUT, 0)
        ew[FILE_INPUT] = need_w.get(FILE_INPUT, 0)

        # Stage specs; a conv with a pre-map splits into a point stage (f32,
        # not a node boundary) and the conv of its output.  Inputs go in the
        # order of the kernel's declared images (mix reads input_image as
        # in0), whatever order the config wires them in.
        specs: list[dict] = []
        for kind, node, extra in nodes:
            out_res = node.outputs[0][0]
            by_desc = {desc: res for res, desc in node.inputs}
            in_res = [by_desc[desc] for desc in node.spec.images_in]
            synth = synth_of.get(node.name)
            if synth is not None:
                specs += self._synth_specs(node, kind, extra, synth, in_res[0], out_res, eh, ew)
                continue
            point = point_of.get(node.name)
            if point is not None:
                specs.append(dict(kind="point", node=node, op=cuda_ops.McOp(cuda_ops.MC_GLSL),
                                  out=out_res, ins=in_res, x=None, extra=None, point=point))
                continue
            op = node.spec.mc_op(node.params)
            if cuda_ops.mc_kind(op.code) != _MC_KINDS[kind]:
                return None
            if kind == "conv" and node.spec.conv_pre is not None:
                pre_res = f"{node.name}::__pre"
                eh[pre_res] = eh[out_res] + (len(extra[0]) - 1) // 2
                ew[pre_res] = ew[out_res] + (len(extra[1]) - 1) // 2
                pre_op = node.spec.mc_op(node.params, pre=True)
                if cuda_ops.mc_kind(pre_op.code) != cuda_ops.MC_POINT:
                    return None
                specs.append(dict(kind="pre", node=node, op=pre_op, out=pre_res,
                                  ins=in_res[:1], x=None, extra=None))
                specs.append(dict(kind="conv", node=node, op=op, out=out_res, ins=[pre_res],
                                  x=in_res[0], extra=extra))
            elif kind == "conv":
                x_res = None if op.code == cuda_ops.MC_CONV_IDENTITY else in_res[0]
                specs.append(dict(kind="conv", node=node, op=op, out=out_res, ins=in_res,
                                  x=x_res, extra=extra))
            else:
                if kind == "stencil" and any(
                    np.shape(tab) != (2 * extra + 1, 2 * extra + 1) for tab in op.tables
                ):
                    return None
                specs.append(dict(kind=kind, node=node, op=op, out=out_res, ins=in_res,
                                  x=None, extra=extra))

        # Pool slots: linear scan, a slot freed after its resource's last
        # read and reused by a later output (never by the reading stage's
        # own output, which is assigned first).
        last_use: dict[str, int] = {}
        for si, ss in enumerate(specs):
            for res in ss["ins"] + ([ss["x"]] if ss["x"] else []):
                last_use[res] = si
        slot_of: dict[str, int] = {FILE_INPUT: cuda_ops.MC_INPUT}
        free: list[int] = []
        n_slots = 0
        for si, ss in enumerate(specs):
            out_res = ss["out"]
            if out_res == FINAL_OUTPUT:
                slot_of[out_res] = cuda_ops.MC_OUTPUT
            elif out_res not in slot_of:
                if free:
                    slot_of[out_res] = free.pop()
                else:
                    slot_of[out_res] = n_slots
                    n_slots += 1
            for res in dict.fromkeys(ss["ins"] + ([ss["x"]] if ss["x"] else [])):
                if last_use.get(res) == si and slot_of.get(res, -1) >= 0:
                    free.append(slot_of[res])
        if slot_of.get(FINAL_OUTPUT) != cuda_ops.MC_OUTPUT:
            return None  # the final output is not produced by a staged node

        stages = [self._mc_stage(ss, slot_of, eh, ew) for ss in specs]
        if len(stages) > cuda_ops.MC_MAX_STAGES:
            return None
        halo_borders = {synth_of[node.name].border if node.name in synth_of else "edge"
                        for kind, node, _extra in nodes if kind in ("conv", "stencil")}
        prog = cuda_ops.McProgram(
            stages=stages, n_slots=n_slots, rh_in=eh[FILE_INPUT], ew_in=ew[FILE_INPUT],
            width=self.width, height=self.height, fmt=self.fmt,
        )
        if "zero" in halo_borders:
            # A slot's outside cells hold the clamped values, where GL's
            # robust access reads a stored image out of bounds as zeros.
            if halo_borders != {"zero"} or prog.edge_hazard:
                return None
            prog.mode = "zero"
        if prog.tile() is None and prog.widened() is not None:
            prog = prog.widened()
        if prog.tile() is None:
            if point_of:
                warnln(f"GLSL point shader node(s) {', '.join(point_of)} cannot join the fused "
                       f"megakernel at {self.width}x{self.height}: {prog.refusal()}; the graph "
                       "takes another tier")
            return None  # no tile holds this plan, or it passes a limit: run per node
        if prog.halo_work()[1] / len(prog.stages) > MC_MAX_HALO_WORK:
            return None  # halo recompute past the bound: per node wins
        return prog

    def _glsl_point(self, node) -> Optional[PointProgram]:
        """The op list of a GLSL shader with inputs, of halo 0 and
        ``mc_block_ok`` or of halo None (glsl/lower.py), or None: lowered
        once per source text, params, frame and output in the process
        (``_POINT_PROGRAMS``), so a warm reload lowers nothing."""
        spec, params = node.spec, node.params
        if not node.inputs:
            return None
        if spec.halo_for(params) == 0 and (spec.mc_block_ok is None
                                           or not spec.mc_block_ok(params)):
            return None
        out_desc = node.outputs[0][1]
        key = (spec.source_hash, tuple(sorted(params.items())), self.width, self.height, out_desc)
        got = _POINT_PROGRAMS.get(key)
        if got is None:
            got = lower_point(spec, params, self.width, self.height, out_desc)
            remember(_POINT_PROGRAMS, _POINT_PROGRAMS_MAX, key, got)
        return got if isinstance(got, PointProgram) else None

    def _glsl_synth(self, node):
        """The affine tap-sum of a one-input GLSL node of halo >= 1 that
        fits the mc tier (glsl/affine.py), or None; its border ("edge" or
        "zero") joins the plan's.  A wide frame's conv-idiom shader that
        cannot join warns, as in the reference (program.py:478-496 there)."""
        spec, params = node.spec, node.params
        halo = spec.halo_for(params) or 0
        got = None
        if len(node.inputs) == 1 and halo >= 1:
            got = synthesize_conv(spec, params)
        if isinstance(got, ConvSynth) and not 4 <= len(got.wh) + len(got.ww) <= MC_MAX_TAPS:
            got = None
        if isinstance(got, StencilSynth) and (got.radius > MC_MAX_RADIUS or got.scale[3] != 0.0):
            got = None  # the stencil stage sums the colour channels only
        if got is None and self.width >= 1920 and halo >= 2:
            warnln(
                f"GLSL node '{node.name}' ({spec.name}) is a conv-idiom shader (radius "
                f"{halo}) that could not join the fused megakernel at {self.width}x"
                f"{self.height}; it will run per-node — expect reduced throughput"
            )
        return got

    @staticmethod
    def _compose_synth_chains(nodes: list, synth_of: dict) -> int:
        """Fold chains of synthesized 1-D convs (gaussian_h.comp ->
        gaussian_v.comp) into one conv stage each, in place, as the
        reference does (program.py:531-588 there); returns the number of
        nodes merged away."""
        merged_away = 0
        changed = True
        while changed:
            changed = False
            cons: dict[str, int] = {}
            for _k, nd, _e in nodes:
                for res, _d in nd.inputs:
                    cons[res] = cons.get(res, 0) + 1
            for i, (kind_a, na, _plan_a) in enumerate(nodes):
                sa = synth_of.get(na.name)
                if kind_a != "conv" or not isinstance(sa, ConvSynth):
                    continue
                out_res = na.outputs[0][0]
                if out_res == FINAL_OUTPUT or cons.get(out_res, 0) != 1:
                    continue
                for j, (kind_b, nb, _plan_b) in enumerate(nodes):
                    sb = synth_of.get(nb.name)
                    if j == i or kind_b != "conv" or not isinstance(sb, ConvSynth):
                        continue
                    if len(nb.inputs) != 1 or nb.inputs[0][0] != out_res:
                        continue
                    comp = compose(sa, sb)
                    if comp is None or not 4 <= len(comp.wh) + len(comp.ww) <= MC_MAX_TAPS:
                        continue
                    merged = PipelineNode(
                        name=f"{na.name}>{nb.name}", spec=nb.spec, inputs=list(na.inputs),
                        outputs=list(nb.outputs), params=dict(nb.params),
                    )
                    synth_of[merged.name] = comp
                    nodes[i] = ("conv", merged, (comp.wh, comp.ww))
                    del nodes[j]
                    merged_away += 1
                    changed = True
                    break
                if changed:
                    break
        return merged_away

    @staticmethod
    def _synth_specs(node, kind, extra, synth, in_res, out_res, eh, ew) -> list:
        """A synthesized GLSL node as mc stage specs: its tap-sum (an
        identity conv, or a stencil in emboss form: the colour channels
        summed, alpha the centre's), then, unless the mix is the identity,
        an MC_AFFINE point stage of that sum (f32, not a node boundary) and
        the node's input.  The mix rides in a stage of its own so that the
        conv and stencil stages of the kernel run as they do for builtins."""
        if kind == "conv":
            lin = dict(kind="conv", op=cuda_ops.McOp(cuda_ops.MC_CONV_IDENTITY))
        else:
            table = np.asarray(synth.w, np.float32)
            lin = dict(kind="stencil", op=cuda_ops.McOp(cuda_ops.MC_EMBOSS, tables=(table,)))
        lin.update(node=node, ins=[in_res], x=None, extra=extra, synth=synth)
        alpha_kept = (synth.scale[3], synth.passthrough[3], synth.offset[3]) == (0.0, 1.0, 0.0)
        rgb_sum = all((synth.scale[c], synth.passthrough[c], synth.offset[c]) == (1.0, 0.0, 0.0)
                      for c in range(3))
        whole = synth.identity if kind == "conv" else rgb_sum and alpha_kept
        if whole:  # the tap-sum stage is the whole node
            return [dict(lin, out=out_res)]
        sum_res = f"{node.name}::__sum"
        eh[sum_res], ew[sum_res] = eh[out_res], ew[out_res]
        needs_x = any(p != 0.0 for p in synth.passthrough)
        mix = dict(kind="point", node=node, out=out_res, x=None, extra=None, synth=synth,
                   op=cuda_ops.McOp(cuda_ops.MC_AFFINE, tables=(cuda_ops.affine_table(synth),)),
                   ins=[sum_res] + ([in_res] if needs_x else []))
        return [dict(lin, out=sum_res, store=False), mix]

    def _mc_stage(self, ss: dict, slot_of: dict, eh: dict, ew: dict) -> cuda_ops.McStage:
        """One McStage of a stage spec, with its plain form: the builtin's
        own ``fn``, ``conv_pre``, ``conv_epilogue`` or ``mc_stencil_fn``."""
        node, kind = ss["node"], ss["kind"]
        spec, params = node.spec, dict(node.params)

        def ref(res):
            return (slot_of[res], eh[res], ew[res])

        common = dict(op=ss["op"], ins=tuple(ref(r) for r in ss["ins"]), out=slot_of[ss["out"]],
                      eh=eh[ss["out"]], ew=ew[ss["out"]])
        point = ss.get("point")
        if point is not None:
            def glsl_plain(ctx, ins):
                device = ins[0].device
                h = ctx.block_height
                gy = torch.arange(h, dtype=torch.int64, device=device).view(-1, 1) + ctx.row_offset
                gx = torch.arange(self.width, dtype=torch.int64, device=device).view(1, -1)
                hw = (h, self.width)
                return point_program_plain(point, ins, gy.expand(hw), gx.expand(hw), ctx.time)

            return cuda_ops.McStage(kind=cuda_ops.MC_POINT, taps=(point.packed(),),
                                    plain=glsl_plain, **common)
        synth = ss.get("synth")
        if synth is not None:
            store = ss.get("store", True)
            if kind == "conv":
                return cuda_ops.McStage(kind=cuda_ops.MC_CONV, taps=ss["extra"], store=store,
                                        plain=lambda ctx, x, blur: blur, **common)
            if kind == "stencil":
                return cuda_ops.McStage(
                    kind=cuda_ops.MC_STENCIL, r=ss["extra"], taps=ss["op"].tables, store=store,
                    plain=lambda ctx, tap: cuda_ops.synth_stencil_plain(synth, tap), **common)
            return cuda_ops.McStage(
                kind=cuda_ops.MC_POINT, taps=ss["op"].tables,
                plain=lambda ctx, ins: cuda_ops.affine_mix_plain(
                    synth, ins[0], ins[1] if len(ins) > 1 else None), **common)
        if kind == "pre":
            return cuda_ops.McStage(
                kind=cuda_ops.MC_POINT, store=False,
                plain=lambda ctx, ins: spec.conv_pre(ctx, ins[0], params), **common)
        if kind == "conv":
            def conv_plain(ctx, x, blur):
                return blur if x is None else spec.conv_epilogue(ctx, x, blur, params)

            return cuda_ops.McStage(
                kind=cuda_ops.MC_CONV, x=ref(ss["x"]) if ss["x"] else None, taps=ss["extra"],
                plain=conv_plain, **common)
        if kind == "stencil":
            return cuda_ops.McStage(
                kind=cuda_ops.MC_STENCIL, r=ss["extra"], taps=ss["op"].tables,
                plain=lambda ctx, tap: spec.mc_stencil_fn(ctx, tap, params), **common)
        descs = spec.images_in
        out_desc = node.outputs[0][1]
        return cuda_ops.McStage(
            kind=cuda_ops.MC_POINT, taps=ss["op"].tables,
            plain=lambda ctx, ins: spec(ctx, dict(zip(descs, ins)), params)[out_desc], **common)

    def _build_strip_program(self, device=None, row0: int = 0,
                             rows: Optional[int] = None) -> cuda_ops.StripProgram:
        """The single plan's op list, conv plans and coordinate planes, built
        once per program, device and slab: the device form of the
        reference's traced epilogue (program.py:1245-1266 there), keyed by
        the graph's structure and static params.  The hoisted planes hold
        ``rows`` rows from image row ``row0`` (default: the frame) on
        ``device`` (default: the program's)."""
        _tag, conv_items, pointwise = self._strip_plan
        device = self.device if device is None else torch.device(device)

        # Coordinate-plane hoist: data- and time-independent factors of
        # pointwise nodes (vignette's fade) are built once, here, for the
        # block's global rows.
        plane_nodes = [
            n for n in pointwise
            if n.spec.cw_coord_plane is not None and n.spec.cw_plane_fn is not None
        ]
        aux = None
        if plane_nodes:
            ctx0 = KernelContext(width=self.width, height=self.height, fmt=self.fmt, device=device,
                                 row_offset=row0, local_height=rows)
            aux = torch.stack(
                [n.spec.cw_coord_plane(ctx0, n.params).to(torch.float32) for n in plane_nodes]
            ).contiguous()
        plane_idx = {id(n): k for k, n in enumerate(plane_nodes)}

        slots, out_slot, _n = self._strip_slots(conv_items, pointwise)
        ops = []
        for k, (node, _plan) in enumerate(conv_items):
            code, params = node.spec.cw_op(node.params, False)

            def plain(ctx, ci, ins, plane, _node=node):
                return _node.spec.conv_epilogue_cw(ctx, ci, ins[0], ins[1], _node.params)

            ops.append(cuda_ops.StripOp(code, *slots[k], tuple(params), -1, plain))
        for node, (ins, out) in zip(pointwise, slots[len(conv_items):]):
            plane = plane_idx.get(id(node), -1)
            code, params = node.spec.cw_op(node.params, plane >= 0)
            descs = node.spec.images_in

            def plain(ctx, ci, vals, plane_v, _node=node, _descs=descs, _hoisted=plane >= 0):
                named = dict(zip(_descs, vals))
                if _hoisted:
                    return _node.spec.cw_plane_fn(ctx, ci, named, _node.params, plane_v)
                return _node.spec.cw_fn(ctx, ci, named, _node.params)

            ops.append(cuda_ops.StripOp(code, ins, out, tuple(params), plane, plain))
        return cuda_ops.StripProgram(
            plans=[plan for _, plan in conv_items],
            ops=ops,
            out_slot=out_slot,
            fmt=self.fmt,
            aux=aux,
        )

    def _strip_program_for(self, device, row0: int, rows: int) -> cuda_ops.StripProgram:
        """The StripProgram of a block on ``device``: the program's own for
        its frame on its device, else one built once per (device, block)
        and kept with the program's host build (a slab or a batch share on
        another card needs its planes there)."""
        device = _device_name(device)
        if device == _device_name(self.device) and row0 == 0 and rows == self.height:
            if self._strip_program is None:
                self._strip_program = self._build_strip_program()
            return self._strip_program
        key = (device, row0, rows)
        host = self._host
        with host.lock:
            strip = host.strip_blocks.get(key)
        if strip is None:
            strip = self._build_strip_program(device, row0, rows)
            with host.lock:
                strip = host.strip_blocks.setdefault(key, strip)
        return strip

    def _strip_fused_forward(self, file_input, t, row0_base: Optional[int] = None,
                             out: Optional[torch.Tensor] = None):
        """Run the whole graph as one graph_strip or graph_strip_mc kernel,
        or return None when the graph has no whole-graph strip plan.
        ``file_input`` is in storage type: the frame, or (``row0_base``) a
        slab of its rows whose first row is image row ``row0_base`` (the
        halo-sharded executor's, parallel/halo.py).  ``out``: where the
        kernel writes (the wrappers' ``out``)."""
        plan = self._strip_plan
        if plan is None or plan[0] == "segments":
            return None
        row0 = 0 if row0_base is None else int(row0_base)
        if plan[0] == "mc":
            if row0_base is None:  # a whole frame (not one slab of it)
                GLSL_GATHER_RUNS["op_list"] += len(self._gather_nodes())
            return cuda_ops.graph_strip_mc(file_input, t, plan[1], row0, out=out)
        rows = int(file_input.shape[1])
        strip = self._strip_program_for(file_input.device, row0, rows)
        return cuda_ops.graph_strip(file_input, t, strip, row0, self.height, out=out)

    def _segments_forward(self, x: torch.Tensor, t,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run a ``("segments", steps)`` plan: each segment's child kernel
        on its input in storage type, the other nodes per node.  Values
        between steps are in storage type either way, as per node.  A
        child's plan was fixed when it was taken, so a child with no kernel
        to run is a fault, not a cue to run per node.  ``out``: where the
        segment that writes the final output writes it."""
        resources: dict[str, Any] = {FILE_INPUT: x}
        ctx = self._ctx(t, x.device)
        for step in self._strip_plan[1]:
            if step[0] == "node":
                with trace.span("node", node=step[1].name):
                    resources.update(self._run_node(step[1], ctx, resources))
                continue
            _, child, r_in, r_out, nodes = step
            with trace.span("segment", nodes=len(nodes)):
                if out is not None and r_out == FINAL_OUTPUT:
                    value = child._strip_fused_forward(resources[r_in], t, out=out)
                else:
                    value = child._strip_fused_forward(resources[r_in], t)
            if value is None:
                raise GraphTraceError(
                    f"segment {[nd.name for nd in nodes]} has no strip plan at run time")
            resources[r_out] = value
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out

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
        if node.name in self._gather_nodes() and torch.device(ctx.device).type != "meta":
            GLSL_GATHER_RUNS["interpreter"] += 1
        outs = node.spec(ctx, images, node.params)
        written = {}
        for res, desc in node.outputs:
            if desc not in outs:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' did not produce declared output "
                    f"'{desc}' (produced: {', '.join(outs)})"
                )
            value = outs[desc]
            if desc in node.spec.ssbos_out:
                # A storage buffer: 1-D f32 of the graph's size for the
                # resource, never cast to the storage type or quantized.
                expected_len = self.graph.buffer_sizes.get(res, value.shape[-1])
                if tuple(value.shape) != (expected_len,):
                    raise GraphTraceError(
                        f"kernel '{node.spec.name}' buffer output '{desc}' has shape "
                        f"{tuple(value.shape)}, expected ({expected_len},)"
                    )
                written[res] = value.to(torch.float32)
                continue
            expected = (4,) + ctx.local_shape
            if tuple(value.shape) != expected:
                raise GraphTraceError(
                    f"kernel '{node.spec.name}' output '{desc}' has shape "
                    f"{tuple(value.shape)}, expected {expected}"
                )
            written[res] = self.store_output(value)
        return written

    def _forward(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        """One frame in storage type.  Inside ``render_sequence``'s stacked
        loop the strip kernel that writes the final output writes the
        frame's slice (``_frame_out``) and that slice is returned."""
        x = file_input.to(self.storage_dtype)
        plan = self._strip_plan
        out = getattr(self._frame_out, "out", None)
        with trace.span("forward") as sp:
            if sp is not None:
                sp.attrs["tier"] = plan[0] if plan else "per-node"
            if plan is not None and plan[0] == "segments":
                return self._segments_forward(x, t, out)
            strip = self._strip_fused_forward(x, t, out=out)
            if strip is not None:
                return strip
            return self._forward_layers({FILE_INPUT: x}, self._ctx(t, x.device))

    def _forward_nostrip(self, file_input: torch.Tensor, t: float) -> torch.Tensor:
        """Per-node path only, with same-input conv bundles."""
        x = file_input.to(self.storage_dtype)
        return self._forward_layers({FILE_INPUT: x}, self._ctx(t, x.device))

    def _check_shapes(self) -> int:
        """Run each node once on ``meta`` tensors (shapes only, no data, no
        kernel launch), in execution order, and return how many ran: a node
        whose check key passed before takes its outputs from the memo
        (reference: the per-node cache, ``_node_fn``, program.py:1544-1590).
        Raises GraphTraceError, or the kernel's own error, on a bad node."""
        meta = torch.device("meta")
        ctx = self._ctx(0.0, meta)
        resources: dict[str, Any] = {
            FILE_INPUT: torch.empty((4, self.height, self.width), dtype=self.storage_dtype,
                                    device=meta)}
        ran = 0
        for node in self.graph.ordered_nodes:
            key = _node_key(node, self.graph, self.width, self.height, self.fmt)
            hit = _NODE_CHECKS.get(key)
            if hit is None:
                written = self._run_node(node, ctx, resources)
                ran += 1
                remember(_NODE_CHECKS, _NODE_CHECKS_MAX, key, (node.spec, written))
            else:
                written = hit[1]
            resources.update(written)
        if FINAL_OUTPUT not in resources:
            raise GraphTraceError("no node wrote the final output")
        return ran

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
        reference's rule: its bf16 convs took the MXU entry point), and so
        do heavy convs (the x3 entry point) and convs with a pre-map,
        whose conv does not read the node's input."""
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
                and spec.conv_pre is None
                and spec.border_for(node.params) == "edge"
            ):
                plan = spec.conv_weights(node.params)
            if plan is not None and not 4 <= len(plan[0]) + len(plan[1]) < X3_MIN_TAPS:
                plan = None  # degenerate (identity) and heavy convs run as plain nodes
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
        ``stack``.  Stacked, frame i's strip kernel writes ``frames[i]``
        itself; a frame whose final output comes from a per-node step, or
        whose slice the kernels' stores cannot take (``out_aligned``), is
        copied there (``SEQUENCE_FRAMES`` counts each frame once).
        Launches are queued without waiting on the device."""
        if n < 1:
            raise ValueError("render_sequence needs n >= 1")
        with trace.span("sequence", n=n):
            if not stack:
                out = None
                for i in range(n):
                    out = self._forward(file_input, float(t0) + i * float(dt))
                return out
            frames = torch.empty((n, 4, self.height, self.width), dtype=self.storage_dtype,
                                 device=file_input.device)
            for i in range(n):
                slot = frames[i]
                self._frame_out.out = slot if cuda_ops.out_aligned(slot) else None
                try:
                    frame = self._forward(file_input, float(t0) + i * float(dt))
                finally:
                    self._frame_out.out = None
                if frame is slot:
                    SEQUENCE_FRAMES["in_place"] += 1
                    continue
                with trace.span("sequence.stack"):
                    slot.copy_(frame)
                SEQUENCE_FRAMES["copied"] += 1
            return frames

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
        self, file_input: torch.Tensor, t: float, check_nans: bool = False
    ) -> tuple[torch.Tensor, dict[str, float]]:
        """Execute node by node, timing each node on the host clock after
        the device has finished it.  Returns (final_output, {node: ms})
        (reference: per-pipeline GPU timestamps, vkutils.rs:104-134).
        ``check_nans`` raises FloatingPointError at the first node whose
        output holds a NaN, naming it."""
        x = file_input.to(self.storage_dtype)
        resources: dict[str, Any] = {FILE_INPUT: x}
        ctx = self._ctx(t, x.device)
        times: dict[str, float] = {}
        _sync(x.device)
        for node in self.graph.ordered_nodes:
            start = _time.perf_counter()
            written = self._run_node(node, ctx, resources)
            _sync(x.device)
            times[node.name] = (_time.perf_counter() - start) * 1000.0
            if check_nans and any(bool(torch.isnan(v).any()) for v in written.values()):
                raise FloatingPointError(f"NaN in the output of node '{node.name}'")
            resources.update(written)
        out = resources.get(FINAL_OUTPUT)
        if out is None:
            raise GraphTraceError("no node wrote the final output")
        return out, times


def make_program(
    graph: BuiltGraph, width: int, height: int, fmt: str = "rgba32f",
    plan_strips: bool = True, device: Any = "cuda",
) -> Optional[GraphProgram]:
    """Build a GraphProgram on ``device`` (the card unless the caller names
    the CPU; raises without one) and check its wiring and shapes.

    Each node runs once on ``meta`` tensors (``_check_shapes``): the analog
    of the reference's ``jax.eval_shape`` check, so a bad edit is rejected
    before any frame renders.  A graph signature this process has checked
    before skips the check and shares that program's plan (reference:
    ``compile_cached``, program.py:1524-1532 and :1634-1638)."""
    program = GraphProgram(graph, width, height, fmt, device=device, plan_strips=plan_strips)
    key = program._program_key()
    hit = _PROGRAMS.get(key)
    if hit is not None:
        program._host = hit[1]
        program.from_cache = True
        return program
    try:
        program.nodes_checked = program._check_shapes()
    except GraphTraceError as e:
        warnln(f"Graph build failed: {e}")
        return None
    except Exception as e:  # a kernel that cannot run on these shapes
        warnln(f"Graph build failed while checking kernels: {e}")
        return None
    specs = tuple(n.spec for n in graph.ordered_nodes)
    remember(_PROGRAMS, _PROGRAMS_MAX, key, (specs, program._host))
    return program
