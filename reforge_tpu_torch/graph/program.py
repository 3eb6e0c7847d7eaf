"""GraphProgram: run a built graph on one device (the port of
``reforge_tpu/graph/program.py``: the per-node tier and the single and mc
strip tiers).

Execution modes:
  * ``__call__`` / ``_forward`` -- a strip tier when the graph qualifies,
    tried in the reference's order:
      - single: every conv reads the input and every other node is
        channel-local; the whole graph in one ``graph_strip`` kernel.
      - mc: convs of any image, small-radius stencils (sharpen, sobel,
        emboss, median3), channel-mixing point nodes and GLSL shaders whose
        body is an affine tap-sum (glsl/affine.py); the whole graph in one
        ``graph_strip_mc`` kernel.
    Otherwise layer by layer, with same-input convs of a layer bundled
    into one ``sep_conv_fused_multi`` launch; stencils run as
    ``stencil_apply`` and heavy f32 convs as ``sep_conv_fused_mxu_x3``.
  * ``run_unfused`` / ``run_per_node`` -- node by node, the second timing
    each node.
  * ``render_sequence`` -- a Python loop of ``_forward`` over frame times.

The planners keep the reference's structural gates and drop the gates
that modelled the TPU (VMEM tile models, lane-multiple widths, MXU
eligibility, transpose variants, ``REFORGE_STRIP_*``/``REFORGE_MC_*``
knobs).  A plan whose kernel fits no shared-memory tile is refused when
it is planned.  The segments tier is not ported: a graph that needs it
runs per node.
"""

from __future__ import annotations

import time as _time
from typing import Any, Optional

import numpy as np
import torch

from ..config import FILE_INPUT, FINAL_OUTPUT
from ..glsl.affine import ConvSynth, StencilSynth, compose, synthesize_conv
from ..kernels import cuda_ops
from ..kernels.base import KernelContext, quantize_rgba8
from ..kernels.ops import X3_MIN_TAPS
from ..utils import warnln
from .builder import BuiltGraph, PipelineNode


class GraphTraceError(Exception):
    pass


# Structural gates of the mc tier: conv taps (H + W) and stencil radius.
MC_MAX_TAPS = 200
MC_MAX_RADIUS = cuda_ops.STENCIL_MAX_RADIUS
_MC_KINDS = {"conv": cuda_ops.MC_CONV, "stencil": cuda_ops.MC_STENCIL, "point": cuda_ops.MC_POINT}


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
        device: Any = "cuda",
        plan_strips: bool = True,
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
        as one graph_strip kernel, else ``("mc", McProgram)`` when it can
        run as one graph_strip_mc kernel, else None (per-node
        execution)."""
        single = self._plan_strip_single()
        if single is not None:
            return ("single",) + single
        mc = self._plan_strip_mc()
        if mc is not None:
            return ("mc", mc)
        return None

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

    def _plan_strip_mc(self) -> Optional[cuda_ops.McProgram]:
        """The mc tier's stage list (the port of the reference's
        ``_plan_strip_mc``, program.py:339-967), or None.

        Node classes: separable edge convs of any image (4 to 200 taps,
        optionally after a node-internal pre-map such as bloom's mask),
        stencils of radius 1..16 with one input, and point nodes of halo
        0.  Every builtin node needs an ``mc_op`` whose kind matches its
        class; a GLSL node needs a synthesized affine tap-sum
        (``_glsl_synth``).  The plan needs at least one conv or stencil.  Each resource is
        computed over the tile plus the extent its consumers read around
        it (a reverse-topological lift, exact); pool slots are reused by
        linear scan."""
        nodes: list = []
        synth_of: dict[str, Any] = {}  # GLSL node -> its ConvSynth / StencilSynth
        n_heavy = 0
        for layer in self.graph.layers:
            for node in layer:
                spec = node.spec
                if len(node.outputs) != 1 or spec.ssbos_in or spec.ssbos_out:
                    return None
                if spec.source_hash is not None:
                    # A GLSL node: only an affine tap-sum (halo >= 1, one
                    # input) has a device form here.  A point shader has
                    # none (the reference traces the interpreter into its
                    # kernel; a CUDA kernel takes no closure), so its graph
                    # runs per node.
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
        if n_heavy == 0:
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
        prog = cuda_ops.McProgram(
            stages=stages, n_slots=n_slots, rh_in=eh[FILE_INPUT], ew_in=ew[FILE_INPUT],
            width=self.width, height=self.height, fmt=self.fmt,
        )
        if prog.tile() is None:
            return None  # no shared-memory tile holds this plan: run per node
        return prog

    def _glsl_synth(self, node):
        """The affine tap-sum of a one-input GLSL node of halo >= 1 with an
        edge border that fits the mc tier (glsl/affine.py), or None.  A
        wide frame's conv-idiom shader that cannot join warns, as in the
        reference (program.py:478-496 there)."""
        spec, params = node.spec, node.params
        halo = spec.halo_for(params) or 0
        got = None
        if len(node.inputs) == 1 and halo >= 1:
            got = synthesize_conv(spec, params)
        if isinstance(got, ConvSynth) and not 4 <= len(got.wh) + len(got.ww) <= MC_MAX_TAPS:
            got = None
        if isinstance(got, StencilSynth) and (got.radius > MC_MAX_RADIUS or got.scale[3] != 0.0):
            got = None  # the stencil stage sums the colour channels only
        if got is not None and got.border != "edge":
            got = None  # the port has no zero-border plans
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
        """Run the whole graph as one graph_strip or graph_strip_mc kernel,
        or return None when the graph has no strip plan.  ``file_input``
        is in storage type."""
        if self._strip_plan is None:
            return None
        if self._strip_plan[0] == "mc":
            return cuda_ops.graph_strip_mc(file_input, t, self._strip_plan[1])
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
    plan_strips: bool = True, device: Any = "cuda",
) -> Optional[GraphProgram]:
    """Build a GraphProgram on ``device`` (the card unless the caller names
    the CPU; raises without one) and check its wiring and shapes.

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
