"""Graph synthesis: Config + kernel reflection -> validated node graph (the
port of ``reforge_tpu/graph/builder.py``, unchanged in behaviour).

  1. Resolve each node's kernel and match the config's descriptor names
     against its declared bindings; unknown names warn and fail the build
     (keep-last-good).
  2. Resolve static parameters against declared params.
  3. Kahn-layer the nodes by resource dependencies, with cycle detection
     (reference: src/vulkan/pipeline_graph.rs:429-497).  Independent nodes
     share a layer; same-input convs of one layer run as one bundle.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..config import Config, FILE_INPUT, FINAL_OUTPUT
from ..kernels.base import KernelSpec
from ..kernels.loader import resolve_kernel
from ..utils import warnln


@dataclasses.dataclass
class PipelineNode:
    name: str
    spec: KernelSpec
    # (resource_name, descriptor_name) pairs, in config order.
    inputs: list[tuple[str, str]]
    outputs: list[tuple[str, str]]
    params: dict[str, Any]

    @property
    def halo(self) -> Optional[int]:
        return self.spec.halo_for(self.params)


@dataclasses.dataclass
class BuiltGraph:
    nodes: dict[str, PipelineNode]
    layers: list[list[PipelineNode]]  # topological layers, execution order
    # resource -> "image" | "buffer", and sizes for buffer resources
    # (max across users, like the reference's SSBO union sizing,
    # pipeline_graph.rs:158-175).
    resource_kinds: dict[str, str] = dataclasses.field(default_factory=dict)
    buffer_sizes: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ordered_nodes(self) -> list[PipelineNode]:
        return [n for layer in self.layers for n in layer]

    def uses_file_input(self) -> bool:
        return any(
            res == FILE_INPUT for n in self.nodes.values() for res, _ in n.inputs
        )


def build_graph(config: Config) -> Optional[BuiltGraph]:
    nodes: dict[str, PipelineNode] = {}
    for name, gp in config.graph_pipelines.items():
        ptype = config.pipeline_type_of(name)
        spec = resolve_kernel(ptype, gp.file_path)
        if spec is None:
            return None

        # Match config descriptor names against reflected kernel bindings —
        # images first, then SSBOs, as the reference does
        # (vkutils.rs:160-183: unknown names are a build error).
        for desc in (d.descriptor_name for d in gp.inputs):
            if desc not in spec.inputs_all:
                warnln(
                    f"Unable to find input descriptor '{desc}' in kernel "
                    f"'{spec.name}' (declares: {', '.join(spec.inputs_all) or 'none'})"
                )
                return None
        for desc in (d.descriptor_name for d in gp.outputs):
            if desc not in spec.outputs_all:
                warnln(
                    f"Unable to find output descriptor '{desc}' in kernel "
                    f"'{spec.name}' (declares: {', '.join(spec.outputs_all) or 'none'})"
                )
                return None

        # Every declared input binding must be wired or the kernel would read
        # undefined memory (the reference leaves such descriptors unbound and
        # relies on validation-layer noise; we reject up front).  Exception:
        # an SSBO the SAME shader also writes (the single-node meter /
        # flag-mask idiom — atomics plus a read-back) self-initializes to
        # zeros when no upstream edge feeds it, exactly as a written-only
        # buffer does.
        wired = {d.descriptor_name for d in gp.inputs}
        missing = [
            d for d in spec.inputs_all
            if d not in wired and d not in spec.ssbos_out
        ]
        if missing:
            warnln(
                f"Input binding(s) {', '.join(repr(m) for m in missing)} of node "
                f"'{name}' are not connected in the graph"
            )
            return None

        params = spec.resolve_params(config.parameters_of(name))
        nodes[name] = PipelineNode(
            name=name,
            spec=spec,
            inputs=list((d.resource_name, d.descriptor_name) for d in gp.inputs),
            outputs=list((d.resource_name, d.descriptor_name) for d in gp.outputs),
            params=params,
        )

    kinds, sizes = _resolve_resource_kinds(nodes)
    if kinds is None:
        return None
    layers = _order_by_execution(nodes)
    if layers is None:
        return None
    return BuiltGraph(
        nodes=nodes, layers=layers, resource_kinds=kinds, buffer_sizes=sizes
    )


def _resolve_resource_kinds(nodes: dict[str, PipelineNode]):
    """Classify each resource as image or buffer and size the buffers.

    A resource's kind comes from the bindings that touch it; mixing image
    and buffer bindings on one resource is a wiring error.  Buffer sizes
    take the maximum any user declares.
    """
    kinds: dict[str, str] = {FILE_INPUT: "image", FINAL_OUTPUT: "image"}
    sizes: dict[str, int] = {}
    for n in nodes.values():
        spec = n.spec
        for res, desc in list(n.outputs) + list(n.inputs):
            kind = "buffer" if desc in spec.ssbos_in + spec.ssbos_out else "image"
            prev = kinds.get(res)
            if prev is not None and prev != kind:
                warnln(
                    f"Resource '{res}' is wired as both an image and a "
                    f"buffer (node '{n.name}', binding '{desc}')"
                )
                return None, None
            kinds[res] = kind
            if kind == "buffer":
                declared = spec.ssbo_sizes.get(desc, 0)
                sizes[res] = max(sizes.get(res, 0), int(declared))
    for res, kind in kinds.items():
        if kind == "buffer" and sizes.get(res, 0) <= 0:
            warnln(f"Buffer resource '{res}' has no declared size")
            return None, None
    return kinds, sizes


def _order_by_execution(
    nodes: dict[str, PipelineNode]
) -> Optional[list[list[PipelineNode]]]:
    """Kahn-style layering with cycle detection (pipeline_graph.rs:429-497)."""
    producers: dict[str, str] = {}
    for n in nodes.values():
        for res, _ in n.outputs:
            if res != FINAL_OUTPUT:
                producers[res] = n.name

    deps: dict[str, set[str]] = {name: set() for name in nodes}
    for n in nodes.values():
        for res, _ in n.inputs:
            if res == FILE_INPUT:
                continue
            producer = producers.get(res)
            if producer is None:
                warnln(
                    f"Node '{n.name}' reads resource '{res}' which no node produces"
                )
                return None
            if producer != n.name:
                deps[n.name].add(producer)

    layers: list[list[PipelineNode]] = []
    remaining = dict(deps)
    done: set[str] = set()
    while remaining:
        ready = sorted(name for name, d in remaining.items() if d <= done)
        if not ready:
            cyclic = ", ".join(sorted(remaining))
            warnln(f"Pipeline graph has a cycle involving: {cyclic}")
            return None
        layers.append([nodes[name] for name in ready])
        done.update(ready)
        for name in ready:
            del remaining[name]
    return layers
