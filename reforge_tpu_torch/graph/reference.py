"""Carry a graph built by the JAX package over to the port.

The engine has no learned weights: what two renders of one config share is
each node's resolved parameters and, for conv nodes, the numpy tap
vectors.  ``graph_from_reference`` rebuilds a ``reforge_tpu`` BuiltGraph
from exactly those, checking that the port's builtins derive the same tap
vectors bit for bit.  It reads the reference graph's attributes only and
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from .builder import BuiltGraph, PipelineNode, _order_by_execution, _resolve_resource_kinds
from ..kernels.base import lookup_builtin


def graph_from_reference(ref_graph) -> BuiltGraph:
    """The port's BuiltGraph for a ``reforge_tpu.graph.BuiltGraph``: the same
    nodes, wiring and resolved params, on the port's builtins.  Raises
    ValueError for a kernel the port lacks or for tap vectors that differ."""
    nodes: dict[str, PipelineNode] = {}
    for name, ref in ref_graph.nodes.items():
        spec = lookup_builtin(ref.spec.name)
        if spec is None or ref.spec.source_path is not None:
            raise ValueError(f"node '{name}': kernel '{ref.spec.name}' is not ported")
        params = dict(ref.params)
        if set(params) != set(spec.params):
            raise ValueError(f"node '{name}': params {sorted(params)} != {sorted(spec.params)}")
        if ref.spec.conv_weights is not None:
            want = ref.spec.conv_weights(params)
            got = spec.conv_weights(params) if spec.conv_weights is not None else None
            if (want is None) != (got is None) or (
                want is not None
                and not all(
                    np.asarray(a).dtype == np.asarray(b).dtype
                    and np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(want, got)
                )
            ):
                raise ValueError(f"node '{name}': conv tap vectors differ from the reference")
        nodes[name] = PipelineNode(
            name=name, spec=spec, inputs=list(ref.inputs), outputs=list(ref.outputs),
            params=params,
        )
    kinds, sizes = _resolve_resource_kinds(nodes)
    layers = _order_by_execution(nodes)
    if kinds is None or layers is None:
        raise ValueError("the reference graph does not build in the port")
    return BuiltGraph(nodes=nodes, layers=layers, resource_kinds=kinds, buffer_sizes=sizes)
