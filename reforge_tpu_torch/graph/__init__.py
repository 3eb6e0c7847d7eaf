"""Graph layer: synthesis and execution (the port of ``reforge_tpu/graph/``)."""

from .builder import BuiltGraph, PipelineNode, build_graph
from .program import GraphProgram, GraphTraceError, make_program
from .reference import graph_from_reference

__all__ = [
    "BuiltGraph",
    "PipelineNode",
    "build_graph",
    "GraphProgram",
    "GraphTraceError",
    "make_program",
    "graph_from_reference",
]
