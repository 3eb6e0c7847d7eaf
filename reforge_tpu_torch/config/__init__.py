"""Pipeline-config DSL: lexer, parser, and semantic pass.

A copy of ``reforge_tpu/config/`` (which imports no jax), kept inside the
PyTorch package so that the port and its smoke script load nothing of the
JAX package.  tests/test_torch_graph.py holds both parsers to the same
result.  Grammar and semantics: the reference's src/config/.
"""

from .ast import GraphExpr, GraphMember, ParamValue, PipelineDecl
from .parser import ConfigParseError, parse_exprs
from .semantics import (
    FILE_INPUT,
    FINAL_OUTPUT,
    Config,
    ConfigDescriptor,
    GraphPipeline,
    PipelineInstance,
    add_file_paths,
    parse,
    parse_file,
    single_shader_parse,
)

__all__ = [
    "GraphExpr",
    "GraphMember",
    "ParamValue",
    "PipelineDecl",
    "ConfigParseError",
    "parse_exprs",
    "FILE_INPUT",
    "FINAL_OUTPUT",
    "Config",
    "ConfigDescriptor",
    "GraphPipeline",
    "PipelineInstance",
    "add_file_paths",
    "parse",
    "parse_file",
    "single_shader_parse",
]
