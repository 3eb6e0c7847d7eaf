"""Semantic pass: AST -> Config (per-node input/output resource lists).

Re-implements the reference's semantic pass (src/config/config.rs:98-205)
with identical naming rules:

  * A chain ``a -> b:tex -> c`` gives node ``b`` one input
    ``{resource: "a:output_image", descriptor: "tex"}`` and one output
    ``{resource: "b:tex", descriptor: "tex"}`` — the ``:tex`` annotation names
    both the annotated node's input binding and its output resource
    (config.rs:164-189).
  * The ``input`` / ``output`` endpoints are not nodes; they map neighbours to
    the sentinels ``rf:file-input`` / ``rf:final-output``
    (src/vulkan/pipeline_graph.rs:22-23).
  * Validation: empty graph, ``input`` present without an input image, and a
    missing ``output`` are errors (config.rs:200-203); callers get ``None``
    and a warning, preserving keep-last-good reload semantics.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from . import ast
from .parser import ConfigParseError, parse_exprs
from ..utils import warnln

# Sentinel resource names (reference: src/vulkan/pipeline_graph.rs:22-23).
FILE_INPUT = "rf:file-input"
FINAL_OUTPUT = "rf:final-output"

SHADER_EXTENSIONS = (".comp", ".frag", ".py")


@dataclasses.dataclass(frozen=True)
class ConfigDescriptor:
    """resource_name -> descriptor_name binding request (config.rs:17-20)."""

    resource_name: str
    descriptor_name: str


@dataclasses.dataclass
class GraphPipeline:
    """Per-node wiring discovered from the graph chains (config.rs:23-28)."""

    inputs: list[ConfigDescriptor] = dataclasses.field(default_factory=list)
    outputs: list[ConfigDescriptor] = dataclasses.field(default_factory=list)
    # Path to the node's kernel source (.comp GLSL or .py), or "" when the
    # node resolves to a builtin library kernel.
    file_path: str = ""


@dataclasses.dataclass
class PipelineInstance:
    pipeline_type: str
    parameters: dict[str, ast.ParamValue]


@dataclasses.dataclass
class Config:
    graph_pipelines: dict[str, GraphPipeline]
    pipeline_instances: dict[str, PipelineInstance]

    def pipeline_type_of(self, name: str) -> str:
        """Instance type if declared, else the node name itself (config.rs:59-75)."""
        inst = self.pipeline_instances.get(name)
        return inst.pipeline_type if inst is not None else name

    def parameters_of(self, name: str) -> dict[str, ast.ParamValue]:
        inst = self.pipeline_instances.get(name)
        return inst.parameters if inst is not None else {}


def parse(contents: str, expects_input: bool) -> Optional[Config]:
    """Parse config text into a Config, or None (with warnings) on error."""
    if not contents.strip():
        warnln("Empty configuration given to parse")
        return None

    try:
        exprs = parse_exprs(contents)
    except ConfigParseError as err:
        for msg in err.messages:
            warnln(msg)
        return None

    graph_pipelines: dict[str, GraphPipeline] = {}
    pipeline_instances: dict[str, PipelineInstance] = {}
    found_input = False
    found_output = False

    for expr in exprs:
        if isinstance(expr, ast.PipelineDecl):
            pipeline_instances[expr.name] = PipelineInstance(
                pipeline_type=expr.pipeline_type, parameters=dict(expr.parameters)
            )
            continue
        assert isinstance(expr, ast.GraphExpr)
        chain = expr.members
        for i, member in enumerate(chain):
            if member.name == "input":
                found_input = True
                continue
            if member.name == "output":
                found_output = True
                continue
            info = graph_pipelines.setdefault(member.name, GraphPipeline())

            if i > 0:
                prev = chain[i - 1]
                descriptor_name = member.descriptor or "input_image"
                if prev.name == "input":
                    resource_name = FILE_INPUT
                else:
                    resource_name = f"{prev.name}:{prev.descriptor or 'output_image'}"
                desc = ConfigDescriptor(resource_name, descriptor_name)
                if desc not in info.inputs:
                    info.inputs.append(desc)

            if i + 1 < len(chain):
                nxt = chain[i + 1]
                descriptor_name = member.descriptor or "output_image"
                if nxt.name == "output":
                    resource_name = FINAL_OUTPUT
                else:
                    resource_name = f"{member.name}:{descriptor_name}"
                desc = ConfigDescriptor(resource_name, descriptor_name)
                if desc not in info.outputs:
                    info.outputs.append(desc)

    if not graph_pipelines:
        warnln("Configuration had an empty graph")
        return None
    if found_input and not expects_input:
        warnln("Found 'input' in pipeline configuration but no input image was specified")
        return None
    if not found_output:
        warnln("'output' is never used in the pipeline configuration")
        return None

    return Config(graph_pipelines, pipeline_instances)


def _resolve_kernel_path(shader_path: str, pipeline_type: str) -> str:
    """Find the kernel source file for a pipeline type, or "" for builtins.

    The reference always points at ``{shader_path}/{type}.comp``
    (config.rs:59-75); we additionally probe ``.py`` kernel modules and fall
    back to the builtin kernel registry when no file exists.
    """
    for ext in SHADER_EXTENSIONS:
        candidate = os.path.join(shader_path, pipeline_type + ext)
        if os.path.exists(candidate):
            return candidate
    return ""


def add_file_paths(config: Config, shader_path: str) -> Config:
    for name, pipeline in config.graph_pipelines.items():
        if not pipeline.file_path:
            pipeline.file_path = _resolve_kernel_path(
                shader_path, config.pipeline_type_of(name)
            )
    return config


def parse_file(contents: str, expects_input: bool, shader_path: str) -> Optional[Config]:
    config = parse(contents, expects_input)
    if config is None:
        return None
    return add_file_paths(config, shader_path)


def single_shader_parse(path: str, expects_input: bool) -> Optional[Config]:
    """Build a config for a single kernel file (reference: config.rs:77-90).

    ``rf blur.comp -i in.jpg`` behaves as the config ``input -> blur -> output``
    with the node's kernel path pinned to the given file.
    """
    name = os.path.splitext(os.path.basename(path))[0]
    text = f"input -> {name} -> output" if expects_input else f"{name} -> output"
    config = parse(text, expects_input)
    if config is None:
        return None
    config.graph_pipelines[name].file_path = path
    return config
