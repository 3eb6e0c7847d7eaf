"""AST node types for the pipeline-config DSL.

Mirrors the reference AST (reference: src/config/ast.rs:4-17): a config file
is a list of expressions, each either a *graph chain* (``a -> b:desc -> c``)
or a *pipeline-instance declaration* (``name: type { key: value, ... }``).
Comments are skipped by the lexer rather than surfaced as AST nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class GraphMember:
    """One member of a graph chain: a node name plus optional descriptor.

    ``blur:tex`` parses to ``GraphMember("blur", "tex")``.  The descriptor
    annotation names both the member's input binding and its output resource
    (see semantics.py; reference: src/config/config.rs:164-189).
    """

    name: str
    descriptor: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class GraphExpr:
    """A chain ``a -> b -> c`` (always at least two members)."""

    members: tuple[GraphMember, ...]


@dataclasses.dataclass(frozen=True)
class PipelineDecl:
    """``name: type { sigma: 32, enabled: true }``.

    Parameter values keep both their typed Python value and the original
    source string (the reference stores strings and re-parses them against
    the reflected UBO member type — src/config/config.rs:32,
    src/render.rs:167-186).
    """

    name: str
    pipeline_type: str
    parameters: dict[str, "ParamValue"]


@dataclasses.dataclass(frozen=True)
class ParamValue:
    raw: str
    value: Union[int, float, bool]


Expr = Union[GraphExpr, PipelineDecl]
