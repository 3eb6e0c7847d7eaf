"""GLSL AST node types (expression + statement + declaration nodes)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


# ---- expressions --------------------------------------------------------


@dataclasses.dataclass
class Num:
    value: Any  # int | float
    is_float: bool
    line: int = 0
    is_uint: bool = False  # 123u / 0xFFu literal


@dataclasses.dataclass
class BoolLit:
    value: bool
    line: int = 0


@dataclasses.dataclass
class Ident:
    name: str
    line: int = 0


@dataclasses.dataclass
class Unary:
    op: str  # '-', '!', '~', '++pre', '--pre', '++post', '--post'
    expr: Any
    line: int = 0


@dataclasses.dataclass
class Binary:
    op: str
    left: Any
    right: Any
    line: int = 0


@dataclasses.dataclass
class Assign:
    op: str  # '=', '+=', ...
    target: Any  # Ident | Member | Index
    value: Any
    line: int = 0


@dataclasses.dataclass
class Ternary:
    cond: Any
    then: Any
    other: Any
    line: int = 0


@dataclasses.dataclass
class Call:
    name: str
    args: list
    line: int = 0


@dataclasses.dataclass
class Member:
    expr: Any
    name: str  # swizzle or struct member
    line: int = 0


@dataclasses.dataclass
class Index:
    expr: Any
    index: Any
    line: int = 0


@dataclasses.dataclass
class ArrayLit:
    """float[](a, b, c) — constructor of array type."""

    elem_type: str
    size: Optional[int]
    elems: list
    line: int = 0


# ---- statements ---------------------------------------------------------


@dataclasses.dataclass
class Decl:
    type: str  # 'float', 'vec4', ...
    name: str
    init: Any  # expression or None
    array_size: Optional[Any] = None  # expression or None
    is_const: bool = False
    line: int = 0
    # Vulkan specialization constant id (`layout(constant_id = N) const ...`).
    # The reference creates pipelines with no VkSpecializationInfo
    # (pipeline.rs:44-88), so the GLSL default initializer always applies;
    # here the default additionally surfaces as a config-settable parameter
    # (static at trace time, like every UBO param in this framework).
    spec_id: Optional[int] = None


@dataclasses.dataclass
class DeclList:
    """`float a = 1.0, b, c = a;` — one Decl per declarator, executed in
    order in the CURRENT scope (no block scope, unlike ast.Block)."""

    decls: list
    line: int = 0


@dataclasses.dataclass
class ExprStmt:
    expr: Any
    line: int = 0


@dataclasses.dataclass
class If:
    cond: Any
    then: list
    other: Optional[list]
    line: int = 0


@dataclasses.dataclass
class For:
    init: Any  # Decl | ExprStmt | None
    cond: Any
    update: Any
    body: list
    line: int = 0


@dataclasses.dataclass
class While:
    cond: Any
    body: list
    line: int = 0


@dataclasses.dataclass
class DoWhile:
    cond: Any
    body: list
    line: int = 0


@dataclasses.dataclass
class Switch:
    selector: Any
    # [(case_values, body)]; a value of None is `default`.  Fall-through is
    # honored for uniform selectors (the only supported kind).
    cases: list = dataclasses.field(default_factory=list)
    line: int = 0


@dataclasses.dataclass
class Return:
    value: Any  # expression or None
    line: int = 0


@dataclasses.dataclass
class Break:
    line: int = 0


@dataclasses.dataclass
class Continue:
    line: int = 0


@dataclasses.dataclass
class Discard:
    line: int = 0


@dataclasses.dataclass
class Block:
    body: list
    line: int = 0


# ---- top-level declarations --------------------------------------------


@dataclasses.dataclass
class LayoutQual:
    """Parsed layout(...) qualifier items, e.g. {"binding": 0, "rgba8": None}."""

    items: dict


@dataclasses.dataclass
class ImageDecl:
    name: str
    binding: int
    format: Optional[str]  # 'rgba8' | 'rgba32f' | ...
    readonly: bool
    writeonly: bool
    sampled: bool = False  # sampler2D (texture() reads) vs storage image
    line: int = 0


@dataclasses.dataclass
class UboMember:
    type: str
    name: str
    array_size: Optional[int] = None
    # `float data[];` — a runtime-sized trailing array (std430).  Sized by
    # the allocated buffer at run time; see docs/glsl.md "SSBO blocks".
    runtime_array: bool = False


@dataclasses.dataclass
class UboDecl:
    block_name: str
    binding: int
    members: list  # of UboMember
    instance_name: Optional[str] = None
    line: int = 0


@dataclasses.dataclass
class SsboDecl:
    block_name: str
    binding: int
    members: list  # of UboMember
    instance_name: Optional[str] = None
    readonly: bool = False
    writeonly: bool = False
    line: int = 0


@dataclasses.dataclass
class Param:
    type: str
    name: str
    qualifier: str = "in"  # in | out | inout
    array_size: Optional[int] = None


@dataclasses.dataclass
class FuncDecl:
    return_type: str
    name: str
    params: list  # of Param
    body: list
    line: int = 0


@dataclasses.dataclass
class GlobalDecl:
    decl: Decl


@dataclasses.dataclass
class Shader:
    """A parsed shader translation unit (compute or fragment stage)."""

    local_size: tuple[int, int, int]
    images: list  # of ImageDecl
    ubos: list  # of UboDecl
    ssbos: list  # of SsboDecl
    globals: list  # of Decl (const globals etc.)
    functions: dict  # name -> FuncDecl
    stage: str = "compute"  # "compute" | "fragment"
    # Fragment-stage interface variables: `out vec4 color;` becomes the
    # node's output_image (the reference's frag output_image exemption,
    # vkutils.rs:175-177); `in vec2 uv;` receives normalized coordinates.
    frag_outputs: list = dataclasses.field(default_factory=list)  # names
    frag_inputs: list = dataclasses.field(default_factory=list)  # (type, name)
    structs: dict = dataclasses.field(default_factory=dict)  # name -> [(type, field)]
    # Workgroup-shared arrays: (elem_type, name, size, line) tuples.
    shared: list = dataclasses.field(default_factory=list)
