"""Vectorizing GLSL interpreter: per-pixel programs -> whole-image torch ops
(the port of ``reforge_tpu/glsl/interp.py``).

The interpreter walks the shader AST once with whole-image tensors standing
in for per-pixel scalars, eagerly, on the program's device.  Semantics of
the mapping, as in the reference:
  * a GLSL ``float``/``int``/``uint``/``bool`` value is a Python scalar when
    uniform (literals, UBO params, imageSize) or a tensor when it varies per
    pixel (``(H, W)``) or per frame (the 0-d frame time); vectors are lists
    of such components.  Tensors hold ``float`` as float32, ``int`` as
    int32, ``bool`` as bool and ``uint`` as int64 in [0, 2**32): PyTorch
    has no full uint32 arithmetic, so every uint result is masked back to
    32 bits, as ``kernels/prng.py`` does.  Conversions follow XLA's (float
    to int truncates and saturates, NaN gives 0).
  * ``gl_GlobalInvocationID.xy`` carries a symbolic *origin*; ``imageLoad``
    at the pixel plus a static offset is a shifted copy with zero or edge
    padding, anything else a clamped gather with zeros out of bounds.
  * non-uniform ``if``/``return``/``break`` predicate writes with lane
    masks merged by ``torch.where``; uniform control flow unrolls in
    Python.
  * a data-dependent loop runs as a Python loop over rounds while any lane
    is live (one host read of the live mask a round); the carry holds every
    variable the body assigns, the images it stores and the globals its
    callees write, exactly as the reference's ``lax.while_loop`` carry.
  * ``imageStore`` at a computed coordinate scatters; where lanes of one
    store hit one pixel, the last lane in row-major order wins (the JAX
    package's CPU result), on every device.

  * storage buffers are flat f32 tensors, one a block, and workgroup
    ``shared`` arrays one f32 plane of (groups * size) elements; every
    atomic call site is one masked reduction over the pixel grid (see
    ``_atomic_apply``), in an order fixed on each device.

Abstract evaluation: no loop tests its live mask, so a data-dependent loop
runs its body exactly once -- what ``jax.eval_shape`` traces -- and every
load inside it is seen; atomics leave their buffers as they are.  The
program's shape check runs this way on ``meta`` tensors (nothing is
computed), and the halo reflection (``glsl/__init__.py``) on small CPU
tensors of zeros, whose values nothing reads.

``COUNTS`` counts, over the process, the runs on real tensors (neither
abstract nor on ``meta``: frames, and the conv synthesis's probes), the
operations they issued on per-pixel values and their gathers.  An
operation is one component, varying per pixel, of the result of an
operator, a comparison, a ``?:`` select, a scalar conversion, a builtin
function or an image read (a shifted ``imageLoad`` included; a load at
the pixel itself issues nothing); constructors, user functions' calls and
control flow's masked writes count nothing of their own.  A sample is one
``texture()`` call or one ``imageLoad``/``texelFetch`` at a computed
coordinate.
"""

from __future__ import annotations

import dataclasses
import operator as _op
from typing import Any, Optional

import torch

from . import ast
from .lexer import GlslError

SCALAR_TYPES = {"float", "int", "uint", "bool"}
MAT_TYPES = {"mat2": 2, "mat3": 3, "mat4": 4}
ATOMIC_FUNCS = (
    "atomicAdd", "atomicMin", "atomicMax",
    "atomicAnd", "atomicOr", "atomicXor",
    "atomicExchange", "atomicCompSwap",
)
IMAGE_ATOMIC_FUNCS = tuple("image" + n[0].upper() + n[1:] for n in ATOMIC_FUNCS)
VEC_TYPES = {
    "vec2": ("float", 2), "vec3": ("float", 3), "vec4": ("float", 4),
    "ivec2": ("int", 2), "ivec3": ("int", 3), "ivec4": ("int", 4),
    "uvec2": ("uint", 2), "uvec3": ("uint", 3), "uvec4": ("uint", 4),
    "bvec2": ("bool", 2), "bvec3": ("bool", 3), "bvec4": ("bool", 4),
}
SWIZZLE_SETS = ("xyzw", "rgba", "stpq")

# Tensor dtype of each GLSL scalar type (uint: 32-bit values in int64).
DTYPES = {"float": torch.float32, "int": torch.int32, "uint": torch.int64, "bool": torch.bool}
U32 = 0xFFFFFFFF
_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1

# Elements a runtime-sized SSBO trailing array gets when no buffer is bound
# (the reference's DEFAULT_RUNTIME_SSBO_ELEMS).
DEFAULT_RUNTIME_SSBO_ELEMS = 65536

# Runs on real tensors, their operations on per-pixel values and their
# gathers, over the process (see the module docstring).
COUNTS: dict[str, int] = {"runs": 0, "ops": 0, "samples": 0}


@dataclasses.dataclass
class Origin:
    """Symbolic pixel-coordinate provenance of an int scalar: axis + offset.
    ``clamped`` marks a value clamped to the exact image bounds."""

    axis: str
    offset: int
    clamped: bool = False


@dataclasses.dataclass
class Val:
    type: str
    data: Any  # scalar-like | list of components | list of Vals (arrays)
    origin: Optional[Origin] = None  # scalar int provenance

    def is_vector(self) -> bool:
        return self.type in VEC_TYPES

    def comps(self) -> list:
        assert self.is_vector()
        return self.data

    @property
    def elem_type(self) -> str:
        return VEC_TYPES[self.type][0] if self.is_vector() else self.type

    @property
    def size(self) -> int:
        return VEC_TYPES[self.type][1] if self.is_vector() else 1


def is_static(x: Any) -> bool:
    return isinstance(x, (int, float, bool))


def val_is_static(v: Val) -> bool:
    if v.is_vector():
        return all(is_static(c) for c in v.data)
    if v.type.startswith("array"):
        return all(val_is_static(e) for e in v.data)
    return is_static(v.data)


def cast(x: torch.Tensor, to: str) -> torch.Tensor:
    """Convert a tensor to GLSL type ``to`` with XLA's semantics: float to
    int truncates toward zero and saturates (NaN gives 0), int to uint and
    back wrap modulo 2**32."""
    dt = DTYPES[to]
    if x.dtype == dt:
        return x
    if to == "bool":
        return x != 0
    if x.dtype == torch.bool or to == "float":
        return x.to(dt)
    if x.is_floating_point():
        v = torch.nan_to_num(x, nan=0.0, posinf=3.0e38, neginf=-3.0e38)
        if to == "int":
            low = v.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
            return torch.where(v >= 2147483648.0, _I32_MAX, low)
        low = v.clamp(0.0, 4294967040.0).to(torch.int64)
        return torch.where(v >= 4294967296.0, U32, low)
    if to == "uint":
        return x.to(torch.int64) & U32
    x = x & U32  # uint (int64) -> int: two's complement of the low 32 bits
    return torch.where(x > _I32_MAX, x - 2**32, x).to(torch.int32)


def where(m, a, b, elem: str):
    """Per-lane select of GLSL type ``elem`` (either side may be static)."""
    out = torch.where(m, a, b)
    return out if out.dtype == DTYPES[elem] else cast(out, elem)


def land(a, b):
    if isinstance(a, torch.Tensor):
        return a & b
    if isinstance(b, torch.Tensor):
        return b & bool(a)
    return bool(a) and bool(b)


def lor(a, b):
    if isinstance(a, torch.Tensor):
        return a | b
    if isinstance(b, torch.Tensor):
        return b | bool(a)
    return bool(a) or bool(b)


def lnot(a):
    return ~a if isinstance(a, torch.Tensor) else not a


def elem_of(x) -> str:
    """GLSL scalar type of a tensor's dtype (uint for int64)."""
    return {torch.float32: "float", torch.int32: "int", torch.int64: "uint",
            torch.bool: "bool"}[x.dtype]


class _BreakSignal(Exception):
    pass


class _ContinueSignal(Exception):
    pass


class _ReturnSignal(Exception):
    def __init__(self, value: Optional[Val]):
        self.value = value


_MAX_UNROLL = 65536


class Interp:
    """One shader execution over a (height, width) pixel grid on ``device``
    (``meta``, or ``abstract=True`` on any device: abstract evaluation, see
    the module docstring)."""

    def __init__(
        self,
        shader: ast.Shader,
        height: int,
        width: int,
        images_in: dict[str, Any],  # name -> (4, H, W) f32
        params: dict[str, Any],  # UBO member name -> python scalar
        time: Any = 0.0,
        stats: Optional[dict] = None,
        device: Any = "cpu",
        buffers_in: Optional[dict[str, Any]] = None,  # block name -> (N,) f32
        abstract: Optional[bool] = None,
        row_offset: int = 0,  # global row of local row 0 (a row-sharded slab)
        global_height: Optional[int] = None,  # imageSize's extent
        lower_loop: Optional[Any] = None,  # glsl/lower.py's recorder: loops run once
    ):
        self.shader = shader
        self.lower_loop = lower_loop
        self.h = height  # the local block's rows (array shapes)
        self.w = width
        self.row_offset = row_offset
        self.global_h = global_height if global_height is not None else height
        self.global_w = width
        self.device = torch.device(device)
        self.abstract = self.device.type == "meta" if abstract is None else abstract
        # This run's operations and gathers, added to COUNTS when it ends
        # (runs on real tensors only).
        self.counted = not self.abstract and self.device.type != "meta"
        self.ops = 0
        self.samples = 0
        self.images_in = images_in
        self.params = params
        self.time = time
        # Output image accumulators, created lazily on first store.
        self.stores: dict[str, list] = {}
        # SSBO state: one flat f32 buffer per block (its input, else
        # zeros); each member is an element range of it (std430 over
        # 4-byte elements), a runtime-sized trailing array sized from the
        # bound buffer, else DEFAULT_RUNTIME_SSBO_ELEMS.
        self.buffers: dict[str, Any] = {}
        self.ssbo_members: dict[str, tuple[str, int]] = {}  # member -> (block, size)
        self.ssbo_offsets: dict[str, int] = {}  # member -> element offset in its block
        self.ssbo_scalar: set[str] = set()
        self.ssbo_elem: dict[str, str] = {}
        self.ssbo_instances: dict[str, str] = {}
        for ssbo in shader.ssbos:
            if not ssbo.members:
                raise GlslError(f"SSBO block '{ssbo.block_name}' has no members", ssbo.line)
            init = (buffers_in or {}).get(ssbo.block_name)
            fixed = sum(int(m.array_size) if m.array_size is not None else 1
                        for m in ssbo.members if not m.runtime_array)
            off = 0
            for j, m in enumerate(ssbo.members):
                if m.type not in ("float", "int", "uint"):
                    raise GlslError(
                        f"SSBO member '{m.name}' must be float/int/uint (scalar or array)",
                        ssbo.line,
                    )
                if m.runtime_array:
                    if j != len(ssbo.members) - 1:
                        raise GlslError(
                            f"runtime-sized array '{m.name}[]' must be the last member of "
                            f"its block (std430)",
                            ssbo.line,
                        )
                    size = (max(int(init.shape[0]) - fixed, 0) if init is not None
                            else DEFAULT_RUNTIME_SSBO_ELEMS)
                elif m.array_size is not None:
                    size = int(m.array_size)
                else:
                    size = 1
                    self.ssbo_scalar.add(m.name)
                self.ssbo_members[m.name] = (ssbo.block_name, size)
                self.ssbo_offsets[m.name] = off
                self.ssbo_elem[m.name] = m.type
                off += size
            if ssbo.instance_name:
                self.ssbo_instances[ssbo.instance_name] = ssbo.block_name
            if init is None:
                init = torch.zeros((off,), dtype=torch.float32, device=self.device)
            self.buffers[ssbo.block_name] = init
        # Workgroup-shared arrays: one flat (n_groups * size,) f32 plane per
        # declaration, indexed by group id * size + element.  Every
        # statement runs for all invocations before the next, which is
        # stronger than barrier(), so barriers are no-ops.
        self.shared_members: dict[str, tuple[str, int]] = {}
        self.shared_state: dict[str, Any] = {}
        self._gids: Optional[Any] = None
        if shader.shared:
            lsx, lsy, _ = shader.local_size
            groups = (-(-self.w // lsx)) * (-(-self.global_h // lsy))
            for elem, sname, size, sline in shader.shared:
                if groups * size > 64 * 1024 * 1024:
                    raise GlslError(
                        f"shared array '{sname}': {groups} workgroups x {size} elements "
                        f"exceeds the lowering budget (raise local_size or shrink the array)",
                        sline,
                    )
                self.shared_members[sname] = (elem, size)
                self.shared_state[sname] = torch.zeros((groups * size,), dtype=torch.float32,
                                                       device=self.device)
        # Active lane mask (None = all lanes).
        self.mask: Optional[Any] = None
        # Fragment discard: lanes whose output is dropped (zeros).
        self.discard_mask: Optional[Any] = None
        # Vectorized-loop contexts: (activation, boxes) per nesting level.
        self._vec_loop_stack: list = []
        # Masked-switch regions: (activation, len(_vec_loop_stack) at entry).
        self._switch_stack: list = []
        self.globals: dict[str, Val] = {}
        # Reflection statistics: max static shift, gathers, border kinds.
        self.stats = stats if stats is not None else {"max_shift": 0, "gather": False}
        self._iota_cache: dict[str, Any] = {}

        self._install_builtin_idents()
        for decl in shader.globals:
            if decl.spec_id is not None and decl.name in self.params:
                raw = self.params[decl.name]
                conv = {"float": float, "bool": bool}.get(decl.type, int)
                self.globals[decl.name] = Val(decl.type, conv(raw))
                continue
            self.globals[decl.name] = (
                self.eval_expr(decl.init, self.globals)
                if decl.init is not None
                else self._zero_of(decl.type, decl.line)
            )

    # ---- machinery ------------------------------------------------------

    def _full(self, value, elem: str) -> torch.Tensor:
        """A 0-d tensor of GLSL type ``elem`` on the device."""
        if elem in ("int", "uint"):
            value = self._wrap_static_int(value, elem)
        return torch.full((), value, dtype=DTYPES[elem], device=self.device)

    def _iota(self, axis: str) -> Any:
        got = self._iota_cache.get(axis)
        if got is None:
            if axis == "x":
                got = torch.arange(self.w, dtype=torch.int64, device=self.device).view(1, -1)
            else:
                got = torch.arange(self.h, dtype=torch.int64, device=self.device).view(-1, 1)
            got = got.expand(self.h, self.w)
            self._iota_cache[axis] = got
        return got

    def _global_rows(self) -> Any:
        """The block's global row plane: the local iota plus the slab's
        row offset.  Origin tags stay local: shifted loads index the
        block."""
        ys = self._iota("y")
        return ys + self.row_offset if self.row_offset != 0 else ys

    def _install_builtin_idents(self) -> None:
        gx = Val("uint", self._iota("x"), Origin("x", 0))
        gy = Val("uint", self._global_rows(), Origin("y", 0))
        gz = Val("uint", 0)
        self.globals["gl_GlobalInvocationID"] = Val("uvec3", [gx.data, gy.data, gz.data])
        self._gid_comps = [gx, gy, gz]
        lsx, lsy, lsz = self.shader.local_size
        self.globals["gl_WorkGroupSize"] = Val("uvec3", [lsx, lsy, lsz])
        self.globals["gl_NumWorkGroups"] = Val(
            "uvec3", [-(-self.global_w // lsx), -(-self.global_h // lsy), 1]
        )
        self.globals["gl_LocalInvocationID"] = Val("uvec3", [gx.data % lsx, gy.data % lsy, 0])
        self.globals["gl_WorkGroupID"] = Val("uvec3", [gx.data // lsx, gy.data // lsy, 0])
        self.globals["gl_LocalInvocationIndex"] = Val(
            "uint", (gy.data % lsy) * lsx + gx.data % lsx
        )
        for ubo in self.shader.ubos:
            for m in ubo.members:
                self.globals[m.name] = self._ubo_member_val(m)

        if self.shader.stage == "fragment":
            fx = self._as_array(gx.data, "float") + 0.5
            fy = self._as_array(gy.data, "float") + 0.5
            fc = Val("vec4", [fx, fy, 0.0, 1.0])
            fc._comp_origins = [Origin("x", 0), Origin("y", 0), None, None]  # type: ignore[attr-defined]
            self.globals["gl_FragCoord"] = fc
            for vtype, vname in self.shader.frag_inputs:
                if vtype == "vec2":
                    # Full-screen-pass uv varying: normalized coordinates.
                    uv_x = (self._as_array(gx.data, "float") + 0.5) / self._full(
                        float(self.global_w), "float")
                    uv_y = (self._as_array(gy.data, "float") + 0.5) / self._full(
                        float(self.global_h), "float")
                    self.globals[vname] = Val("vec2", [uv_x, uv_y])
                else:
                    self.globals[vname] = self._zero_of(vtype, 0)
            for vname in self.shader.frag_outputs:
                self.globals[vname] = self._zero_of("vec4", 0)

    def _vector_param(self, type_name: str, dotted: str) -> Val:
        """A vector UBO member, settable per component as ``name.x`` (any
        swizzle alias); unset components read as zero."""
        elem, n = VEC_TYPES[type_name]
        conv = {"float": float, "bool": bool}.get(elem, int)
        comps = []
        for i in range(n):
            raw = 0
            for alias in SWIZZLE_SETS:
                got = self.params.get(f"{dotted}.{alias[i]}")
                if got is not None:
                    raw = got
                    break
            comps.append(conv(raw))
        return Val(type_name, comps)

    def _scalar_param(self, type_name: str, key: str) -> Val:
        raw = self.params.get(key, 0)
        if type_name == "float":
            return Val("float", float(raw))
        if type_name == "bool":
            return Val("bool", bool(raw))
        return Val(type_name, int(raw))

    def _ubo_member_val(self, m: ast.UboMember) -> Val:
        if m.name == "_rf_time" or m.name.endswith("_rf_time"):
            return Val("float", self.time)
        if m.type in self.shader.structs:
            return self._struct_param_val(m.type, m.name)
        if m.array_size is not None:
            # Not settable from the config; reads as zeros (the reference's
            # zero-fill of unset UBO memory).
            return Val(f"array:{m.type}", [self._zero_of(m.type, 0) for _ in range(m.array_size)])
        if m.type in VEC_TYPES:
            return self._vector_param(m.type, m.name)
        if m.type in MAT_TYPES:
            return self._zero_of(m.type, 0)
        if m.type not in SCALAR_TYPES:
            raise GlslError(
                f"UBO member '{m.name}' has type {m.type}; only scalar float/int/bool "
                f"parameters (or vectors, matrices, arrays, structs of them) are supported"
            )
        return self._scalar_param(m.type, m.name)

    def _struct_param_val(self, struct_name: str, prefix: str) -> Val:
        fields: dict[str, Val] = {}
        for ftype, fname in self.shader.structs[struct_name]:
            dotted = f"{prefix}.{fname}"
            if fname.endswith("_rf_time"):
                fields[fname] = Val("float", self.time)
            elif ftype in self.shader.structs:
                fields[fname] = self._struct_param_val(ftype, dotted)
            elif ftype in SCALAR_TYPES:
                fields[fname] = self._scalar_param(ftype, dotted)
            elif ftype in VEC_TYPES:
                fields[fname] = self._vector_param(ftype, dotted)
            else:
                fields[fname] = self._zero_of(ftype, 0)
        return Val(f"struct:{struct_name}", fields)

    def _zero_of(self, type_name: str, line: int) -> Val:
        if type_name in SCALAR_TYPES:
            zero = {"float": 0.0, "int": 0, "uint": 0, "bool": False}[type_name]
            return Val(type_name, zero)
        if type_name in VEC_TYPES:
            elem, n = VEC_TYPES[type_name]
            z = {"float": 0.0, "bool": False}.get(elem, 0)
            return Val(type_name, [z] * n)
        if type_name in MAT_TYPES:
            n = MAT_TYPES[type_name]
            return Val(type_name, [[0.0] * n for _ in range(n)])
        if type_name in self.shader.structs:
            fields = {
                fname: self._zero_of(ftype, line)
                for ftype, fname in self.shader.structs[type_name]
            }
            return Val(f"struct:{type_name}", fields)
        if type_name.endswith("]") and "[" in type_name:
            elem, n = type_name[:-1].split("[")
            return Val(f"array:{elem}", [self._zero_of(elem, line)] * int(n))
        raise GlslError(f"cannot default-initialize type '{type_name}'", line)

    @staticmethod
    def _wrap_static_int(x, elem: str) -> int:
        """Wrap a static Python int to 32 bits (uint mod 2**32, int two's
        complement)."""
        x = int(x)
        if elem == "uint":
            return x & U32
        return ((x + 2**31) % 2**32) - 2**31

    def _as_array(self, x: Any, elem: str) -> Any:
        """``x`` as an (H, W) tensor of GLSL type ``elem``."""
        if is_static(x):
            if elem in ("int", "uint"):
                x = self._wrap_static_int(x, elem)
            return torch.full((self.h, self.w), x, dtype=DTYPES[elem], device=self.device)
        return torch.broadcast_to(cast(x, elem), (self.h, self.w))

    def _as_tensor(self, x: Any, elem: str) -> Any:
        """``x`` as a tensor of GLSL type ``elem`` (0-d when static)."""
        return self._full(x, elem) if is_static(x) else cast(x, elem)

    def _issued(self, v: Val) -> Val:
        """``v``, the result of one operation: each of its components that
        varies per pixel counts as one operation issued."""
        if self.counted:
            if v.type in MAT_TYPES:
                comps = [c for col in v.data for c in col]
            else:
                comps = v.data if v.is_vector() else (v.data,)
            self.ops += sum(isinstance(c, torch.Tensor) and c.dim() > 0 for c in comps)
        return v

    # ---- running --------------------------------------------------------

    def run_main(self) -> dict[str, Any]:
        main = self.shader.functions["main"]
        try:
            self.exec_block(main.body, _Scope(self.globals))
        except _ReturnSignal:
            pass
        outputs = {}
        for name, comps in self.stores.items():
            outputs[name] = torch.stack([self._as_array(c, "float") for c in comps], dim=0)
        # Fragment stage: the first `out vec4` is the node's output_image;
        # extras are additional outputs by their own names.
        for i, vname in enumerate(self.shader.frag_outputs):
            v = self.globals[vname]
            key = "output_image" if i == 0 else vname
            comps = [self._as_array(c, "float") for c in v.data]
            if self.discard_mask is not None:
                comps = [torch.where(self.discard_mask, 0.0, c) for c in comps]
            outputs[key] = torch.stack(comps, dim=0)
        if self.counted:
            COUNTS["runs"] += 1
            COUNTS["ops"] += self.ops
            COUNTS["samples"] += self.samples
        return outputs

    # ---- statements -----------------------------------------------------

    def exec_block(self, stmts: list, scope: "_Scope") -> None:
        inner = scope.child()
        for s in stmts:
            self.exec_stmt(s, inner)

    def exec_stmt(self, s: Any, scope: "_Scope") -> None:
        if isinstance(s, ast.DeclList):
            for d in s.decls:
                self.exec_stmt(d, scope)
            return
        if isinstance(s, ast.Decl):
            if s.array_size is not None:
                size_v = self.eval_expr(s.array_size, scope)
                if not is_static(size_v.data):
                    raise GlslError("array size must be constant", s.line)
                if s.init is not None:
                    init = self.eval_expr(s.init, scope)
                    if not init.type.startswith("array"):
                        raise GlslError("array initializer expected", s.line)
                    scope.declare(s.name, init)
                else:
                    elems = [self._zero_of(s.type, s.line) for _ in range(int(size_v.data))]
                    scope.declare(s.name, Val(f"array:{s.type}", elems))
                return
            if s.init is not None:
                v = self.convert(self.eval_expr(s.init, scope), s.type, s.line)
            else:
                v = self._zero_of(s.type, s.line)
            scope.declare(s.name, v)
            return
        if isinstance(s, ast.ExprStmt):
            self.eval_expr(s.expr, scope)
            return
        if isinstance(s, ast.Block):
            self.exec_block(s.body, scope)
            return
        if isinstance(s, ast.If):
            self.exec_if(s, scope)
            return
        if isinstance(s, ast.For):
            self.exec_for(s, scope)
            return
        if isinstance(s, ast.While):
            self.exec_while(s, scope)
            return
        if isinstance(s, ast.DoWhile):
            self.exec_do_while(s, scope)
            return
        if isinstance(s, ast.Switch):
            self.exec_switch(s, scope)
            return
        if isinstance(s, ast.Return):
            value = self.eval_expr(s.value, scope) if s.value is not None else None
            if self.mask is None:
                raise _ReturnSignal(value)
            # Lanes that already returned must not return again.
            live = scope.activation.live_mask()
            m = self.mask if live is None else land(self.mask, live)
            if self._vec_loop_stack:
                # Return inside a data-dependent loop: the lane leaves the
                # loop and the enclosing activation; a valued return blends
                # into the round's return-value box.
                act, boxes = self._vec_loop_stack[-1]
                boxes[1] = m if boxes[1] is None else lor(boxes[1], m)
                if value is not None:
                    old = boxes[2]
                    bv = self._broadcast_val(value)
                    boxes[2] = bv if old is None else self._blend_val(m, bv, old)
                scope.activation.note_return(m, None)
                return
            scope.activation.note_return(m, value)
            return
        if isinstance(s, ast.Discard):
            if self.shader.stage != "fragment":
                raise GlslError("discard is only valid in fragment shaders", s.line)
            m = self.mask
            if m is None:
                m = torch.ones((self.h, self.w), dtype=torch.bool, device=self.device)
                self.discard_mask = m if self.discard_mask is None else lor(self.discard_mask, m)
                raise _ReturnSignal(None)
            self.discard_mask = m if self.discard_mask is None else lor(self.discard_mask, m)
            scope.activation.note_return(m, None)
            return
        if isinstance(s, ast.Break):
            if self.mask is not None:
                if self._switch_stack and (
                    self._switch_stack[-1][1] >= len(self._vec_loop_stack)
                ):
                    # The innermost breakable construct is a masked switch:
                    # kill the lane for the switch's remainder only.
                    live = scope.activation.live_mask()
                    m = self.mask if live is None else land(self.mask, live)
                    self._switch_stack[-1][0].note_break(m)
                    return
                if self._vec_loop_stack:
                    # break = kill the lane for this round and all later ones.
                    act, boxes = self._vec_loop_stack[-1]
                    boxes[0] = self.mask if boxes[0] is None else lor(boxes[0], self.mask)
                    act.note_return(self.mask, None)
                    return
                raise GlslError("break under non-uniform condition is not supported", s.line)
            raise _BreakSignal()
        if isinstance(s, ast.Continue):
            if self.mask is not None:
                if self._vec_loop_stack:
                    live = scope.activation.live_mask()
                    m = self.mask if live is None else land(self.mask, live)
                    scope.activation.note_return(m, None)
                    return
                raise GlslError("continue under non-uniform condition is not supported", s.line)
            raise _ContinueSignal()
        raise GlslError(f"unsupported statement {type(s).__name__}", getattr(s, "line", 0))

    def exec_if(self, s: ast.If, scope: "_Scope") -> None:
        cond = self.eval_expr(s.cond, scope)
        if cond.type != "bool":
            raise GlslError("if condition must be bool", s.line)
        if is_static(cond.data):
            if cond.data:
                self.exec_block(s.then, scope)
            elif s.other is not None:
                self.exec_block(s.other, scope)
            return
        # Vectorized predication.
        outer = self.mask
        live = scope.activation.live_mask()
        base = cond.data if live is None else land(cond.data, live)
        self.mask = base if outer is None else land(outer, base)
        try:
            self.exec_block(s.then, scope)
        finally:
            self.mask = outer
        if s.other is not None:
            neg = lnot(cond.data)
            live = scope.activation.live_mask()
            base = neg if live is None else land(neg, live)
            self.mask = base if outer is None else land(outer, base)
            try:
                self.exec_block(s.other, scope)
            finally:
                self.mask = outer

    # Static-count loops at or above this trip count run their body with
    # the induction variable as a (0-d) tensor, as the reference's
    # lax.fori_loop lowering traces it (the body is side-effect-free).
    _SCAN_THRESHOLD = 512
    # Safety cap on the rounds of a data-dependent loop.
    _WHILE_CAP = 1 << 16


    def _body_has_masked_jump(self, body: list) -> bool:
        """True when the loop body contains a break/continue/return nested
        under an if — potentially per-pixel, so the vectorized lowering
        should be tried first.  Nested loops bind their own jumps and are
        not descended into.  A nested switch binds its own BREAKS, but a
        continue/return inside its cases still jumps THIS loop's round —
        and runs masked whenever the selector is per-pixel, so any counts
        as a masked jump."""
        def has_cont_ret(stmts):
            for t in stmts:
                if isinstance(t, (ast.For, ast.While, ast.DoWhile)):
                    continue
                if isinstance(t, (ast.Continue, ast.Return)):
                    return True
                if isinstance(t, ast.If):
                    if has_cont_ret(t.then):
                        return True
                    if t.other is not None and has_cont_ret(t.other):
                        return True
                if isinstance(t, ast.Block) and has_cont_ret(t.body):
                    return True
                if isinstance(t, ast.Switch) and any(
                    has_cont_ret(cb) for _, cb in t.cases
                ):
                    return True
            return False

        def walk(stmts, under_if):
            for s in stmts:
                if isinstance(s, (ast.For, ast.While, ast.DoWhile)):
                    continue
                if isinstance(s, ast.Switch):
                    if any(has_cont_ret(cb) for _, cb in s.cases):
                        return True
                    continue
                if isinstance(s, (ast.Break, ast.Continue, ast.Return)) and under_if:
                    return True
                if isinstance(s, ast.If):
                    if walk(s.then, True):
                        return True
                    if s.other is not None and walk(s.other, True):
                        return True
                if isinstance(s, ast.Block):
                    if walk(s.body, under_if):
                        return True
            return False

        return walk(body, False)

    @staticmethod
    def _static_induction_var(s: ast.For):
        """The induction variable name of a For whose init, bound, and
        step are integer literals (``for (int k = 0; k < 4; k++)``): such
        a loop always unrolls with a concrete Python int per iteration —
        even when traced inside a vectorized while body — so indexing a
        local array by it stays a static index.  None otherwise."""
        if not (
            isinstance(s.init, ast.Decl)
            and s.init.type in ("int", "uint")
            and isinstance(s.init.init, ast.Num)
            and isinstance(s.cond, ast.Binary)
            and s.cond.op in ("<", "<=")
            and isinstance(s.cond.left, ast.Ident)
            and s.cond.left.name == s.init.name
            and isinstance(s.cond.right, ast.Num)
            and s.update is not None
        ):
            return None
        u = s.update
        if (
            isinstance(u, ast.Unary)
            and u.op in ("++pre", "++post")
            and isinstance(u.expr, ast.Ident)
            and u.expr.name == s.init.name
        ):
            return s.init.name
        if (
            isinstance(u, ast.Assign)
            and u.op == "+="
            and isinstance(u.target, ast.Ident)
            and u.target.name == s.init.name
            and isinstance(u.value, ast.Num)
        ):
            return s.init.name
        return None

    def _body_has_own_jump(self, body: list) -> bool:
        """True when the loop body contains a break/continue binding to
        THIS loop (not one inside a nested loop, and not return — a
        return escapes every loop, which the enclosing-boxes path
        already handles correctly).  A nested switch binds its own
        breaks, but a `continue` inside its cases is this loop's.  Used
        to force the vectorized lowering for a loop traced inside an
        enclosing vectorized loop: the unrolled path would record these
        jumps into the ENCLOSING loop's lane kills."""
        def has_continue(stmts):
            for t in stmts:
                if isinstance(t, (ast.For, ast.While, ast.DoWhile)):
                    continue
                if isinstance(t, ast.Continue):
                    return True
                if isinstance(t, ast.If):
                    if has_continue(t.then):
                        return True
                    if t.other is not None and has_continue(t.other):
                        return True
                if isinstance(t, ast.Block) and has_continue(t.body):
                    return True
                if isinstance(t, ast.Switch) and any(
                    has_continue(cb) for _, cb in t.cases
                ):
                    return True
            return False

        def walk(stmts):
            for s in stmts:
                if isinstance(s, (ast.For, ast.While, ast.DoWhile)):
                    continue
                if isinstance(s, ast.Switch):
                    if any(has_continue(cb) for _, cb in s.cases):
                        return True
                    continue
                if isinstance(s, (ast.Break, ast.Continue)):
                    return True
                if isinstance(s, ast.If):
                    if walk(s.then):
                        return True
                    if s.other is not None and walk(s.other):
                        return True
                if isinstance(s, ast.Block) and walk(s.body):
                    return True
            return False

        return walk(body)

    def _body_has_return(self, body: list) -> bool:
        """True when the loop body contains a lexical `return` (calls are
        by name, so user-function bodies are never descended into)."""
        found = False

        def walk(node):
            nonlocal found
            if found:
                return
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Return):
                found = True
                return
            for field in node.__dataclass_fields__:
                walk(getattr(node, field))

        walk(body)
        return found

    def exec_for(self, s: ast.For, scope: "_Scope") -> None:
        if self._try_exec_for_scan(s, scope):
            return
        loop_scope = scope.child()
        if s.init is not None:
            self.exec_stmt(s.init, loop_scope)
        forced = bool(
            self._vec_loop_stack or self._switch_stack
        ) and self._body_has_own_jump(s.body)
        if forced or self._body_has_masked_jump(s.body):
            # A break/continue under an if may be per-pixel: the unrolled
            # path cannot mask it, so try the vectorized lowering first;
            # its gates (side effects, nesting) fall back to unrolling,
            # which is correct whenever the jump is actually uniform.
            # Inside an enclosing vectorized loop OR masked switch
            # (`forced`) there is no fallback: the unrolled path would
            # record this loop's break/continue into the ENCLOSING
            # construct's lane kills (a break in an unrolled loop under a
            # masked switch would silently retire the lane for the case
            # remainder), so a lowering failure propagates as the
            # diagnostic.
            try:
                self._exec_loop_vectorized(
                    s.cond, s.body, s.update, loop_scope, s.line
                )
                return
            except GlslError:
                if forced:
                    raise
                pass
        if self.mask is not None:
            # Under a per-pixel mask every assignment blends with
            # where(mask, ...), so `k++` would turn the induction var
            # into a plane and push a perfectly static loop onto the
            # vectorized path.  A static-shaped For instead unrolls with
            # a CONCRETE induction value shadowed per iteration (the
            # fori lowering's trick), keeping loop control uniform and
            # local-array indexing by the var static.  Bodies that jump
            # or reassign the var fall through to the generic paths.
            shape = self._scan_loop_shape(s, loop_scope)
            if shape is not None and shape[2] <= _MAX_UNROLL:
                var, start, count, step = shape
                assigned, _ = self._collect_assigned(s.body)
                if var not in assigned and not self._body_has_own_jump(s.body):
                    for t in range(count):
                        inner = loop_scope.child()
                        inner.declare(
                            var, Val(s.init.type, start + step * t)
                        )
                        self.exec_block(s.body, inner)
                    return
        iters = 0
        while True:
            if s.cond is not None:
                cond = self.eval_expr(s.cond, loop_scope)
                if not is_static(cond.data):
                    # The condition turned per-pixel (possibly after a
                    # statically-true unrolled prefix, e.g. mandelbrot's
                    # z=0 start): hand the rest of the loop to the
                    # vectorized while_loop lowering.
                    self._exec_loop_vectorized(
                        s.cond, s.body, s.update, loop_scope, s.line
                    )
                    return
                if not cond.data:
                    break
            try:
                self.exec_block(s.body, loop_scope)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            if s.update is not None:
                self.eval_expr(s.update, loop_scope)
            iters += 1
            if iters > _MAX_UNROLL:
                raise GlslError("loop exceeds unroll limit", s.line)

    def exec_while(self, s: ast.While, scope: "_Scope") -> None:
        forced = bool(
            self._vec_loop_stack or self._switch_stack
        ) and self._body_has_own_jump(s.body)
        if forced or self._body_has_masked_jump(s.body):
            try:
                self._exec_loop_vectorized(s.cond, s.body, None, scope, s.line)
                return
            except GlslError:
                if forced:  # see exec_for: no unrolled fallback in here
                    raise
                pass
        iters = 0
        while True:
            cond = self.eval_expr(s.cond, scope)
            if not is_static(cond.data):
                # Per-pixel condition (possibly after a statically-true
                # unrolled prefix): vectorized while_loop lowering.
                self._exec_loop_vectorized(s.cond, s.body, None, scope, s.line)
                return
            if not cond.data:
                break
            try:
                self.exec_block(s.body, scope)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            iters += 1
            if iters > _MAX_UNROLL:
                raise GlslError("loop exceeds unroll limit", s.line)
    def _exec_loop_vectorized(self, cond_expr, body, update_expr,
                              loop_scope: "_Scope", line: int,
                              at_least_once: bool = False) -> None:
        """Per-pixel data-dependent loop (the reference's lax.while_loop
        lowering, interp.py:1007-1385 there), run as rounds in Python.

        The carry holds every variable the body (or a callee) assigns, as
        (H, W) planes, the planes of every image it stores, the globals its
        callees write, the storage buffers and shared arrays when it runs an
        atomic (the shared arrays also for a plain shared store), and an
        active-lane mask.  Each round runs the body
        predicated on the mask; the loop ends when no lane is active (one
        host read a round), or after _WHILE_CAP rounds.  A loop inside
        non-uniform control flow starts with the enclosing mask folded into
        its active lanes.  Under abstract evaluation the body runs once;
        under ``lower_loop`` (glsl/lower.py) it runs once on the recorder's
        carry, which becomes a loop region of the op list."""
        enclosing = self.mask
        live = loop_scope.activation.live_mask()
        if live is not None:
            enclosing = live if enclosing is None else land(enclosing, live)
        effect_stmts = list(body)
        if update_expr is not None:
            effect_stmts.append(ast.ExprStmt(update_expr, line))
        if cond_expr is not None:
            effect_stmts.append(ast.ExprStmt(cond_expr, line))
        if not self._scan_body_allowed(effect_stmts, allow_break=True):
            why = self._scan_reject_reason or "an unsupported construct"
            raise GlslError(
                f"data-dependent loop uses {why}, which the vectorized "
                "while_loop lowering cannot carry (see docs/glsl.md "
                '"Data-dependent loops")',
                line,
            )
        stored_imgs = self._stored_images(effect_stmts, line)
        has_atomic = self._body_has_atomic(effect_stmts)
        buf_keys = list(self.buffers) if has_atomic else []
        shm_keys = (list(self.shared_state)
                    if has_atomic or self._body_has_shared_write(effect_stmts) else [])
        assigned, declared = self._collect_assigned(effect_stmts)
        carried = [
            n for n in assigned
            if n not in declared and loop_scope.lookup(n) is not None
        ]

        def _is_scope_local(n):
            s = loop_scope
            while s is not None:
                if n in s.vars:
                    return True
                s = s.parent
            return False

        # Globals written inside called functions resolve through the
        # globals dict: carry them by swapping the dict entry each round.
        glob_carried = [
            n for n in self._callee_global_writes(effect_stmts)
            if n in self.globals and not _is_scope_local(n)
        ]
        for n in carried:
            if not _is_scope_local(n) and n in self.globals and n not in glob_carried:
                glob_carried.append(n)
        carried = [n for n in carried if n not in glob_carried]
        protos = {n: loop_scope.lookup(n) for n in carried}
        gprotos = {n: self.globals[n] for n in glob_carried}
        if any(p.type == "void" for p in list(protos.values()) + list(gprotos.values())):
            raise GlslError("unsupported loop-carried variable type", line)

        hw = (self.h, self.w)

        def cond_plane(c: Val):
            if c.type != "bool":
                raise GlslError("loop condition must be bool", line)
            return self._as_array(c.data, "bool")

        true_val = Val("bool", True)
        cond0 = true_val if cond_expr is None else self.eval_expr(cond_expr, loop_scope)
        retval_proto: list = [None]

        def body_fn(carry):
            # boxes = [break mask, return mask, return value] of this round.
            act = _Activation(interp=self)
            boxes: list = [None, None, None]
            inner = _Scope(loop_scope.globals, act, loop_scope)
            for n in carried:
                inner.declare(n, self._tree_to_val(carry[n], protos[n]))
            prev = self.mask
            prev_discard = self.discard_mask
            self.discard_mask = None
            self.mask = carry["_active"]
            prev_stores = {nm: self.stores.get(nm) for nm in stored_imgs}
            for nm in stored_imgs:
                self.stores[nm] = list(carry["_img:" + nm])
            prev_bufs = {k: self.buffers[k] for k in buf_keys}
            prev_shm = {k: self.shared_state[k] for k in shm_keys}
            for k in buf_keys:
                self.buffers[k] = carry["_buf:" + k]
            for k in shm_keys:
                self.shared_state[k] = carry["_shm:" + k]
            prev_globals = {n: self.globals[n] for n in glob_carried}
            for n in glob_carried:
                self.globals[n] = self._tree_to_val(carry["_g:" + n], gprotos[n])
            new_imgs, new_globs = {}, {}
            new_bufs, new_shm = {}, {}
            self._vec_loop_stack.append((act, boxes))
            try:
                for st in body:
                    self.exec_stmt(st, inner)
                if update_expr is not None:
                    # `continue` jumps to the update: only broken and
                    # returned lanes skip it.
                    act2 = _Activation(interp=self)
                    for b in boxes[:2]:
                        if b is not None:
                            act2.note_return(b, None)
                    self.eval_expr(update_expr, _Scope(loop_scope.globals, act2, inner))
                cnext = true_val if cond_expr is None else self.eval_expr(cond_expr, inner)
                for nm in stored_imgs:
                    new_imgs[nm] = [self._as_array(p, "float") for p in self.stores[nm]]
                for k in buf_keys:
                    new_bufs[k] = self.buffers[k]
                for k in shm_keys:
                    new_shm[k] = self.shared_state[k]
                for n in glob_carried:
                    new_globs[n] = self.globals[n]
            finally:
                self._vec_loop_stack.pop()
                self.mask = prev
                new_discard = self.discard_mask
                self.discard_mask = prev_discard
                for nm, pv in prev_stores.items():
                    if pv is None:
                        self.stores.pop(nm, None)
                    else:
                        self.stores[nm] = pv
                for k, pv in prev_bufs.items():
                    self.buffers[k] = pv
                for k, pv in prev_shm.items():
                    self.shared_state[k] = pv
                for n, pv in prev_globals.items():
                    self.globals[n] = pv
            out = {n: self._val_to_tree(inner.lookup(n)) for n in carried}
            for nm in stored_imgs:
                out["_img:" + nm] = new_imgs[nm]
            for k in buf_keys:
                out["_buf:" + k] = new_bufs[k]
            for k in shm_keys:
                out["_shm:" + k] = new_shm[k]
            for n in glob_carried:
                out["_g:" + n] = self._val_to_tree(new_globs[n])
            active = carry["_active"] & cond_plane(cnext)
            for b in boxes[:2]:
                if b is not None:
                    active = active & ~b
            returned = carry["_returned"]
            if boxes[1] is not None:
                returned = returned | boxes[1]
            discard = carry["_discard"]
            if new_discard is not None:
                discard = discard | new_discard
                active = active & ~discard
            out["_discard"] = discard
            out["_returned"] = returned
            out["_active"] = active
            if boxes[2] is not None:
                # Valued return: blend this round's value over the carried
                # one (zeros before any round returned, as the reference's
                # seeded carry) at the lanes that returned this round.
                retval_proto[0] = boxes[2]
                rv = boxes[2]
                prev_rv = carry.get("_retval")
                old = (self._tree_to_val(prev_rv, rv) if prev_rv is not None
                       else self._tree_to_val(self._zeros_tree(self._val_to_tree(rv)), rv))
                out["_retval"] = self._val_to_tree(self._blend_val(self._as_array(boxes[1], "bool"),
                                                                   rv, old))
            return out

        carry = {n: self._val_to_tree(protos[n]) for n in carried}
        for nm in stored_imgs:
            carry["_img:" + nm] = [self._as_array(p, "float") for p in self._image_current(nm)]
        for k in buf_keys:
            carry["_buf:" + k] = self.buffers[k]
        for k in shm_keys:
            carry["_shm:" + k] = self.shared_state[k]
        for n in glob_carried:
            carry["_g:" + n] = self._val_to_tree(gprotos[n])
        active = (torch.ones(hw, dtype=torch.bool, device=self.device) if at_least_once
                  else cond_plane(cond0))
        if enclosing is not None:
            active = active & enclosing
        carry["_active"] = torch.broadcast_to(active, hw)
        carry["_discard"] = torch.zeros(hw, dtype=torch.bool, device=self.device)
        carry["_returned"] = torch.zeros(hw, dtype=torch.bool, device=self.device)
        if self.abstract:
            carry = body_fn(carry)
        elif self.lower_loop is not None:
            # Lowering to an op list (glsl/lower.py): the recorder runs the
            # body once on its own carry and returns the carry after the
            # loop; a valued return's carry starts as zeros.
            carry = self.lower_loop(carry, body_fn, self._zeros_tree)
        else:
            rounds = 0
            while rounds < self._WHILE_CAP and bool(carry["_active"].any()):
                carry = body_fn(carry)
                rounds += 1
        final = carry
        for n in carried:
            loop_scope.assign(n, self._tree_to_val(final[n], protos[n]))
        for n in glob_carried:
            self.globals[n] = self._tree_to_val(final["_g:" + n], gprotos[n])
        for nm in stored_imgs:
            self.stores[nm] = list(final["_img:" + nm])
        for k in buf_keys:
            self.buffers[k] = final["_buf:" + k]
        for k in shm_keys:
            self.shared_state[k] = final["_shm:" + k]
        if self.shader.stage == "fragment":
            fd = final["_discard"]
            self.discard_mask = fd if self.discard_mask is None else self.discard_mask | fd
        if self._body_has_return(body):
            # Lanes that returned inside the loop leave the enclosing
            # activation too; a valued return delivers its carried value.
            rv = None
            if retval_proto[0] is not None and "_retval" in final:
                rv = self._tree_to_val(final["_retval"], retval_proto[0])
            if self._vec_loop_stack:
                # Nested in an enclosing data-dependent loop of the same
                # activation: the lane leaves that loop as well.
                act, boxes = self._vec_loop_stack[-1]
                m = final["_returned"]
                boxes[1] = m if boxes[1] is None else lor(boxes[1], m)
                if rv is not None:
                    bv = self._broadcast_val(rv)
                    boxes[2] = bv if boxes[2] is None else self._blend_val(m, bv, boxes[2])
                loop_scope.activation.note_return(m, None)
            else:
                loop_scope.activation.note_return(final["_returned"], rv)
        self.stats["while_loop"] = True

    # ---- fori_loop lowering of long uniform loops -----------------------

    def _scan_loop_shape(self, s: ast.For, scope: "_Scope"):
        """(var_name, start, count, step) for `for (int i = A; i <|<= B;
        i++|i+=C)` with uniform static A/B/C, else None."""
        if not (
            isinstance(s.init, ast.Decl)
            and s.init.type in ("int", "uint")
            and s.init.init is not None
            and s.cond is not None
            and s.update is not None
        ):
            return None
        var = s.init.name
        start_v = self.eval_expr(s.init.init, scope)
        if not is_static(start_v.data):
            return None
        start = int(start_v.data)
        c = s.cond
        if not (
            isinstance(c, ast.Binary)
            and c.op in ("<", "<=")
            and isinstance(c.left, ast.Ident)
            and c.left.name == var
        ):
            return None
        bound_v = self.eval_expr(c.right, scope)
        if not is_static(bound_v.data):
            return None
        bound = int(bound_v.data) + (1 if c.op == "<=" else 0)
        u = s.update
        if isinstance(u, ast.Unary) and u.op in ("++pre", "++post") and isinstance(u.expr, ast.Ident) and u.expr.name == var:
            step = 1
        elif (
            isinstance(u, ast.Assign)
            and u.op == "+="
            and isinstance(u.target, ast.Ident)
            and u.target.name == var
        ):
            step_v = self.eval_expr(u.value, scope)
            if not is_static(step_v.data) or int(step_v.data) <= 0:
                return None
            step = int(step_v.data)
        else:
            return None
        count = max(0, -(-(bound - start) // step))
        return (var, start, count, step)

    def _scan_body_allowed(self, body: list, allow_break: bool = False) -> bool:
        """Conservative: no side effects, control-flow escapes, or constructs
        that require a static loop variable (static-offset loads, local-array
        indexing).  ``allow_break`` admits break/continue (the vectorized
        while_loop lowers them to lane kills) and — because that lowering
        executes the body under a lane mask with a proper carry — pure
        GATHERS (imageLoad/texture/texelFetch: the raymarch and
        iterative-warp idioms), stores/atomics/shared writes (threaded
        through the carry), `return` (void or valued — it rides the
        carry), nested loops and switches of any case shape, plus calls
        to qualifying user functions (see _loop_callable).  Without
        ``allow_break`` (the fori path, which has no carry), none of
        those side effects or escapes are admitted.

        On rejection, ``self._scan_reject_reason`` names the offending
        construct so the caller's diagnostic states the real cause."""
        ok = True
        self._scan_reject_reason = None
        # Induction variables of enclosing nested Fors with literal
        # bounds: such loops unroll with a concrete Python int even
        # inside the vectorized while body, so `acc[k]` stays a static
        # index (see _static_induction_var).
        static_ivs: list = []

        def reject(why):
            nonlocal ok
            ok = False
            if self._scan_reject_reason is None:
                self._scan_reject_reason = why

        def shared_root(t):
            while isinstance(t, (ast.Member, ast.Index)):
                t = t.expr
            return (
                isinstance(t, ast.Ident) and t.name in self.shared_members
            )

        def walk(node):
            if not ok:
                return
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if allow_break and isinstance(node, (ast.Break, ast.Continue)):
                return
            if allow_break and isinstance(node, ast.Return):
                # Return (void or valued): the lane leaves the loop and
                # the enclosing activation; a valued return's result
                # rides the while carry (threaded like discard).
                return
            if allow_break and isinstance(node, (ast.For, ast.While,
                                                 ast.DoWhile)):
                # Nested loops compose: a literal-bound nested For
                # unrolls inline during the body trace (its induction
                # var stays a concrete int, so indexing locals by it is
                # admitted below); a per-pixel nested loop lowers to its
                # own nested lax.while_loop (exec_for/exec_while force
                # that path whenever the nested body binds its own
                # break/continue — the unrolled fallback would record
                # those into THIS loop's lane kills).
                iv = (
                    self._static_induction_var(node)
                    if isinstance(node, ast.For) else None
                )
                if iv is not None:
                    static_ivs.append(iv)
                for field in node.__dataclass_fields__:
                    walk(getattr(node, field))
                if iv is not None:
                    static_ivs.remove(iv)
                return
            if allow_break and isinstance(node, ast.Switch):
                # A switch inside the vectorized body executes via the
                # masked lowering (exec_switch routes there whenever a
                # mask or the loop stack is live), which binds breaks to
                # the SWITCH via its own activation region — any case
                # shape works.  Walk the contents for other constructs.
                walk(node.selector)
                for _vals, cbody in node.cases:
                    walk(cbody)
                return
            if isinstance(node, (ast.Break, ast.Continue, ast.Return, ast.For,
                                 ast.While, ast.DoWhile, ast.Switch)):
                reject(
                    "a nested switch statement"
                    if isinstance(node, ast.Switch)
                    else "a nested loop"
                    if isinstance(node, (ast.For, ast.While, ast.DoWhile))
                    else "break/continue/return here"
                )
                return
            if isinstance(node, ast.Discard) and not allow_break:
                # The fori lowering has no discard carry; the vectorized
                # while path (allow_break=True) threads it through the
                # loop carry.
                reject("discard")
                return
            if isinstance(node, ast.Call):
                if node.name in ATOMIC_FUNCS and not allow_break:
                    reject(node.name)  # fori path: no buffer carry
                    return
                if node.name == "barrier" and allow_break:
                    # A barrier under divergent per-pixel control flow is
                    # UB in GLSL; the vectorized lowering has no shared-
                    # resync point inside the while body either.
                    reject("barrier() (UB under divergent control flow)")
                    return
                if node.name == "imageStore" or node.name in IMAGE_ATOMIC_FUNCS:
                    if not allow_break:
                        reject(node.name)  # fori path: no image carry
                        return
                    # Vectorized while path: the written planes ride the
                    # loop carry (see the image-carry block in the while
                    # lowering), so direct stores/atomics are fine.
                if node.name in (
                    "imageLoad", "texture", "textureLod", "texelFetch",
                ):
                    if not allow_break:
                        reject(f"{node.name} with a loop-dependent offset")
                        return
                elif node.name in self.shader.functions:
                    if allow_break:
                        if not self._loop_callable(node.name):
                            reject(
                                f"the call to {node.name}() (callees must "
                                "not use barrier() or recursion)"
                            )
                            return
                    else:
                        # fori path: no carry for callee side effects —
                        # pure-compute callees only.
                        imgs, atomic, globs = self._callee_effect_summary(
                            node.name
                        )
                        if (
                            imgs or atomic or globs
                            or self._body_has_shared_write([node])
                            or not self._loop_callable(node.name)
                        ):
                            reject(f"the call to {node.name}()")
                            return
            if isinstance(node, ast.Assign) and shared_root(node.target):
                if not allow_break:
                    # fori path: no shared-state carry.
                    reject("a non-atomic shared-memory write")
                    return
                # Vectorized while path: the shared arrays ride the loop
                # carry (shm_keys includes them whenever the body writes
                # one), so a plain store lands in the carried buffer
                # exactly like an atomic — writes in round k are visible
                # to every lane's reads in round k+1.
            if isinstance(node, ast.Unary) and node.op in (
                "++pre", "--pre", "++post", "--post"
            ) and shared_root(node.expr) and not allow_break:
                reject("a non-atomic shared-memory write")
                return
            if isinstance(node, ast.Index) and not allow_break:
                # The fori lowering keeps local arrays OUT of its carry,
                # so array/vector indexing there needs a static index — a
                # LITERAL one stays static under the trace, as does the
                # induction var of an enclosing literal-bound For.  (The
                # vectorized while path has no such limit: dynamic
                # indices lower to per-lane gathers/masked merges, and
                # SSBO reads handle traced indices on both paths.)
                base = node.expr
                is_ssbo = isinstance(base, ast.Ident) and (
                    base.name in self.ssbo_members
                ) or (
                    isinstance(base, ast.Member)
                    and isinstance(base.expr, ast.Ident)
                    and base.expr.name in self.ssbo_instances
                )
                if not is_ssbo and not isinstance(node.index, ast.Num):
                    if not (
                        isinstance(node.index, ast.Ident)
                        and node.index.name in static_ivs
                    ):
                        reject("a non-literal local array/vector index")
                        return
            for field in node.__dataclass_fields__:
                walk(getattr(node, field))

        walk(body)
        return ok

    def _callee_effect_summary(
        self, name: str, _seen: Optional[set] = None
    ) -> tuple:
        """(stored_image_names, has_atomic, written_global_names) of a user
        function, transitively through nested calls — what the vectorized
        loop lowering must thread through its carry when the loop body
        calls this function.  Flow-insensitive like _loop_callable (a Decl
        anywhere in the body shadows for the whole body); cached per
        function name (the shader AST is immutable)."""
        cache = getattr(self, "_callee_fx_cache", None)
        if cache is None:
            cache = self._callee_fx_cache = {}
        if name in cache:
            return cache[name]
        fn = self.shader.functions.get(name)
        if fn is None:
            return ([], False, [])
        # _seen is the active RECURSION PATH (not a visited set): a
        # diamond call graph (f->g->u, f->h->u) must traverse u twice.
        seen = _seen if _seen is not None else set()
        if name in seen:
            return ([], False, [])  # recursion: _loop_callable rejects it
        seen.add(name)
        local = {p.name for p in fn.params}
        imgs: list = []
        globs: list = []
        atomic = [False]

        def root_ident(t):
            while isinstance(t, (ast.Member, ast.Index)):
                t = t.expr
            return t.name if isinstance(t, ast.Ident) else None

        def note_glob(n):
            if n is not None and n not in local and n not in globs:
                globs.append(n)

        def walk(node):
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Decl):
                local.add(node.name)
            if isinstance(node, ast.Call):
                if (
                    node.name == "imageStore"
                    or node.name in IMAGE_ATOMIC_FUNCS
                ) and node.args:
                    nm = self._get_image(
                        node.args[0], getattr(node, "line", fn.line)
                    )
                    if nm not in imgs:
                        imgs.append(nm)
                elif node.name in ATOMIC_FUNCS:
                    atomic[0] = True
                elif node.name in self.shader.functions:
                    ci, ca, cg = self._callee_effect_summary(node.name, seen)
                    for nm in ci:
                        if nm not in imgs:
                            imgs.append(nm)
                    atomic[0] = atomic[0] or ca
                    for g in cg:
                        note_glob(g)
                    # A global bound to an out/inout parameter is written
                    # by the copy-back at THIS call site.
                    callee = self.shader.functions[node.name]
                    for p, a in zip(callee.params, node.args):
                        if p.qualifier in ("out", "inout"):
                            note_glob(root_ident(a))
            if isinstance(node, ast.Assign):
                note_glob(root_ident(node.target))
            if isinstance(node, ast.Unary) and node.op in (
                "++pre", "--pre", "++post", "--post"
            ):
                note_glob(root_ident(node.expr))
            for field in node.__dataclass_fields__:
                walk(getattr(node, field))

        walk(fn.body)
        seen.discard(name)
        res = (imgs, atomic[0], globs)
        if not seen:
            cache[name] = res
        return res

    def _callee_global_writes(self, stmts) -> list:
        """Global names written (transitively) by user functions called
        from ``stmts`` — carried through the vectorized loop via the
        globals-dict swap (see _exec_loop_vectorized)."""
        names: list = []

        def walk(node):
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Call) and node.name in self.shader.functions:
                for g in self._callee_effect_summary(node.name)[2]:
                    if g not in names:
                        names.append(g)
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))

        walk(stmts)
        return names

    def _body_has_atomic(self, stmts) -> bool:
        """True when a loop body calls an SSBO or shared-array atomic,
        directly or inside a called user function (transitively)."""
        found = False

        def walk(node):
            nonlocal found
            if found:
                return
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Call) and (
                node.name in ATOMIC_FUNCS
                or (node.name in self.shader.functions
                    and self._callee_effect_summary(node.name)[1])
            ):
                found = True
                return
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))

        walk(stmts)
        return found

    def _body_has_shared_write(self, stmts, _seen: Optional[set] = None) -> bool:
        """True when a loop body performs a plain (non-atomic) store or
        ++/-- on a workgroup-shared array, directly or inside a called
        user function (transitively).  Such writes require the shared
        state to ride the vectorized loop carry (shm_keys)."""
        seen = _seen if _seen is not None else set()
        found = False

        def shared_root(t):
            while isinstance(t, (ast.Member, ast.Index)):
                t = t.expr
            return (
                isinstance(t, ast.Ident) and t.name in self.shared_members
            )

        def walk(node):
            nonlocal found
            if found:
                return
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Assign) and shared_root(node.target):
                found = True
                return
            if isinstance(node, ast.Unary) and node.op in (
                "++pre", "--pre", "++post", "--post"
            ) and shared_root(node.expr):
                found = True
                return
            if isinstance(node, ast.Call) and node.name in self.shader.functions:
                # An argument rooted at a shared member bound to an
                # out/inout parameter is written by the caller-side
                # copy-back at THIS call site (`setv(mine[lid], v)` with
                # `void setv(out float x, ...)`), even though the callee
                # body only assigns a local param.
                callee = self.shader.functions[node.name]
                for p, a in zip(callee.params, node.args):
                    if p.qualifier in ("out", "inout") and shared_root(a):
                        found = True
                        return
                if node.name not in seen:
                    seen.add(node.name)
                    if self._body_has_shared_write(callee.body, seen):
                        found = True
                        return
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))

        walk(stmts)
        return found

    def _stored_images(self, stmts, line: int) -> list:
        """Image names a loop body stores to, directly or inside called
        user functions (carried through the vectorized while_loop; see
        the image-carry block above)."""
        names: list = []

        def walk(node):
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if (
                isinstance(node, ast.Call)
                and (
                    node.name == "imageStore"
                    or node.name in IMAGE_ATOMIC_FUNCS
                )
                and node.args
            ):
                nm = self._get_image(
                    node.args[0], getattr(node, "line", line)
                )
                if nm not in names:
                    names.append(nm)
            if isinstance(node, ast.Call) and node.name in self.shader.functions:
                for nm in self._callee_effect_summary(node.name)[0]:
                    if nm not in names:
                        names.append(nm)
            for f in node.__dataclass_fields__:
                walk(getattr(node, f))

        walk(stmts)
        return names

    def _loop_callable(self, name: str, _seen: Optional[set] = None) -> bool:
        """True when a user function may be called inside a vectorized
        loop body.  Callees may do anything the loop body itself may do —
        gathers, ``imageStore``, ``atomicAdd``, plain shared-array
        stores, writes to globals (the stored images / SSBO buffers /
        shared arrays / written globals are discovered transitively by
        _callee_effect_summary / _body_has_shared_write and threaded
        through the loop carry) — but not ``barrier`` (divergent
        barriers are UB in GLSL) or recursion.  Loops in callees
        compose like loops in the body: static ones unroll during the
        body trace, per-pixel ones lower to their own nested
        lax.while_loop (the call machinery swaps the loop stack out, so
        a callee-loop `return` correctly exits the callee only)."""
        # _seen is the active recursion path; a diamond call graph
        # (f->g->u, f->h->u) must qualify u on both paths.
        seen = _seen if _seen is not None else set()
        if name in seen:
            return False
        seen.add(name)
        fn = self.shader.functions.get(name)
        if fn is None:
            seen.discard(name)
            return False
        ok = True

        def walk(node):
            nonlocal ok
            if not ok:
                return
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Call):
                if node.name == "barrier":
                    ok = False
                    return
                if node.name in self.shader.functions and not self._loop_callable(
                    node.name, seen
                ):
                    ok = False
                    return
            for field in node.__dataclass_fields__:
                walk(getattr(node, field))

        walk(fn.body)
        seen.discard(name)
        return ok

    def _collect_assigned(self, body: list) -> tuple[list[str], set[str]]:
        """(names assigned in body, names declared in body).  Declared names
        shadow the enclosing scope and must not be written back.  Args
        bound to out/inout parameters of user calls count as assigned."""
        names: list[str] = []
        declared: set[str] = set()

        def note(target):
            t = target
            while isinstance(t, (ast.Member, ast.Index)):
                t = t.expr
            if isinstance(t, ast.Ident) and t.name not in names:
                names.append(t.name)

        def walk(node):
            if isinstance(node, (list, tuple)):
                for x in node:
                    walk(x)
                return
            if not hasattr(node, "__dataclass_fields__"):
                return
            if isinstance(node, ast.Decl):
                declared.add(node.name)
            if isinstance(node, ast.Assign):
                note(node.target)
            if isinstance(node, ast.Unary) and node.op in (
                "++pre", "--pre", "++post", "--post"
            ):
                note(node.expr)
            if isinstance(node, ast.Call) and node.name in self.shader.functions:
                fn = self.shader.functions[node.name]
                for p, a in zip(fn.params, node.args):
                    if p.qualifier in ("out", "inout"):
                        note(a)
            for field in node.__dataclass_fields__:
                walk(getattr(node, field))

        walk(body)
        return names, declared

    def _blend_val(self, m, new: Val, old: Val) -> Val:
        """Per-lane select between two same-typed Vals (vector, matrix,
        struct, array, scalar)."""
        if new.is_vector():
            e = new.elem_type
            return Val(new.type, [where(m, n, o, e) for n, o in zip(new.data, old.data)])
        if new.type in MAT_TYPES:
            return Val(new.type, [[where(m, n, o, "float") for n, o in zip(nc, oc)]
                                  for nc, oc in zip(new.data, old.data)])
        if new.type.startswith("struct:"):
            return Val(new.type, {k: self._blend_val(m, f, old.data[k])
                                  for k, f in new.data.items()})
        if new.type.startswith("array:"):
            if len(new.data) != len(old.data):
                raise GlslError(
                    f"array size mismatch in per-lane merge: "
                    f"{len(new.data)} vs {len(old.data)} elements"
                )
            return Val(new.type, [self._blend_val(m, n, o) for n, o in zip(new.data, old.data)])
        return Val(new.type, where(m, new.data, old.data, new.type))

    # The same per-lane merge, under the name the assignment paths use.
    _mask_merge_val = _blend_val

    def _broadcast_val(self, v: Val) -> Val:
        """Every plane of ``v`` broadcast to (h, w)."""
        return self._tree_to_val(self._val_to_tree(v), v)

    def _val_to_tree(self, v: Val):
        if v.is_vector():
            return tuple(self._as_array(c, v.elem_type) for c in v.data)
        if v.type in MAT_TYPES:
            return tuple(tuple(self._as_array(c, "float") for c in col) for col in v.data)
        if v.type.startswith("struct:"):
            return {k: self._val_to_tree(f) for k, f in v.data.items()}
        if v.type.startswith("array:"):
            return tuple(self._val_to_tree(e) for e in v.data)
        return self._as_array(v.data, v.type)

    def _tree_to_val(self, tree, proto: Val) -> Val:
        if proto.is_vector():
            return Val(proto.type, list(tree))
        if proto.type in MAT_TYPES:
            return Val(proto.type, [list(col) for col in tree])
        if proto.type.startswith("struct:"):
            return Val(proto.type, {k: self._tree_to_val(tree[k], f) for k, f in proto.data.items()})
        if proto.type.startswith("array:"):
            if len(tree) != len(proto.data):
                raise GlslError(f"array size mismatch: {len(tree)} vs {len(proto.data)} elements")
            return Val(proto.type, [self._tree_to_val(t, p) for t, p in zip(tree, proto.data)])
        return Val(proto.type, tree)

    def _zeros_tree(self, tree):
        if isinstance(tree, dict):
            return {k: self._zeros_tree(t) for k, t in tree.items()}
        if isinstance(tree, tuple):
            return tuple(self._zeros_tree(t) for t in tree)
        return torch.zeros_like(tree)

    def _try_exec_for_scan(self, s: ast.For, scope: "_Scope") -> bool:
        """A long static-count loop with a side-effect-free body (the
        reference's lax.fori_loop lowering, interp.py:2026-2100 there): the
        body runs with the induction variable as a 0-d int32 tensor and the
        carried variables as planes, so it sees what the reference's trace
        sees.  False: the caller unrolls."""
        try:
            shape = self._scan_loop_shape(s, scope)
        except GlslError:
            return False
        if shape is None:
            return False
        var, start, count, step = shape
        if count < self._SCAN_THRESHOLD:
            return False
        if self.mask is not None or scope.activation.live_mask() is not None:
            return False
        if not self._scan_body_allowed(s.body):
            return False
        assigned, declared = self._collect_assigned(s.body)
        carried = [
            n for n in assigned
            if n != var and n not in declared and scope.lookup(n) is not None
        ]
        protos = {n: scope.lookup(n) for n in carried}
        if any(p.type.startswith("array") or p.type == "void" for p in protos.values()):
            return False

        def body_fn(k, carry):
            inner = scope.child()
            inner.declare(var, Val("int", self._full(start + step * k, "int")))
            for n in carried:
                inner.declare(n, self._tree_to_val(carry[n], protos[n]))
            for stmt in s.body:
                self.exec_stmt(stmt, inner)
            return {n: self._val_to_tree(inner.lookup(n)) for n in carried}

        carry = {n: self._val_to_tree(protos[n]) for n in carried}
        try:
            for k in range(1 if self.abstract else count):
                carry = body_fn(k, carry)
        except Exception:
            return False  # what the reference cannot trace it unrolls
        for n in carried:
            scope.assign(n, self._tree_to_val(carry[n], protos[n]))
        self.stats["fori_loop"] = True
        return True

    def exec_do_while(self, s: ast.DoWhile, scope: "_Scope") -> None:
        forced = bool(
            self._vec_loop_stack or self._switch_stack
        ) and self._body_has_own_jump(s.body)
        if forced or self._body_has_masked_jump(s.body):
            try:
                # at_least_once: do-while runs the body before the first
                # condition check.
                self._exec_loop_vectorized(
                    s.cond, s.body, None, scope, s.line, at_least_once=True
                )
                return
            except GlslError:
                if forced:  # see exec_for: no unrolled fallback in here
                    raise
                pass
        iters = 0
        while True:
            try:
                self.exec_block(s.body, scope)
            except _BreakSignal:
                break
            except _ContinueSignal:
                pass
            cond = self.eval_expr(s.cond, scope)
            if not is_static(cond.data):
                # The condition turned per-pixel after k uniform
                # iterations: the remainder is exactly while(cond){body}.
                self._exec_loop_vectorized(
                    s.cond, s.body, None, scope, s.line
                )
                return
            if not cond.data:
                break
            iters += 1
            if iters > _MAX_UNROLL:
                raise GlslError("loop exceeds unroll limit", s.line)

    def exec_switch(self, s: ast.Switch, scope: "_Scope") -> None:
        """switch with fall-through.  A uniform selector picks the entry case
        at trace time; a per-pixel selector vectorizes as a masked if-chain
        (entry masks OR-accumulate across fall-through, a trailing `break`
        clears the carry), requiring `break` only in tail position and no
        `return`."""
        sel = self.eval_expr(s.selector, scope)
        if not is_static(sel.data):
            self._exec_switch_masked(s, scope, sel)
            return
        if (
            self._vec_loop_stack or self.mask is not None
            or self._switch_needs_masked(s)
        ):
            # Inside a vectorized loop round (or any lane-masked region)
            # a `break` must bind to the SWITCH — the unrolled executor
            # would record it as a loop lane-kill (or reject it under a
            # plain mask).  Route uniform selectors through the masked
            # lowering as a broadcast plane; it handles any case shape
            # (non-tail breaks and returns become switch-region lane
            # kills via _SwitchActivation).
            if sel.type not in ("int", "uint"):
                raise GlslError(
                    "switch selector must be an integer", s.line
                )
            plane = Val(sel.type, self._as_array(sel.data, "int"))
            self._exec_switch_masked(s, scope, plane)
            return
        sel_v = int(sel.data)
        start = None
        for i, (values, _body) in enumerate(s.cases):
            for v in values:
                if v is None:
                    continue
                cv = self.eval_expr(v, scope)
                if is_static(cv.data) and int(cv.data) == sel_v:
                    start = i
                    break
            if start is not None:
                break
        if start is None:
            # No case label matched: enter at `default` (wherever it sits).
            for i, (values, _body) in enumerate(s.cases):
                if any(v is None for v in values):
                    start = i
                    break
        if start is None:
            return
        try:
            for i in range(start, len(s.cases)):
                self.exec_block(s.cases[i][1], scope)
        except _BreakSignal:
            pass

    @staticmethod
    def _switch_needs_masked(s: ast.Switch) -> bool:
        """True when a case body contains a jump that may execute under a
        per-pixel mask — break/continue/return nested under an `if`, or
        anywhere inside a nested switch (whose selector may be
        per-pixel).  The Python-unrolled static-selector executor cannot
        lane-mask those, so such switches route through the masked
        lowering even with a uniform selector.  Jumps inside nested
        loops bind to (or are carried by) those loops and don't count."""
        def walk(stmts, under_if):
            for t in stmts:
                if isinstance(t, (ast.For, ast.While, ast.DoWhile)):
                    continue
                if isinstance(t, (ast.Break, ast.Continue, ast.Return)):
                    if under_if:
                        return True
                elif isinstance(t, ast.If):
                    if walk(t.then, True):
                        return True
                    if t.other is not None and walk(t.other, True):
                        return True
                elif isinstance(t, ast.Block):
                    if walk(t.body, under_if):
                        return True
                elif isinstance(t, ast.Switch):
                    if any(walk(cb, True) for _, cb in t.cases):
                        return True
            return False

        return any(walk(cb, False) for _, cb in s.cases)

    def _exec_switch_masked(self, s: ast.Switch, scope: "_Scope", sel: Val) -> None:
        if sel.type not in ("int", "uint"):
            raise GlslError("switch selector must be an integer", s.line)
        # Per-case entry masks: which pixels START at this case.
        match: list = [None] * len(s.cases)
        default_idx = None
        any_match = None
        for i, (values, body) in enumerate(s.cases):
            m = None
            for v in values:
                if v is None:
                    default_idx = i
                    continue
                cv = self.eval_expr(v, scope)
                if not is_static(cv.data):
                    raise GlslError("case label must be a constant", s.line)
                mm = sel.data == int(cv.data)
                m = mm if m is None else lor(m, mm)
            match[i] = m
            if m is not None:
                any_match = m if any_match is None else lor(any_match, m)
        if default_idx is not None:
            no_match = (
                lnot(any_match)
                if any_match is not None
                else torch.ones(sel.data.shape, dtype=torch.bool, device=self.device)
            )
            m = match[default_idx]
            match[default_idx] = (
                no_match if m is None else lor(m, no_match)
            )
        # Fall-through: the carry mask accumulates entries until a trailing
        # break retires every active pixel.  The switch body runs in its
        # own activation region so a NON-tail `break` (e.g. under a
        # per-pixel `if`) kills the lane for the switch's remainder only,
        # and a `return`/`discard` forwards through to the enclosing
        # activation (see _SwitchActivation).  Case statements execute in
        # one shared child scope: a declaration in one case is visible to
        # later fall-through cases but not after the switch (GLSL switch
        # body scoping).
        outer = self.mask
        act = _SwitchActivation(
            self, scope.activation, scope.activation.live_mask()
        )
        inner = _Scope(scope.globals, act, scope)
        self._switch_stack.append((act, len(self._vec_loop_stack)))
        carry = None
        try:
            for i, (values, body) in enumerate(s.cases):
                if match[i] is not None:
                    carry = (
                        match[i] if carry is None
                        else lor(carry, match[i])
                    )
                if carry is None:
                    continue
                stmts = body
                has_break = bool(stmts) and isinstance(stmts[-1], ast.Break)
                if has_break:
                    stmts = stmts[:-1]
                if stmts:
                    self.mask = (
                        carry if outer is None
                        else land(outer, carry)
                    )
                    try:
                        for st in stmts:
                            self.exec_stmt(st, inner)
                    finally:
                        self.mask = outer
                if has_break:
                    carry = None
        finally:
            self._switch_stack.pop()

    # ---- expression evaluation -----------------------------------------

    def eval_expr(self, e: Any, scope: "_Scope") -> Val:
        method = getattr(self, f"_eval_{type(e).__name__}", None)
        if method is None:
            raise GlslError(f"unsupported expression {type(e).__name__}", getattr(e, "line", 0))
        return method(e, scope)

    def _eval_Num(self, e: ast.Num, scope) -> Val:
        if e.is_float:
            return Val("float", e.value)
        if getattr(e, "is_uint", False):
            return Val("uint", self._wrap_static_int(e.value, "uint"))
        return Val("int", e.value)

    def _eval_BoolLit(self, e: ast.BoolLit, scope) -> Val:
        return Val("bool", e.value)

    def _eval_Ident(self, e: ast.Ident, scope) -> Val:
        v = scope.lookup(e.name)
        if v is None:
            if e.name in self.ssbo_members:
                block, _ = self.ssbo_members[e.name]
                if e.name in self.ssbo_scalar:
                    # Scalar block member: reading the bare name yields
                    # its value (element 0 of its range).
                    return self._ssbo_read((block, e.name), Val("int", 0), e.line)
                return Val("ssbo", (block, e.name))
            if e.name in self.ssbo_instances:
                return Val("ssbo_block", self.ssbo_instances[e.name])
            if e.name in self.shared_members:
                return Val("shared", e.name)
            raise GlslError(f"undeclared identifier '{e.name}'", e.line)
        return v

    def _ssbo_ref_of(self, expr: Any, scope) -> Optional[Val]:
        """Resolve `member` / `instance.member` to a Val("ssbo", (block,
        member)) reference without reading the value (atomic/store
        targets)."""
        if isinstance(expr, ast.Ident) and expr.name in self.ssbo_members:
            if scope.lookup(expr.name) is not None:
                return None  # shadowed by a local
            return Val("ssbo", (self.ssbo_members[expr.name][0], expr.name))
        if (
            isinstance(expr, ast.Member)
            and isinstance(expr.expr, ast.Ident)
            and expr.expr.name in self.ssbo_instances
        ):
            block = self.ssbo_instances[expr.expr.name]
            got = self.ssbo_members.get(expr.name)
            if got is not None and got[0] == block:
                return Val("ssbo", (block, expr.name))
        return None

    def _eval_Member(self, e: ast.Member, scope) -> Val:
        # Special-case gl_GlobalInvocationID components to keep origins.
        if isinstance(e.expr, ast.Ident) and e.expr.name == "gl_GlobalInvocationID":
            return self._swizzle_gid(e.name, e.line)
        base = self.eval_expr(e.expr, scope)
        if base.type.startswith("struct:"):
            field = base.data.get(e.name)
            if field is None:
                raise GlslError(
                    f"struct {base.type.split(':', 1)[1]} has no member "
                    f"'{e.name}'",
                    e.line,
                )
            return field
        if base.type == "ssbo_block":
            block = base.data
            got = self.ssbo_members.get(e.name)
            if got is None or got[0] != block:
                raise GlslError(f"SSBO block has no member '{e.name}'", e.line)
            if e.name in self.ssbo_scalar:
                return self._ssbo_read((block, e.name), Val("int", 0), e.line)
            return Val("ssbo", (block, e.name))
        return self._swizzle(base, e.name, e.line)

    def _swizzle_gid(self, name: str, line: int) -> Val:
        comps = {"x": 0, "y": 1, "z": 2}
        idxs = [comps.get(c) for c in name]
        if any(i is None for i in idxs):
            raise GlslError(f"bad swizzle '.{name}' on gl_GlobalInvocationID", line)
        vals = [self._gid_comps[i] for i in idxs]
        if len(vals) == 1:
            return vals[0]
        v = Val(f"uvec{len(vals)}", [c.data for c in vals])
        v._comp_origins = [c.origin for c in vals]  # type: ignore[attr-defined]
        return v

    def _swizzle(self, base: Val, name: str, line: int) -> Val:
        if not base.is_vector():
            raise GlslError(f"cannot swizzle non-vector type {base.type}", line)
        for letters in SWIZZLE_SETS:
            if all(c in letters for c in name):
                idxs = [letters.index(c) for c in name]
                break
        else:
            raise GlslError(f"bad swizzle '.{name}'", line)
        if max(idxs) >= base.size:
            raise GlslError(f"swizzle '.{name}' out of range for {base.type}", line)
        elem = base.elem_type
        base_origins = getattr(base, "_comp_origins", None)
        if len(idxs) == 1:
            origin = base_origins[idxs[0]] if base_origins else None
            return Val(elem, base.data[idxs[0]], origin)
        prefix = {"float": "", "int": "i", "uint": "u", "bool": "b"}[elem]
        v = Val(f"{prefix}vec{len(idxs)}", [base.data[i] for i in idxs])
        if base_origins:
            v._comp_origins = [base_origins[i] for i in idxs]  # type: ignore[attr-defined]
        return v

    def _dyn_index_plane(self, idx: Val, n: int, line: int) -> Any:
        """A traced (per-pixel or traced-uniform) index as a clamped
        (h, w) int32 plane.  GLSL leaves out-of-bounds dynamic indexing
        undefined; clamping to the valid range is the robustBufferAccess
        convention (the scalar reference clamps identically)."""
        if idx.type not in ("int", "uint"):
            raise GlslError("array/vector index must be an integer", line)
        return torch.clamp(self._as_array(idx.data, "int"), 0, n - 1)

    def _gather_leaf(self, datas: list, elem_t: str, i: Any) -> Any:
        """Per-lane gather over scalar leaves: out[y,x] = datas[i[y,x]].
        Leaves stack to one (n, h, w) array; a single take_along_axis
        resolves every lane (XLA lowers it to a vectorized select tree
        for small n)."""
        # Recorded for the mc planner: take_along_axis lowers to a gather
        # XLA op that Mosaic may refuse inside a Pallas kernel, so shaders
        # using per-lane local-array gathers stay off the in-kernel
        # block-evaluation path (they still run everywhere else).
        self.stats["dyn_gather"] = True
        stacked = torch.stack([self._as_array(d, elem_t) for d in datas])
        return torch.gather(stacked, 0, i[None].to(torch.int64))[0]

    def _gather_elems(self, elems: list, i: Any, line: int) -> Val:
        """Per-lane gather over a list of same-typed Vals (the elements of
        a local array): result[lane] = elems[i[lane]].  Recurses through
        vectors, matrices, structs, and nested arrays down to scalar
        leaves."""
        proto = elems[0]
        if proto.is_vector():
            return Val(
                proto.type,
                [
                    self._gather_leaf(
                        [e.data[c] for e in elems], proto.elem_type, i
                    )
                    for c in range(proto.size)
                ],
            )
        if proto.type in MAT_TYPES:
            n = MAT_TYPES[proto.type]
            return Val(
                proto.type,
                [
                    [
                        self._gather_leaf(
                            [e.data[col][c] for e in elems], "float", i
                        )
                        for c in range(n)
                    ]
                    for col in range(n)
                ],
            )
        if proto.type.startswith("struct:"):
            return Val(
                proto.type,
                {
                    k: self._gather_elems([e.data[k] for e in elems], i, line)
                    for k in proto.data
                },
            )
        if proto.type.startswith("array"):
            return Val(
                proto.type,
                [
                    self._gather_elems([e.data[s] for e in elems], i, line)
                    for s in range(len(proto.data))
                ],
            )
        return Val(
            proto.type,
            self._gather_leaf([e.data for e in elems], proto.type, i),
        )

    def _eval_Index(self, e: ast.Index, scope) -> Val:
        base = self.eval_expr(e.expr, scope)
        idx = self.eval_expr(e.index, scope)
        if base.type == "ssbo":
            return self._ssbo_read(base.data, idx, e.line)
        if base.type == "shared":
            return self._shared_read(base.data, idx, e.line)
        if base.type.startswith("array"):
            if not is_static(idx.data):
                i = self._dyn_index_plane(idx, len(base.data), e.line)
                return self._gather_elems(base.data, i, e.line)
            return base.data[int(idx.data)]
        if base.is_vector():
            if not is_static(idx.data):
                i = self._dyn_index_plane(idx, base.size, e.line)
                return Val(
                    base.elem_type,
                    self._gather_leaf(base.data, base.elem_type, i),
                )
            return Val(base.elem_type, base.data[int(idx.data)])
        if base.type in MAT_TYPES:
            n = MAT_TYPES[base.type]
            if not is_static(idx.data):
                i = self._dyn_index_plane(idx, n, e.line)
                return Val(
                    f"vec{n}",
                    [
                        self._gather_leaf(
                            [base.data[col][c] for col in range(n)],
                            "float",
                            i,
                        )
                        for c in range(n)
                    ],
                )
            return Val(f"vec{n}", list(base.data[int(idx.data)]))
        raise GlslError(f"cannot index type {base.type}", e.line)

    def _eval_Unary(self, e: ast.Unary, scope) -> Val:
        if e.op in ("++pre", "--pre", "++post", "--post"):
            old = self.eval_expr(e.expr, scope)
            delta = 1 if "++" in e.op else -1
            one = Val(old.type, delta) if not old.is_vector() else None
            new = self._issued(self._arith("+", old, Val("int", delta), e.line))
            self._assign_to(e.expr, new, scope, e.line)
            return old if e.op.endswith("post") else new
        v = self.eval_expr(e.expr, scope)
        return self._issued(self._unary(e, v))

    def _unary(self, e: ast.Unary, v: Val) -> Val:
        if e.op == "-":
            def neg(c):
                out = self._neg(c)
                if v.elem_type == "uint" and not is_static(out):
                    out = out & U32
                if v.elem_type in ("int", "uint") and is_static(out):
                    out = self._wrap_static_int(out, v.elem_type)
                return out

            if v.is_vector():
                return Val(v.type, [neg(c) for c in v.data], None)
            return Val(v.type, neg(v.data))
        if e.op == "!":
            if v.type != "bool":
                raise GlslError("'!' needs bool", e.line)
            data = lnot(v.data)
            return Val("bool", data)
        if e.op == "~":
            if is_static(v.data):
                data = self._wrap_static_int(~int(v.data), v.type)
            else:
                data = (v.data ^ U32) if v.type == "uint" else torch.bitwise_not(v.data)
            return Val(v.type, data)
        raise GlslError(f"unsupported unary '{e.op}'", e.line)

    @staticmethod
    def _neg(x):
        return -x

    def _eval_Ternary(self, e: ast.Ternary, scope) -> Val:
        cond = self.eval_expr(e.cond, scope)
        if cond.type != "bool":
            raise GlslError("?: condition must be bool", e.line)
        if is_static(cond.data):
            return self.eval_expr(e.then if cond.data else e.other, scope)
        # Evaluate each branch under its lane mask so side effects inside
        # (atomicAdd, out-param writes) are predicated like if/else.
        outer = self.mask
        self.mask = (
            cond.data if outer is None else land(outer, cond.data)
        )
        try:
            a = self.eval_expr(e.then, scope)
        finally:
            self.mask = outer
        neg = lnot(cond.data)
        self.mask = neg if outer is None else land(outer, neg)
        try:
            b = self.eval_expr(e.other, scope)
        finally:
            self.mask = outer
        a, b = self._usual_convert(a, b, e.line)
        if a.is_vector():
            return self._issued(Val(a.type, [where(cond.data, x, y, a.elem_type)
                                             for x, y in zip(a.data, b.data)]))
        return self._issued(Val(a.type, where(cond.data, a.data, b.data, a.type)))

    def _eval_Binary(self, e: ast.Binary, scope) -> Val:
        if e.op in ("&&", "||"):
            a = self.eval_expr(e.left, scope)
            if a.type != "bool":
                raise GlslError(f"'{e.op}' needs bool operands", e.line)
            if is_static(a.data):
                # Short-circuit on uniform left operand.
                if e.op == "&&" and not a.data:
                    return Val("bool", False)
                if e.op == "||" and a.data:
                    return Val("bool", True)
                return self.eval_expr(e.right, scope)
            b = self.eval_expr(e.right, scope)
            fn = land if e.op == "&&" else lor
            return self._issued(Val("bool", fn(a.data, b.data)))
        a = self.eval_expr(e.left, scope)
        b = self.eval_expr(e.right, scope)
        if e.op in ("==", "!=", "<", ">", "<=", ">="):
            return self._issued(self._compare(e.op, a, b, e.line))
        return self._issued(self._arith(e.op, a, b, e.line))

    def _eval_Assign(self, e: ast.Assign, scope) -> Val:
        value = self.eval_expr(e.value, scope)
        if e.op != "=":
            old = self.eval_expr(e.target, scope)
            value = self._issued(self._arith(e.op[:-1], old, value, e.line))
        self._assign_to(e.target, value, scope, e.line)
        return value

    def _eval_Call(self, e: ast.Call, scope) -> Val:
        return self.call(e.name, e.args, scope, e.line)

    def _eval_ArrayLit(self, e: ast.ArrayLit, scope) -> Val:
        elems = [
            self.convert(self.eval_expr(x, scope), e.elem_type, e.line)
            for x in e.elems
        ]
        return Val(f"array:{e.elem_type}", elems)

    # ---- assignment targets --------------------------------------------

    def _assign_to(self, target: Any, value: Val, scope: "_Scope", line: int) -> None:
        if isinstance(target, ast.Ident):
            old = scope.lookup(target.name)
            if old is None and target.name in self.ssbo_scalar:
                # Scalar SSBO member: `count = 0u;` writes element 0 of
                # its range (uniform value required, like any SSBO store).
                ref = (self.ssbo_members[target.name][0], target.name)
                self._ssbo_write(ref, Val("int", 0), value, scope, line)
                return
            if old is None:
                raise GlslError(f"assignment to undeclared '{target.name}'", line)
            value = self.convert(value, old.type, line)
            m = self._effective_mask(scope)
            if m is None:
                merged = value
            elif value.is_vector():
                merged = Val(
                    value.type,
                    [where(m, n, o, value.elem_type) for n, o in zip(value.data, old.data)],
                )
            elif value.type in MAT_TYPES:
                merged = Val(
                    value.type,
                    [
                        [where(m, n, o, "float") for n, o in zip(nc, oc)]
                        for nc, oc in zip(value.data, old.data)
                    ],
                )
            elif value.type.startswith("struct:"):
                merged = self._mask_merge_val(m, value, old)
            elif value.type.startswith("array"):
                merged = Val(
                    value.type,
                    [
                        self._mask_merge_val(m, nv, ov)
                        for nv, ov in zip(value.data, old.data)
                    ],
                )
            else:
                merged = Val(value.type, where(m, value.data, old.data, value.type))
            scope.assign(target.name, merged)
            return
        if isinstance(target, ast.Member):
            if (
                isinstance(target.expr, ast.Ident)
                and target.expr.name in self.ssbo_instances
                and target.name in self.ssbo_scalar
            ):
                block = self.ssbo_instances[target.expr.name]
                if self.ssbo_members[target.name][0] == block:
                    self._ssbo_write(
                        (block, target.name), Val("int", 0), value, scope, line
                    )
                    return
            base_old = self.eval_expr(target.expr, scope)
            if base_old.type.startswith("struct:"):
                sname = base_old.type.split(":", 1)[1]
                ftype = next(
                    (ft for ft, fn in self.shader.structs[sname] if fn == target.name),
                    None,
                )
                if ftype is None:
                    raise GlslError(f"struct {sname} has no member '{target.name}'", line)
                value = self.convert(value, ftype, line) if ftype not in self.shader.structs else value
                fields = dict(base_old.data)
                m = self._effective_mask(scope)
                fields[target.name] = (
                    value if m is None else self._mask_merge_val(m, value, fields[target.name])
                )
                self._assign_to(target.expr, Val(base_old.type, fields), scope, line)
                return
            if not base_old.is_vector():
                raise GlslError("swizzle store on non-vector", line)
            for letters in SWIZZLE_SETS:
                if all(c in letters for c in target.name):
                    idxs = [letters.index(c) for c in target.name]
                    break
            else:
                raise GlslError(f"bad swizzle '.{target.name}'", line)
            new_comps = list(base_old.data)
            if len(idxs) == 1:
                value = self.convert(value, base_old.elem_type, line)
                new_comps[idxs[0]] = self._write_masked_scoped(
                    scope, base_old.data[idxs[0]], value.data, base_old.elem_type
                )
            else:
                if not value.is_vector() or value.size != len(idxs):
                    raise GlslError("swizzle store size mismatch", line)
                for slot, comp in zip(idxs, value.data):
                    new_comps[slot] = self._write_masked_scoped(
                        scope, new_comps[slot], comp, base_old.elem_type
                    )
            self._assign_to(
                target.expr, Val(base_old.type, new_comps), scope, line
            )
            return
        if isinstance(target, ast.Index):
            base_old = self.eval_expr(target.expr, scope)
            idx = self.eval_expr(target.index, scope)
            if base_old.type == "ssbo":
                self._ssbo_write(base_old.data, idx, value, scope, line)
                return
            if base_old.type == "shared":
                self._shared_write(base_old.data, idx, value, scope, line)
                return
            if not is_static(idx.data):
                # Dynamic (per-pixel) indexed store: lane k of the index
                # selects element k — lower to one masked merge per
                # element (i == k composes with the enclosing lane mask).
                if base_old.type.startswith("array"):
                    n = len(base_old.data)
                    elem_t = base_old.type.split(":", 1)[1]
                    if not elem_t.startswith(("struct:",)) and (
                        elem_t not in self.shader.structs
                    ):
                        value = self.convert(value, elem_t, line)
                    ip = self._dyn_index_plane(idx, n, line)
                    m = self._effective_mask(scope)
                    elems = list(base_old.data)
                    for k in range(n):
                        mk = ip == k
                        if m is not None:
                            mk = land(mk, m)
                        elems[k] = self._mask_merge_val(mk, value, elems[k])
                    self._assign_to(
                        target.expr, Val(base_old.type, elems), scope, line
                    )
                    return
                if base_old.is_vector():
                    value = self.convert(value, base_old.elem_type, line)
                    ip = self._dyn_index_plane(idx, base_old.size, line)
                    m = self._effective_mask(scope)
                    comps = list(base_old.data)
                    for k in range(base_old.size):
                        mk = ip == k
                        if m is not None:
                            mk = land(mk, m)
                        comps[k] = torch.where(
                            mk,
                            self._as_array(value.data, base_old.elem_type),
                            self._as_array(comps[k], base_old.elem_type),
                        )
                    self._assign_to(
                        target.expr, Val(base_old.type, comps), scope, line
                    )
                    return
                raise GlslError("store through non-uniform index", line)
            i = int(idx.data)
            if base_old.type.startswith("array"):
                elems = list(base_old.data)
                elem_t = base_old.type.split(":", 1)[1]
                value = self.convert(value, elem_t, line)
                m = self._effective_mask(scope)
                elems[i] = (
                    value if m is None else self._mask_merge_val(m, value, elems[i])
                )
                self._assign_to(target.expr, Val(base_old.type, elems), scope, line)
                return
            if base_old.is_vector():
                comps = list(base_old.data)
                value = self.convert(value, base_old.elem_type, line)
                comps[i] = self._write_masked_scoped(scope, comps[i], value.data,
                                                     base_old.elem_type)
                self._assign_to(target.expr, Val(base_old.type, comps), scope, line)
                return
            raise GlslError("cannot index-assign this type", line)
        raise GlslError("unsupported assignment target", line)


    def _write_masked_scoped(self, scope: "_Scope", old: Any, new: Any, elem: str) -> Any:
        m = self._effective_mask(scope)
        if m is None:
            return new
        return where(m, new, old, elem)

    def _effective_mask(self, scope: "_Scope") -> Optional[Any]:
        live = scope.activation.live_mask()
        if self.mask is None:
            return live
        if live is None:
            return self.mask
        return land(self.mask, live)


    def _usual_convert(self, a: Val, b: Val, line: int) -> tuple[Val, Val]:
        """Implicit conversions + scalar->vector broadcast for binary ops."""
        if a.is_vector() and not b.is_vector():
            b = Val(a.type, [self.convert(b, a.elem_type, line).data] * a.size)
        elif b.is_vector() and not a.is_vector():
            a = Val(b.type, [self.convert(a, b.elem_type, line).data] * b.size)
        elif a.is_vector() and b.is_vector():
            if a.size != b.size:
                raise GlslError(f"vector size mismatch {a.type} vs {b.type}", line)
            if a.elem_type != b.elem_type:
                if "float" in (a.elem_type, b.elem_type):
                    a = self.convert(a, f"vec{a.size}", line)
                    b = self.convert(b, f"vec{b.size}", line)
        else:
            if a.type != b.type:
                if "float" in (a.type, b.type):
                    a = self.convert(a, "float", line)
                    b = self.convert(b, "float", line)
                elif {"int", "uint"} == {a.type, b.type}:
                    # GLSL usual conversions promote the int to uint.
                    a = self.convert(a, "uint", line)
                    b = self.convert(b, "uint", line)
        return a, b

    def _arith(self, op: str, a: Val, b: Val, line: int) -> Val:
        if a.type in MAT_TYPES or b.type in MAT_TYPES:
            return self._mat_arith(op, a, b, line)
        a, b = self._usual_convert(a, b, line)
        if a.is_vector():
            a_origins = getattr(a, "_comp_origins", None) or [None] * a.size
            b_origins = getattr(b, "_comp_origins", None) or [None] * a.size
            comps = [
                self._arith_scalar(op, a.elem_type, x, y, line, ox, oy)
                for x, y, ox, oy in zip(a.data, b.data, a_origins, b_origins)
            ]
            out = Val(a.type, [c[0] for c in comps])
            if a.elem_type in ("int", "uint") and any(c[1] for c in comps):
                out._comp_origins = [c[1] for c in comps]  # type: ignore[attr-defined]
            return out
        data, origin = self._arith_scalar(op, a.type, a.data, b.data, line, a.origin, b.origin)
        return Val(a.type, data, origin)


    def _arith_scalar(
        self, op, elem, x, y, line, ox: Optional[Origin] = None, oy: Optional[Origin] = None
    ):
        is_int = elem in ("int", "uint")
        static = is_static(x) and is_static(y)

        def ints(a, b):
            """Both operands as tensors of the elem's type, so mixed
            static/tensor math wraps at 32 bits like the GPU."""
            return self._as_tensor(a, elem), self._as_tensor(b, elem)

        def wrap(v):
            return v & U32 if elem == "uint" else v

        if op == "+":
            if is_int:
                if static:
                    data = self._wrap_static_int(x + y, elem)
                else:
                    xa, ya = ints(x, y)
                    data = wrap(xa + ya)
            else:
                data = x + y
            origin = None
            if ox is not None and is_static(y):
                origin = Origin(ox.axis, ox.offset + int(y), False)
            elif oy is not None and is_static(x):
                origin = Origin(oy.axis, oy.offset + int(x), False)
            return data, origin
        if op == "-":
            if is_int:
                if static:
                    data = self._wrap_static_int(x - y, elem)
                else:
                    xa, ya = ints(x, y)
                    data = wrap(xa - ya)
            else:
                data = x - y
            origin = None
            if ox is not None and is_static(y):
                origin = Origin(ox.axis, ox.offset - int(y), False)
            return data, origin
        if op == "*":
            if is_int:
                if static:
                    return self._wrap_static_int(x * y, elem), None
                xa, ya = ints(x, y)
                return wrap(xa * ya), None
            return x * y, None
        if op == "/":
            if is_int:
                if static:
                    x = self._wrap_static_int(x, elem)
                    y = self._wrap_static_int(y, elem)
                    q = abs(x) // abs(y) if y != 0 else 0
                    return (q if (x >= 0) == (y >= 0) else -q), None
                # lax.div: truncation; x / 0 gives -1 (int) or 2**32 - 1
                # (uint), INT_MIN / -1 gives INT_MIN.
                xa, ya = ints(x, y)
                zero = ya == 0
                if elem == "uint":
                    q = torch.div(xa, torch.where(zero, 1, ya), rounding_mode="trunc")
                    return torch.where(zero, U32, q), None
                ovf = (xa == _I32_MIN) & (ya == -1)
                q = torch.div(xa, torch.where(zero | ovf, 1, ya), rounding_mode="trunc")
                return torch.where(zero, -1, torch.where(ovf, _I32_MIN, q)), None
            if static:
                return (x / y if y != 0 else 0.0), None
            # A static divisor goes to the device first: PyTorch's CUDA
            # kernels multiply by the reciprocal of a Python scalar.
            return x / self._as_tensor(y, "float") if is_static(y) else x / y, None
        if op == "%":
            if is_int:
                if static:
                    x = self._wrap_static_int(x, elem)
                    y = self._wrap_static_int(y, elem)
                    if y == 0:
                        return 0, None
                    r = abs(x) % abs(y)
                    return (r if x >= 0 else -r), None
                # lax.rem: C's remainder (sign of x); x % 0 gives x.
                xa, ya = ints(x, y)
                zero = ya == 0
                r = torch.fmod(xa, torch.where(zero | (ya == -1), 1, ya))
                return torch.where(zero, xa, r), None
            raise GlslError("'%' on floats: use mod()", line)
        if op in ("&", "|", "^", "<<", ">>"):
            if not is_int and elem != "bool":
                raise GlslError(f"'{op}' needs integer operands", line)
            fn = {"&": _op.and_, "|": _op.or_, "^": _op.xor,
                  "<<": _op.lshift, ">>": _op.rshift}[op]
            if elem == "bool":
                if static:
                    return fn(bool(x), bool(y)), None
                return fn(self._as_tensor(x, "bool"), self._as_tensor(y, "bool")), None
            if static:
                return self._wrap_static_int(
                    fn(self._wrap_static_int(x, elem),
                       self._wrap_static_int(y, elem) if op not in ("<<", ">>") else int(y)),
                    elem,
                ), None
            xa, ya = ints(x, y)
            if op in ("<<", ">>"):
                # XLA: a count outside [0, 32) shifts every bit out.
                out_of_range = (ya < 0) | (ya >= 32)
                n = torch.where(out_of_range, 0, ya).to(xa.dtype)
                if op == "<<":
                    return torch.where(out_of_range, 0, wrap(xa << n)), None
                spill = torch.where(xa < 0, -1, 0) if elem == "int" else 0
                return torch.where(out_of_range, spill, xa >> n), None
            return fn(xa, ya), None
        raise GlslError(f"unsupported operator '{op}'", line)

    def _compare(self, op: str, a: Val, b: Val, line: int) -> Val:
        a, b = self._usual_convert(a, b, line)
        if a.is_vector():
            raise GlslError(f"'{op}' on vectors: use lessThan()/equal() etc.", line)
        fn = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, ">": _op.gt,
              "<=": _op.le, ">=": _op.ge}[op]
        x, y = a.data, b.data
        if is_static(x) and is_static(y):
            return Val("bool", fn(x, y))
        if is_static(x):
            x = self._as_tensor(x, a.type)
        return Val("bool", fn(x, y))

    def convert(self, v: Val, to_type: str, line: int) -> Val:
        if v.type == to_type:
            return v
        if to_type.endswith("]") and "[" in to_type:
            # Array-typed conversion target ("float[4]": a function's
            # array return type).  GLSL arrays convert only to the exact
            # same element type and size.
            elem, n = to_type[:-1].split("[")
            if v.type == f"array:{elem}" and len(v.data) == int(n):
                return v
            raise GlslError(f"cannot convert {v.type} to {to_type}", line)
        if to_type in self.shader.structs:
            if v.type == f"struct:{to_type}":
                return v
            raise GlslError(f"cannot convert {v.type} to {to_type}", line)
        if v.type.startswith("struct:"):
            raise GlslError(f"cannot convert {v.type} to {to_type}", line)
        if to_type in MAT_TYPES or v.type in MAT_TYPES:
            raise GlslError(f"cannot convert {v.type} to {to_type}", line)
        if to_type in SCALAR_TYPES:
            if v.is_vector():
                raise GlslError(f"cannot convert {v.type} to {to_type}", line)
            return Val(to_type, self._cast_scalar(v.data, v.type, to_type), v.origin if to_type in ("int", "uint") and v.type in ("int", "uint") else None)
        if to_type in VEC_TYPES:
            elem, n = VEC_TYPES[to_type]
            if v.is_vector():
                if v.size != n:
                    raise GlslError(f"cannot convert {v.type} to {to_type}", line)
                out = Val(to_type, [self._cast_scalar(c, v.elem_type, elem) for c in v.data])
                # int<->uint vector conversions preserve pixel provenance.
                if elem in ("int", "uint") and v.elem_type in ("int", "uint"):
                    origins = getattr(v, "_comp_origins", None)
                    if origins:
                        out._comp_origins = list(origins)  # type: ignore[attr-defined]
                return out
            return Val(to_type, [self._cast_scalar(v.data, v.type, elem)] * n)
        raise GlslError(f"cannot convert {v.type} to {to_type}", line)


    def _cast_scalar(self, x, from_t: str, to_t: str):
        if from_t == to_t:
            return x
        if is_static(x):
            if to_t == "float":
                return float(x)
            if to_t in ("int", "uint"):
                # C-style truncation then 32-bit wrap.
                return self._wrap_static_int(int(x), to_t)
            if to_t == "bool":
                return bool(x)
        return cast(x, to_t)

    # ---- calls ----------------------------------------------------------

    def call(self, name: str, arg_exprs: list, scope: "_Scope", line: int) -> Val:
        if name == "__method_length":  # arr.length() / vec.length()
            v = self.eval_expr(arg_exprs[0], scope)
            if v.type == "ssbo":
                _, member = v.data
                return Val("int", self.ssbo_members[member][1])
            if v.type.startswith("array:"):
                return Val("int", len(v.data))
            if v.is_vector():
                return Val("int", v.size)
            if v.type in MAT_TYPES:
                return Val("int", MAT_TYPES[v.type])
            raise GlslError(f".length() on non-array type {v.type}", line)
        # Type constructors.
        if name in SCALAR_TYPES:
            if len(arg_exprs) != 1:
                raise GlslError(f"{name}() takes one argument", line)
            v = self.eval_expr(arg_exprs[0], scope)
            return v if v.type == name else self._issued(self.convert(v, name, line))
        if name in VEC_TYPES:
            return self._construct_vector(name, arg_exprs, scope, line)
        if name in MAT_TYPES:
            return self._construct_matrix(name, arg_exprs, scope, line)
        if name in self.shader.structs:
            fields_decl = self.shader.structs[name]
            args = [self.eval_expr(a, scope) for a in arg_exprs]
            if len(args) != len(fields_decl):
                raise GlslError(
                    f"{name}() takes {len(fields_decl)} fields, got {len(args)}", line
                )
            fields = {}
            for (ftype, fname), arg in zip(fields_decl, args):
                fields[fname] = (
                    arg if ftype in self.shader.structs
                    else self.convert(arg, ftype, line)
                )
            return Val(f"struct:{name}", fields)
        if name == "transpose":
            (m,) = [self.eval_expr(a, scope) for a in arg_exprs]
            if m.type not in MAT_TYPES:
                raise GlslError("transpose() needs a matrix", line)
            n = MAT_TYPES[m.type]
            cols = [[m.data[j][i] for j in range(n)] for i in range(n)]
            return Val(m.type, cols)
        if name in ("modf", "frexp"):
            # Out-parameter builtins: evaluate x, compute both parts,
            # write the out argument through the normal lvalue path.
            if len(arg_exprs) != 2:
                raise GlslError(f"{name}(x, out y) takes two arguments", line)
            x = self.eval_expr(arg_exprs[0], scope)
            if name == "modf":
                from .builtins import BUILTIN_FUNCS

                whole = BUILTIN_FUNCS["trunc"](self, [x], line)
                self._assign_to(arg_exprs[1], whole, scope, line)
                return self._arith("-", x, whole, line)
            import math as _math

            comps = x.data if x.is_vector() else [x.data]
            ms, es = [], []
            for c in comps:
                if is_static(c):
                    m_, e_ = _math.frexp(float(c))
                    ms.append(m_)
                    es.append(e_)
                else:
                    # Exponent/significand split on the raw f32 bits
                    # (exact for normals; x == 0 -> (x, 0)).
                    c = cast(c, "float")
                    bits = c.view(torch.int32)
                    be = (bits >> 23) & 0xFF
                    m_ = ((bits & -0x7F800001) | (126 << 23)).view(torch.float32)
                    zero = c == 0.0
                    ms.append(torch.where(zero, c, m_))
                    es.append(torch.where(zero, 0, be - 126))
            if x.is_vector():
                self._assign_to(
                    arg_exprs[1], Val(f"ivec{x.size}", es), scope, line
                )
                return Val(x.type, ms)
            self._assign_to(arg_exprs[1], Val("int", es[0]), scope, line)
            return Val("float", ms[0])
        if name == "imageLoad":
            return self._image_load(arg_exprs, scope, line)
        if name == "imageStore":
            return self._image_store(arg_exprs, scope, line)
        if name in ("imageSize", "textureSize"):
            return self._image_size(arg_exprs, scope, line)
        if name in ("texture", "textureLod"):
            # No mip chain exists (storage images, one resolution), so the
            # explicit-LOD variant samples level 0.
            return self._issued(self._texture(arg_exprs[:2], scope, line))
        if name == "texelFetch":
            return self._image_load(arg_exprs[:2], scope, line)
        if name in ATOMIC_FUNCS:
            return self._atomic_rmw(name, arg_exprs, scope, line)
        if name in IMAGE_ATOMIC_FUNCS:
            return self._image_atomic(name, arg_exprs, scope, line)
        if name in (
            "barrier", "memoryBarrier", "memoryBarrierShared",
            "memoryBarrierBuffer", "memoryBarrierImage", "groupMemoryBarrier",
        ):
            # The vectorized whole-image model executes each statement for
            # ALL invocations before the next statement — sequentially
            # consistent, strictly stronger than any barrier; these lower
            # to no-ops.  (barrier() inside non-uniform control flow is UB
            # in GLSL, so masked execution needs no special case.)
            return Val("void", None)
        from .builtins import BUILTIN_FUNCS

        fn = BUILTIN_FUNCS.get(name)
        if fn is not None:
            args = [self.eval_expr(a, scope) for a in arg_exprs]
            return self._issued(fn(self, args, line))
        user = self.shader.functions.get(name)
        if user is not None:
            return self._call_user(user, arg_exprs, scope, line)
        raise GlslError(f"unknown function '{name}'", line)

    def _construct_vector(self, name: str, arg_exprs: list, scope, line) -> Val:
        elem, n = VEC_TYPES[name]
        args = [self.eval_expr(a, scope) for a in arg_exprs]
        comps: list = []
        origins: list = []
        for a in args:
            if a.is_vector():
                a_origins = getattr(a, "_comp_origins", None) or [None] * a.size
                for c, o in zip(a.data, a_origins):
                    comps.append(self._cast_scalar(c, a.elem_type, elem))
                    origins.append(o if elem in ("int", "uint") else None)
            else:
                comps.append(self._cast_scalar(a.data, a.type, elem))
                origins.append(a.origin if elem in ("int", "uint") else None)
        if len(comps) == 1 and n > 1:
            comps = comps * n
            origins = origins * n
        if len(comps) < n:
            raise GlslError(f"too few components for {name}", line)
        comps = comps[:n]
        origins = origins[:n]
        v = Val(name, comps)
        # Keep per-component origin info for ivec2 pixel coords.
        v._comp_origins = origins  # type: ignore[attr-defined]
        return v

    def _construct_matrix(self, name: str, arg_exprs: list, scope, line) -> Val:
        """mat constructors: diagonal from scalar, column vectors, or n*n
        scalars in column-major order (GLSL convention)."""
        n = MAT_TYPES[name]
        args = [self.eval_expr(a, scope) for a in arg_exprs]
        if len(args) == 1 and not args[0].is_vector() and args[0].type not in MAT_TYPES:
            s = self._cast_scalar(args[0].data, args[0].type, "float")
            cols = [[s if i == j else 0.0 for i in range(n)] for j in range(n)]
            return Val(name, cols)
        if len(args) == 1 and args[0].type in MAT_TYPES:
            m = args[0]
            src_n = MAT_TYPES[m.type]
            cols = [
                [
                    (m.data[j][i] if i < src_n and j < src_n else (1.0 if i == j else 0.0))
                    for i in range(n)
                ]
                for j in range(n)
            ]
            return Val(name, cols)
        if all(a.is_vector() for a in args):
            if len(args) != n or any(a.size != n for a in args):
                raise GlslError(f"{name}() needs {n} column vectors of size {n}", line)
            cols = [
                [self._cast_scalar(c, a.elem_type, "float") for c in a.data]
                for a in args
            ]
            return Val(name, cols)
        flat: list = []
        for a in args:
            if a.is_vector():
                flat.extend(self._cast_scalar(c, a.elem_type, "float") for c in a.data)
            else:
                flat.append(self._cast_scalar(a.data, a.type, "float"))
        if len(flat) != n * n:
            raise GlslError(f"{name}() needs {n * n} components, got {len(flat)}", line)
        cols = [flat[j * n : (j + 1) * n] for j in range(n)]
        return Val(name, cols)

    def _mat_arith(self, op: str, a: Val, b: Val, line: int) -> Val:
        """Matrix involvement in binary ops: linear-algebraic '*', else
        componentwise."""
        def vecname(k):
            return f"vec{k}"

        if op == "*":
            if a.type in MAT_TYPES and b.is_vector():
                n = MAT_TYPES[a.type]
                if b.size != n:
                    raise GlslError(f"{a.type} * {b.type}: size mismatch", line)
                bf = self.convert(b, vecname(n), line)
                out = []
                for i in range(n):
                    acc = None
                    for j in range(n):
                        term = a.data[j][i] * bf.data[j]
                        acc = term if acc is None else acc + term
                    out.append(acc)
                return Val(vecname(n), out)
            if a.is_vector() and b.type in MAT_TYPES:
                n = MAT_TYPES[b.type]
                if a.size != n:
                    raise GlslError(f"{a.type} * {b.type}: size mismatch", line)
                af = self.convert(a, vecname(n), line)
                out = []
                for j in range(n):
                    acc = None
                    for i in range(n):
                        term = af.data[i] * b.data[j][i]
                        acc = term if acc is None else acc + term
                    out.append(acc)
                return Val(vecname(n), out)
            if a.type in MAT_TYPES and b.type in MAT_TYPES:
                if a.type != b.type:
                    raise GlslError(f"cannot multiply {a.type} by {b.type}", line)
                n = MAT_TYPES[a.type]
                cols = []
                for j in range(n):
                    col = []
                    for i in range(n):
                        acc = None
                        for k in range(n):
                            term = a.data[k][i] * b.data[j][k]
                            acc = term if acc is None else acc + term
                        col.append(acc)
                    cols.append(col)
                return Val(a.type, cols)
        # Componentwise with scalar broadcast (+, -, scalar *, /).
        if a.type in MAT_TYPES and b.type in MAT_TYPES:
            if a.type != b.type:
                raise GlslError(f"type mismatch {a.type} vs {b.type}", line)
            n = MAT_TYPES[a.type]
            cols = [
                [
                    self._arith_scalar(op, "float", a.data[j][i], b.data[j][i], line)[0]
                    for i in range(n)
                ]
                for j in range(n)
            ]
            return Val(a.type, cols)
        mat, scalar, flipped = (
            (a, b, False) if a.type in MAT_TYPES else (b, a, True)
        )
        if scalar.is_vector():
            raise GlslError(f"cannot combine {a.type} and {b.type} with '{op}'", line)
        s = self._cast_scalar(scalar.data, scalar.type, "float")
        n = MAT_TYPES[mat.type]
        cols = []
        for j in range(n):
            col = []
            for i in range(n):
                x, y = (mat.data[j][i], s) if not flipped else (s, mat.data[j][i])
                col.append(self._arith_scalar(op, "float", x, y, line)[0])
            cols.append(col)
        return Val(mat.type, cols)


    def _texture(self, arg_exprs: list, scope, line: int) -> Val:
        """texture(sampler2D, vec2 uv): bilinear sample at normalized
        coordinates with clamp-to-edge (the reference's one sampler is
        linear/clamp -- vkutils.rs:359-370), except at the top and left
        edges: an inherited reference fault, kept bit for bit.  ``y1`` (and
        ``x1``) is taken from the clamped ``y0``, and the weight ``ty`` from
        the unclamped floor, so a sample inside the first row's outer half
        texel blends row 0 with row 1 where clamp-to-edge reads row 0.
        Fixing it moves four goldens and is a change of the contract
        (tests/test_torch_texture.py pins it)."""
        if len(arg_exprs) != 2:
            raise GlslError("texture(sampler, vec2)", line)
        name = self._get_image(arg_exprs[0], line)
        uv = self.eval_expr(arg_exprs[1], scope)
        if not uv.is_vector() or uv.size != 2 or uv.elem_type != "float":
            raise GlslError("texture() coordinate must be vec2", line)
        self.stats["gather"] = True
        self.samples += self.counted
        comps = self._image_current(name)
        # Pixel centers at (i + 0.5) / size.
        xf = self._as_array(uv.data[0], "float") * float(self.w) - 0.5
        yf = self._as_array(uv.data[1], "float") * float(self.h) - 0.5
        x0 = torch.floor(xf)
        y0 = torch.floor(yf)
        tx = xf - x0
        ty = yf - y0
        x0 = torch.clamp(cast(x0, "int"), 0, self.w - 1).to(torch.int64)
        x1 = torch.clamp(x0 + 1, 0, self.w - 1)
        y0 = torch.clamp(cast(y0, "int"), 0, self.h - 1).to(torch.int64)
        y1 = torch.clamp(y0 + 1, 0, self.h - 1)
        out = []
        for c in comps:
            arr = self._as_array(c, "float")
            p00 = arr[y0, x0]
            p01 = arr[y0, x1]
            p10 = arr[y1, x0]
            p11 = arr[y1, x1]
            top = p00 + (p01 - p00) * tx
            bot = p10 + (p11 - p10) * tx
            out.append(top + (bot - top) * ty)
        return Val("vec4", out)

    def _coord_origin(self, coord: Val) -> Optional[tuple[int, int, bool]]:
        """(dx, dy, clamped) when coord is pixel+static offset, else None."""
        origins = getattr(coord, "_comp_origins", None)
        if origins is None or len(origins) < 2:
            return None
        ox, oy = origins[0], origins[1]
        if ox is None or oy is None or ox.axis != "x" or oy.axis != "y":
            return None
        clamped = ox.clamped and oy.clamped
        if (ox.clamped or oy.clamped) and not clamped:
            return None
        return (ox.offset, oy.offset, clamped)

    def _get_image(self, arg: Any, line: int) -> str:
        if not isinstance(arg, ast.Ident):
            raise GlslError("image argument must be an image variable", line)
        names = {img.name for img in self.shader.images}
        if arg.name not in names:
            raise GlslError(f"'{arg.name}' is not a declared image", line)
        return arg.name

    def _image_current(self, name: str) -> list:
        """Current contents of an image as a 4-component list."""
        if name in self.stores:
            return self.stores[name]
        arr = self.images_in.get(name)
        if arr is None:
            # Writable image never loaded/stored yet: zeros.
            z = torch.zeros((self.h, self.w), dtype=torch.float32, device=self.device)
            return [z, z, z, torch.ones((self.h, self.w), dtype=torch.float32, device=self.device)]
        return [arr[i] for i in range(4)]

    def _image_load(self, arg_exprs: list, scope, line: int) -> Val:
        if len(arg_exprs) != 2:
            raise GlslError("imageLoad(image, ivec2)", line)
        name = self._get_image(arg_exprs[0], line)
        coord = self.eval_expr(arg_exprs[1], scope)
        if not coord.is_vector() or coord.size != 2:
            raise GlslError("imageLoad coordinate must be ivec2", line)
        comps = self._image_current(name)
        origin = self._coord_origin(coord)
        if origin is not None:
            dx, dy, clamped = origin
            self.stats["max_shift"] = max(self.stats["max_shift"], abs(dx), abs(dy))
            if dx == 0 and dy == 0:
                return Val("vec4", list(comps))
            self.stats["edge_shift" if clamped else "zero_shift"] = True
            return self._issued(Val("vec4", [self._shift(c, dx, dy, clamped) for c in comps]))
        # General gather: clamped indices, zeros out of bounds.
        self.stats["gather"] = True
        self.samples += self.counted
        xs = self._as_array(coord.data[0], "int")
        ys = self._as_array(coord.data[1], "int")
        inb = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        xc = torch.clamp(xs, 0, self.w - 1).to(torch.int64)
        yc = torch.clamp(ys, 0, self.h - 1).to(torch.int64)
        out = []
        for c in comps:
            arr = self._as_array(c, "float")
            out.append(torch.where(inb, arr[yc, xc], 0.0))
        return self._issued(Val("vec4", out))

    def _shift(self, plane: Any, dx: int, dy: int, clamped: bool) -> Any:
        """Read plane at (x+dx, y+dy): clamped indices (edge) or zeros."""
        arr = self._as_array(plane, "float")
        h, w = self.h, self.w
        if self.abstract:
            # Shapes only: index arithmetic on meta tensors runs through
            # PyTorch's Python references, milliseconds an op.
            return torch.zeros((h, w), dtype=arr.dtype, device=self.device)
        if clamped:
            ys = torch.clamp(torch.arange(dy, dy + h, device=self.device), 0, h - 1)
            xs = torch.clamp(torch.arange(dx, dx + w, device=self.device), 0, w - 1)
            return arr.index_select(0, ys).index_select(1, xs)
        out = torch.zeros((h, w), dtype=arr.dtype, device=self.device)
        y0, y1 = max(0, -dy), min(h, h - dy)
        x0, x1 = max(0, -dx), min(w, w - dx)
        if y0 < y1 and x0 < x1:
            out[y0:y1, x0:x1] = arr[y0 + dy : y1 + dy, x0 + dx : x1 + dx]
        return out

    def _image_store(self, arg_exprs: list, scope, line: int) -> Val:
        if len(arg_exprs) != 3:
            raise GlslError("imageStore(image, ivec2, vec4)", line)
        name = self._get_image(arg_exprs[0], line)
        coord = self.eval_expr(arg_exprs[1], scope)
        value = self.convert(self.eval_expr(arg_exprs[2], scope), "vec4", line)
        origin = self._coord_origin(coord)
        if origin is None or origin[:2] != (0, 0):
            return self._image_store_scatter(name, coord, value, scope, line)
        old = self._image_current(name)
        m = self._effective_mask(scope)
        if m is None:
            self.stores[name] = list(value.data)
        else:
            self.stores[name] = [
                torch.where(m, self._as_array(nw, "float"), self._as_array(od, "float"))
                for nw, od in zip(value.data, old)
            ]
        return Val("void", None)

    def _image_store_scatter(self, name: str, coord: Val, value: Val, scope, line: int) -> Val:
        """imageStore at a computed coordinate: a per-pixel scatter.

        GLSL leaves concurrent same-pixel writes unordered.  Here the last
        active lane in row-major order wins (see _last_writer); out-of-bounds
        and masked lanes write nothing."""
        if not coord.is_vector() or coord.size != 2:
            raise GlslError("imageStore coordinate must be ivec2", line)
        self.stats["gather"] = True
        xs = self._as_array(coord.data[0], "int")
        ys = self._as_array(coord.data[1], "int") - self.row_offset
        inb = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        mask = self._effective_mask(scope)
        keep = inb if mask is None else land(inb, mask)
        winner = self._last_writer(ys.to(torch.int64) * self.w + xs, keep, self.h * self.w)
        hit = winner >= 0
        src = winner.clamp(min=0)
        stored = []
        for ch_new, ch_old in zip(value.data, self._image_current(name)):
            v = self._as_array(ch_new, "float").reshape(-1)
            base = self._as_array(ch_old, "float").reshape(-1)
            stored.append(torch.where(hit, v[src], base).reshape(self.h, self.w))
        self.stores[name] = stored
        return Val("void", None)

    def _image_size(self, arg_exprs: list, scope, line: int) -> Val:
        self._get_image(arg_exprs[0], line)
        v = Val("ivec2", [self.global_w, self.global_h])
        v._comp_origins = [None, None]  # type: ignore[attr-defined]
        return v

    # ---- storage buffers ------------------------------------------------

    def _ssbo_read(self, ref: tuple, idx: Val, line: int) -> Val:
        block, member = ref
        size = self.ssbo_members[member][1]
        off = self.ssbo_offsets[member]
        elem = self.ssbo_elem.get(member, "float")
        buf = self.buffers[block]
        if is_static(idx.data):
            i = int(idx.data)
            if not 0 <= i < size:
                return self._zero_of(elem, line)  # robust out-of-bounds read
            v = buf[off + i]
        else:
            self.stats["gather"] = True
            ii = idx.data.to(torch.int64)
            inb = (ii >= 0) & (ii < size)
            v = torch.where(inb, buf[off + ii.clamp(0, size - 1)], 0.0)
        if elem != "float":
            v = cast(v, elem)  # f32 storage, the declared type's value view
        return Val(elem, v)

    def _ssbo_write(self, ref: tuple, idx: Val, value: Val, scope, line: int) -> None:
        """Plain indexed store: a uniform index and value only (a per-pixel
        scatter has no defined order in GLSL; atomics accumulate)."""
        block, member = ref
        size = self.ssbo_members[member][1]
        if not is_static(idx.data):
            raise GlslError(
                "SSBO stores need a uniform index (use atomicAdd for per-pixel accumulation)",
                line,
            )
        if self._effective_mask(scope) is not None:
            raise GlslError("SSBO stores under non-uniform conditions are not supported", line)
        v = self.convert(value, "float", line).data
        if not is_static(v) and getattr(v, "ndim", 0) != 0:
            raise GlslError("SSBO stores need a uniform value", line)
        i = int(idx.data)
        if 0 <= i < size:
            buf = self.buffers[block].clone()
            buf[self.ssbo_offsets[member] + i] = v
            self.buffers[block] = buf

    # ---- workgroup-shared arrays ----------------------------------------

    def _group_ids(self):
        """(H, W) int64 plane of flattened workgroup ids."""
        if self._gids is None:
            lsx, lsy, _ = self.shader.local_size
            groups_x = -(-self.global_w // lsx)
            self._gids = (self._global_rows() // lsy) * groups_x + self._iota("x") // lsx
        return self._gids

    def _lane_index(self, idx: Val):
        """``idx`` as an (H, W) int64 plane."""
        if is_static(idx.data):
            return torch.full((self.h, self.w), int(idx.data), dtype=torch.int64,
                              device=self.device)
        return torch.broadcast_to(idx.data.to(torch.int64), (self.h, self.w))

    def _shared_fid(self, name: str, idx: Val):
        """(flat slot plane, in-bounds mask) of shared[idx] per pixel."""
        size = self.shared_members[name][1]
        ii = self._lane_index(idx)
        inb = (ii >= 0) & (ii < size)
        return self._group_ids() * size + ii.clamp(0, size - 1), inb

    def _shared_read(self, name: str, idx: Val, line: int) -> Val:
        self.stats["gather"] = True
        elem = self.shared_members[name][0]
        fid, inb = self._shared_fid(name, idx)
        v = torch.where(inb, self.shared_state[name][fid], 0.0)
        return Val(elem, v if elem == "float" else cast(v, elem))

    def _shared_write(self, name: str, idx: Val, value: Val, scope, line: int) -> None:
        """Plain store: a per-pixel scatter.  Two invocations of one
        workgroup writing one slot is undefined in GLSL; the last active
        lane in row-major order wins, as in the JAX package on the CPU."""
        self.stats["gather"] = True
        elem = self.shared_members[name][0]
        vv = self._as_array(self.convert(value, elem, line).data, "float")
        fid, inb = self._shared_fid(name, idx)
        mask = self._effective_mask(scope)
        keep = inb if mask is None else land(inb, mask)
        state = self.shared_state[name]
        winner = self._last_writer(fid, keep, state.shape[0])
        self.shared_state[name] = torch.where(winner >= 0, vv.reshape(-1)[winner.clamp(min=0)],
                                              state)

    def _last_writer(self, fid, keep, total: int):
        """For each of ``total`` slots the largest lane index (row-major)
        of an active lane writing it, else -1: XLA's in-order scatter on
        the CPU, as an integer max that is the same on every device.
        Inactive lanes each target a slot of their own past the end (one
        shared slot would serialize millions of atomics on the card)."""
        n = self.h * self.w
        lane = torch.arange(n, device=self.device)
        keep = torch.broadcast_to(keep, (self.h, self.w)).reshape(-1)
        flat = torch.where(keep, fid.reshape(-1), total + lane)
        winner = torch.full((total + n,), -1, dtype=torch.int64, device=self.device)
        return winner.scatter_reduce(0, flat, lane, reduce="amax")[:total]

    # ---- atomics --------------------------------------------------------

    # Per op: (identity of inactive lanes, reduction) for add/min/max.
    _RMW = {
        "atomicAdd": (0.0, "sum"),
        "atomicMin": (float("inf"), "min"),
        "atomicMax": (float("-inf"), "max"),
    }
    _BITWISE = ("atomicAnd", "atomicOr", "atomicXor")

    def _lanes_i32(self, val: Val, line: int):
        """(H, W) int32 plane of a scalar operand's 32-bit two's-complement
        value (uint wraps; float truncates)."""
        if val.is_vector() or val.type.startswith(("mat", "struct:")):
            raise GlslError("atomic operand must be a scalar int/uint", line)
        v = val.data
        if is_static(v):
            return torch.full((self.h, self.w), self._wrap_static_int(int(v), "int"),
                              dtype=torch.int32, device=self.device)
        return torch.broadcast_to(cast(v, "int"), (self.h, self.w))

    def _segment_reduce(self, buf, fid, contrib, how: str, ident: float):
        """``buf`` with each lane's ``contrib`` reduced into its slot.

        On the CPU in lane order (``index_add``: ((b + c0) + c1) + ..., the
        bits of the JAX package's scatter-add; min and max by
        ``scatter_reduce``).  On the card the order is fixed as well, so a
        frame is bit-identical from run to run: a stable sort of the slots
        and one fixed-order segment reduction (``torch.segment_reduce``)
        per slot, then the buffer's value (no float atomics, whose order
        varies).  A sum there leaves the CPU's order; counts of 1.0 stay
        exact below 2**24."""
        if buf.device.type != "cuda":
            if how == "sum":
                return buf.index_add(0, fid, contrib)
            return buf.scatter_reduce(0, fid, contrib, reduce="a" + how, include_self=True)
        order = torch.sort(fid, stable=True).indices
        lengths = torch.bincount(fid, minlength=buf.shape[0])
        part = torch.segment_reduce(contrib[order], how, lengths=lengths, initial=ident,
                                    unsafe=True)
        if how == "sum":
            return buf + part
        return torch.minimum(buf, part) if how == "min" else torch.maximum(buf, part)

    def _atomic_apply(self, buf, fid, keep, op, vv_f, vv_i):
        """One atomic call site over a flat f32 buffer.

        ``fid`` is the (H, W) slot of each lane (clamped in bounds),
        ``keep`` the active lanes, ``vv_f``/``vv_i`` the operand as f32 and
        two's-complement int32 planes.  add/min/max: a masked segment
        reduction, inactive lanes giving the identity.  and/or/xor: the
        exact 32-bit-plane reduction on the integer value view (bit b of a
        slot from its own bit and the count of active lanes carrying bit
        b), stored back as f32.  exchange: the last active lane in
        row-major order wins (see _last_writer)."""
        if self.abstract:
            return buf
        total = buf.shape[0]
        hw = (self.h, self.w)
        keep = torch.broadcast_to(keep, hw)
        if op in self._RMW:
            ident, how = self._RMW[op]
            contrib = torch.where(keep, vv_f, ident).reshape(-1)
            return self._segment_reduce(buf, fid.reshape(-1), contrib, how, ident)
        if op == "atomicExchange":
            winner = self._last_writer(fid, keep, total)
            return torch.where(winner >= 0, vv_f.reshape(-1)[winner.clamp(min=0)], buf)
        fk = torch.where(keep, fid, total).reshape(-1)  # inactive lanes: a dropped slot
        keep_i = keep.reshape(-1).to(torch.int64)

        def count(bits):
            c = torch.zeros((total + 1,), dtype=torch.int64, device=self.device)
            return c.index_add_(0, fk, bits)[:total]

        cnt = count(keep_i)
        cur = cast(buf, "int")
        res = torch.zeros((total,), dtype=torch.int64, device=self.device)
        for b in range(32):
            cb = count(((vv_i >> b) & 1).reshape(-1).to(torch.int64) * keep_i)
            ib = ((cur >> b) & 1).to(torch.int64)
            if op == "atomicOr":
                nb = ib | (cb > 0).to(torch.int64)
            elif op == "atomicXor":
                nb = ib ^ (cb & 1)
            else:  # atomicAnd
                nb = ib & torch.where(cnt > 0, cb == cnt, True).to(torch.int64)
            res = res | (nb << b)
        return cast(res, "int").to(torch.float32)  # two's complement, then the f32 value

    def _atomic_call(self, buf, fid, keep, op: str, vals: list, line: int):
        """``buf`` after atomic ``op`` with operands ``vals``; compSwap is
        an exchange by the lanes whose compare matches the buffer before
        the call, the last of them winning: one order a GPU could run."""
        data = vals[-1]
        vv_f = self._as_array(self.convert(data, "float", line).data, "float")
        vv_i = (self._lanes_i32(data, line)
                if op in self._BITWISE or op == "atomicCompSwap" else None)
        if op == "atomicCompSwap":
            keep = land(keep, cast(buf[fid], "int") == self._lanes_i32(vals[0], line))
            op = "atomicExchange"
        return self._atomic_apply(buf, fid, keep, op, vv_f, vv_i)

    def _atomic_rmw(self, op: str, arg_exprs: list, scope, line: int) -> Val:
        """atomicAdd/Min/Max/And/Or/Xor/Exchange(mem[idx], value) and
        atomicCompSwap(mem[idx], compare, data) on SSBO members and shared
        arrays: one masked reduction over the pixel grid a call site (see
        _atomic_apply and _atomic_call).  Every atomic returns 0: the value
        before the operation depends on execution order on a GPU and has
        no meaning here."""
        nargs = 3 if op == "atomicCompSwap" else 2
        shape = "compare, data" if nargs == 3 else "value"
        if len(arg_exprs) != nargs:
            raise GlslError(f"{op}(ssbo_member[index], {shape})", line)
        if isinstance(arg_exprs[0], ast.Index):
            target = self.eval_expr(arg_exprs[0].expr, scope)
            idx = self.eval_expr(arg_exprs[0].index, scope)
        else:
            # A scalar SSBO member: element 0 of its range.
            target = self._ssbo_ref_of(arg_exprs[0], scope)
            if target is None or self.ssbo_members[target.data[1]][1] != 1:
                raise GlslError(f"{op}(ssbo_member[index], {shape})", line)
            idx = Val("int", 0)
        vals = [self.eval_expr(a, scope) for a in arg_exprs[1:]]
        if target.type == "shared":
            name = target.data
            fid, inb = self._shared_fid(name, idx)
            buf = self.shared_state[name]
        elif target.type == "ssbo":
            block, member = target.data
            size = self.ssbo_members[member][1]
            ii = self._lane_index(idx)
            inb = (ii >= 0) & (ii < size)
            fid = self.ssbo_offsets[member] + ii.clamp(0, size - 1)
            buf = self.buffers[block]
        else:
            raise GlslError(f"{op} target must be an SSBO member or shared array element", line)
        self.stats["gather"] = True
        mask = self._effective_mask(scope)
        keep = inb if mask is None else land(inb, mask)
        new = self._atomic_call(buf, fid, keep, op, vals, line)
        if target.type == "shared":
            self.shared_state[name] = new
        else:
            self.buffers[block] = new
        return Val("float", 0.0)

    def _image_atomic(self, op: str, arg_exprs: list, scope, line: int) -> Val:
        """imageAtomicAdd/Min/Max/And/Or/Xor/Exchange(image, ivec2, data) and
        imageAtomicCompSwap(image, ivec2, compare, data) on channel 0 of a
        storage image (GLSL allows image atomics on one-channel formats
        only), lowered as the SSBO atomics with the plane as a flat
        (h * w) buffer.  Out-of-bounds coordinates are dropped.  Returns
        0."""
        base = "atomic" + op[len("imageAtomic"):]
        nargs = 4 if base == "atomicCompSwap" else 3
        shape = "compare, data" if nargs == 4 else "data"
        if len(arg_exprs) != nargs:
            raise GlslError(f"{op}(image, ivec2, {shape})", line)
        name = self._get_image(arg_exprs[0], line)
        coord = self.eval_expr(arg_exprs[1], scope)
        if not coord.is_vector() or coord.size != 2:
            raise GlslError(f"{op} coordinate must be ivec2", line)
        vals = [self.eval_expr(a, scope) for a in arg_exprs[2:]]
        self.stats["gather"] = True
        xs = self._as_array(coord.data[0], "int").to(torch.int64)
        ys = self._as_array(coord.data[1], "int").to(torch.int64) - self.row_offset
        inb = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        mask = self._effective_mask(scope)
        keep = inb if mask is None else land(inb, mask)
        fid = ys.clamp(0, self.h - 1) * self.w + xs.clamp(0, self.w - 1)
        planes = self._image_current(name)
        buf = self._as_array(planes[0], "float").reshape(-1)
        new = self._atomic_call(buf, fid, keep, base, vals, line)
        self.stores[name] = [new.reshape(self.h, self.w)] + [
            self._as_array(p, "float") for p in planes[1:]]
        return Val("float", 0.0)

    def _call_user(self, fn: ast.FuncDecl, arg_exprs: list, scope: "_Scope", line: int) -> Val:
        args = [self.eval_expr(a, scope) for a in arg_exprs]
        if len(args) != len(fn.params):
            raise GlslError(
                f"{fn.name}() expects {len(fn.params)} args, got {len(args)}", line
            )
        activation = _Activation(self, parent_live=scope.activation.live_mask())
        fscope = _Scope(self.globals, activation)
        for p, a in zip(fn.params, args):
            if p.array_size is not None:
                fscope.declare(p.name, a)
            else:
                fscope.declare(p.name, self.convert(a, p.type, line))
        ret: Optional[Val] = None
        # The function body is NOT lexically inside any vectorized loop:
        # a return (or break in its own loops) must bind to the function,
        # not kill the caller's loop lanes.
        prev_stack = self._vec_loop_stack
        prev_switch = self._switch_stack
        self._vec_loop_stack = []
        self._switch_stack = []
        try:
            self.exec_block(fn.body, fscope)
        except _ReturnSignal as r:
            ret = r.value
        finally:
            self._vec_loop_stack = prev_stack
            self._switch_stack = prev_switch
        # Copy back out/inout parameters.
        for p, a_expr in zip(fn.params, arg_exprs):
            if p.qualifier in ("out", "inout"):
                self._assign_to(a_expr, fscope.lookup(p.name), scope, line)
        if activation.returned_mask is not None:
            merged = activation.merged_return()
            if merged is not None:
                if ret is None:
                    ret = merged
                else:
                    rm = activation.returned_mask
                    ret = self.convert(ret, merged.type, line)
                    ret = self._blend_val(rm, merged, ret)
        if ret is None:
            if fn.return_type == "void":
                return Val("void", None)
            ret = self._zero_of(fn.return_type, line)
        return self.convert(ret, fn.return_type, line) if fn.return_type != "void" else ret


class _Activation:
    """Per-function-call state: non-uniform return tracking."""

    def __init__(self, interp: Optional[Interp] = None, parent_live=None):
        self.interp = interp
        self.returned_mask = None
        self.return_value: Optional[Val] = None
        self.parent_live = parent_live

    def live_mask(self):
        combined = None
        if self.parent_live is not None:
            combined = self.parent_live
        if self.returned_mask is not None:
            not_ret = lnot(self.returned_mask)
            combined = not_ret if combined is None else land(combined, not_ret)
        return combined

    def note_return(self, mask, value: Optional[Val]) -> None:
        if value is not None:
            if self.return_value is None:
                self.return_value = value
            else:
                self.return_value = self.interp._blend_val(mask, value, self.return_value)
        self.returned_mask = (
            mask if self.returned_mask is None else lor(self.returned_mask, mask)
        )

    def merged_return(self) -> Optional[Val]:
        return self.return_value


class _SwitchActivation(_Activation):
    """Per-masked-switch lane-kill region.

    ``break`` inside a vectorized switch kills a lane for the REMAINDER
    of the switch only (``note_break`` — the lane resumes after the
    switch ends).  ``return``/``discard`` kills forward through to the
    enclosing activation (``note_return``), so a lane leaving the
    function does not resume after the switch; nested switches chain."""

    def __init__(self, interp, outer: _Activation, parent_live=None):
        super().__init__(interp=interp, parent_live=parent_live)
        self.outer = outer

    def note_break(self, mask) -> None:
        _Activation.note_return(self, mask, None)

    def note_return(self, mask, value) -> None:
        _Activation.note_return(self, mask, value)
        self.outer.note_return(mask, value)


class _Scope:
    """Lexical scope chain over the interpreter globals."""

    def __init__(self, globals_: dict, activation: Optional[_Activation] = None, parent: Optional["_Scope"] = None):
        self.vars: dict[str, Val] = {}
        self.globals = globals_
        self.parent = parent
        self.activation = activation or (parent.activation if parent else _Activation())

    def child(self) -> "_Scope":
        return _Scope(self.globals, self.activation, self)

    def lookup(self, name: str) -> Optional[Val]:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return self.globals.get(name)

    def declare(self, name: str, v: Val) -> None:
        self.vars[name] = v

    def assign(self, name: str, v: Val) -> None:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = v
                return
            s = s.parent
        if name in self.globals:
            self.globals[name] = v
            return
        raise GlslError(f"assignment to undeclared '{name}'")
