"""GLSL point shaders as typed op lists for the mc kernel.

The reference evaluates a point shader (reflected halo 0, ``mc_block_ok``)
by tracing its vectorized interpreter into the mc kernel's blocks
(``program.py:670-682`` there).  A CUDA kernel takes no closure, so here a
point shader becomes a record: a ``PointProgram``, a list of typed scalar
ops over two small register files (floats, integers) that
``graph_strip_mc`` evaluates at each pixel (an ``MC_GLSL`` point stage,
csrc/graph_strip_mc.cu).  Each op carries the kernel's opcode, chosen
when the op is recorded, and the plain version dispatches on it too.

The op list is lowered from the port's own interpreter, not from a second
reading of GLSL: ``lower_point`` runs ``Interp`` on ``meta`` tensors of
the frame's size under a ``TorchDispatchMode`` that records every aten op
on a per-pixel value.  The leaves are the input images' channels (a
``select`` of an input image), the coordinate planes (``arange`` viewed
as a row or a column) and the frame time (a 0-d tensor).  UBO params and
``imageSize`` are Python scalars in the interpreter, so they arrive as
constants, and an op whose operands are all constants is folded on the
CPU with the same aten op.  Type promotion is made explicit: each op
computes in one type (f32, i32, i64 -- the interpreter's ``uint``, int64
masked to 32 bits -- or bool) and a cast precedes any operand of another
type, with torch's conversions.

The interpreter runs with ``abstract=False``: counted loops unroll as on
a real frame.  A data-dependent loop (the interpreter's vectorized
rounds, ``Interp._exec_loop_vectorized``) hands its body to the recorder
(``lower_loop``), which records it once as a loop region: moves of the
carried values into registers of their own, the body, and a back-edge
(LOOP) that repeats it while the carried ``_active`` holds, at most the
interpreter's ``_WHILE_CAP`` rounds.  Running a lane past its own exit
changes nothing (the body's merges are masked), so the region run a
pixel at a time is bit-equal to the interpreter's whole-image rounds.
Integer shifts are ops of their own (ISHL, ISHR, with torch's rule for a
count outside the width), and so are the bit casts (``view`` of f32 as i32
and back: FBITS, IBITS; the uint forms the interpreter builds from them).
A shader reads its first two input images through the stage's own views,
the others through LOADX (the plan's launch holds at most
``cuda_ops.MC_GLSL_INPUTS`` of those).  A read of an input image's channel
at a per-pixel integer point (``texture()``'s corners, a computed
``imageLoad``: ``aten.index`` with a row and a column register) is a
GATHER; the interpreter's own clamps and bounds tests are ops before it,
so the list needs no clamp of its own.  A host read of a per-pixel value
elsewhere refuses the lowering, and so do an op outside the op set, a
gather of a computed plane or inside a loop region, a store at a computed
point (a scatter), per-lane array indexing, an in-place update, storage
buffers, atomics and ``shared`` arrays, and more registers or constants
than an op word's wide fields address: each raises ``Refused``, whose
reason ``lower_point`` returns, and such a node runs per node (or between
segments), as before.
A list that fits the narrow op word (8-bit fields) packs into it; a
larger one packs into the wide word (``PointProgram.packed``).  Whether a
program's register files fit the kernel's shared memory beside the rest
of its plan, or lie in device memory, is the mc planner's question
(``cuda_ops.McProgram.tile``).

``point_program_plain`` is the plain version: the ops in order (a taken
back-edge jumps back while any pixel is active), each with the torch
function the interpreter called and the same operand forms (a Python
scalar where the interpreter passed one), so that on the CPU it is
bit-equal to the interpreter.
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import ast
from .interp import ATOMIC_FUNCS, IMAGE_ATOMIC_FUNCS, Interp

# Value types.
F32, I32, I64, BOOL = 0, 1, 2, 3
_TYPE_OF = {torch.float32: F32, torch.int32: I32, torch.int64: I64, torch.bool: BOOL}
DTYPES = {v: k for k, v in _TYPE_OF.items()}

# The kernel's two register files, float (f32) and integer (i32, i64 and
# bool, in 64 bits), each sized to a program's live registers of its
# class (csrc/graph_strip_mc.cu: planes in shared memory, a lane each).
# Integer registers of an op list are numbered from I_BASE (past every
# float register a wide field names).  An operand field of the narrow op
# word has 8 bits: a register's index, or CONST | k, the k-th constant of
# the operand's class, read from the program's own constant table (MAX_F,
# MAX_I: the registers a field can name, and the constants of a class).
# The ints of the packed program's header (``PointProgram.packed``); each
# op packs into two words.
MAX_F = 128
MAX_I = 128
CONST = 0x80
I_BASE = 1 << 16
HEAD_INTS = 10
# The wide op word (``packed(wide=True)``, header flag 4): four words an
# op, each operand field 16 bits, WIDE_CONST | k the k-th constant of its
# class; so up to WIDE_MAX registers of each file and constants of each
# class.  A wide list's ops start on a multiple of four words (one 16-byte
# read an op).
WIDE_CONST = 0x8000
WIDE_MAX = 0x8000

# The opcodes, one list for the recorder, the plain version and the kernel
# (csrc/graph_strip_mc.cu GlslKop, in this order).  An op of a name with
# no type prefix (an aten op's: ADD, LT, SIN, ...) takes F for an f32 op,
# I for an integer or bool one (``_opcode``); a cast's name says its
# operand's type and its own.
KERNEL_OPS = (
    "LOAD", "COORD_X", "COORD_Y", "TIME",
    "FADD", "FSUB", "FMUL", "FDIV", "FREM", "FFMOD", "FMAX", "FMIN", "FPOW", "FATAN2",
    "FEQ", "FNE", "FLT", "FLE", "FGT", "FGE",
    "FNEG", "FABS", "FSIGN", "FFLOOR", "FCEIL", "FTRUNC", "FROUND", "FEXP", "FEXP2", "FLOG",
    "FLOG2", "FSQRT", "FRECIP", "FSIN", "FCOS", "FTAN", "FASIN", "FACOS", "FATAN", "FSINH",
    "FCOSH", "FTANH", "FISNAN",
    "FWHERE", "FCLAMP", "FNAN2NUM",
    "IADD", "ISUB", "IMUL", "IDIV", "IFLOORDIV", "IREM", "IFMOD", "IMAX", "IMIN", "IAND", "IOR",
    "IXOR",
    "IEQ", "INE", "ILT", "ILE", "IGT", "IGE",
    "INEG", "IABS", "ISIGN", "INOT", "ILNOT",
    "IWHERE", "ICLAMP",
    "F2I", "F2L", "F2B", "I2F", "L2F", "B2F", "L2I", "I2B", "ICOPY",
    "FMOV", "IMOV", "ISHL", "ISHR", "LOOP", "LOADX", "FBITS", "IBITS", "GATHER",
)
K = {name: k for k, name in enumerate(KERNEL_OPS)}
_LEAVES = ("LOAD", "COORD_X", "COORD_Y", "TIME", "LOADX")
# LOAD reads image 0 or 1, LOADX image 2 and on: (image, channel) operands.
_LOADS = {K["LOAD"], K["LOADX"]}
# GATHER reads channel c of image k at a per-pixel integer point: (image,
# channel, row register, column register) operands.
_GATHER = K["GATHER"]
# Ops whose name takes no type prefix.
_UNTYPED = _LEAVES + ("LOOP", "FBITS", "IBITS", "GATHER")
# Bit casts, by (operand type, result type): f32 bits as i32, i32 bits as f32.
_BITCASTS = {(F32, I32): "FBITS", (I32, F32): "IBITS"}
_MOVES = {K["FMOV"], K["IMOV"]}
_CASTS = {(F32, I32): "F2I", (F32, I64): "F2L", (F32, BOOL): "F2B", (I32, F32): "I2F",
          (I64, F32): "L2F", (BOOL, F32): "B2F", (I64, I32): "L2I", (I32, BOOL): "I2B",
          (I64, BOOL): "I2B", (I32, I64): "ICOPY", (BOOL, I32): "ICOPY", (BOOL, I64): "ICOPY"}
_CAST_OPS = {K[name] for name in _CASTS.values()}
# The ops of a list that only the kernel's trig forms evaluate (the
# header's flags).
_TRIG_OPS = {K["FSIN"], K["FCOS"], K["FTAN"]}
# The ops of loops, shifts, images past the second and bit casts: only the
# kernel's forms for lists that have them (the header's flags) evaluate
# them.  GATHER, the last opcode, has forms of its own (flag 8).
_EXT_OPS = set(range(K["FMOV"], _GATHER))
# Ops that compute in their type and give bool.
_BOOL_OUT = {K[p + n] for p in "FI" for n in ("EQ", "NE", "LT", "LE", "GT", "GE")} | {K["FISNAN"]}

_aten = torch.ops.aten
_BINARY = {
    _aten.add: "ADD", _aten.sub: "SUB", _aten.mul: "MUL", _aten.div: "DIV",
    _aten.remainder: "REM", _aten.maximum: "MAX", _aten.minimum: "MIN", _aten.atan2: "ATAN2",
    _aten.bitwise_and: "AND", _aten.bitwise_or: "OR", _aten.bitwise_xor: "XOR",
    _aten.logical_and: "AND", _aten.logical_or: "OR", _aten.logical_xor: "XOR",
    _aten.floor_divide: "FLOORDIV", _aten.pow: "POW", _aten.fmod: "FMOD",
    _aten.__lshift__: "SHL", _aten.bitwise_left_shift: "SHL",
    _aten.__rshift__: "SHR", _aten.bitwise_right_shift: "SHR",
}
_COMPARE = {_aten.eq: "EQ", _aten.ne: "NE", _aten.lt: "LT", _aten.le: "LE", _aten.gt: "GT",
            _aten.ge: "GE"}
_UNARY = {
    _aten.neg: "NEG", _aten.abs: "ABS", _aten.sign: "SIGN", _aten.floor: "FLOOR",
    _aten.ceil: "CEIL", _aten.trunc: "TRUNC", _aten.round: "ROUND", _aten.exp: "EXP",
    _aten.exp2: "EXP2", _aten.log: "LOG", _aten.log2: "LOG2", _aten.sqrt: "SQRT",
    _aten.reciprocal: "RECIP", _aten.sin: "SIN", _aten.cos: "COS", _aten.tan: "TAN",
    _aten.asin: "ASIN", _aten.acos: "ACOS", _aten.atan: "ATAN", _aten.sinh: "SINH",
    _aten.cosh: "COSH", _aten.tanh: "TANH",
}
# Unary ops that leave an integer operand as it is (torch returns a copy).
_INT_IDENTITY = {"FLOOR", "CEIL", "TRUNC", "ROUND"}
_IDENTITY = {_aten.clone, _aten.alias, _aten.detach, _aten.lift_fresh, _aten.lift_fresh_copy,
             _aten.contiguous}
_VIEWS = {_aten.view, _aten._unsafe_view, _aten.expand, _aten.unsqueeze, _aten.squeeze,
          _aten.reshape}
_CREATE = {_aten.full, _aten.scalar_tensor, _aten.zeros, _aten.ones, _aten.zeros_like,
           _aten.ones_like, _aten.full_like, _aten.new_zeros, _aten.new_ones, _aten.new_full}
_HOST_READS = {_aten.is_nonzero, _aten._local_scalar_dense, _aten.item, _aten.equal}
# The interpreter's stores at computed points (imageStore's scatter).
_SCATTERS = {_aten.scatter_reduce, _aten.scatter, _aten.index_put}


class Refused(Exception):
    """The shader has no op list; ``str()`` says why."""


def _opcode(name: str, typ: int, src: Optional[int] = None) -> int:
    """The opcode of op ``name`` computing in ``typ`` (``src``: a cast's
    operand type); Refused where the kernel has none."""
    if name == "CAST":
        name = _CASTS.get((src, typ), "")
    elif name not in _UNTYPED:
        name = ("F" if typ == F32 else "I") + name
    if name not in K:
        raise Refused(f"no op {name or 'cast'} of type {DTYPES[typ]} (src {src})")
    return K[name]


@dataclasses.dataclass(frozen=True)
class Const:
    """A constant operand: its type, its value (a Python number exactly
    representable in the type) and whether the interpreter passed it as a
    Python scalar (the plain version passes it the same way)."""

    typ: int
    value: Any
    scalar: bool = False


def out_type(op: int, typ: int) -> int:
    """The type of an op's result: bool for a comparison or isnan (which
    compute in ``typ``), else ``typ``."""
    return BOOL if op in _BOOL_OUT else typ


@dataclasses.dataclass(frozen=True)
class PointProgram:
    """A point shader's op list for one (source, params, frame size).

    ``ops`` are ``(op, typ, dst, refs)``: the opcode (an index of
    KERNEL_OPS), the type it computes in (a cast's: its result's), the
    result's register and the operands, each a register or constant ``-1
    - k`` (a LOAD's or LOADX's: the image and the channel; a LOOP's: the carried
    ``_active``, the round cap, the index of the loop body's first op and
    the trip bound, its ``dst`` the round counter; a GATHER's: the image,
    the channel, the row's and the column's registers).  A loop region is the
    ops from a LOOP's first op to the LOOP: the body, then moves of its
    results into the carried registers (FMOV, IMOV); LOOP adds one to the
    counter and goes back while any lane's ``_active`` holds and the
    count is below the cap.  Float registers count
    from 0 (``n_f`` of them), integer ones from I_BASE (``n_i``).
    ``outputs`` are the four channels' operands (f32).  ``images`` are the
    input images read, by name, in the kernel spec's order; ``gathers``
    those of them read by a GATHER."""

    ops: tuple
    consts: tuple
    outputs: tuple
    n_f: int
    n_i: int
    images: tuple
    reads_coords: bool
    reads_time: bool
    gathers: tuple = ()

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def _slots(self) -> dict:
        """Each constant's index in its class's constant table: floats and
        integers apart, in the order of ``consts``."""
        slot, n = {}, {True: 0, False: 0}
        for k, c in enumerate(self.consts):
            slot[k] = n[c.typ == F32]
            n[c.typ == F32] += 1
        return slot

    @property
    def narrow(self) -> bool:
        """Whether the list fits the narrow op word: 128 registers of each
        file, 128 constants of each class."""
        n_fk = sum(c.typ == F32 for c in self.consts)
        return (self.n_f <= MAX_F and self.n_i <= MAX_I and n_fk <= CONST
                and len(self.consts) - n_fk <= CONST)

    def packed(self, wide: Optional[bool] = None) -> np.ndarray:
        """The program as the kernel reads it (int32), in the narrow op
        word where it fits (``narrow``) and ``wide`` is not True, else in
        the wide one (``widen``'s form).  Every part on an
        even word, so that the integer constants and each op read as one
        8-byte load where the list itself starts on an even word: the
        header (ops, the float and integer registers in use, the float and
        integer constants' counts, the four output channels' operands,
        flags: 1 where the list calls sinf, cosf or tanf, whose argument
        reduction keeps an array the kernel's other forms need not carry, 2
        where it has loops, shifts, bit casts or reads a third image, which
        the kernel's forms for them evaluate, 4 for the wide op word, 8
        where it has gathers, which only the kernel's gather forms read);
        the float constants' bits, and a zero where their count is
        odd; the integer constants, the low and high words of their 64-bit
        form; then two words an op: its opcode | dst << 8 | a << 16 | b <<
        24 and c | d << 8 | (i32: wraps to 32 bits) << 16.  An operand is
        a register's index in its file, or CONST | k for the k-th constant
        of its class (a LOAD's a and b: the image and the channel; a
        GATHER's a and b the same, its c and d the row and the column).  A
        LOOP (a back-edge) is LOOP | counter << 8 | active << 16 | cap << 24
        and the index of its body's first op | (trip bound - 1) << 16."""
        if wide is None:
            wide = not self.narrow
        elif not wide and not self.narrow:
            raise ValueError("the list's registers or constants pass the narrow op word")
        slot = self._slots()

        def at(ref: int) -> int:
            if ref < 0:
                return (WIDE_CONST if wide else CONST) | slot[-1 - ref]
            return ref - I_BASE if ref >= I_BASE else ref

        fk = [k for k, c in enumerate(self.consts) if c.typ == F32]
        ik = [k for k, c in enumerate(self.consts) if c.typ != F32]
        trig = any(op in _TRIG_OPS for op, *_ in self.ops)
        ext = any(op in _EXT_OPS for op, *_ in self.ops)
        gather = any(op == _GATHER for op, *_ in self.ops)
        words = [len(self.ops), self.n_f, self.n_i, len(fk), len(ik),
                 *(at(o) for o in self.outputs),
                 int(trig) | int(ext) << 1 | int(wide) << 2 | int(gather) << 3]
        words += [_register_bits(F32, self.consts[k].value) for k in fk] + [0] * (len(fk) % 2)
        for k in ik:
            bits = _register_bits(self.consts[k].typ, self.consts[k].value)
            words += [bits & 0xFFFFFFFF, bits >> 32]
        if wide:
            words += [0] * (len(words) % 4)
            for op, typ, dst, refs in self.ops:
                if op == K["LOOP"]:
                    active, cap, target, trips = refs
                    words += [op | at(dst) << 16, at(active) | at(cap) << 16, 0,
                              target | (min(trips, 1 << 16) - 1) << 16]
                    continue
                f = _fields(op, refs, at)
                words += [op | int(typ == I32) << 8 | at(dst) << 16, f[0] | f[1] << 16,
                          f[2] | f[3] << 16, 0]
            return np.asarray([_i32(w) for w in words], np.int32)
        for op, typ, dst, refs in self.ops:
            if op == K["LOOP"]:
                active, cap, target, trips = refs
                words += [op | at(dst) << 8 | at(active) << 16 | at(cap) << 24,
                          target | (min(trips, 1 << 16) - 1) << 16]
                continue
            f = _fields(op, refs, at)
            words += [op | at(dst) << 8 | f[0] << 16 | f[1] << 24,
                      f[2] | f[3] << 8 | int(typ == I32) << 16]
        return np.asarray([_i32(w) for w in words], np.int32)


def _fields(op: int, refs, at) -> list:
    """An op's four operand fields: a LOAD's image and channel as they
    are, a GATHER's too before its two registers, every other operand
    through ``at``."""
    raw = 2 if op in _LOADS or op == _GATHER else 0
    f = list(refs[:raw]) + [at(r) for r in refs[raw:]]
    return f + [0] * (4 - len(f))


def pixel_reads(words) -> set:
    """The input images (by their index among the stage's inputs) that a
    packed program reads at the pixel itself (LOAD, LOADX), not at a
    computed point."""
    words = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    n, width = int(words[0]), 4 if is_wide(words) else 2
    at = ops_at(words)
    ops = words[at:at + width * n].reshape(-1, width)
    codes = ops[:, 0] & 255
    image = (ops[:, 1] & 0xFFFF) if width == 4 else (ops[:, 0] >> 16) & 255
    return {int(k) for k in image[(codes == K["LOAD"]) | (codes == K["LOADX"])]}


def ops_at(words) -> int:
    """Where a packed program's ops start within it: past the header, the
    float constants (padded to an even count) and the integer constants'
    two words each, and in the wide form on a multiple of four words."""
    k_f, k_i = int(words[3]), int(words[4])
    at = HEAD_INTS + k_f + k_f % 2 + 2 * k_i
    return at + at % 4 if int(words[HEAD_INTS - 1]) & 4 else at


def is_wide(words) -> bool:
    """Whether a packed program is in the wide op word (header flag 4)."""
    return bool(int(words[HEAD_INTS - 1]) & 4)


def packed_work(words) -> int:
    """The ops a pixel runs of a packed program (``PointProgram.packed``,
    either op word): each op once, an op of a loop region times the trip
    bound its back-edge carries (nested regions multiply), so that the mc
    planner's work model counts a loop by its rounds and not by one trip."""
    words = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    n, width = int(words[0]), 4 if is_wide(words) else 2
    at = ops_at(words)
    ops = words[at:at + width * n].reshape(-1, width)
    weight = np.ones(n, np.float64)
    for e in np.flatnonzero((ops[:, 0] & 255) == K["LOOP"]):
        w = int(ops[e, -1])
        weight[w & 0xFFFF:e + 1] *= (w >> 16) + 1
    return int(weight.sum())


def widen(words) -> np.ndarray:
    """A narrow packed program (``PointProgram.packed``) in the wide op
    word: the same header (flag 4 added), constants and ops, each operand
    field carried over (CONST | k as WIDE_CONST | k).  The mc planner
    widens a plan's lists where their register files fit no tile at the
    narrow forms' pixels a thread; the wide form runs one."""
    words = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    if is_wide(words):
        return np.asarray([_i32(int(w)) for w in words], np.int32)

    def field(f: int) -> int:
        return WIDE_CONST | (f & (CONST - 1)) if f & CONST else f

    n, at = int(words[0]), ops_at(words)
    out = [int(w) for w in words[:at]]
    out[5:9] = [field(int(w)) for w in words[5:9]]
    out[HEAD_INTS - 1] |= 4
    out += [0] * (len(out) % 4)
    for w0, w1 in words[at:at + 2 * n].reshape(-1, 2):
        w0, w1 = int(w0), int(w1)
        op, d, a, b = w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255, w0 >> 24
        if op == K["LOOP"]:
            out += [op | d << 16, field(a) | field(b) << 16, 0, w1]
            continue
        c, e = w1 & 255, (w1 >> 8) & 255
        if op == _GATHER:
            c, e = field(c), field(e)
        elif op not in _LOADS:
            a, b, c, e = field(a), field(b), field(c), field(e)
        out += [op | ((w1 >> 16) & 1) << 8 | d << 16, a | b << 16, c | e << 16, 0]
    return np.asarray([_i32(w) for w in out], np.int32)


def _i32(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= 1 << 31 else u


def _register_bits(typ: int, value) -> int:
    """A value's 64-bit register form in the kernel: f32 as its bits, i32
    sign-extended, i64 as it is, bool 0 or 1 (as unsigned 64 bits)."""
    if typ == F32:
        return struct.unpack("<I", struct.pack("<f", float(value)))[0]
    return int(value) & 0xFFFFFFFFFFFFFFFF


# ---- the recorder ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Img:
    k: int


@dataclasses.dataclass(frozen=True)
class _Vec:
    items: tuple


@dataclasses.dataclass(frozen=True)
class _Arange:
    n: int


@dataclasses.dataclass(frozen=True)
class _Bad:
    """A value with no op list: the Refused reason, raised where an output
    uses it (the interpreter makes values that no output reads)."""

    reason: str


class _Py:
    """A Python scalar argument."""

    def __init__(self, value):
        self.value = value


class _Other:
    """An argument that is neither a tensor nor a scalar (a shape, a dtype)."""


def _convert(value, from_dtype, typ: int):
    """``value`` (Python number of ``from_dtype``, or None for a Python
    scalar) converted to ``typ`` as torch converts it."""
    src = torch.tensor(value) if from_dtype is None else torch.tensor(value, dtype=from_dtype)
    return src.to(DTYPES[typ]).item()


class _Recorder(TorchDispatchMode):
    def __init__(self, height: int, width: int):
        super().__init__()
        self.h, self.w = height, width
        self.vals: dict[int, Any] = {}
        self.keep: list = []  # the recorded tensors stay alive: ids stay unique
        self.nodes: list[tuple] = []  # (op, typ, operands); a LOAD's operands (image, channel)
        self.loads: dict[tuple, int] = {}
        self.refused: Optional[str] = None
        # Loop regions: (the body's first node, the back-edge node); a
        # back-edge move's or back-edge's node -> the node whose register
        # it writes (a carried value, the round counter); a carried node ->
        # those writers; a back-edge move -> its back-edge; the back-edge's
        # trip bound; a carried value that leaves the loop with no op list.
        self.regions: list[tuple[int, int]] = []
        self.into: dict[int, int] = {}
        self.writers: dict[int, list] = {}
        self.loop_of: dict[int, int] = {}
        self.trips: dict[int, int] = {}
        self.bad: dict[int, str] = {}
        self.in_loop = 0  # loop bodies being recorded

    # -- bookkeeping

    def bind(self, t: torch.Tensor, value) -> None:
        self.vals[id(t)] = value
        self.keep.append(t)

    def value(self, x):
        if isinstance(x, torch.Tensor):
            return self.vals.get(id(x), _Bad("a tensor from outside the shader"))
        if isinstance(x, (bool, int, float)):
            return _Py(x)
        return _Other()

    def emit(self, name: str, typ: int, operands=(), src: Optional[int] = None) -> int:
        self.nodes.append((_opcode(name, typ, src), typ, tuple(operands)))
        return len(self.nodes) - 1

    def refuse(self, reason: str) -> None:
        """Refuse the whole shader, even where the interpreter catches the
        exception."""
        if self.refused is None:
            self.refused = reason
        raise Refused(reason)

    # -- operands

    def operand(self, v, typ: int):
        """``v`` (a node, Const or _Py) as an operand of type ``typ``."""
        if isinstance(v, _Py):
            return Const(typ, _convert(v.value, None, typ), scalar=True)
        if isinstance(v, Const):
            if v.typ == typ:
                return v
            return Const(typ, _convert(v.value, DTYPES[v.typ], typ))
        src = out_type(*self.nodes[v][:2])
        if src == typ:
            return v
        return self.emit("CAST", typ, (v,), src)

    # -- loop regions (Interp's ``lower_loop``)

    def loop(self, carry: dict, body_fn, zeros_tree) -> dict:
        """A data-dependent loop as a region of the op list: a move of each
        carried value into a register of its own and a round counter set to
        0, the body's ops (``body_fn`` run once on those registers), then
        the back-edge: moves of the body's results into the carried
        registers and LOOP, which repeats the body while the carried
        ``_active`` holds and the round count is below the interpreter's
        cap.  Returns the carry after the loop: the carried registers.  A
        valued return's carry, which the interpreter starts at zeros after
        the first round, is recorded from the start (the body is recorded a
        second time, the first record dead)."""
        inner, start, counter = self._carry_in(carry)
        self.in_loop += 1
        try:
            out = body_fn(inner)
            late = [k for k in out if k not in inner]
            if late:
                carry = {**carry, **{k: zeros_tree(out[k]) for k in late}}
                inner, start, counter = self._carry_in(carry)
                out = body_fn(inner)
        finally:
            self.in_loop -= 1
        self._back_edge(inner, out, start, counter)
        return inner

    def _carry_in(self, carry: dict):
        def move(t):
            if not isinstance(t, torch.Tensor):
                return t
            v = self.value(t)
            if isinstance(v, (_Img, _Vec, _Arange)):
                self.refuse("a loop that carries a whole image")
            if t.dtype not in _TYPE_OF:
                self.refuse(f"a loop that carries {t.dtype}")
            new = torch.empty_like(t)
            if not isinstance(v, _Bad):
                typ = _TYPE_OF[t.dtype]
                v = self.emit("MOV", typ, (self.operand(v, typ),))
            self.bind(new, v)
            return new

        inner = {k: _tree_map(move, tree) for k, tree in carry.items()}
        counter = self.emit("MOV", I32, (Const(I32, 0),))
        return inner, len(self.nodes), counter

    def _back_edge(self, inner: dict, out: dict, start: int, counter: int) -> None:
        pairs = []
        for key, tree in inner.items():
            ins, outs = _tree_leaves(tree), _tree_leaves(out[key])
            if len(ins) != len(outs):
                self.refuse("a loop carry whose structure changes in the body")
            for a, b in zip(ins, outs):
                if isinstance(a, torch.Tensor) and isinstance(self.value(a), int):
                    pairs.append((self.value(a), self.value(b) if isinstance(b, torch.Tensor)
                                  else _Py(b)))
        carried = {p for p, _v in pairs}
        srcs = []
        for p, v in pairs:
            if isinstance(v, _Bad):
                self.bad[p] = v.reason
                srcs.append(None)
                continue
            typ = out_type(*self.nodes[p][:2])
            v = self.operand(v, typ)
            if isinstance(v, int) and v in carried and v != p:
                v = self.emit("MOV", typ, (v,))  # read before the moves write it
            srcs.append(v)
        moves = []
        for (p, _v), v in zip(pairs, srcs):
            if v is None or v == p:
                continue
            m = self.emit("MOV", out_type(*self.nodes[p][:2]), (v,))
            self.into[m] = p
            self.writers.setdefault(p, []).append(m)
            moves.append(m)
        active = self.value(_tree_leaves(inner["_active"])[0])
        loop = len(self.nodes)
        self.nodes.append((K["LOOP"], I32, (active, counter, Const(I32, Interp._WHILE_CAP))))
        self.loop_of.update((m, loop) for m in moves)
        self.into[loop] = counter
        self.writers.setdefault(counter, []).append(loop)
        self.regions.append((start, loop))
        self.trips[loop] = self._trip_bound(pairs, srcs, active)

    def _trip_bound(self, pairs, srcs, active: int) -> int:
        """The most rounds the loop can take, where its condition compares
        a carried counter stepped by a constant with a constant (a carried
        value from a Const, its body result that value plus or minus a Const,
        under a mask or not); else the interpreter's cap."""
        nodes = self.nodes
        slot = {}
        for (p, _v), v in zip(pairs, srcs):
            init = nodes[p][2][0]
            if isinstance(init, Const) and v is not None:
                slot[p] = (p, init.value)
                if isinstance(v, int):
                    slot[v] = (p, init.value)

        def step(v, p):
            """The constant the body adds to carried value p, or None."""
            if not isinstance(v, int):
                return None
            op, _typ, args = nodes[v]
            name = KERNEL_OPS[op][1:]
            if name == "WHERE":
                return step(args[1], p) if args[2] == p else None
            if name in ("ADD", "SUB") and args[0] == p and isinstance(args[1], Const):
                return args[1].value if name == "ADD" else -args[1].value
            if name == "ADD" and args[1] == p and isinstance(args[0], Const):
                return args[0].value
            return None

        out_of = {p: v for (p, _v), v in zip(pairs, srcs)}
        best = Interp._WHILE_CAP
        todo = [out_of.get(active)]
        while todo:
            v = todo.pop()
            if not isinstance(v, int):
                continue
            op, _typ, args = nodes[v]
            name = KERNEL_OPS[op]
            if name == "IAND" or (name == "IWHERE" and isinstance(args[2], Const)
                                  and not args[2].value):
                todo += list(args[:2])
                continue
            rel = name[1:]
            if rel not in ("LT", "LE", "GT", "GE"):
                continue
            x, c = args
            if isinstance(x, Const):
                x, c = c, x
                rel = {"LT": "GT", "LE": "GE", "GT": "LT", "GE": "LE"}[rel]
            while isinstance(x, int) and nodes[x][0] in _CAST_OPS:
                x = nodes[x][2][0]
            if not isinstance(c, Const) or x not in slot:
                continue
            p, i0 = slot[x]
            s = step(out_of[p], p)
            if s is None or not (s > 0 if rel in ("LT", "LE") else s < 0):
                continue
            span = (c.value - i0) / abs(s) if s > 0 else (i0 - c.value) / abs(s)
            # rounds r >= 1 while i0 + r * s stays on the near side of c
            n = math.ceil(span) if rel in ("LT", "GT") else math.floor(span) + 1
            best = min(best, max(n, 1) + int(x == p))  # x == p: read before the step
        return best

    # -- the dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        name = packet.__name__
        if packet in _HOST_READS:
            self.refuse("a host read of a per-pixel value (a loop the interpreter runs "
                        "unrolled, or a branch on a per-pixel value)")
        if func._schema.is_mutable or (name.endswith("_") and not name.startswith("__")):
            self.refuse(f"in-place update ({name})")
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            try:
                value = self.lower(func, packet, args, kwargs, out)
            except Refused as e:
                value = _Bad(str(e))
            self.bind(out, value)
        elif isinstance(out, (tuple, list)):
            for o in out:
                if isinstance(o, torch.Tensor):
                    self.bind(o, _Bad(f"{packet.__name__} returns several tensors"))
        return out

    def lower(self, func, packet, args, kwargs, out):
        name = packet.__name__
        if packet is _aten.index:
            return self.gather(args, out)
        if packet in _SCATTERS:
            raise Refused("a store at a computed point (a scatter; only gathers lower)")
        vals = [self.value(a) for a in args]
        if packet is _aten.stack:
            if (kwargs.get("dim", args[1] if len(args) > 1 else 0)) != 0:
                raise Refused("stack along a pixel axis")
            items = tuple(self.value(t) for t in args[0])
            return _Vec(items)
        if packet is _aten.arange:
            if len(args) != 1 or out.dtype != torch.int64:
                raise Refused("arange other than a coordinate plane")
            return _Arange(int(args[0]))
        for v in vals:
            if isinstance(v, _Bad):
                return v
        if out.dtype not in _TYPE_OF:
            raise Refused(f"{name} gives {out.dtype}")
        if packet in _CREATE:
            fill = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1, "ones_like": 1,
                    "new_ones": 1}.get(name)
            if fill is None:
                fill = kwargs.get("fill_value", args[-1] if name != "scalar_tensor" else args[0])
            return Const(_TYPE_OF[out.dtype], _convert(fill, None, _TYPE_OF[out.dtype]))
        if packet in _VIEWS:
            v = vals[0]
            if out.dtype != args[0].dtype:
                return self.bitcast(v, args[0].dtype, out)
            if isinstance(v, _Arange):
                shape = tuple(out.shape)
                if packet is _aten.view and shape == (1, v.n) and v.n == self.w:
                    return self.emit("COORD_X", I64)
                if packet is _aten.view and shape == (v.n, 1) and v.n == self.h:
                    return self.emit("COORD_Y", I64)
                raise Refused("arange other than a coordinate plane")
            if isinstance(v, (_Img, _Vec)) and tuple(out.shape) != tuple(args[0].shape):
                raise Refused(f"{name} of an image")
            return v
        if packet in _IDENTITY:
            return vals[0]
        if packet is _aten.slice:
            if tuple(out.shape) != tuple(args[0].shape) or (len(args) > 4 and args[4] != 1):
                raise Refused("a slice of an image (a shifted read)")
            return vals[0]
        if packet is _aten.select:
            v, dim, i = vals[0], args[1], args[2]
            if isinstance(v, _Img) and dim == 0:
                key = (v.k, int(i))
                if key not in self.loads:
                    self.loads[key] = self.emit("LOAD" if v.k < 2 else "LOADX", F32, key)
                return self.loads[key]
            if isinstance(v, _Vec) and dim == 0:
                return v.items[i]
            if isinstance(v, Const):
                return v
            raise Refused("select of a pixel row or column")
        if packet is _aten._to_copy:
            v = vals[0]
            if isinstance(v, (_Img, _Vec, _Arange)):
                raise Refused("a conversion of a whole image")
            return self.operand(v, _TYPE_OF[out.dtype])
        for v in vals:
            if isinstance(v, (_Img, _Vec, _Arange)):
                raise Refused(f"{name} of a whole image")
        tensors = [v for a, v in zip(args, vals) if isinstance(a, torch.Tensor)]
        if tensors and all(isinstance(v, Const) for v in tensors):
            return self.fold(func, args, kwargs, out)
        typ = _TYPE_OF[out.dtype]
        if packet in _BINARY or packet is _aten.rsub:
            return self.binary(packet, name, vals, kwargs, typ)
        if packet in _COMPARE:
            ctype = _TYPE_OF[torch.result_type(args[0], args[1])]
            return self.emit(_COMPARE[packet], ctype,
                             (self.operand(vals[0], ctype), self.operand(vals[1], ctype)))
        if packet is _aten.isnan:
            return self.emit("ISNAN", F32, (self.operand(vals[0], F32),))
        if packet is _aten.isinf:  # GLSL isinf: |x| == inf, NaN false as in torch
            a = self.emit("ABS", F32, (self.operand(vals[0], F32),))
            return self.emit("EQ", F32, (a, Const(F32, float("inf"))))
        if packet is _aten.logical_not:
            return self.emit("LNOT", BOOL, (self.operand(vals[0], BOOL),))
        if packet is _aten.bitwise_not:
            return self.emit("LNOT" if typ == BOOL else "NOT", typ, (self.operand(vals[0], typ),))
        if packet in _UNARY:
            op = _UNARY[packet]
            if op in _INT_IDENTITY and typ != F32:
                return self.operand(vals[0], typ)
            return self.emit(op, typ, (self.operand(vals[0], typ),))
        if packet is _aten.where:
            return self.emit("WHERE", typ, (self.operand(vals[0], BOOL),
                                            self.operand(vals[1], typ),
                                            self.operand(vals[2], typ)))
        if packet is _aten.clamp:
            lo = kwargs.get("min", args[1] if len(args) > 1 else None)
            hi = kwargs.get("max", args[2] if len(args) > 2 else None)
            bounds = []
            for bound, far in ((lo, -1), (hi, 1)):
                if bound is None:
                    if typ == F32:
                        bounds.append(Const(F32, far * float("inf"), scalar=True))
                    else:
                        info = torch.iinfo(DTYPES[typ])
                        bounds.append(Const(typ, info.min if far < 0 else info.max, scalar=True))
                else:
                    bounds.append(self.operand(self.value(bound), typ))
            return self.emit("CLAMP", typ, (self.operand(vals[0], typ), *bounds))
        if packet is _aten.nan_to_num:
            if typ != F32:
                return self.operand(vals[0], typ)
            fin = torch.finfo(torch.float32)
            nan = kwargs.get("nan", args[1] if len(args) > 1 else None)
            posinf = kwargs.get("posinf", args[2] if len(args) > 2 else None)
            neginf = kwargs.get("neginf", args[3] if len(args) > 3 else None)
            consts = [Const(F32, _convert(0.0 if nan is None else nan, None, F32), scalar=True),
                      Const(F32, _convert(fin.max if posinf is None else posinf, None, F32),
                            scalar=True),
                      Const(F32, _convert(fin.min if neginf is None else neginf, None, F32),
                            scalar=True)]
            return self.emit("NAN2NUM", F32, (self.operand(vals[0], F32), *consts))
        raise Refused(f"aten.{name} is outside the op set")

    def gather(self, args, out):
        """``plane[iy, ix]``: channel c of input image k (``plane`` a
        LOAD's or LOADX's node, a ``select`` of a bound image) at integer
        per-pixel values or constants (a plane the interpreter filled), a
        GATHER.  Any other index refuses: a row or column ``arange``, a
        boolean mask, one index."""
        def integer(v) -> bool:
            if isinstance(v, Const):
                return v.typ in (I32, I64)
            return isinstance(v, int) and out_type(*self.nodes[v][:2]) in (I32, I64)

        plane, index = self.value(args[0]), args[1]
        if isinstance(plane, _Bad):
            return plane
        if len(index) != 2 or not all(isinstance(i, torch.Tensor) for i in index):
            raise Refused("an index of an image other than a (row, column) pair")
        point = [self.value(i) for i in index]
        for v in point:
            if isinstance(v, _Bad):
                return v
        if not isinstance(plane, int) or self.nodes[plane][0] not in _LOADS:
            raise Refused("a gather of a plane that is not an input image's channel")
        if self.in_loop:
            raise Refused("a gather inside a loop region")
        if not all(map(integer, point)) or out.dtype != torch.float32:
            raise Refused("a gather at a point that is not an integer")
        return self.emit("GATHER", F32, (*self.nodes[plane][2], *point))

    def bitcast(self, v, src_dtype, out):
        """A view of a per-pixel value as another dtype of its size: f32
        bits as i32 (FBITS) or i32 bits as f32 (IBITS), or a constant's
        bits folded on the CPU."""
        src, typ = _TYPE_OF.get(src_dtype), _TYPE_OF.get(out.dtype)
        if (src, typ) not in _BITCASTS:
            raise Refused(f"a bit cast of {src_dtype} as {out.dtype}")
        if isinstance(v, Const):
            return Const(typ, torch.tensor(v.value, dtype=src_dtype).view(out.dtype).item())
        if not isinstance(v, int):
            raise Refused("a bit cast of a whole image")
        return self.emit(_BITCASTS[(src, typ)], typ, (self.operand(v, src),))

    def binary(self, packet, name, vals, kwargs, typ):
        if kwargs.get("alpha", 1) != 1:
            raise Refused(f"{name} with alpha")
        a, b = vals[0], vals[1]
        op = "SUB" if packet is _aten.rsub else _BINARY[packet]
        if packet is _aten.rsub:
            a, b = b, a
        if op == "POW" and (isinstance(b, _Py) or isinstance(a, _Py)):
            raise Refused("pow by a Python scalar")  # torch special-cases its exponents
        if op == "DIV":
            mode = kwargs.get("rounding_mode")
            if mode == "trunc" and typ == F32:
                q = self.emit("DIV", F32, (self.operand(a, F32), self.operand(b, F32)))
                return self.emit("TRUNC", F32, (q,))
            if mode == "floor":
                op = "FLOORDIV"
            # the integer DIV truncates; a true division of integers gives f32
        if op in ("SHL", "SHR") and typ not in (I32, I64):
            raise Refused(f"a shift of {DTYPES[typ]} values ({name})")
        if typ == BOOL:
            if op not in ("ADD", "MUL", "MAX", "MIN", "AND", "OR", "XOR"):
                raise Refused(f"{name} of booleans")
            op = {"ADD": "OR", "MUL": "AND"}.get(op, op)  # torch's bool sum and product
        return self.emit(op, typ, (self.operand(a, typ), self.operand(b, typ)))

    def fold(self, func, args, kwargs, out):
        """An op of constants, computed on the CPU with the same aten op on
        tensors of one element and the same dimensions (so the same type
        promotion)."""
        def concrete(a):
            if isinstance(a, torch.Tensor):
                c = self.vals[id(a)]
                return torch.full((1,) * a.dim(), c.value, dtype=a.dtype)
            return a

        got = func(*[concrete(a) for a in args], **kwargs)
        typ = _TYPE_OF[out.dtype]
        return Const(typ, got.reshape(-1)[0].to(DTYPES[typ]).item())


def _tree_leaves(tree) -> list:
    """The leaves of an interpreter carry tree (tuples, lists and dicts of
    planes), in order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, t) for k, t in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


# ---- lowering --------------------------------------------------------------


def _uses_atomics(shader: ast.Shader) -> bool:
    found = False

    def walk(node):
        nonlocal found
        if found:
            return
        if isinstance(node, (list, tuple)):
            for item in node:
                walk(item)
            return
        if not hasattr(node, "__dataclass_fields__"):
            return
        if isinstance(node, ast.Call) and (node.name in ATOMIC_FUNCS
                                           or node.name in IMAGE_ATOMIC_FUNCS):
            found = True
            return
        for field in node.__dataclass_fields__:
            walk(getattr(node, field))

    for fn in shader.functions.values():
        walk(fn.body)
    return found


def reads_at_points(spec, params: dict) -> bool:
    """Whether ``spec`` is a GLSL shader of halo None (it reads images at
    computed points) with no storage buffers, atomics or ``shared`` arrays,
    which are of halo None for reasons of their own."""
    shader = getattr(spec, "glsl", None)
    return (shader is not None and spec.halo_for(params) is None and not shader.ssbos
            and not spec.ssbos_in and not spec.ssbos_out and not shader.shared
            and not _uses_atomics(shader))


def _gate(spec, params: dict) -> None:
    """Refused where a kernel spec has no op list before it runs."""
    shader = getattr(spec, "glsl", None)
    if shader is None:
        raise Refused("not a GLSL shader")
    if _uses_atomics(shader):
        raise Refused("atomics")
    if shader.ssbos or spec.ssbos_in or spec.ssbos_out:
        raise Refused("storage buffers")
    if shader.shared:
        raise Refused("shared arrays")
    halo = spec.halo_for(params)
    if halo is not None and halo > 0:
        raise Refused(f"halo {halo}: a neighbourhood read (a conv or stencil stage's, not a "
                      "point stage's)")
    # halo None: the shader reads images at computed points, whose reads
    # the recorder takes as GATHERs or refuses (mc_block_ok is False for
    # any gather, so it decides only for halo 0)
    if halo == 0 and spec.mc_block_ok is not None and not spec.mc_block_ok(params):
        raise Refused("not mc_block_ok (per-lane array indexing)")
    if not spec.images_in:
        raise Refused("no input image")


def lower_point(spec, params: dict, width: int, height: int,
                out_desc: str = "output_image") -> Union[PointProgram, str]:
    """The PointProgram of the GLSL point shader ``spec`` with ``params``
    at ``width`` x ``height`` writing ``out_desc``, or the reason it has
    none."""
    rec = _Recorder(height, width)
    stats = {"max_shift": 0, "gather": False, "dyn_gather": False}
    try:
        _gate(spec, params)
        meta = torch.device("meta")
        images = {}
        for k, name in enumerate(spec.images_in):
            img = torch.empty((4, height, width), dtype=torch.float32, device=meta)
            rec.bind(img, _Img(k))
            images[name] = img
        t = torch.empty((), dtype=torch.float32, device=meta)
        rec.bind(t, rec.emit("TIME", F32))
        with rec:
            outputs = Interp(spec.glsl, height, width, images, dict(params), time=t,
                             device=meta, abstract=False, lower_loop=rec.loop,
                             stats=stats).run_main()
        if stats["dyn_gather"]:
            raise Refused("per-lane array indexing")
        return _allocate(rec, _output_items(rec, outputs, out_desc), spec.images_in)
    except Refused as e:
        return rec.refused or str(e)
    except Exception as e:  # the interpreter's own error on these inputs
        return rec.refused or f"the interpreter failed: {e}"


def _output_items(rec: _Recorder, outputs: dict, out_desc: str) -> tuple:
    """The four channels of ``out_desc``, each a node or a Const."""
    if out_desc not in outputs:
        return (Const(F32, 0.0),) * 4  # an unwritten output reads zeros
    out = rec.vals.get(id(outputs[out_desc]), _Bad("an output from outside the shader"))
    if isinstance(out, _Bad):
        raise Refused(out.reason)
    if not isinstance(out, _Vec) or len(out.items) != 4:
        raise Refused("an output that is not four channels")
    for item in out.items:
        if isinstance(item, _Bad):
            raise Refused(item.reason)
        if isinstance(item, int) and out_type(*rec.nodes[item][:2]) != F32:
            raise Refused("a non-float output channel")
        if not isinstance(item, (int, Const)):
            raise Refused("an output channel that is not a per-pixel value")
    return out.items


def _allocate(rec: _Recorder, outputs: tuple, image_names) -> PointProgram:
    """The live nodes in order, with registers assigned by liveness in two
    files, floats and integers (a register frees after its value's last
    read, so an op's result may take an operand's register; the outputs
    stay live to the end), and a deduplicated constant table.

    A loop region lives while a value it carries does (a carried value's
    back-edge move, and a move's back-edge, live with it).  Liveness
    crosses the back-edge: a value defined before a region and read (or,
    a carried register, written) inside it stays live to the region's
    end, so that no register of the body takes it.  A back-edge move
    writes its carried value's register, the back-edge its counter's; the
    back-edge's operands are the carried ``_active``, the cap, the index
    of the body's first op and the trip bound."""
    nodes = rec.nodes
    loop_op, leaves = K["LOOP"], {K[name] for name in _LEAVES}

    def operands(i: int) -> tuple:
        op, _typ, args = nodes[i]
        return () if op in _LOADS else args[2:] if op == _GATHER else args

    live = set()
    stack = [o for o in outputs if isinstance(o, int)]
    while stack:
        i = stack.pop()
        if i in live:
            continue
        if i in rec.bad:
            raise Refused(rec.bad[i])
        live.add(i)
        stack += [a for a in operands(i) if isinstance(a, int)]
        stack += rec.writers.get(i, [])
        if i in rec.loop_of:
            stack.append(rec.loop_of[i])
    order = sorted(live)
    if len(order) > 0xFFFF:
        raise Refused(f"{len(order)} ops (a back-edge's field addresses 65535)")
    pos = {i: j for j, i in enumerate(order)}
    regions = []
    for start, end in rec.regions:
        if end in live:
            regions.append((next(j for j, i in enumerate(order) if i >= start), pos[end]))
    last = {}
    for j, i in enumerate(order):
        reads = [a for a in operands(i) if isinstance(a, int)]
        if i in rec.into:
            reads.append(rec.into[i])
        for a in reads:
            end = j
            for s, e in regions:
                if s <= j <= e and pos[a] < s:
                    end = max(end, e)
            last[a] = max(last.get(a, -1), end)
    for o in outputs:
        if isinstance(o, int):
            last[o] = len(order)
    consts: list[Const] = []
    const_of: dict[tuple, int] = {}

    def ref(a) -> int:
        if isinstance(a, Const):
            key = (a.typ, _register_bits(a.typ, a.value), a.scalar)
            if key not in const_of:
                const_of[key] = len(consts)
                consts.append(a)
            return -1 - const_of[key]
        return reg_of[a]

    def is_f(i: int) -> bool:
        return out_type(*nodes[i][:2]) == F32

    reg_of: dict[int, int] = {}
    free: dict[bool, set] = {True: set(), False: set()}
    n = {True: 0, False: 0}
    ops = []
    for j, i in enumerate(order):
        op, typ, args = nodes[i]
        if op == loop_op:
            active, _counter, cap = args
            refs = (ref(active), ref(cap), next(s for s, e in regions if e == j), rec.trips[i])
        elif op == _GATHER:
            refs = (*args[:2], ref(args[2]), ref(args[3]))
        else:
            refs = args if op in _LOADS else tuple(ref(a) for a in args)
        for a in set(operands(i)) | ({rec.into[i]} if i in rec.into else set()):
            if isinstance(a, int) and last[a] == j:
                free[is_f(a)].add(reg_of[a])
        if i in rec.into:
            dst = reg_of[rec.into[i]]
        else:
            f = is_f(i)
            if free[f]:
                dst = min(free[f])
                free[f].discard(dst)
            else:
                dst = n[f] if f else I_BASE + n[f]
                n[f] += 1
        reg_of[i] = dst
        ops.append((op, typ, dst, refs))
    out_refs = tuple(ref(o) for o in outputs)
    n_fk = sum(c.typ == F32 for c in consts)
    if max(n[True], n[False], n_fk, len(consts) - n_fk) > WIDE_MAX:
        raise Refused(f"{n[True]} float registers and {n_fk} constants, {n[False]} integer "
                      f"registers and {len(consts) - n_fk} constants (a wide op's fields name "
                      f"{WIDE_MAX} registers of each file, {WIDE_MAX} constants of each class)")
    used = {op for op, *_ in ops} & leaves
    read = sorted({refs[0] for op, _t, _d, refs in ops if op in _LOADS or op == _GATHER})
    gathered = sorted({refs[0] for op, _t, _d, refs in ops if op == _GATHER})
    return PointProgram(
        ops=tuple(ops), consts=tuple(consts), outputs=out_refs, n_f=n[True], n_i=n[False],
        images=tuple(image_names[k] for k in read),
        reads_coords=bool(used & {K["COORD_X"], K["COORD_Y"]}), reads_time=K["TIME"] in used,
        gathers=tuple(image_names[k] for k in gathered),
    )


# ---- the plain version -----------------------------------------------------


def _tensor(x, typ: int, like):
    """A Python scalar as a 0-d tensor of ``typ`` (for functions that take
    no scalar)."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.tensor(x, dtype=DTYPES[typ], device=device)


def _pair(fn):
    """``fn`` of two operands that takes no Python scalar."""
    return lambda typ, a, b: fn(_tensor(a, typ, b), _tensor(b, typ, a))


def _unary(fn):
    return lambda typ, a: fn(a)


def _clamp(typ, a, lo, hi):
    if isinstance(lo, torch.Tensor) != isinstance(hi, torch.Tensor):
        lo, hi = _tensor(lo, typ, a), _tensor(hi, typ, a)
    return torch.clamp(a, lo, hi)


# Each op's torch function, as the interpreter calls it, by its name
# without the type prefix: (typ, operands...) -> value.
_PLAIN = {
    "ADD": lambda typ, a, b: a + b,
    "SUB": lambda typ, a, b: a - b,
    "MUL": lambda typ, a, b: a * b,
    "DIV": lambda typ, a, b: a / b if typ == F32 else torch.div(a, b, rounding_mode="trunc"),
    "FLOORDIV": lambda typ, a, b: torch.div(a, b, rounding_mode="floor"),
    "REM": lambda typ, a, b: torch.remainder(a, b),
    "FMOD": lambda typ, a, b: torch.fmod(a, b),
    "MAX": _pair(torch.maximum), "MIN": _pair(torch.minimum), "ATAN2": _pair(torch.atan2),
    "POW": lambda typ, a, b: torch.pow(a, b),
    "AND": lambda typ, a, b: a & b,
    "OR": lambda typ, a, b: a | b,
    "XOR": lambda typ, a, b: a ^ b,
    **{name: (lambda fn: lambda typ, a, b: fn(_tensor(a, typ, b), b))(fn) for name, fn in (
        ("EQ", torch.eq), ("NE", torch.ne), ("LT", torch.lt), ("LE", torch.le),
        ("GT", torch.gt), ("GE", torch.ge))},
    **{name: _unary(getattr(torch, name.lower())) for name in (
        "NEG", "ABS", "SIGN", "FLOOR", "CEIL", "TRUNC", "ROUND", "EXP", "EXP2", "LOG", "LOG2",
        "SQRT", "SIN", "COS", "TAN", "ASIN", "ACOS", "ATAN", "SINH", "COSH", "TANH", "ISNAN")},
    "RECIP": _unary(torch.reciprocal),
    "NOT": _unary(torch.bitwise_not), "LNOT": _unary(torch.bitwise_not),
    "SHL": _pair(torch.bitwise_left_shift), "SHR": _pair(torch.bitwise_right_shift),
    "MOV": lambda typ, a: a,
    "WHERE": lambda typ, c, a, b: torch.where(c, a, b),
    "CLAMP": _clamp,
    "NAN2NUM": lambda typ, a, nan, posinf, neginf: torch.nan_to_num(
        a, nan=nan, posinf=posinf, neginf=neginf),
}


def point_program_plain(prog: PointProgram, ins, gy: torch.Tensor, gx: torch.Tensor,
                        t) -> torch.Tensor:
    """The op list over whole images: ``ins`` the input images ((4, H, W)
    f32, in the spec's order), ``gy``/``gx`` the int64 coordinate planes
    (broadcastable to (H, W)), ``t`` the frame time; returns (4, H, W)
    f32."""
    device = gx.device
    hw = (gy.shape[0], gx.shape[-1])
    if not isinstance(t, torch.Tensor):
        t = torch.full((), float(t), dtype=torch.float32, device=device)
    leaves = {K["COORD_X"]: gx, K["COORD_Y"]: gy, K["TIME"]: t}
    regs: dict[int, Any] = {}

    def arg(o):
        if o >= 0:
            return regs[o]
        k = prog.consts[-1 - o]
        if k.scalar:
            return k.value
        return torch.tensor(k.value, dtype=DTYPES[k.typ], device=device)

    pc = 0
    while pc < len(prog.ops):
        op, typ, dst, refs = prog.ops[pc]
        pc += 1
        if op == K["LOOP"]:
            # the interpreter's rounds: the whole image while any lane is
            # active (a lane past its exit changes nothing: the body's
            # merges are masked)
            active, cap, target, _trips = refs
            regs[dst] = arg(dst) + 1
            if bool(torch.as_tensor(arg(active)).any()) and int(regs[dst]) < int(arg(cap)):
                pc = target
            continue
        if op in _LOADS:
            v = ins[refs[0]][refs[1]]
        elif op == _GATHER:
            v = ins[refs[0]][refs[1]][arg(refs[2]), arg(refs[3])]
        elif op == K["FBITS"]:
            v = arg(refs[0]).view(torch.int32)
        elif op == K["IBITS"]:
            v = arg(refs[0]).view(torch.float32)
        elif op in leaves:
            v = leaves[op]
        elif op in _CAST_OPS:
            v = arg(refs[0]).to(DTYPES[typ])
        else:
            v = _PLAIN[KERNEL_OPS[op][1:]](typ, *(arg(r) for r in refs))
        regs[dst] = v

    def plane(o):
        v = arg(o)
        if not isinstance(v, torch.Tensor):
            v = torch.tensor(v, dtype=torch.float32, device=device)
        return torch.broadcast_to(v, hw)

    return torch.stack([plane(o) for o in prog.outputs], dim=0)
