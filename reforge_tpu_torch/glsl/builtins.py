"""GLSL builtin functions for the vectorizing interpreter (the port of
``reforge_tpu/glsl/builtins.py``).

Componentwise math maps onto torch; geometric functions reduce over
components.  Each builtin has a Python form for static (uniform) operands
and a tensor form, which receives every operand as a tensor of the call's
GLSL type.  ``clamp``/``min``/``max`` propagate pixel-coordinate origins:
``clamp(pos + ivec2(i, j), ivec2(0), size - 1)`` keeps its origin with the
``clamped`` flag set, so imageLoad reads an edge-padded shift.

Bit-level builtins work on 32-bit values: an ``int`` tensor is int32, a
``uint`` tensor int64 in [0, 2**32) (interp.DTYPES); bit casts are
``Tensor.view``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .interp import U32, Interp, Origin, Val, cast, is_static, land, lnot, lor, where
from .lexer import GlslError


def _static_all(*xs) -> bool:
    return all(is_static(x) for x in xs)


def _map1(interp: Interp, v: Val, py: Callable, tx: Callable, out_elem: str | None = None) -> Val:
    """Componentwise unary map."""
    elem = out_elem or ("float" if v.elem_type in ("float",) else v.elem_type)
    if v.is_vector():
        data = [py(c) if is_static(c) else tx(c) for c in v.data]
        prefix = {"float": "", "int": "i", "uint": "u", "bool": "b"}[elem]
        return Val(f"{prefix}vec{v.size}" if v.size > 1 else elem, data)
    return Val(elem, py(v.data) if is_static(v.data) else tx(v.data))


def _broadcast_args(interp: Interp, args: list[Val], line: int) -> tuple[list[Val], str]:
    """Broadcast scalars to the common vector size; floats win over ints."""
    size = max(a.size for a in args)
    any_float = any(a.elem_type == "float" for a in args)
    elem = "float" if any_float else args[0].elem_type
    out = []
    for a in args:
        if a.is_vector():
            if a.size != size:
                raise GlslError("vector size mismatch in builtin call", line)
            out.append(interp.convert(a, _vec_name(elem, size), line) if a.elem_type != elem else a)
        else:
            conv = interp.convert(a, elem, line)
            if size > 1:
                out.append(Val(_vec_name(elem, size), [conv.data] * size))
            else:
                out.append(conv)
    return out, elem


def _vec_name(elem: str, size: int) -> str:
    if size == 1:
        return elem
    prefix = {"float": "", "int": "i", "uint": "u", "bool": "b"}[elem]
    return f"{prefix}vec{size}"


def _zip_map(
    interp: Interp, args: list[Val], line: int, py: Callable, tx: Callable,
    out_elem: Optional[str] = None,
) -> Val:
    args, elem = _broadcast_args(interp, args, line)
    size = args[0].size

    def apply(xs):
        if _static_all(*xs):
            return py(*xs)
        return tx(*[interp._as_tensor(x, elem) for x in xs])

    if size == 1:
        return Val(out_elem or elem, apply([a.data for a in args]))
    comps = [apply([a.data[i] for a in args]) for i in range(size)]
    return Val(_vec_name(out_elem or elem, size), comps)


# ---- origin-aware min/max/clamp ----------------------------------------


def _origin_of(v: Val, comp: int) -> Optional[Origin]:
    if v.is_vector():
        origins = getattr(v, "_comp_origins", None)
        return origins[comp] if origins else None
    return v.origin


def _clamp_origin(
    interp: Interp, x: Val, lo: Val, hi: Val, comp: int, axis_extent: dict
) -> Optional[Origin]:
    """Origin of clamp(x, lo, hi) when lo==0 and hi==extent-1 for x's axis."""
    ox = _origin_of(x, comp)
    if ox is None or ox.clamped:
        return ox
    lo_d = lo.data[comp] if lo.is_vector() else lo.data
    hi_d = hi.data[comp] if hi.is_vector() else hi.data
    if not (is_static(lo_d) and is_static(hi_d)):
        return None
    extent = axis_extent[ox.axis]
    if int(lo_d) == 0 and int(hi_d) == extent - 1:
        return Origin(ox.axis, ox.offset, clamped=True)
    return None


def _clip(a, lo, hi):
    """jnp.clip: minimum(maximum(a, lo), hi)."""
    return torch.minimum(torch.maximum(a, lo), hi)


def _bi_clamp(interp: Interp, args: list[Val], line: int) -> Val:
    x, lo, hi = args
    out = _zip_map(interp, args, line, py=lambda a, b, c: min(max(a, b), c), tx=_clip)
    # Propagate pixel origins through exact image-bounds clamps.
    if x.elem_type in ("int", "uint"):
        extents = {"x": interp.w, "y": interp.global_h}
        if out.is_vector():
            out._comp_origins = [  # type: ignore[attr-defined]
                _clamp_origin(interp, x, lo, hi, i, extents) for i in range(out.size)
            ]
        else:
            out.origin = _clamp_origin(interp, x, lo, hi, 0, extents)
    return out


# ---- geometric ----------------------------------------------------------


def _dot(interp: Interp, args: list[Val], line: int) -> Val:
    a, b = args
    if not a.is_vector() or not b.is_vector() or a.size != b.size:
        raise GlslError("dot() needs equal-size vectors", line)
    total = None
    for x, y in zip(a.data, b.data):
        term = x * y
        total = term if total is None else total + term
    return Val("float", total)


def _length(interp: Interp, args: list[Val], line: int) -> Val:
    (a,) = args
    if not a.is_vector():
        return _zip_map(interp, [a], line, abs, torch.abs)
    d = _dot(interp, [a, a], line)
    return Val("float", math.sqrt(d.data) if is_static(d.data) else torch.sqrt(d.data))


def _screen_derivative(interp: Interp, v: Val, axis: int) -> Val:
    """Forward difference along screen x (axis=1) or y (axis=0),
    edge-clamped: the whole-image analog of the GPU's quad dFdx/dFdy.
    Derivatives of uniforms are exactly zero."""
    interp.stats["max_shift"] = max(interp.stats.get("max_shift", 0), 1)
    interp.stats["edge_shift"] = True

    def d(comp):
        if is_static(comp):
            return 0.0
        a = interp._as_array(comp, "float")
        if axis == 1:
            nxt = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
        else:
            nxt = torch.cat([a[1:, :], a[-1:, :]], dim=0)
        return nxt - a

    if v.is_vector():
        return Val(f"vec{v.size}", [d(c) for c in v.data])
    return Val("float", d(v.data))


def _dfdx(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    return _screen_derivative(interp, v, 1)


def _dfdy(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    return _screen_derivative(interp, v, 0)


def _fwidth(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    ax = _map1(interp, _dfdx(interp, [v], line), abs, torch.abs)
    ay = _map1(interp, _dfdy(interp, [v], line), abs, torch.abs)
    return interp._arith("+", ax, ay, line)


def _distance(interp: Interp, args: list[Val], line: int) -> Val:
    a, b = args
    diff = interp._arith("-", a, b, line)
    return _length(interp, [diff], line)


def _normalize(interp: Interp, args: list[Val], line: int) -> Val:
    (a,) = args
    ln = _length(interp, [a], line)
    return interp._arith("/", a, ln, line)


def _cross(interp: Interp, args: list[Val], line: int) -> Val:
    a, b = args
    if a.type != "vec3" or b.type != "vec3":
        raise GlslError("cross() needs vec3", line)
    ax, ay, az = a.data
    bx, by, bz = b.data
    return Val("vec3", [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx])


def _reflect(interp: Interp, args: list[Val], line: int) -> Val:
    i, n = args
    d = _dot(interp, [n, i], line)
    two_d = Val("float", 2.0 * d.data)
    scaled = interp._arith("*", n, two_d, line)
    return interp._arith("-", i, scaled, line)


def _mix(interp: Interp, args: list[Val], line: int) -> Val:
    if args[2].elem_type == "bool":
        # mix(x, y, bvec a): componentwise select, y where a is true.
        x, y, a = args
        size = max(x.size, y.size, a.size)

        def comp(v, i):
            return v.data[i] if v.is_vector() else v.data

        comps = []
        for i in range(size):
            c, xc, yc = comp(a, i), comp(x, i), comp(y, i)
            if is_static(c):
                comps.append(yc if c else xc)
            else:
                comps.append(where(c, yc, xc, x.elem_type))
        return Val(_vec_name(x.elem_type, size), comps) if size > 1 else Val(
            x.elem_type, comps[0]
        )
    return _zip_map(
        interp, args, line,
        py=lambda x, y, a: x + (y - x) * a,
        tx=lambda x, y, a: x + (y - x) * a,
    )


def _mod(interp: Interp, args: list[Val], line: int) -> Val:
    # GLSL float mod: x - y*floor(x/y)
    return _zip_map(
        interp, args, line,
        py=lambda x, y: x - y * math.floor(x / y) if y != 0 else 0.0,
        tx=lambda x, y: x - y * torch.floor(x / y),
    )


def _step(interp: Interp, args: list[Val], line: int) -> Val:
    return _zip_map(
        interp, args, line,
        py=lambda e, x: 0.0 if x < e else 1.0,
        tx=lambda e, x: torch.where(x < e, 0.0, 1.0),
    )


def _smoothstep(interp: Interp, args: list[Val], line: int) -> Val:
    def py(e0, e1, x):
        t = min(max((x - e0) / (e1 - e0), 0.0), 1.0)
        return t * t * (3.0 - 2.0 * t)

    def tx(e0, e1, x):
        t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    return _zip_map(interp, args, line, py, tx)


def _atan(interp: Interp, args: list[Val], line: int) -> Val:
    if len(args) == 2:
        return _zip_map(interp, args, line, math.atan2, torch.atan2)
    return _zip_map(interp, args, line, math.atan, torch.atan)


def _compare_vec(op_py, op_tx):
    def fn(interp: Interp, args: list[Val], line: int) -> Val:
        return _zip_map(interp, args, line, op_py, op_tx, out_elem="bool")

    return fn


def _any(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    acc = None
    for c in v.data if v.is_vector() else [v.data]:
        acc = c if acc is None else lor(acc, c)
    return Val("bool", acc)


def _all(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    acc = None
    for c in v.data if v.is_vector() else [v.data]:
        acc = c if acc is None else land(acc, c)
    return Val("bool", acc)


def _not(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    return _map1(interp, v, lambda x: not x, lnot, out_elem="bool")


def _gdot(a: Val, b: Val):
    """dot() generalized to genType (scalar or vector) raw data."""
    xs = a.data if a.is_vector() else [a.data]
    ys = b.data if b.is_vector() else [b.data]
    total = None
    for x, y in zip(xs, ys):
        t = x * y
        total = t if total is None else total + t
    return total


def _refract(interp: Interp, args: list[Val], line: int) -> Val:
    i, n, eta = args
    d = _gdot(n, i)
    e = eta.data if not eta.is_vector() else eta.data[0]
    k = 1.0 - e * e * (1.0 - d * d)
    ics = i.data if i.is_vector() else [i.data]
    ncs = n.data if n.is_vector() else [n.data]
    if _static_all(k, e, d) and all(map(is_static, ics + ncs)):
        if k < 0.0:
            comps = [0.0] * len(ics)
        else:
            coef = e * d + math.sqrt(k)
            comps = [e * ic - coef * nc for ic, nc in zip(ics, ncs)]
    else:
        k = interp._as_tensor(k, "float")
        coef = e * d + torch.sqrt(torch.maximum(k, torch.zeros_like(k)))
        keep = k >= 0.0
        comps = [
            torch.where(keep, interp._as_tensor(e * ic - coef * nc, "float"), 0.0)
            for ic, nc in zip(ics, ncs)
        ]
    return Val(i.type, comps if i.is_vector() else comps[0])


def _faceforward(interp: Interp, args: list[Val], line: int) -> Val:
    n, i, nref = args
    d = _gdot(nref, i)
    ncs = n.data if n.is_vector() else [n.data]
    if is_static(d) and all(map(is_static, ncs)):
        comps = [nc if d < 0.0 else -nc for nc in ncs]
    else:
        fwd = interp._as_tensor(d, "float") < 0.0
        comps = [torch.where(fwd, interp._as_tensor(nc, "float"), -1.0 * nc) for nc in ncs]
    return Val(n.type, comps if n.is_vector() else comps[0])


def _ldexp(interp: Interp, args: list[Val], line: int) -> Val:
    return _zip_map(
        interp, args, line,
        py=lambda x, e: math.ldexp(x, int(e)),
        tx=lambda x, e: x * torch.exp2(e),
    )


# ---- bit-level: casts, counts, fields, pack/unpack ----------------------
#
# Static (python-int) lanes wrap to 32 bits like the GPU's registers do;
# tensor lanes work on the 32-bit value in int64 (``& U32``) and go back to
# the call's type.  Python and tensor forms must agree bit-exactly.


def _u32(x) -> int:
    return int(x) & 0xFFFFFFFF


def _i32(x) -> int:
    x = int(x) & 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def _float_bits_py(x) -> int:
    import struct

    return struct.unpack("<I", struct.pack("<f", x))[0]


def _bits_float_py(x) -> float:
    import struct

    return struct.unpack("<f", struct.pack("<I", _u32(x)))[0]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit value of an int or uint tensor, in int64."""
    return x.to(torch.int64) & U32


def _back(u: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A 32-bit value in int64 as the type of ``like`` (int or uint)."""
    return cast(u, "int") if like.dtype == torch.int32 else u


def _pop_py(x) -> int:
    return bin(_u32(x)).count("1")


def _pop_u(u: torch.Tensor) -> torch.Tensor:
    """Population count of 32-bit values in int64 (SWAR)."""
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return ((u * 0x01010101) & U32) >> 24


def _pop_tx(x):
    return _pop_u(_bits(x)).to(torch.int32)


def _find_lsb_py(x) -> int:
    v = _u32(x)
    return (v & -v).bit_length() - 1 if v else -1


def _find_lsb_tx(x):
    u = _bits(x)
    tz = _pop_u(((u & -u) - 1) & U32).to(torch.int32)
    return torch.where(u == 0, -1, tz)


def _find_msb_py(x) -> int:
    v = int(x)
    if v < 0:
        v = ~v
    v = _u32(v)
    return v.bit_length() - 1


def _find_msb_tx(x):
    v = torch.where(x < 0, ~x, x) if x.dtype == torch.int32 else x
    u = _bits(v)
    for s in (1, 2, 4, 8, 16):
        u = u | (u >> s)
    return (_pop_u(u) - 1).to(torch.int32)  # 0 gives -1


def _bitfield_extract(interp: Interp, args: list[Val], line: int) -> Val:
    signed = args[0].elem_type == "int"

    def py(v, o, b):
        v, o, b = _u32(v), int(o), int(b)
        if b == 0:
            return 0
        r = (v >> o) & ((1 << b) - 1)
        if signed and (r >> (b - 1)) & 1:
            r -= 1 << b
        return r if signed else r & 0xFFFFFFFF

    def tx(v, o, b):
        o, b = o.to(torch.int64), b.to(torch.int64)
        r = (_bits(v) >> o) & ((1 << b) - 1)
        if signed:
            neg = (b > 0) & (((r >> (b - 1).clamp(min=0)) & 1) == 1)
            r = torch.where(neg, r - (1 << b), r)
            return torch.where(b == 0, 0, r).to(torch.int32)
        return torch.where(b == 0, 0, r)

    return _zip_map(interp, args, line, py, tx)


def _bitfield_insert(interp: Interp, args: list[Val], line: int) -> Val:
    signed = args[0].elem_type == "int"

    def py(base, ins, o, b):
        base, ins, o, b = _u32(base), _u32(ins), int(o), int(b)
        mask = ((1 << b) - 1) << o
        r = (base & ~mask) | ((ins << o) & mask)
        return _i32(r) if signed else r & 0xFFFFFFFF

    def tx(base, ins, o, b):
        o, b = o.to(torch.int64), b.to(torch.int64)
        mask = torch.where(b >= 32, U32, (((1 << b) - 1) << o) & U32)
        r = (_bits(base) & (mask ^ U32)) | ((_bits(ins) << o) & mask)
        return _back(r & U32, base)

    return _zip_map(interp, args, line, py, tx)


def _brev_py(x) -> int:
    return int("{:032b}".format(_u32(x))[::-1], 2)


def _brev_tx(x):
    u = _bits(x)
    u = ((u & 0x55555555) << 1) | ((u >> 1) & 0x55555555)
    u = ((u & 0x33333333) << 2) | ((u >> 2) & 0x33333333)
    u = ((u & 0x0F0F0F0F) << 4) | ((u >> 4) & 0x0F0F0F0F)
    u = ((u & 0x00FF00FF) << 8) | ((u >> 8) & 0x00FF00FF)
    u = ((u << 16) | (u >> 16)) & U32
    return _back(u, x)


def _bitrev(interp: Interp, args: list[Val], line: int) -> Val:
    (v,) = args
    signed = v.elem_type == "int"
    return _map1(interp, v, (lambda x: _i32(_brev_py(x))) if signed else _brev_py, _brev_tx)


def _pack(interp: Interp, v: Val, line: int, n: int, encode_py, encode_tx, name: str) -> Val:
    if not v.is_vector() or v.size != n or v.elem_type != "float":
        raise GlslError(f"{name}() needs a vec{n}", line)
    bits = 32 // n
    if all(map(is_static, v.data)):
        acc = 0
        for i, c in enumerate(v.data):
            acc |= (encode_py(c) & ((1 << bits) - 1)) << (bits * i)
        return Val("uint", acc)
    acc = None
    for i, c in enumerate(v.data):
        b = cast(encode_tx(interp._as_array(c, "float")), "uint")
        b = (b & ((1 << bits) - 1)) << (bits * i)
        acc = b if acc is None else acc | b
    return Val("uint", acc)


def _unpack(interp: Interp, v: Val, line: int, n: int, decode_py, decode_tx, name: str) -> Val:
    if v.is_vector() or v.elem_type not in ("uint", "int"):
        raise GlslError(f"{name}() needs a uint", line)
    bits = 32 // n
    comps = []
    for i in range(n):
        if is_static(v.data):
            comps.append(decode_py((_u32(v.data) >> (bits * i)) & ((1 << bits) - 1)))
        else:
            field = (_bits(v.data) >> (bits * i)) & ((1 << bits) - 1)
            comps.append(decode_tx(interp, field))
    return Val(f"vec{n}", comps)


def _snorm_enc_py(scale):
    return lambda c: _u32(int(round(min(max(c, -1.0), 1.0) * scale)))


def _snorm_enc_tx(scale):
    return lambda c: cast(torch.round(torch.clamp(c, -1.0, 1.0) * scale), "int")


def _snorm_dec(bits, scale):
    half = 1 << (bits - 1)
    full = 1 << bits

    def py(b):
        s = b - full if b >= half else b
        return min(max(s / scale, -1.0), 1.0)

    def tx(interp, b):
        s = torch.where(b >= half, b - full, b).to(torch.float32)
        return torch.clamp(s / interp._as_tensor(scale, "float"), -1.0, 1.0)

    return py, tx


def _half_enc_py(c) -> int:
    import numpy as np

    return int(np.float32(c).astype(np.float16).view(np.uint16))


def _half_enc_tx(c):
    return c.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _half_dec_py(b) -> float:
    import numpy as np

    return float(np.uint16(b).view(np.float16))


def _half_dec_tx(interp, b):
    return torch.where(b >= 32768, b - 65536, b).to(torch.int16).view(torch.float16).to(
        torch.float32)


def _unorm_dec_tx(scale):
    return lambda interp, b: b.to(torch.float32) / interp._as_tensor(scale, "float")


_PACK_FNS: dict[str, tuple] = {
    # name -> (n, encode_py, encode_tx)
    "packUnorm4x8": (
        4,
        lambda c: int(round(min(max(c, 0.0), 1.0) * 255.0)),
        lambda c: torch.round(torch.clamp(c, 0.0, 1.0) * 255.0),
    ),
    "packSnorm4x8": (4, _snorm_enc_py(127.0), _snorm_enc_tx(127.0)),
    "packUnorm2x16": (
        2,
        lambda c: int(round(min(max(c, 0.0), 1.0) * 65535.0)),
        lambda c: torch.round(torch.clamp(c, 0.0, 1.0) * 65535.0),
    ),
    "packSnorm2x16": (2, _snorm_enc_py(32767.0), _snorm_enc_tx(32767.0)),
    "packHalf2x16": (2, _half_enc_py, _half_enc_tx),
}

_UNPACK_FNS: dict[str, tuple] = {
    "unpackUnorm4x8": (4, lambda b: b / 255.0, _unorm_dec_tx(255.0)),
    "unpackSnorm4x8": (4, *_snorm_dec(8, 127.0)),
    "unpackUnorm2x16": (2, lambda b: b / 65535.0, _unorm_dec_tx(65535.0)),
    "unpackSnorm2x16": (2, *_snorm_dec(16, 32767.0)),
    "unpackHalf2x16": (2, _half_dec_py, _half_dec_tx),
}


def _make_pack(name, n, enc_py, enc_tx):
    def fn(interp: Interp, args: list[Val], line: int) -> Val:
        (v,) = args
        return _pack(interp, v, line, n, enc_py, enc_tx, name)

    return fn


def _make_unpack(name, n, dec_py, dec_tx):
    def fn(interp: Interp, args: list[Val], line: int) -> Val:
        (v,) = args
        return _unpack(interp, v, line, n, dec_py, dec_tx, name)

    return fn


# ---- matrix builtins -----------------------------------------------------
#
# Matrices are column-major lists of columns (Val.data[j][i] = row i of
# column j), each element a static float or an (H, W) lane array — so
# determinant/inverse are plain arithmetic over elements and vectorize
# for free.


def _mat_size(v: Val, line: int, fn: str) -> int:
    from .interp import MAT_TYPES

    if v.type not in MAT_TYPES:
        raise GlslError(f"{fn}() needs a matrix", line)
    return MAT_TYPES[v.type]


def _matrix_comp_mult(interp: Interp, args: list[Val], line: int) -> Val:
    a, b = args
    n = _mat_size(a, line, "matrixCompMult")
    if b.type != a.type:
        raise GlslError("matrixCompMult() needs matching matrices", line)
    return Val(
        a.type,
        [[x * y for x, y in zip(ca, cb)] for ca, cb in zip(a.data, b.data)],
    )


def _outer_product(interp: Interp, args: list[Val], line: int) -> Val:
    c, r = args
    if not c.is_vector() or not r.is_vector() or c.size != r.size:
        raise GlslError(
            "outerProduct() supports equal-size vectors (square result)", line
        )
    n = c.size
    cols = [[c.data[i] * r.data[j] for i in range(n)] for j in range(n)]
    return Val(f"mat{n}", cols)


def _minor(d, n: int, i: int, j: int):
    rows = [r for r in range(n) if r != i]
    cols = [c for c in range(n) if c != j]
    return [[d[c][r] for r in rows] for c in cols]


def _det(d, n: int):
    if n == 1:
        return d[0][0]
    if n == 2:
        return d[0][0] * d[1][1] - d[1][0] * d[0][1]
    acc = None
    for i in range(n):
        term = d[0][i] * _det(_minor(d, n, i, 0), n - 1)
        if i % 2:
            term = -term
        acc = term if acc is None else acc + term
    return acc


def _determinant(interp: Interp, args: list[Val], line: int) -> Val:
    (m,) = args
    n = _mat_size(m, line, "determinant")
    return Val("float", _det(m.data, n))


def _inverse(interp: Interp, args: list[Val], line: int) -> Val:
    (m,) = args
    n = _mat_size(m, line, "inverse")
    det = _det(m.data, n)
    inv_det = (1.0 / det) if is_static(det) else 1.0 / det
    cols = []
    for j in range(n):
        col = []
        for i in range(n):
            c = _det(_minor(m.data, n, j, i), n - 1)
            if (i + j) % 2:
                c = -c
            col.append(c * inv_det)
        cols.append(col)
    return Val(m.type, cols)


def _simple(py: Callable, tx: Callable, out_elem: Optional[str] = None):
    def fn(interp: Interp, args: list[Val], line: int) -> Val:
        return _zip_map(interp, args, line, py, tx, out_elem=out_elem)

    return fn


def _trunc_py(x):
    return float(int(x))


def _bitcast(to: str) -> Callable:
    """Bit cast of a 32-bit tensor to float, int or uint."""
    def fn(x):
        if x.dtype == torch.float32:
            bits = x.view(torch.int32)
            return bits if to == "int" else bits.to(torch.int64) & U32
        return cast(x, "int").view(torch.float32)

    return fn


BUILTIN_FUNCS: dict[str, Callable[[Interp, list, int], Val]] = {
    "abs": _simple(abs, torch.abs, None),
    "sign": _simple(lambda x: (x > 0) - (x < 0), torch.sign),
    "floor": _simple(math.floor, torch.floor),
    "ceil": _simple(math.ceil, torch.ceil),
    "fract": _simple(lambda x: x - math.floor(x), lambda x: x - torch.floor(x)),
    "trunc": _simple(_trunc_py, torch.trunc),
    "round": _simple(round, torch.round),
    "roundEven": _simple(round, torch.round),
    "min": _simple(min, torch.minimum),
    "max": _simple(max, torch.maximum),
    "clamp": _bi_clamp,
    "mix": _mix,
    "step": _step,
    "smoothstep": _smoothstep,
    "mod": _mod,
    "pow": _simple(math.pow, torch.pow),
    "exp": _simple(math.exp, torch.exp),
    "exp2": _simple(lambda x: 2.0 ** x, torch.exp2),
    "log": _simple(math.log, torch.log),
    "log2": _simple(math.log2, torch.log2),
    "sqrt": _simple(math.sqrt, torch.sqrt),
    "inversesqrt": _simple(lambda x: 1.0 / math.sqrt(x), lambda x: 1.0 / torch.sqrt(x)),
    "sin": _simple(math.sin, torch.sin),
    "cos": _simple(math.cos, torch.cos),
    "tan": _simple(math.tan, torch.tan),
    "asin": _simple(math.asin, torch.asin),
    "acos": _simple(math.acos, torch.acos),
    "atan": _atan,
    "sinh": _simple(math.sinh, torch.sinh),
    "cosh": _simple(math.cosh, torch.cosh),
    "tanh": _simple(math.tanh, torch.tanh),
    "radians": _simple(math.radians, lambda x: x * (math.pi / 180.0)),
    "degrees": _simple(math.degrees, lambda x: x * (180.0 / math.pi)),
    "dot": _dot,
    "length": _length,
    "dFdx": _dfdx,
    "dFdy": _dfdy,
    "fwidth": _fwidth,
    "distance": _distance,
    "normalize": _normalize,
    "cross": _cross,
    "reflect": _reflect,
    "lessThan": _compare_vec(lambda a, b: a < b, torch.lt),
    "lessThanEqual": _compare_vec(lambda a, b: a <= b, torch.le),
    "greaterThan": _compare_vec(lambda a, b: a > b, torch.gt),
    "greaterThanEqual": _compare_vec(lambda a, b: a >= b, torch.ge),
    "equal": _compare_vec(lambda a, b: a == b, torch.eq),
    "notEqual": _compare_vec(lambda a, b: a != b, torch.ne),
    "any": _any,
    "all": _all,
    "not": _not,
    "isnan": _simple(lambda x: x != x, torch.isnan, out_elem="bool"),
    "isinf": _simple(lambda x: x in (float("inf"), float("-inf")), torch.isinf, out_elem="bool"),
    "fma": _simple(lambda a, b, c: a * b + c, lambda a, b, c: a * b + c),
    "ldexp": _ldexp,
    "refract": _refract,
    "faceforward": _faceforward,
    "floatBitsToInt": _simple(lambda x: _i32(_float_bits_py(x)), _bitcast("int"), out_elem="int"),
    "floatBitsToUint": _simple(_float_bits_py, _bitcast("uint"), out_elem="uint"),
    "intBitsToFloat": _simple(_bits_float_py, _bitcast("float"), out_elem="float"),
    "uintBitsToFloat": _simple(_bits_float_py, _bitcast("float"), out_elem="float"),
    "bitCount": _simple(_pop_py, _pop_tx, out_elem="int"),
    "findLSB": _simple(_find_lsb_py, _find_lsb_tx, out_elem="int"),
    "findMSB": _simple(_find_msb_py, _find_msb_tx, out_elem="int"),
    "bitfieldExtract": _bitfield_extract,
    "bitfieldInsert": _bitfield_insert,
    "bitfieldReverse": _bitrev,
    "matrixCompMult": _matrix_comp_mult,
    "outerProduct": _outer_product,
    "determinant": _determinant,
    "inverse": _inverse,
}

BUILTIN_FUNCS.update({name: _make_pack(name, *spec) for name, spec in _PACK_FNS.items()})
BUILTIN_FUNCS.update({name: _make_unpack(name, *spec) for name, spec in _UNPACK_FNS.items()})
