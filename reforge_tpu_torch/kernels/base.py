"""Kernel specification, registry, and binding reflection (the port of
``reforge_tpu/kernels/base.py``).

Data model, as in the reference package:
  * Images are planar ``float32[4, H, W]`` (RGBA, channels leading) tensors
    on the program's device, in linear light; sRGB conversion happens at
    the I/O boundary (io/srgb.py).
  * Parameters are static Python scalars: a parameter edit rebuilds the
    program, so kernels may derive static structure (tap vectors, op
    lists) from them.  The one per-frame value, ``_rf_time``, arrives as
    ``KernelContext.time``.
"""

from __future__ import annotations

import dataclasses
import enum
import inspect
from typing import Any, Callable, Mapping, Optional

import torch

from ..utils import warnln


class ParamKind(enum.Enum):
    FLOAT = "float"
    INT = "int"
    BOOL = "bool"

    @staticmethod
    def of(value: Any) -> "ParamKind":
        if isinstance(value, bool):
            return ParamKind.BOOL
        if isinstance(value, int):
            return ParamKind.INT
        if isinstance(value, float):
            return ParamKind.FLOAT
        raise TypeError(f"unsupported parameter default {value!r}")


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    """One scalar parameter (the analog of a reflected UBO member)."""

    name: str
    kind: ParamKind
    default: Any

    def coerce(self, raw: Any) -> Any:
        """Coerce a config-file value to this parameter's declared type, with
        the reference's warn-and-zero fallback (src/render.rs:169-186)."""
        try:
            if self.kind is ParamKind.FLOAT:
                return float(raw)
            if self.kind is ParamKind.INT:
                if isinstance(raw, bool):
                    return int(raw)
                if isinstance(raw, float) and not raw.is_integer():
                    raise ValueError(f"non-integer value {raw!r} for int parameter")
                return int(raw)
            return bool(raw)
        except (TypeError, ValueError) as e:
            warnln(f"Failed to convert: {e}")
            return {ParamKind.FLOAT: 0.0, ParamKind.INT: 0, ParamKind.BOOL: False}[
                self.kind
            ]


@dataclasses.dataclass
class KernelContext:
    """Execution context passed to every kernel.

    ``width``/``height`` are the image extent that coordinate math uses;
    ``device`` is where coordinate planes are built (the card unless the
    caller names the CPU).  The reference's row/column offsets of sharded
    blocks wait for the sharded tiers.
    """

    width: int
    height: int
    time: Any = 0.0  # f32 seconds since start (``_rf_time``)
    fmt: str = "rgba32f"  # "rgba8" | "rgba16f" | "rgba32f"
    device: Any = "cuda"


@dataclasses.dataclass
class KernelSpec:
    """A graph-node kernel: declared bindings + a torch function.

    ``fn(ctx, **images, **params)`` returns a single tensor (bound to the
    first declared output) or a dict of ``descriptor_name -> tensor``.
    """

    name: str
    fn: Callable[..., Any]
    images_in: tuple[str, ...] = ("input_image",)
    images_out: tuple[str, ...] = ("output_image",)
    # Storage-buffer bindings (1-D f32 between nodes).  No ported builtin
    # declares one; the graph builder still validates their wiring.
    ssbos_in: tuple[str, ...] = ()
    ssbos_out: tuple[str, ...] = ()
    ssbo_sizes: dict[str, int] = dataclasses.field(default_factory=dict)
    params: dict[str, ParamDecl] = dataclasses.field(default_factory=dict)
    # Alternate config spellings for declared params (GLSL vector UBO
    # members accept "tint.r" for the canonical "tint.x").
    param_aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    # Spatial support radius as a function of (static) params.
    halo: Callable[[Mapping[str, Any]], Optional[int]] = lambda params: 0
    # Border convention at the image edge ("edge" clamp or "zero").
    border: Callable[[Mapping[str, Any]], str] = lambda params: "edge"
    source_path: Optional[str] = None
    doc: str = ""
    # Separable-conv structure: conv_weights(params) -> (wh, ww) numpy tap
    # vectors (or None for these params); conv_epilogue(ctx, x, blurred,
    # params) makes the node's output from the blur.  Same-input conv
    # nodes of one layer bundle into one sep_conv_fused_multi launch.
    conv_weights: Optional[Callable[[Mapping[str, Any]], Optional[tuple]]] = None
    conv_epilogue: Optional[Callable[..., Any]] = None
    # Channel-local forms: cw_fn(ctx, ci, ins, params) computes channel ci
    # (an int or a (C, 1, 1) index tensor) of the node's output;
    # conv_epilogue_cw(ctx, ci, x, blurred, params) is the channel form of
    # conv_epilogue.
    cw_fn: Optional[Callable[..., Any]] = None
    conv_epilogue_cw: Optional[Callable[..., Any]] = None
    # Coordinate-plane hoist: cw_coord_plane(ctx, params) -> (H, W) f32
    # built once per program; cw_plane_fn(ctx, ci, ins, params, plane) is
    # cw_fn consuming it.
    cw_coord_plane: Optional[Callable[..., Any]] = None
    cw_plane_fn: Optional[Callable[..., Any]] = None
    # Device form of the channel-local node for the graph_strip kernel:
    # cw_op(params, plane) -> (opcode, float params), opcodes from
    # kernels/cuda_ops.py.  ``plane`` is True when the program hoisted the
    # node's coordinate plane.  Only nodes with a cw_op join a strip plan.
    cw_op: Optional[Callable[..., tuple]] = None
    # Node-internal pointwise map feeding the separable conv (bloom's
    # threshold mask): conv_pre(ctx, x, params) -> image, kept in f32 (not
    # a node boundary).
    conv_pre: Optional[Callable[..., Any]] = None
    # Small-radius neighbourhood form for the mc tier: mc_stencil_fn(ctx,
    # tap, params) -> (4, h, w), where tap(dy, dx) is the (4, h, w) view
    # shifted by (dy - r, dx - r).
    mc_stencil_fn: Optional[Callable[..., Any]] = None
    # Device form of the node for the graph_strip_mc kernel: mc_op(params,
    # pre=False) -> cuda_ops.McOp (opcode, float params, tap tables),
    # opcodes from kernels/cuda_ops.py; ``pre=True`` asks for the form of
    # conv_pre.  The opcode's kind (point, stencil or conv epilogue) must
    # match the stage the node becomes.  Only nodes with an mc_op join an
    # mc plan.
    mc_op: Optional[Callable[..., Any]] = None
    # File-loaded (GLSL) kernels: mc_block_ok(params) is the reference's
    # eligibility for evaluating the shader on blocks inside its mc kernel
    # (pointwise, no per-lane local-array gathers); the port's mc tier has
    # no GLSL point stages, and keeps it for reflection parity.  None for
    # builtins.
    mc_block_ok: Optional[Callable[[Mapping[str, Any]], bool]] = None
    # SHA-256 of a GLSL kernel's source: the conv-synthesis cache key.
    source_hash: Optional[str] = None

    # ---- reflection (the SPIR-V descriptor-enumeration analog) ---------

    @property
    def inputs_all(self) -> tuple[str, ...]:
        return self.images_in + self.ssbos_in

    @property
    def outputs_all(self) -> tuple[str, ...]:
        return self.images_out + self.ssbos_out

    def resolve_params(self, config_params: Mapping[str, Any]) -> dict[str, Any]:
        """Match config parameter values against declared parameters by
        name: unknown names warn, unspecified ones take their defaults."""
        resolved = {name: decl.default for name, decl in self.params.items()}
        for key, raw in config_params.items():
            if key == "_rf_time":
                continue
            key = self.param_aliases.get(key, key)
            decl = self.params.get(key)
            if decl is None:
                warnln(
                    f"Parameter '{key}' not found in kernel '{self.name}' "
                    f"(declared: {', '.join(self.params) or 'none'})"
                )
                continue
            value = raw.value if hasattr(raw, "value") else raw
            resolved[key] = decl.coerce(value)
        return resolved

    def halo_for(self, params: Mapping[str, Any]) -> Optional[int]:
        return self.halo(params)

    def border_for(self, params: Mapping[str, Any]) -> str:
        return self.border(params)

    def __call__(self, ctx: KernelContext, images: Mapping[str, Any], params: Mapping[str, Any]) -> dict[str, Any]:
        out = self.fn(ctx, **images, **params)
        if isinstance(out, dict):
            return out
        return {self.images_out[0]: out}


def kernel(
    name: str,
    *,
    images_in: tuple[str, ...] | None = None,
    images_out: tuple[str, ...] = ("output_image",),
    halo: int | Callable[[Mapping[str, Any]], Optional[int]] = 0,
    doc: str = "",
):
    """Decorator declaring a kernel from a plain function.

    Parameters after ``ctx`` without defaults are image bindings; keyword
    parameters with scalar defaults become ``ParamDecl``s typed by their
    default.
    """

    def wrap(fn: Callable[..., Any]) -> KernelSpec:
        sig = inspect.signature(fn)
        names = list(sig.parameters)
        if not names or names[0] != "ctx":
            raise TypeError(f"kernel {name}: first arg must be ctx")
        inferred_images: list[str] = []
        params: dict[str, ParamDecl] = {}
        for pname in names[1:]:
            p = sig.parameters[pname]
            if p.default is inspect.Parameter.empty:
                inferred_images.append(pname)
            else:
                params[pname] = ParamDecl(pname, ParamKind.of(p.default), p.default)
        halo_fn = halo if callable(halo) else (lambda _params, _h=halo: _h)
        spec = KernelSpec(
            name=name,
            fn=fn,
            images_in=tuple(images_in if images_in is not None else inferred_images),
            images_out=images_out,
            params=params,
            halo=halo_fn,
            doc=doc or (fn.__doc__ or ""),
        )
        register_kernel(spec)
        return spec

    return wrap


# ---- builtin registry ---------------------------------------------------

_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> None:
    _REGISTRY[spec.name] = spec


def builtin_kernels() -> dict[str, KernelSpec]:
    from . import library  # noqa: F401  (registers the builtins)

    return dict(_REGISTRY)


def lookup_builtin(name: str) -> Optional[KernelSpec]:
    from . import library  # noqa: F401

    return _REGISTRY.get(name)


def true_divide(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """``x / divisor`` correctly rounded on every device.  With a Python
    scalar divisor PyTorch's CUDA kernel multiplies by the reciprocal,
    which can be one bit off; a divisor held on the device divides."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def quantize_rgba8(x: torch.Tensor) -> torch.Tensor:
    """Round-trip through 8-bit UNORM storage precision (``--shader-format
    rgba8``, src/main.rs:34-41).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, and the division is exact as in the reference:
    node outputs that average two grid values sit on rounding ties, where
    one bit decides the bucket."""
    return true_divide(torch.round(torch.clamp(x, 0.0, 1.0) * 255.0), 255.0)
