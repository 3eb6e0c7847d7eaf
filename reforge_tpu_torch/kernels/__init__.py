"""Kernel layer: specs, registry, builtin library, loader and the CUDA
kernels (the port of ``reforge_tpu/kernels/``)."""

from .base import (
    KernelContext,
    KernelSpec,
    ParamDecl,
    ParamKind,
    builtin_kernels,
    kernel,
    lookup_builtin,
    quantize_rgba8,
    register_kernel,
)

__all__ = [
    "KernelContext",
    "KernelSpec",
    "ParamDecl",
    "ParamKind",
    "builtin_kernels",
    "kernel",
    "lookup_builtin",
    "quantize_rgba8",
    "register_kernel",
]
