"""sRGB transfer functions and host <-> device image layout (the port of
``reforge_tpu/io/srgb.py``).

The exact IEC 61966-2-1 piecewise curves run on the image's device at
the program boundary (reference: src/render.rs:286-312, 406-433).  Alpha
is linear in both directions.
"""

from __future__ import annotations

import torch

from ..kernels.base import true_divide


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 EOTF, elementwise on color values in [0, 1]."""
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 OETF (inverse EOTF), elementwise."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def decode_image_to_planar(rgba_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) uint8 sRGB -> (4, H, W) f32 linear light, on the input's
    device."""
    x = true_divide(rgba_u8.to(torch.float32), 255.0)
    x = x.permute(2, 0, 1)
    return torch.cat([srgb_to_linear(x[:3]), x[3:4]], dim=0).contiguous()


def encode_planar_to_image(planar: torch.Tensor) -> torch.Tensor:
    """(4, H, W) linear light -> (H, W, 4) uint8 sRGB, on the input's
    device.  ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    planar = planar.to(torch.float32)
    rgb = linear_to_srgb(planar[:3])
    a = torch.clamp(planar[3:4], 0.0, 1.0)
    x = torch.cat([rgb, a], dim=0).permute(1, 2, 0)
    return torch.round(x * 255.0).to(torch.uint8).contiguous()
