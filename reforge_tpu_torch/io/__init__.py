"""Color management at the program boundary.  Image-file I/O
(``reforge_tpu/io/imagefile.py``) is not ported yet: it needs Pillow or
the native libav extension."""

from .srgb import (
    decode_image_to_planar,
    encode_planar_to_image,
    linear_to_srgb,
    srgb_to_linear,
)

__all__ = [
    "decode_image_to_planar",
    "encode_planar_to_image",
    "linear_to_srgb",
    "srgb_to_linear",
]
