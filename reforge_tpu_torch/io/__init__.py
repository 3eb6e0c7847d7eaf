"""Host image I/O and color management (the port of ``reforge_tpu/io/``).

Image files: PNG through the port's own codec (``png.py``: zlib and numpy,
no Pillow) with Pillow's Lanczos resize in torch (``resize.py``); other
stills through the libav extension or Pillow, video through the libav
extension (``imagefile.py``).  The sRGB conversions run on the device at
the program boundary (``srgb.py``).
"""

from .imagefile import (
    VIDEO_EXTENSIONS,
    ImageFileDecoder,
    ImageFileError,
    VideoEncoder,
    VideoFrames,
    encode,
    is_video_path,
    native_backend_available,
    native_backend_reason,
)
from .srgb import (
    decode_image_to_planar,
    encode_planar_to_image,
    linear_to_srgb,
    srgb_to_linear,
)

__all__ = [
    "VIDEO_EXTENSIONS",
    "ImageFileDecoder",
    "ImageFileError",
    "VideoEncoder",
    "VideoFrames",
    "encode",
    "is_video_path",
    "native_backend_available",
    "native_backend_reason",
    "decode_image_to_planar",
    "encode_planar_to_image",
    "linear_to_srgb",
    "srgb_to_linear",
]
