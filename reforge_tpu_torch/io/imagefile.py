"""Host image decode/encode (the port of ``reforge_tpu/io/imagefile.py``).

Routes, by what the machine has:
  * **PNG** always goes through the port's own codec (``io/png.py``: zlib
    and numpy, the unfilter in C) and Pillow's Lanczos resize in torch
    (``io/resize.py``), so a machine with neither Pillow nor libav reads
    and writes it, and every machine runs the same code for it.
  * **Other stills** go through the libav extension where it is built,
    else through Pillow where it is installed, else raise
    ``ImageFileError`` naming the format and what is missing.
  * **Video** (``VideoFrames``, ``VideoEncoder``) needs the libav
    extension: ``native/imageio.cpp``, built unchanged with g++ at first
    use into ``build/reforge_tpu_torch/`` where the libav headers are
    found.

All APIs traffic in numpy uint8 arrays of shape (H, W, 4), sRGB-encoded;
linearization happens on the device (io/srgb.py).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ..runtime.native import BUILD_DIR, REPO_DIR, NativeBuildError, build_library
from .png import SIGNATURE, HEADER_BYTES, ImageFileError, decode_png, encode_png, read_header
from .resize import resize_lanczos

LIBAV_SOURCE = REPO_DIR / "native" / "imageio.cpp"
LIBAV_LIB = BUILD_DIR / "libreforge_io.so"
LIBAV_PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
LIBAV_HEADERS = ("libavformat/avformat.h", "libavcodec/avcodec.h", "libavutil/imgutils.h",
                 "libswscale/swscale.h")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_lib_reason = ""
_lock = threading.Lock()


def _libav_cflags() -> tuple[Optional[list[str]], str]:
    """The compiler flags for libav, or None and why the headers are not
    found (pkg-config's include directories and the system's)."""
    cflags: list[str] = []
    pkg = shutil.which("pkg-config")
    if pkg is not None:
        proc = subprocess.run([pkg, "--cflags", *LIBAV_PACKAGES], capture_output=True, text=True)
        if proc.returncode == 0:
            cflags = proc.stdout.split()
    dirs = [f[2:] for f in cflags if f.startswith("-I")]
    dirs += ["/usr/include", "/usr/local/include", *glob.glob("/usr/include/*-linux-gnu")]
    missing = [h for h in LIBAV_HEADERS if not any(os.path.exists(os.path.join(d, h)) for d in dirs)]
    if missing:
        return None, f"libav headers not found ({', '.join(missing)})"
    return cflags, ""


def _native_lib() -> Optional[ctypes.CDLL]:
    """The libav extension, built at first use; None where the libav
    headers are not found.  A build or load that fails raises: the headers
    are there, so the extension is expected."""
    global _lib, _lib_tried, _lib_reason
    with _lock:
        if _lib_tried:
            return _lib
        cflags, reason = _libav_cflags()
        if cflags is None:
            _lib_tried, _lib_reason = True, reason
            return None
        try:
            path = build_library(LIBAV_SOURCE, LIBAV_LIB, cflags,
                                 ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"])
            lib = ctypes.CDLL(str(path))
        except (NativeBuildError, OSError) as e:
            raise ImageFileError(f"libav io extension: {e}") from e
        _declare(lib)
        _lib, _lib_tried = lib, True
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    c_int, c_ptr, c_str, c_dbl = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double
    signatures = {
        "rf_decoder_open": (c_ptr, [c_str, c_str, c_int]),
        "rf_decoder_dims": (None, [c_ptr, ctypes.POINTER(c_int), ctypes.POINTER(c_int)]),
        "rf_decoder_decode": (c_int, [c_ptr, c_str, c_int, c_int, c_str, c_int]),
        "rf_decoder_close": (None, [c_ptr]),
        "rf_decoder_fps": (c_dbl, [c_ptr]),
        "rf_decoder_seek": (c_int, [c_ptr, c_dbl, c_str, c_int]),
        "rf_decoder_next2": (c_int, [c_ptr, c_str, c_int, c_int, ctypes.POINTER(c_dbl), c_str,
                                     c_int]),
        "rf_venc_open": (c_ptr, [c_str, c_int, c_int, c_dbl, c_str, c_int]),
        "rf_venc_write": (c_int, [c_ptr, c_str, c_str, c_int]),
        "rf_venc_close": (c_int, [c_ptr, c_str, c_int]),
        "rf_encode": (c_int, [c_str, c_str, c_int, c_int, c_str, c_int]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def native_backend_available() -> bool:
    return _native_lib() is not None


def native_backend_reason() -> str:
    """Why the libav extension is not there ("" when it is)."""
    return "" if _native_lib() is not None else _lib_reason


def _pillow():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _no_route(path: str) -> ImageFileError:
    ext = os.path.splitext(path)[1].lower() or "extension-less"
    return ImageFileError(
        f"Cannot handle '{path}': {ext} files need the libav io extension "
        f"({_lib_reason or 'not built'}) or Pillow, and neither is available "
        f"(PNG needs neither)")


def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(len(SIGNATURE)) == SIGNATURE


class ImageFileDecoder:
    """Decode a file's first frame to RGBA8 at a requested size.

    Mirrors the reference ImageFileDecoder (imagefileio.rs:84-184): probe
    on construction (exposing source width/height for aspect-fit dimension
    selection), then decode+Lanczos-resize into an RGBA8 buffer.
    """

    def __init__(self, path: str):
        self.path = path
        self._native = None
        self._png = False
        try:
            self._png = _is_png(path)
        except OSError as e:
            raise ImageFileError(f"Failed to open '{path}': {e}") from e
        if self._png:
            with open(path, "rb") as f:
                head = read_header(f.read(HEADER_BYTES), path)
            self.width, self.height = head.width, head.height
            return
        lib = _native_lib()
        if lib is not None:
            err = ctypes.create_string_buffer(512)
            handle = lib.rf_decoder_open(path.encode(), err, len(err))
            if not handle:
                raise ImageFileError(err.value.decode() or f"Failed to open {path}")
            self._native = ctypes.c_void_p(handle)
            w, h = ctypes.c_int(), ctypes.c_int()
            lib.rf_decoder_dims(self._native, ctypes.byref(w), ctypes.byref(h))
            self.width, self.height = w.value, h.value
            return
        image = _pillow()
        if image is None:
            raise _no_route(path)
        try:
            with image.open(path) as im:
                self.width, self.height = im.size
        except Exception as e:  # Pillow raises many kinds for a file it cannot read
            raise ImageFileError(f"Failed to open '{path}': {e}") from e

    def decode(self, width: int, height: int) -> np.ndarray:
        """Return (height, width, 4) uint8 RGBA, Lanczos-resized."""
        if self._png:
            with open(self.path, "rb") as f:
                rgba = decode_png(f.read(), self.path)
            return resize_lanczos(rgba, width, height)
        if self._native is not None:
            out = np.empty((height, width, 4), dtype=np.uint8)
            err = ctypes.create_string_buffer(512)
            rc = _native_lib().rf_decoder_decode(
                self._native, out.ctypes.data_as(ctypes.c_char_p), width, height, err, len(err))
            if rc != 0:
                raise ImageFileError(err.value.decode() or "decode failed")
            return out
        image = _pillow()
        with image.open(self.path) as im:
            im = im.convert("RGBA")
            if (width, height) != im.size:
                im = im.resize((width, height), image.LANCZOS)
            return np.asarray(im, dtype=np.uint8).copy()

    def close(self) -> None:
        if self._native is not None:
            _native_lib().rf_decoder_close(self._native)
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".webm", ".mov", ".m4v", ".mpg")


def is_video_path(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in VIDEO_EXTENSIONS


def _requires_native(what: str) -> ImageFileError:
    return ImageFileError(
        f"{what} requires the native io backend (the libav extension built from "
        f"native/imageio.cpp: {_lib_reason or 'not built'})")


class VideoFrames:
    """Sequential frame iterator over a video (native backend only)."""

    def __init__(self, decoder: ImageFileDecoder, width: int, height: int,
                 start: float = 0.0, duration: Optional[float] = None):
        if decoder._native is None or _native_lib() is None:
            raise _requires_native("Video streaming")
        self._dec = decoder
        self.width = width
        self.height = height
        self.start = max(0.0, float(start))
        self.duration = duration

    @property
    def fps(self) -> float:
        fps = _native_lib().rf_decoder_fps(self._dec._native)
        return fps if fps > 0 else 30.0

    def __iter__(self):
        lib = _native_lib()
        err = ctypes.create_string_buffer(512)
        end = None if self.duration is None else self.start + float(self.duration)
        if self.start > 0.0:
            # Keyframe seek, then decode-and-discard up to the exact start.
            if lib.rf_decoder_seek(self._dec._native, self.start, err, len(err)) != 0:
                raise ImageFileError(err.value.decode() or "seek failed")
        pts = ctypes.c_double(-1.0)
        eps = 1e-6
        while True:
            out = np.empty((self.height, self.width, 4), dtype=np.uint8)
            rc = lib.rf_decoder_next2(
                self._dec._native, out.ctypes.data_as(ctypes.c_char_p), self.width,
                self.height, ctypes.byref(pts), err, len(err))
            if rc == 1:
                return
            if rc != 0:
                raise ImageFileError(err.value.decode() or "video decode failed")
            t = pts.value
            if t >= 0.0:
                if t < self.start - eps:
                    continue  # pre-roll frames from the keyframe seek
                if end is not None and t >= end - eps:
                    return
            yield out


class VideoEncoder:
    """Encode RGBA8 frames to a video container (codec from extension)."""

    def __init__(self, path: str, width: int, height: int, fps: float = 30.0):
        lib = _native_lib()
        if lib is None:
            raise _requires_native("Video encoding")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        handle = lib.rf_venc_open(path.encode(), width, height, float(fps), err, len(err))
        if not handle:
            raise ImageFileError(err.value.decode() or f"cannot open {path}")
        self._enc = ctypes.c_void_p(handle)
        self.width = width
        self.height = height
        self.frames_written = 0

    def write(self, rgba: np.ndarray) -> None:
        rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
        expected = (self.height, self.width, 4)
        if rgba.shape != expected:
            # The C side assumes stride width*4; a mismatched array would
            # make sws_scale read out of bounds.
            raise ImageFileError(f"encoder expects frames of shape {expected}, got {rgba.shape}")
        err = ctypes.create_string_buffer(512)
        rc = self._lib.rf_venc_write(self._enc, rgba.ctypes.data_as(ctypes.c_char_p), err,
                                     len(err))
        if rc != 0:
            raise ImageFileError(err.value.decode() or "video encode failed")
        self.frames_written += 1

    def close(self) -> None:
        if self._enc is not None:
            err = ctypes.create_string_buffer(512)
            rc = self._lib.rf_venc_close(self._enc, err, len(err))
            self._enc = None
            if rc != 0:
                # A failed flush/trailer write leaves a corrupt file; the
                # caller must not report success.
                raise ImageFileError(err.value.decode() or "video finalize failed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # Don't mask the original exception with a finalize error.
            try:
                self.close()
            except ImageFileError:
                pass
            return False
        self.close()
        return False


def encode(path: str, rgba: np.ndarray) -> None:
    """Write (H, W, 4) uint8 RGBA to an image file (codec by extension):
    PNG through the port's codec at zlib level 9 (imagefileio.rs:237-241),
    JPEG through libav where it is built, other formats through Pillow."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png(rgba)
        try:
            with open(path, "wb") as f:
                f.write(data)
        except OSError as e:
            raise ImageFileError(f"Cannot write '{path}': {e}") from e
        return
    lib = _native_lib() if ext in (".jpg", ".jpeg") else None
    if lib is not None:
        err = ctypes.create_string_buffer(512)
        rc = lib.rf_encode(path.encode(), rgba.ctypes.data_as(ctypes.c_char_p), w, h, err,
                           len(err))
        if rc != 0:
            raise ImageFileError(err.value.decode() or "encode failed")
        return
    image = _pillow()
    if image is None:
        raise _no_route(path)
    im = image.fromarray(rgba, "RGBA")
    try:
        if ext in (".jpg", ".jpeg"):
            im.convert("RGB").save(path, quality=95)
        else:
            im.save(path)
    except (OSError, ValueError) as e:
        raise ImageFileError(f"Cannot write '{path}': {e}") from e
