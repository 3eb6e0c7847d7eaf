"""A PNG codec on ``zlib`` and numpy, with no Pillow: the only way an image
file reaches the card on a machine without Pillow or libav.

Decode: bit depth 8, not interlaced, colour types 0 (gray), 2 (RGB),
3 (palette), 4 (gray+alpha) and 6 (RGBA), with ``tRNS``; every chunk's CRC
is checked.  The result is (H, W, 4) uint8 RGBA, what Pillow's
``convert("RGBA")`` gives.  Any other PNG raises ``ImageFileError`` naming
what it is.

Encode: RGBA, 8 bits, zlib level 9 (the reference's encoder,
``reforge_tpu/io/imagefile.py:325-354``), each row's filter chosen by the
least sum of absolute differences (libpng's heuristic); the filters read
the unfiltered row above, so the choice is vectorised over the image.

The Sub, Average and Paeth unfilters are sequential along a row, so the
decoder unfilters in C (``png_unfilter.cpp``, built with g++ at first use
into ``build/reforge_tpu_torch/``).  ``unfilter_plain`` is the numpy
version the tests hold it against; the codec never falls back to it.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..runtime.native import BUILD_DIR, NativeBuildError, build_library

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}
# The signature and the IHDR chunk: all read_header needs.
HEADER_BYTES = 33

UNFILTER_SOURCE = Path(__file__).resolve().parent / "png_unfilter.cpp"
UNFILTER_LIB = BUILD_DIR / "librf_png_unfilter.so"

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class ImageFileError(Exception):
    """An image file that cannot be opened, decoded or written."""


@dataclass(frozen=True)
class PngHeader:
    width: int
    height: int
    color_type: int


def _chunks(data: bytes, name: str) -> Iterator[tuple[bytes, bytes]]:
    """(type, payload) of each chunk after the signature, CRC checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ImageFileError(f"PNG '{name}': truncated chunk header at byte {pos}")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ImageFileError(f"PNG '{name}': chunk {ctype!r} runs past the end of the file")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise ImageFileError(f"PNG '{name}': CRC mismatch in chunk {ctype!r}")
        yield ctype, payload
        pos = end + 4


def read_header(data: bytes, name: str = "<bytes>") -> PngHeader:
    """Parse and validate the signature and IHDR (``data`` may hold just
    the first HEADER_BYTES of the file).  Raises ImageFileError for a PNG
    this decoder does not read, naming its type."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ImageFileError(f"'{name}' is not a PNG file")
    ctype, ihdr = next(_chunks(data[:HEADER_BYTES], name), (b"", b""))
    if ctype != b"IHDR" or len(ihdr) != 13:
        raise ImageFileError(f"PNG '{name}': the first chunk is not a 13-byte IHDR")
    width, height, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB", ihdr)
    if width == 0 or height == 0:
        raise ImageFileError(f"PNG '{name}': empty image {width}x{height}")
    if color not in CHANNELS:
        raise ImageFileError(f"PNG '{name}': invalid colour type {color}")
    if comp != 0 or filt != 0:
        raise ImageFileError(f"PNG '{name}': unknown compression or filter method")
    kind = f"{depth}-bit {COLOR_NAMES[color]} (colour type {color})"
    if depth != 8:
        raise ImageFileError(
            f"PNG '{name}' is {kind}: the port's PNG decoder reads 8-bit images only")
    if interlace != 0:
        raise ImageFileError(
            f"PNG '{name}' is Adam7-interlaced {kind}: the port's PNG decoder reads "
            f"non-interlaced images only")
    return PngHeader(width, height, color)


def _unfilter_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = build_library(UNFILTER_SOURCE, UNFILTER_LIB)
                lib = ctypes.CDLL(str(path))
            except (NativeBuildError, OSError) as e:
                raise ImageFileError(f"PNG decoder: the C unfilter is unavailable: {e}") from e
            lib.rf_png_unfilter.restype = ctypes.c_int64
            lib.rf_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64]
            _lib = lib
        return _lib


def _filtered_rows(raw: bytes, height: int, row_bytes: int) -> np.ndarray:
    need = height * (row_bytes + 1)
    if len(raw) < need:
        raise ImageFileError(f"PNG image data is truncated: {len(raw)} of {need} bytes")
    return np.frombuffer(raw, np.uint8, count=need).reshape(height, row_bytes + 1)


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reconstruct (height, row_bytes) uint8 from the decompressed stream
    (a filter-type byte before each row), in C."""
    src = np.ascontiguousarray(_filtered_rows(raw, height, row_bytes))
    out = np.empty((height, row_bytes), np.uint8)
    bad = _unfilter_lib().rf_png_unfilter(src.ctypes.data, out.ctypes.data, height, row_bytes, bpp)
    if bad:
        raise ImageFileError(f"PNG row {bad - 1} has invalid filter type {src[bad - 1, 0]}")
    return out


def unfilter_plain(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """``unfilter`` in numpy and Python loops: the plain version the C
    unfilter is tested against."""
    src = _filtered_rows(raw, height, row_bytes).astype(np.int64)
    out = np.zeros((height, row_bytes), np.int64)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        ftype, line = int(src[y, 0]), src[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = line.reshape(-1, bpp).cumsum(axis=0).reshape(-1) % 256
        elif ftype == 2:
            cur = (line + prev) % 256
        elif ftype in (3, 4):
            cur = np.zeros(row_bytes, np.int64)
            for x in range(0, row_bytes, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int64)
                b = prev[x:x + bpp]
                c = prev[x - bpp:x] if x else np.zeros(bpp, np.int64)
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, c)
                cur[x:x + bpp] = (line[x:x + bpp] + pred) % 256
        else:
            raise ImageFileError(f"PNG row {y} has invalid filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A whole PNG file's bytes -> (H, W, 4) uint8 RGBA."""
    head = read_header(data, name)
    palette = trns = None
    idat = []
    for ctype, payload in _chunks(data, name):
        if ctype == b"PLTE":
            palette = payload
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
    if not idat:
        raise ImageFileError(f"PNG '{name}' has no image data")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ImageFileError(f"PNG '{name}': corrupt image data: {e}") from e
    ch = CHANNELS[head.color_type]
    w, h = head.width, head.height
    pix = unfilter(raw, h, w * ch, ch).reshape(h, w, ch)
    return _to_rgba(pix, head.color_type, palette, trns, name)


def _to_rgba(pix: np.ndarray, color: int, palette: Optional[bytes], trns: Optional[bytes],
             name: str) -> np.ndarray:
    h, w = pix.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if color == 3:
        if palette is None or len(palette) % 3 or not 0 < len(palette) <= 768:
            raise ImageFileError(f"PNG '{name}': palette image without a valid PLTE chunk")
        # Entries past the palette read as opaque black, as Pillow's do.
        table = np.zeros((256, 4), np.uint8)
        table[:, 3] = 255
        table[:len(palette) // 3, :3] = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        if trns is not None:
            alphas = np.frombuffer(trns, np.uint8)[:256]
            table[:len(alphas), 3] = alphas
        return table[pix[..., 0]]
    if color in (0, 4):
        out[..., :3] = pix[..., :1]
    else:
        out[..., :3] = pix[..., :3]
    if color in (4, 6):
        out[..., 3] = pix[..., -1]
        return out
    out[..., 3] = 255
    if trns is not None:
        # A colour key: the pixels equal to it become transparent.
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns[:len(trns) // 2 * 2]))
        if len(key) == pix.shape[-1]:
            out[..., 3][np.all(pix == key, axis=-1)] = 0
    return out


def filter_rows(rows: np.ndarray, bpp: int, filter_type: Optional[int] = None) -> np.ndarray:
    """(H, row_bytes) uint8 -> (H, 1 + row_bytes): each row behind its
    filter-type byte.  ``filter_type`` None picks, per row, the filter of
    least sum of |byte as int8|; 0-4 forces one."""
    x = rows.astype(np.int16)
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = (None, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    if filter_type is not None and filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not 0-4")
    kinds = range(5) if filter_type is None else (filter_type,)
    variants = [rows if k == 0 else (x - preds[k]).astype(np.uint8) for k in kinds]
    if filter_type is None:
        # |byte as int8| is min(v, 256 - v); uint8 negation wraps to 256 - v.
        scores = np.stack([np.minimum(v, np.negative(v)).sum(axis=1, dtype=np.int64)
                           for v in variants])
        choice = scores.argmin(axis=0)  # ties: the lower type
        data = np.empty_like(rows)
        for k, v in enumerate(variants):
            data[choice == k] = v[choice == k]
    else:
        choice = np.full(len(rows), filter_type)
        data = variants[0]
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = choice
    out[:, 1:] = data
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(rgba: np.ndarray, filter_type: Optional[int] = None, level: int = 9) -> bytes:
    """(H, W, 4) uint8 RGBA -> the bytes of an 8-bit RGBA PNG."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    if rgba.ndim != 3 or rgba.shape[2] != 4 or 0 in rgba.shape:
        raise ImageFileError(f"PNG encoder expects (H, W, 4) RGBA, got {rgba.shape}")
    h, w = rgba.shape[:2]
    stream = filter_rows(rgba.reshape(h, w * 4), 4, filter_type)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(stream.tobytes(), level)) + _chunk(b"IEND", b""))
