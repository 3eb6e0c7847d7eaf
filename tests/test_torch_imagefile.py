"""The PyTorch port's image files on the CPU: its PNG codec (zlib and
numpy, the unfilter in C) against Pillow, its Lanczos resize against
Pillow's ``Image.LANCZOS``, the routes of ``io/imagefile.py``, and video
through the libav extension (the cases of ``tests/test_io.py:106-200``,
skipped where the extension is not built, as there)."""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from reforge_tpu_torch import utils
from reforge_tpu_torch.io import imagefile, png
from reforge_tpu_torch.io import (
    ImageFileDecoder, ImageFileError, encode, is_video_path, native_backend_available,
)
from reforge_tpu_torch.io.resize import resize_lanczos

SIZES = [(1, 1), (7, 13), (64, 64)]
MODES = ["L", "LA", "RGB", "RGBA", "P"]


@pytest.fixture(autouse=True)
def _quiet():
    utils.print_warnings = False
    yield


def _pillow_png(arr, mode, **save):
    buf = io.BytesIO()
    (Image.fromarray(arr) if mode is None else Image.fromarray(arr, mode)).save(buf, "PNG", **save)
    return buf.getvalue()


def _random_png(mode, h, w, seed):
    """A PNG Pillow writes in ``mode``; P has a 40-entry palette and a
    tRNS of alphas for its first 30 entries."""
    rng = np.random.default_rng(seed)
    if mode == "P":
        im = Image.fromarray(rng.integers(0, 40, (h, w), dtype=np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 40 * 3).tolist())
        buf = io.BytesIO()
        im.save(buf, "PNG", transparency=bytes(rng.integers(0, 256, 30).astype(np.uint8)))
        return buf.getvalue()
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return _pillow_png(arr[..., 0] if channels == 1 else arr, mode)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_decode_equals_pillow(mode, h, w):
    """Every colour type Pillow writes, decoded like Pillow's
    ``convert("RGBA")``."""
    data = _random_png(mode, h, w, seed=h * 100 + w)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,key", [("L", 77), ("RGB", (10, 20, 30))])
def test_colour_key_transparency_equals_pillow(mode, key):
    """A gray or RGB tRNS colour key becomes alpha 0, as Pillow converts."""
    rng = np.random.default_rng(5)
    shape = (9, 11) if mode == "L" else (9, 11, 3)
    arr = rng.integers(0, 3, shape, dtype=np.uint8) * 10
    arr[0, 0] = key
    data = _pillow_png(arr, mode, transparency=key)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(png.decode_png(data), want)
    assert (want[..., 3] == 0).any()


def test_indices_past_a_short_palette_equal_pillow():
    """Indices past PLTE read as opaque black, and a tRNS shorter than the
    palette leaves the rest opaque, as Pillow converts."""
    ihdr = struct.pack(">IIBBBBB", 4, 1, 8, 3, 0, 0, 0)
    data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"PLTE", bytes([10, 20, 30, 40, 50, 60]))
            + png._chunk(b"tRNS", bytes([7]))
            + png._chunk(b"IDAT", zlib.compress(bytes([0, 0, 1, 5, 200])))
            + png._chunk(b"IEND", b""))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    np.testing.assert_array_equal(png.decode_png(data), want)


@pytest.mark.parametrize("filter_type", range(5))
def test_forced_filter_rows_decode_in_pillow(filter_type):
    """Rows written with each filter type: Pillow and the port decode them
    to the input."""
    rgba = np.random.default_rng(filter_type).integers(0, 256, (17, 23, 4), dtype=np.uint8)
    data = png.encode_png(rgba, filter_type=filter_type)
    stream = zlib.decompress(_idat(data))
    assert {stream[y * (1 + 23 * 4)] for y in range(17)} == {filter_type}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), rgba)
    np.testing.assert_array_equal(png.decode_png(data), rgba)


def _idat(data):
    return b"".join(payload for ctype, payload in png._chunks(data, "test") if ctype == b"IDAT")


def _smooth(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3, yy * 5, xx + yy, np.full_like(xx, 200)], -1)
    return (base + rng.integers(0, 4, (h, w, 4))).astype(np.uint8)


@pytest.mark.parametrize("h,w", SIZES + [(31, 200)])
def test_encoder_output_decodes_in_pillow(h, w):
    """The port's encoder (filters chosen per row): Pillow reads back the
    input, a noise image and a smooth one; the smooth one uses more than
    one filter type."""
    for rgba in (np.random.default_rng(h).integers(0, 256, (h, w, 4), dtype=np.uint8),
                 _smooth(h, w, seed=w)):
        data = png.encode_png(rgba)
        im = Image.open(io.BytesIO(data))
        assert im.mode == "RGBA" and im.size == (w, h)
        np.testing.assert_array_equal(np.asarray(im), rgba)
    if h > 1:
        stream = zlib.decompress(_idat(data))
        assert len({stream[y * (1 + w * 4)] for y in range(h)}) > 1


@settings(max_examples=30, deadline=None)
@given(h=st.integers(1, 12), w=st.integers(1, 12), seed=st.integers(0, 2**32 - 1),
       filter_type=st.sampled_from([None, 0, 1, 2, 3, 4]))
def test_round_trip(h, w, seed, filter_type):
    rgba = np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)
    data = png.encode_png(rgba, filter_type=filter_type)
    np.testing.assert_array_equal(png.decode_png(data), rgba)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), rgba)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, "mixed"])
def test_c_unfilter_equals_plain(filter_type, bpp):
    """The C unfilter against the numpy version on random filtered rows."""
    rng = np.random.default_rng(bpp * 10 + (5 if filter_type == "mixed" else filter_type))
    h, row_bytes = 9, 13 * bpp
    rows = rng.integers(0, 256, (h, 1 + row_bytes), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h) if filter_type == "mixed" else filter_type
    raw = rows.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, h, row_bytes, bpp),
                                  png.unfilter_plain(raw, h, row_bytes, bpp))


def test_bad_filter_type_raises():
    raw = bytes([0, 1, 2, 7, 1, 2])
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ImageFileError, match="row 1 has invalid filter type 7"):
            fn(raw, 2, 2, 1)


def _png_with_header(width, height, depth, color, interlace, body=b"\x00" * 8):
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr) + png._chunk(b"IDAT", zlib.compress(body))
            + png._chunk(b"IEND", b""))


UNSUPPORTED = {
    "16-bit gray": lambda: _pillow_png(np.arange(12, dtype=np.uint16).reshape(3, 4) * 999, None),
    "16-bit RGBA": lambda: _png_with_header(2, 2, 16, 6, 0),
    "1-bit gray": lambda: _pillow_png(np.eye(8, dtype=bool), "1"),
    "4-bit palette": lambda: _png_with_header(4, 4, 4, 3, 0),
    "Adam7-interlaced 8-bit RGBA": lambda: _png_with_header(4, 4, 8, 6, 1),
}


@pytest.mark.parametrize("case", UNSUPPORTED)
def test_unsupported_png_raises_and_names_the_type(case):
    """16-bit, 1/2/4-bit and interlaced PNGs raise, naming their type."""
    with pytest.raises(ImageFileError, match=case):
        png.decode_png(UNSUPPORTED[case](), "test.png")


def test_crc_is_checked():
    data = bytearray(png.encode_png(np.zeros((2, 2, 4), np.uint8)))
    data[-20] ^= 1  # inside the IDAT chunk
    with pytest.raises(ImageFileError, match="CRC mismatch"):
        png.decode_png(bytes(data))


def test_unfilter_build_failure_raises(monkeypatch, tmp_path):
    """A checkout that cannot build the C unfilter raises; the codec never
    switches to the plain version."""
    monkeypatch.setattr(png, "_lib", None)
    monkeypatch.setattr(png, "UNFILTER_LIB", tmp_path / "none.so")
    monkeypatch.setattr("shutil.which", lambda _name: None)
    data = png.encode_png(np.zeros((3, 3, 4), np.uint8))
    with pytest.raises(ImageFileError, match="C unfilter is unavailable.*no g\\+\\+"):
        png.decode_png(data)


LANCZOS_CASES = [((48, 64), (11, 17)), ((11, 17), (48, 64)), ((48, 64), (48, 17)),
                 ((48, 64), (11, 64)), ((48, 64), (48, 64))]


@pytest.mark.parametrize("alpha", ["opaque", "random"])
@pytest.mark.parametrize("src,dst", LANCZOS_CASES, ids=["down", "up", "w-only", "h-only",
                                                        "identity"])
def test_lanczos_matches_pillow(src, dst, alpha):
    """Within one code of Pillow's LANCZOS of the RGBA image (random alpha
    takes Pillow's premultiplied path)."""
    rgba = np.random.default_rng(sum(src + dst)).integers(0, 256, (*src, 4), dtype=np.uint8)
    if alpha == "opaque":
        rgba[..., 3] = 255
    want = np.asarray(Image.fromarray(rgba, "RGBA").resize(dst[::-1], Image.LANCZOS))
    got = resize_lanczos(rgba, dst[1], dst[0])
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def make_rgba(h=40, w=56, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 4), dtype=np.uint8)


def test_png_file_round_trip_and_resize(tmp_path):
    rgba = make_rgba()
    path = str(tmp_path / "x.png")
    encode(path, rgba)
    dec = ImageFileDecoder(path)
    assert (dec.width, dec.height) == (56, 40)
    np.testing.assert_array_equal(dec.decode(56, 40), rgba)
    want = np.asarray(Image.fromarray(rgba, "RGBA").resize((28, 20), Image.LANCZOS))
    assert np.abs(dec.decode(28, 20).astype(int) - want).max() <= 1


def test_png_needs_neither_pillow_nor_libav(tmp_path, monkeypatch):
    monkeypatch.setattr(imagefile, "_pillow", lambda: None)
    monkeypatch.setattr(imagefile, "_native_lib", lambda: None)
    rgba = make_rgba()
    path = str(tmp_path / "x.png")
    encode(path, rgba)
    np.testing.assert_array_equal(ImageFileDecoder(path).decode(56, 40), rgba)
    with pytest.raises(ImageFileError, match=r"\.jpg files need the libav io extension"):
        encode(str(tmp_path / "x.jpg"), rgba)
    Image.fromarray(rgba, "RGBA").save(str(tmp_path / "y.bmp"))
    with pytest.raises(ImageFileError, match=r"\.bmp files need .* or Pillow"):
        ImageFileDecoder(str(tmp_path / "y.bmp"))


def test_other_stills_through_pillow(tmp_path, monkeypatch):
    """Without the libav extension, other formats go through Pillow."""
    monkeypatch.setattr(imagefile, "_native_lib", lambda: None)
    rgba = make_rgba()
    rgba[..., 3] = 255
    path = str(tmp_path / "x.bmp")
    encode(path, rgba)
    np.testing.assert_array_equal(ImageFileDecoder(path).decode(56, 40), rgba)


def test_jpeg_encode_decode(tmp_path):
    """JPEG through libav where it is built, else Pillow (lossy: smooth
    content within 8 codes on average, as tests/test_io.py holds it)."""
    yy, xx = np.mgrid[0:48, 0:48].astype(np.float32)
    rgba = np.stack([yy * 5, xx * 5, (yy + xx) * 2.5, np.full_like(yy, 255)],
                    axis=-1).clip(0, 255).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    encode(path, rgba)
    out = ImageFileDecoder(path).decode(48, 48)
    assert out.shape == (48, 48, 4)
    assert np.abs(out[..., :3].astype(int) - rgba[..., :3].astype(int)).mean() < 8


def test_missing_file_raises():
    with pytest.raises(ImageFileError):
        ImageFileDecoder("/nonexistent/nope.png")


def test_video_needs_the_native_backend(tmp_path, monkeypatch):
    """Without the libav extension: the reference's "requires the native io
    backend" diagnostic, naming why."""
    monkeypatch.setattr(imagefile, "_native_lib", lambda: None)
    monkeypatch.setattr(imagefile, "_lib_reason", "libav headers not found (x.h)")
    with pytest.raises(ImageFileError, match="requires the native io backend.*headers not found"):
        imagefile.VideoEncoder(str(tmp_path / "v.mp4"), 8, 8)
    path = str(tmp_path / "x.png")
    encode(path, make_rgba())
    with pytest.raises(ImageFileError, match="requires the native io backend"):
        imagefile.VideoFrames(ImageFileDecoder(path), 8, 8)


# ---- video (tests/test_io.py:106-200), where the extension is built ------

def _need_native():
    if not native_backend_available():
        pytest.skip("native backend not built: " + imagefile.native_backend_reason())


def _write_video(path, frames, fps=25):
    with imagefile.VideoEncoder(path, frames[0].shape[1], frames[0].shape[0], fps=fps) as enc:
        for f in frames:
            enc.write(f)


def test_video_round_trip(tmp_path):
    _need_native()
    assert is_video_path("x.mp4") and not is_video_path("x.png")
    path = str(tmp_path / "v.mp4")
    frames = []
    for i in range(10):
        f = np.zeros((48, 64, 4), np.uint8)
        f[:, :, 0] = i * 20
        f[:, :, 3] = 255
        frames.append(f)
    _write_video(path, frames)
    got = list(imagefile.VideoFrames(ImageFileDecoder(path), 64, 48))
    assert len(got) == 10
    reds = [f[:, :, 0].mean() for f in got]  # lossy, but the ramp is monotone
    assert reds[0] < reds[4] < reds[9]


def test_video_cli_end_to_end(tmp_path):
    _need_native()
    from reforge_tpu_torch.cli import main

    inp, outp = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    f = np.full((48, 64, 4), 30, np.uint8)
    f[:, :, 3] = 255
    _write_video(inp, [f] * 8)
    cfg = tmp_path / "g.rf"
    cfg.write_text("input -> invert -> output")
    assert main(["-i", inp, "-o", outp, "--config", str(cfg), "--shader-path", str(tmp_path),
                 "--backend", "cpu"]) == 0
    frames = list(imagefile.VideoFrames(ImageFileDecoder(outp), 64, 48))
    assert len(frames) == 8
    assert frames[0][:, :, 0].mean() > 180  # dark input inverted bright


def test_video_batch_frames_identical(tmp_path):
    """--batch-frames 3 against 1 over 8 frames (a 2-frame tail): the
    same frames."""
    _need_native()
    from reforge_tpu_torch.cli import main

    inp = str(tmp_path / "in.mp4")
    rng = np.random.default_rng(9)
    frames = []
    for _ in range(8):
        f = rng.integers(0, 255, (48, 64, 4), np.uint8)
        f[:, :, 3] = 255
        frames.append(f)
    _write_video(inp, frames)
    cfg = tmp_path / "g.rf"
    cfg.write_text("input -> wave -> output\nwave: wave { amplitude: 3.0 }")
    outs = {}
    for k in (1, 3):
        outs[k] = str(tmp_path / f"k{k}.mp4")
        assert main(["-i", inp, "-o", outs[k], "--config", str(cfg), "--shader-path",
                     str(tmp_path), "--backend", "cpu", "--batch-frames", str(k)]) == 0
    f1 = list(imagefile.VideoFrames(ImageFileDecoder(outs[1]), 64, 48))
    f3 = list(imagefile.VideoFrames(ImageFileDecoder(outs[3]), 64, 48))
    assert len(f1) == len(f3) == 8
    for a, b in zip(f1, f3):
        np.testing.assert_array_equal(a, b)


def test_video_start_duration_trim(tmp_path):
    _need_native()
    inp = str(tmp_path / "in.mp4")
    frames = []
    for i in range(20):
        f = np.zeros((48, 64, 4), np.uint8)
        f[:, : 3 * (i + 1), 0] = 255  # frame index encoded in bar width
        f[:, :, 3] = 255
        frames.append(f)
    _write_video(inp, frames, fps=10)
    got = list(imagefile.VideoFrames(ImageFileDecoder(inp), 64, 48, start=1.0, duration=0.5))
    assert len(got) == 5
    widths = [int((f[:, :, 0].astype(int).mean(axis=0) > 128).sum()) for f in got]
    assert widths == [3 * (i + 1) for i in range(10, 15)], widths


def test_animated_export_frame_count(tmp_path):
    """An image in, a video out: --duration x --fps frames."""
    _need_native()
    from reforge_tpu_torch.cli import main

    inp, outp = str(tmp_path / "in.png"), str(tmp_path / "anim.mp4")
    encode(inp, make_rgba(48, 64))
    cfg = tmp_path / "g.rf"
    cfg.write_text("input -> wave -> output\nwave: wave { amplitude: 3.0 }")
    assert main(["-i", inp, "-o", outp, "--config", str(cfg), "--shader-path", str(tmp_path),
                 "--backend", "cpu", "--duration", "0.5", "--fps", "20"]) == 0
    assert len(list(imagefile.VideoFrames(ImageFileDecoder(outp), 64, 48))) == 10
