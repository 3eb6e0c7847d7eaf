"""The 1-D conv kernels' plain version (``conv1d_h``/``conv1d_w``) and the
large-radius route of ``ops.sep_conv`` through the PyTorch port against the
JAX package, on the CPU.

The JAX side runs as its own tests run it: ``pallas_ops.conv1d_h`` and
``conv1d_w`` in interpret mode (tests/test_pallas_ops.py), and its jnp
path (``ops.conv1d``, ``ops.sep_conv``) where ``pallas_available()`` is
false.  Configs resolve no shader path (shaders/kuwahara.comp would
replace the builtin).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.config import parse as jparse
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph.program import GraphProgram as JProgram
from reforge_tpu.kernels import ops as jops
from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.graph import graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels import ops as tops

FORMATS = ("rgba32f", "rgba16f", "rgba8")
T = 0.25
CONV_TOL = 32 * float(np.finfo(np.float32).eps)  # 32 ulp of 1.0


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _image(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _half_window(r):
    """kuwahara's lead quadrant vector: zero taps, then 1/(r+1)."""
    w = np.zeros(2 * r + 1, np.float32)
    w[r:] = 1.0 / (r + 1)
    return w


TAP_VECTORS = {
    "gauss3": jops.gaussian_weights(3.0),  # radius 9
    "box40": jops.box_weights(40),
    "half12": _half_window(12),
}


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("taps", sorted(TAP_VECTORS))
@pytest.mark.parametrize("axis", ["h", "w"])
def test_conv1d_matches_jax_conv1d_kernel(axis, taps, mode):
    """Against pallas_ops.conv1d_h / conv1d_w in interpret mode, on an odd
    6-channel frame: the same shifted products added in the same order
    (the kernel starts from tap 0 even where it is zero, which adds an
    exact zero), but XLA contracts each multiply-add into an FMA (up to
    9e-7 apart at 81 taps): PARITY.md's conv bound, 32 ulp of 1.0."""
    w = TAP_VECTORS[taps]
    x = _image((6, 21, 37), len(w))
    if axis == "h":
        want = pallas_ops.conv1d_h(jnp.asarray(x), w, mode=mode, tile_w=64, interpret=True)
        got = cuda_ops.conv1d_h(torch.from_numpy(x), w, mode)
    else:
        want = pallas_ops.conv1d_w(jnp.asarray(x), w, mode=mode, tile_h=32, interpret=True)
        got = cuda_ops.conv1d_w(torch.from_numpy(x), w, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CONV_TOL, rtol=0)


@pytest.mark.parametrize("taps", sorted(TAP_VECTORS))
@pytest.mark.parametrize("axis", ["h", "w"])
def test_ops_conv1d_matches_jax_jnp(axis, taps):
    """The port's ops.conv1d (edge borders) against the reference's jnp
    ops.conv1d: bit-equal."""
    w = TAP_VECTORS[taps]
    x = _image((4, 30, 50), 7)
    jaxis, taxis = (jops.AXIS_H, tops.AXIS_H) if axis == "h" else (jops.AXIS_W, tops.AXIS_W)
    want = np.asarray(jops.conv1d(jnp.asarray(x), w, jaxis))
    got = tops.conv1d(torch.from_numpy(x), w, taxis)
    np.testing.assert_array_equal(got.numpy(), want)


def test_conv1d_checks_and_counts_nothing_on_the_cpu():
    cuda_ops.reset_launches()
    x = torch.from_numpy(_image((4, 9, 11)))
    w = jops.box_weights(2)
    cuda_ops.conv1d_h(x, w)
    cuda_ops.conv1d_w(x, w, "zero")
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    # radius 0 multiplies by the one tap
    assert torch.equal(cuda_ops.conv1d_h(x, np.array([0.5], np.float32)), x * 0.5)
    with pytest.raises(ValueError):
        cuda_ops.conv1d_h(x, np.ones(4, np.float32))  # even tap count
    with pytest.raises(ValueError):
        cuda_ops.conv1d_w(x, w, "wrap")
    with pytest.raises(TypeError):
        cuda_ops.conv1d_w(x.to(torch.bfloat16), w)
    with pytest.raises(ValueError):
        cuda_ops.conv1d_h(x[0], w)
    with pytest.raises(ValueError):
        tops.conv1d(x, w, 0)


def test_conv1d_tiles():
    """Frost's radius 160 fits the preferred budget on both axes; radius 400
    fits both passes only under the 227 KB limit; radius 3000 fits no
    window (the global-memory path)."""
    for along_h in (True, False):
        th, tw, smem = cuda_ops.choose_conv1d_tile(along_h, 160, 321)
        assert smem <= cuda_ops.SMEM_SOFT and (th, tw) == ((128, 32) if along_h else (16, 256))
        th, tw, smem = cuda_ops.choose_conv1d_tile(along_h, 400, 801)
        assert cuda_ops.SMEM_SOFT < smem <= cuda_ops.SMEM_LIMIT
        assert smem == cuda_ops.conv1d_footprint(along_h, th, tw, 400, 801)
        assert cuda_ops.choose_conv1d_tile(along_h, 3000, 6001) is None
    # the tile shapes the kernel takes (csrc/conv1d.cu rf_conv1d): H runs of
    # CONV1D_RUN rows down 32 columns, W eight warps of 16 rows and two runs
    run = cuda_ops.CONV1D_RUN
    assert all(tw == 32 and th in (16, 32, 64, 128) for th, tw in cuda_ops.CONV1D_TILES[True])
    assert all(th % 16 == 0 and tw % (2 * run) == 0 and (th // 16) * (tw // 32) == 8
               for th, tw in cuda_ops.CONV1D_TILES[False])
    # the W window starts on a multiple of 4 columns and has an odd pitch
    assert cuda_ops.conv1d_footprint(False, 16, 256, 1, 3) == 4 * (16 * (264 | 1) + 6)
    assert cuda_ops.conv1d_footprint(True, 128, 32, 1, 3) == 4 * (130 * 32 + 6)


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeLibrary:
    def __init__(self, rc):
        self.rc = rc
        self.calls = []

    def rf_conv1d(self, *args):
        self.calls.append(args)
        return self.rc

    def rf_error_string(self, rc):
        return b"refused"


@pytest.mark.parametrize("rc", [0, 1])
@pytest.mark.parametrize("axis", ["h", "w"])
def test_conv1d_never_takes_the_plain_version_on_a_gpu(axis, rc, monkeypatch):
    """For a tensor on a GPU the wrapper launches the kernel (counted) with
    the nonzero taps and their positions, or raises; it never runs its
    plain version, at any radius."""

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a GPU tensor")

    lib = _FakeLibrary(rc)
    monkeypatch.setattr(cuda_ops, "correlate1d", no_plain)
    monkeypatch.setattr(cuda_ops, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_ops, "_stream", lambda x: 0)
    entry = cuda_ops.conv1d_h if axis == "h" else cuda_ops.conv1d_w
    x = torch.from_numpy(_image((6, 8, 16))).as_subclass(_ReportsCuda)
    cuda_ops.reset_launches()
    for w in (_half_window(3), jops.box_weights(3000)):
        if rc:
            with pytest.raises(RuntimeError, match=f"conv1d_{axis} launch failed"):
                entry(x, w)
        else:
            out = entry(x, w)
            assert tuple(out.shape) == (6, 8, 16)
    assert cuda_ops.LAUNCHES[f"conv1d_{axis}"] == (0 if rc else 2)
    (first, second) = lib.calls
    assert first[0] == int(axis == "h") and first[3:7] == (6, 8, 16, 3)
    assert first[12] == 4 and first[13] > 0  # the four nonzero taps, in shared memory
    assert second[12] == 6001 and second[13] == 0  # the global-memory path
    # equal taps: the shared form premultiplies, the global form does not
    assert first[15] == 1 and second[15] == 0


@pytest.mark.parametrize("name,box", [("gauss3", False), ("half_window", True),
                                      ("box", True), ("zeros", False), ("sparse", False)])
def test_conv1d_box_taps(name, box):
    """The wrapper's premultiply flag: the nonzero taps exist and are all
    equal (a box, kuwahara's quadrant vector), not for a gaussian, a
    vector of zeros or unequal taps with gaps."""
    w = {"gauss3": jops.gaussian_weights(3.0), "half_window": _half_window(5),
         "box": jops.box_weights(40), "zeros": np.zeros(9, np.float32),
         "sparse": np.array([0.1, 0, 0.2, 0, 0.1], np.float32)}[name]
    taps, pos, got = cuda_ops._device_conv1d_taps(w.tobytes(), torch.device("cpu"))
    assert got is box
    assert taps.numel() == np.count_nonzero(w) and pos.tolist() == np.flatnonzero(w).tolist()


# ---- the route of ops.sep_conv -------------------------------------------------------


def _record(monkeypatch):
    calls = []
    for entry in ("sep_conv_fused", "sep_conv_fused_mxu", "sep_conv_fused_mxu_x3", "conv1d_h",
                  "conv1d_w"):
        real = getattr(cuda_ops, entry)
        monkeypatch.setattr(cuda_ops, entry, functools.partial(
            lambda f, n, *a, **k: calls.append(n) or f(*a, **k), real, entry))
    return calls


ROUTES = {
    # (rh, rw, prefer_mxu): the entries the conv takes
    (4, 4, False): ["sep_conv_fused"],
    (4, 4, True): ["sep_conv_fused_mxu"],
    (24, 24, False): ["sep_conv_fused_mxu_x3"],
    (1, 200, False): ["sep_conv_fused"],  # fits a tile; W radius past the x3 gate
    (1, 200, True): ["sep_conv_fused"],  # and past the bf16 entry's
    (108, 108, False): ["sep_conv_fused_mxu_x3"],
    (109, 109, False): ["conv1d_h", "conv1d_w"],  # the first radius no tile holds
    (120, 120, True): ["conv1d_h", "conv1d_w"],
    (130, 130, False): ["conv1d_h", "conv1d_w"],
    (0, 5, False): ["conv1d_h", "conv1d_w"],  # a radius-0 axis
}


@pytest.mark.parametrize("rh,rw,mxu", sorted(ROUTES))
def test_sep_conv_routes_by_shape(rh, rw, mxu, monkeypatch):
    """ops.sep_conv picks its entry from the radii before any launch: the
    fused entries while a shared-memory tile holds the window (bf16 and x3
    up to W radius 128, as the reference), else the two 1-D kernels."""
    fits = rh > 0 and rw > 0 and cuda_ops.plans_fit([(jops.box_weights(rh),
                                                      jops.box_weights(rw))])
    assert fits == (ROUTES[(rh, rw, mxu)][0] != "conv1d_h")
    calls = _record(monkeypatch)
    x = torch.from_numpy(_image((4, 12, 20)))
    out = tops.sep_conv(x, jops.box_weights(rh), jops.box_weights(rw), prefer_mxu=mxu)
    assert calls == ROUTES[(rh, rw, mxu)] and out.dtype == torch.float32


def test_sep_conv_w_radius_130_matches_jax(monkeypatch):
    """The repaired route: an f32 conv of W radius 130 (266 taps in all; it
    raised in the x3 entry before) takes sep_conv_fused, as in the
    reference, and matches the reference's jnp sep_conv.  Both sum the H
    pass then the W pass tap by tap in ascending order: bit-equal."""
    x = _image((6, 40, 300), 1)
    wh, ww = jops.gaussian_weights(0.7), jops.box_weights(130)
    want = np.asarray(jops.sep_conv(jnp.asarray(x), wh, ww))
    calls = _record(monkeypatch)
    got = tops.sep_conv(torch.from_numpy(x), wh, ww)
    assert calls == ["sep_conv_fused"]
    np.testing.assert_array_equal(got.numpy(), want)


LARGE = {
    "box_blur_150": "input -> n -> output\nn: box_blur { radius: 150 }",
    "kuwahara_130": "input -> n -> output\nn: kuwahara { radius: 130 }",
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(LARGE))
def test_large_radius_builtins_match_jax(name, fmt, monkeypatch):
    """box_blur radius 150 and kuwahara radius 130 render in every format
    (kuwahara raised ValueError here before) through the 1-D kernels' plain
    version, against the JAX package per node: the same sums in the same
    order, so equal but for the ulp where XLA and PyTorch round a product
    of kuwahara's quadrant statistics apart (1e-6 in f32); a bf16 or
    1/255 step where that ulp flips a rounding before the store."""
    h, w = 40, 300
    jprog = JProgram(jbuild(jparse(LARGE[name], expects_input=True)), w, h, fmt)
    x = _image((4, h, w), 2)
    if fmt == "rgba16f":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    calls = _record(monkeypatch)
    prog = make_program(graph_from_reference(jprog.graph), w, h, fmt, device="cpu")
    calls.clear()  # make_program's shape check on meta tensors
    got = prog._forward(torch.from_numpy(x), T).float().numpy()
    n_convs = 4 if name.startswith("kuwahara") else 1
    assert calls == ["conv1d_h", "conv1d_w"] * n_convs
    d = np.abs(got - want)
    if fmt == "rgba32f":
        assert d.max() <= 1e-6, d.max()
    else:
        step = 2e-2 if fmt == "rgba16f" else 1.0 / 255.0 + 1e-6
        assert d.max() <= step and (d > 1e-6).mean() < 1e-3, (d.max(), (d > 1e-6).mean())
