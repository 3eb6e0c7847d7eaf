"""The port's stencil kernel (``stencil_apply``), the stencil builtins per
node and the x3 conv entry, held against the JAX package on the CPU.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
are held against those plain versions on the card (tests/test_torch_cuda.py
and ``chip_smoke.py``).  The JAX side runs as its own tests run it: the jnp
path, and each Pallas kernel in interpret mode.
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
from reforge_tpu.kernels import library as jlibrary
from reforge_tpu.kernels import ops as jops
from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.graph import graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops, library
from reforge_tpu_torch.kernels import ops as tops

H, W = 48, 72
T = 0.3
# A 5x5 table with 24 nonzero taps: above 16 terms conv2d sums in eight
# stripes merged pairwise.
TAPS_5X5 = (np.arange(25, dtype=np.float32).reshape(5, 5) - 7.0) / 16.0
TABLES = {"sharpen": library.SHARPEN_TAPS, "emboss": library.EMBOSS_TAPS, "5x5": TAPS_5X5}


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _image(seed=0, shape=(4, H, W)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _pallas_stencil_closure(monkeypatch, run):
    """Run ``run()`` (a JAX call that reaches pallas_ops.stencil_apply) with
    the Pallas kernel in interpret mode; returns (result, the traced
    neighbourhood function the kernel was given)."""
    seen = []
    real = pallas_ops.stencil_apply

    def recording(x, rh, rw, fn, mode="edge", **kw):
        seen.append(fn)
        return real(x, rh, rw, fn, mode=mode, interpret=True, **kw)

    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(pallas_ops, "stencil_apply", recording)
    out = run()
    monkeypatch.undo()
    assert seen, "the JAX call did not reach stencil_apply"
    return np.asarray(out), seen[0]


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_wsum_matches_jax_stencil_kernel(table, mode, monkeypatch):
    """stencil_apply_plain with a wsum op against ops.conv2d (jnp) and
    against pallas_ops.stencil_apply (interpret) given conv2d's own
    weighted sum.  atol 1e-5: the JAX package's bound for its stencil
    kernel against jnp (XLA may contract a multiply-add into an FMA)."""
    taps = TABLES[table]
    rh, rw = taps.shape[0] // 2, taps.shape[1] // 2
    x = _image(3)
    edge, fn = _pallas_stencil_closure(monkeypatch, lambda: jops.conv2d(jnp.asarray(x), taps))
    want = edge if mode == "edge" else np.asarray(
        pallas_ops.stencil_apply(jnp.asarray(x), rh, rw, fn, mode="zero", interpret=True))
    got = cuda_ops.stencil_apply_plain(torch.from_numpy(x), rh, rw, cuda_ops.wsum(taps), mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if mode == "edge":
        np.testing.assert_allclose(tops.conv2d(torch.from_numpy(x), taps).numpy(),
                                   np.asarray(jops.conv2d(jnp.asarray(x), taps)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_median9_bit_equal_to_jax_stencil_kernel(mode, monkeypatch):
    """The selection network picks one input value per pixel: bit-equal
    (PARITY.md's bound for selection networks is 0)."""
    x = _image(4)
    spec = jlibrary.median3
    _edge, fn = _pallas_stencil_closure(
        monkeypatch, lambda: spec.fn(None, jnp.asarray(x)))
    want = np.asarray(pallas_ops.stencil_apply(jnp.asarray(x), 1, 1, fn, mode=mode, interpret=True))
    got = cuda_ops.stencil_apply_plain(torch.from_numpy(x), 1, 1, cuda_ops.MEDIAN9, mode)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_stencil_tap_tables_bit_equal_to_jax(monkeypatch):
    """The tables the JAX builtins hand to ops.conv2d equal the port's."""
    seen = []
    monkeypatch.setattr(jlibrary, "conv2d", lambda x, taps: seen.append(np.asarray(taps)) or x)
    x = jnp.asarray(_image(5, (4, 8, 8)))
    jlibrary.sharpen.fn(None, x, amount=1.0)
    jlibrary.sobel.fn(None, x, amount=1.0)
    jlibrary.emboss.fn(None, x, amount=0.9)
    want = [library.SHARPEN_TAPS, library.SOBEL_X_TAPS, library.SOBEL_Y_TAPS,
            library.EMBOSS_TAPS * 0.9]
    assert len(seen) == len(want)
    for got, ref in zip(want, seen):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


STENCIL_GRAPHS = {
    "sharpen": "input -> n -> output\nn: sharpen { amount: 0.7 }",
    "sobel": "input -> n -> output\nn: sobel { amount: 1.5 }",
    "emboss": "input -> n -> output\nn: emboss { amount: 0.9 }",
    "median3": "input -> n -> output\nn: median3 {}",
}


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("name", sorted(STENCIL_GRAPHS))
def test_stencil_builtins_per_node_match_jax(name, fmt):
    jprog = JProgram(jbuild(jparse(STENCIL_GRAPHS[name], expects_input=True)), W, H, fmt)
    x = _image(6)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    prog = make_program(graph_from_reference(jprog.graph), W, H, fmt, plan_strips=False,
                        device="cpu")
    got = prog._forward(torch.from_numpy(x), T).float().numpy()
    d = np.abs(got - want)
    if fmt == "rgba32f":
        assert d.max() <= 1e-5, d.max()
    elif fmt == "rgba16f":
        assert d.max() <= 2e-2, d.max()
    else:
        # one rounding apart flips a 1/255 bucket where a value sits on its edge
        assert d.max() <= 1.0 / 255.0 + 1e-6 and (d > 1.0 / 512.0).mean() < 1e-3


@pytest.mark.parametrize("r,mode", [(24, "edge"), (66, "zero"), (66, "edge")])
def test_x3_entry_matches_jax_x3_kernel(r, mode):
    """The x3 entry's plain route against sep_conv_fused_mxu_x3 in
    interpret mode, whose bf16x3 splits are f32-exact to about one ulp.
    r = 66 is a W band of three 128-lane tiles in the TPU kernel and takes
    the port's largest conv tile."""
    x = _image(7 + r)
    w = jops.gaussian_weights(r / 3.0)
    assert len(w) == 2 * r + 1
    want = np.asarray(pallas_ops.sep_conv_fused_mxu_x3(jnp.asarray(x), w, w, mode=mode,
                                                       interpret=True))
    got = cuda_ops.sep_conv_fused_mxu_x3(torch.from_numpy(x), w, w, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert cuda_ops.choose_tile(r, r, 2 * len(w)) is not None


def test_sep_conv_routes_heavy_f32_convs_to_x3(monkeypatch):
    calls = []
    for name in ("sep_conv_fused", "sep_conv_fused_mxu", "sep_conv_fused_mxu_x3"):
        real = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name,
                            functools.partial(lambda f, n, *a, **k: calls.append(n) or f(*a, **k),
                                              real, name))
    x = torch.from_numpy(_image(8))
    for sigma, prefer_mxu in ((8.0, False), (4.0, False), (8.0, True)):
        w = tops.gaussian_weights(sigma)
        tops.sep_conv(x, w, w, prefer_mxu=prefer_mxu)
    # sigma 8: 49 + 49 taps >= X3_MIN_TAPS; sigma 4: 25 + 25 below it
    assert calls == ["sep_conv_fused_mxu_x3", "sep_conv_fused", "sep_conv_fused_mxu"]


def test_stencil_wrappers_check_and_count_nothing():
    cuda_ops.reset_launches()
    x = torch.from_numpy(_image(9))
    cuda_ops.stencil_apply(x, 1, 1, cuda_ops.MEDIAN9)
    cuda_ops.stencil_apply(x, 2, 2, cuda_ops.wsum(TAPS_5X5), "zero")
    cuda_ops.sep_conv_fused_mxu_x3(x, tops.gaussian_weights(8.0), tops.gaussian_weights(8.0))
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply(x, 2, 2, cuda_ops.MEDIAN9)
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply(x, 1, 1, cuda_ops.wsum(TAPS_5X5))
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply(x, 17, 17, cuda_ops.wsum(np.ones((35, 35), np.float32)))
    with pytest.raises(TypeError):
        cuda_ops.stencil_apply(x.to(torch.bfloat16), 1, 1, cuda_ops.MEDIAN9)
    with pytest.raises(ValueError):
        cuda_ops.stencil_apply(x, 1, 1, cuda_ops.MEDIAN9, mode="wrap")
    # a table with no nonzero tap sums to zero, as conv2d's does
    empty = cuda_ops.stencil_apply(x, 1, 1, cuda_ops.wsum(np.zeros((3, 3), np.float32)))
    assert torch.equal(empty, x * 0.0)
    for r in (1, 16):
        th, tw, nbytes = cuda_ops.choose_stencil_tile(r, r, (2 * r + 1) ** 2)
        assert nbytes <= cuda_ops.SMEM_SOFT
