"""The stylized graphs (newsprint, watercolor, oil paint) through the
PyTorch port against the JAX package, on the CPU: the bilateral kernel's
plain version (``stencil_reduce_mc``), the five builtins they add
(bilateral, kuwahara, levels, halftone, noise), the samplers, the
counter-based noise and the three graphs per node in three formats.

The JAX side runs as its own tests run it: its builtins and
``_forward_nostrip`` on the jnp path, and ``pallas_ops.stencil_reduce_mc``
in interpret mode.  Every graph here uses the builtins: ``jparse`` and
``tconfig.parse`` resolve no shader path (shaders/kuwahara.comp,
tonemap.comp and vignette.comp would replace the builtins of those names).
"""

import functools
import inspect

import jax
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
from reforge_tpu.kernels.base import KernelContext as JContext
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import STYLIZED_GRAPHS, build_program
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.graph import build_graph, graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops, library, prng
from reforge_tpu_torch.kernels import ops as tops
from reforge_tpu_torch.kernels.base import KernelContext

FORMATS = ("rgba32f", "rgba16f", "rgba8")
H, W = 48, 128
T = 0.2137
# Bilateral's exp differs by an ulp or two between XLA and PyTorch; the
# weighted mean then moves by a few f32 ulps of [0, 1] values (2.4e-7
# measured at radius 4).
BILATERAL_TOL = 1e-6


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _image(h=H, w=W, seed=3):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


def _one_node(kernel_name, params=""):
    return f"input -> n -> output\nn: {kernel_name} {{ {params} }}"


def _jax_reduce_closures(monkeypatch, run):
    """Run ``run()`` (a JAX bilateral) with the Pallas entry recorded and
    refused, so the JAX package takes its jnp path; returns (the jnp
    result, the taps list, tap_fn and final_fn it gave the kernel)."""
    seen = []

    def refusing(x, rh, rw, taps_list, tap_fn, final_fn, **kw):
        seen.append((taps_list, tap_fn, final_fn))
        return None

    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(pallas_ops, "stencil_reduce_mc", refusing)
    out = run()
    monkeypatch.undo()
    assert len(seen) == 1, "the JAX bilateral did not reach stencil_reduce_mc"
    return np.asarray(out), seen[0]


def _jnp_reduce(stacked, r, taps_list, tap_fn, final_fn, mode):
    """The reference's portable loop (library.py:845-859) over an edge- or
    zero-padded stack."""
    h, w = stacked.shape[1:]
    sp = jnp.pad(stacked, ((0, 0), (r, r), (r, r)), mode="edge" if mode == "edge" else "constant")

    def tap(dy, dx):
        return jax.lax.dynamic_slice(sp, (0, dy, dx), (4, h, w))

    center = tap(r, r)
    acc = None
    for dy, dx in taps_list:
        t = tap_fn(tap, center, dy, dx)
        acc = t if acc is None else acc + t
    return np.asarray(final_fn(acc))


def _stack(x):
    return np.array(jnp.concatenate([jnp.asarray(x[:3]), jops.luma(jnp.asarray(x))[None]], 0))


BILATERAL_PARAMS = {1: (2.0, 0.15), 3: (2.5, 0.12), 4: (2.5, 0.12)}


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r", sorted(BILATERAL_PARAMS))
def test_bilateral_reduction_matches_jax_jnp(r, mode, monkeypatch):
    """The port's tap list equals the reference's (order, positions and
    spatial weights), and stencil_reduce_mc's plain version equals the
    reference's jnp loop over the same closures, in both border modes."""
    ss, sr = BILATERAL_PARAMS[r]
    x = _image(40, 72, seed=r)
    edge, (taps_list, tap_fn, final_fn) = _jax_reduce_closures(
        monkeypatch,
        lambda: jlibrary.bilateral.fn(JContext(72, 40), jnp.asarray(x), radius=r,
                                      sigma_space=ss, sigma_range=sr))
    rr, op = library.bilateral_op(r, ss, sr)
    assert rr == r and [(dy, dx) for dy, dx, _ in op.taps] == list(taps_list)
    spatial = inspect.getclosurevars(tap_fn).nonlocals["spatial"]
    assert [ws for _, _, ws in op.taps] == [spatial[tap] for tap in taps_list]
    assert op.inv2sr == inspect.getclosurevars(tap_fn).nonlocals["inv2sr"]
    stacked = _stack(x)
    want = _jnp_reduce(jnp.asarray(stacked), r, taps_list, tap_fn, final_fn, mode)
    if mode == "edge":
        np.testing.assert_array_equal(edge[:3], want)
    got = cuda_ops.stencil_reduce_mc(torch.from_numpy(stacked), r, r, op, mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 40, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=BILATERAL_TOL, rtol=0)
    if mode == "edge":
        port = library.bilateral.fn(None, torch.from_numpy(x), radius=r, sigma_space=ss,
                                    sigma_range=sr)
        np.testing.assert_allclose(port.numpy(), edge, atol=BILATERAL_TOL, rtol=0)
        np.testing.assert_array_equal(port[3].numpy(), x[3])


def test_bilateral_reduction_matches_jax_stencil_reduce_kernel(monkeypatch):
    """Against pallas_ops.stencil_reduce_mc in interpret mode (two calls,
    about 3 s each): newsprint's radius 4 through the JAX bilateral with
    edge borders, and the same closures with zero borders."""
    x = _image(40, 300, seed=4)
    real = pallas_ops.stencil_reduce_mc
    seen = []

    def interpreting(*args, **kw):
        seen.append(args)
        return real(*args, interpret=True, **kw)

    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(pallas_ops, "stencil_reduce_mc", interpreting)
    edge = np.asarray(jlibrary.bilateral.fn(JContext(300, 40), jnp.asarray(x), radius=4,
                                            sigma_space=2.5, sigma_range=0.12))
    monkeypatch.undo()
    stacked, _rh, _rw, taps_list, tap_fn, final_fn = seen[0]
    zero = np.asarray(real(stacked, 4, 4, taps_list, tap_fn, final_fn, out_channels=3,
                           acc_channels=4, mode="zero", interpret=True))
    _r, op = library.bilateral_op(4, 2.5, 0.12)
    xs = torch.from_numpy(np.array(stacked))
    for mode, want in (("edge", edge[:3]), ("zero", zero)):
        got = cuda_ops.stencil_reduce_mc(xs, 4, 4, op, mode)
        np.testing.assert_allclose(got.numpy(), want, atol=BILATERAL_TOL, rtol=0)


def test_stencil_reduce_checks_and_counts_nothing():
    cuda_ops.reset_launches()
    _r, op = library.bilateral_op(2, 2.0, 0.1)
    x = torch.from_numpy(_image(12, 20))
    cuda_ops.stencil_reduce_mc(x, 2, 2, op)
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        cuda_ops.stencil_reduce_mc(x[:3], 2, 2, op)  # bilateral reduces four channels
    with pytest.raises(ValueError):
        cuda_ops.stencil_reduce_mc(x, 1, 1, op)  # taps outside the window
    with pytest.raises(ValueError):
        cuda_ops.stencil_reduce_mc(x, 2, 2, cuda_ops.ReduceOp("bilateral", ()))
    with pytest.raises(ValueError):
        cuda_ops.stencil_reduce_mc(x, 2, 2, cuda_ops.ReduceOp("median", op.taps))
    with pytest.raises(ValueError):
        cuda_ops.stencil_reduce_mc(x, 2, 2, op, mode="wrap")
    with pytest.raises(TypeError):
        cuda_ops.stencil_reduce_mc(x.to(torch.bfloat16), 2, 2, op)
    # radius 4 fits the soft budget; a radius past every tile reads global memory
    assert cuda_ops.choose_reduce_tile(4, 4, 81)[2] <= cuda_ops.SMEM_SOFT
    assert cuda_ops.choose_reduce_tile(60, 60, 3600) is None


class _ReportsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _FakeLibrary:
    def __init__(self, rc):
        self.rc = rc
        self.calls = []
        self.run_calls = []

    def rf_stencil_reduce(self, *args):
        self.calls.append(args)
        return self.rc

    def rf_stencil_reduce_run(self, *args):
        self.run_calls.append(args)
        return self.rc

    def rf_error_string(self, rc):
        return b"refused"


@pytest.mark.parametrize("rc", [0, 1])
def test_stencil_reduce_never_takes_the_plain_version_on_a_gpu(rc, monkeypatch):
    """For a tensor on a GPU the wrapper launches the kernel (counted) or
    raises; it never runs its plain version."""

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a GPU tensor")

    lib = _FakeLibrary(rc)
    monkeypatch.setattr(cuda_ops, "stencil_reduce_mc_plain", no_plain)
    monkeypatch.setattr(cuda_ops, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_ops, "_stream", lambda x: 0)
    _r, op = library.bilateral_op(60, 8.0, 0.1)  # past every shared-memory tile
    x = torch.from_numpy(_image(8, 16)).as_subclass(_ReportsCuda)
    assert x.is_cuda
    cuda_ops.reset_launches()
    if rc:
        with pytest.raises(RuntimeError, match="stencil_reduce_mc launch failed"):
            cuda_ops.stencil_reduce_mc(x, 60, 60, op)
        assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == 0
    else:
        out = cuda_ops.stencil_reduce_mc(x, 60, 60, op)
        assert tuple(out.shape) == (3, 8, 16)
        assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == 1
        smem = lib.calls[0][-2]
        assert smem == 0  # the global-memory path
    assert len(lib.calls) == 1


@pytest.mark.parametrize("rc", [0, 1])
def test_stencil_reduce_run_form_launches_on_a_gpu(rc, monkeypatch):
    """Newsprint's radius 4 takes the run form on a GPU tensor: its own
    entry, with the radius, the weight table, the row masks and the
    footprint; counted, or raising where the launch fails."""

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a GPU tensor")

    lib = _FakeLibrary(rc)
    monkeypatch.setattr(cuda_ops, "stencil_reduce_mc_plain", no_plain)
    monkeypatch.setattr(cuda_ops, "load_library", lambda: lib)
    monkeypatch.setattr(cuda_ops, "_stream", lambda x: 0)
    monkeypatch.setattr(cuda_ops, "_sm_count", lambda device: 132)
    _r, op = library.bilateral_op(4, 2.5, 0.12)
    x = torch.from_numpy(_image(8, 16)).as_subclass(_ReportsCuda)
    cuda_ops.reset_launches()
    if rc:
        with pytest.raises(RuntimeError, match="stencil_reduce_mc launch failed"):
            cuda_ops.stencil_reduce_mc(x, 4, 4, op)
    else:
        assert tuple(cuda_ops.stencil_reduce_mc(x, 4, 4, op).shape) == (3, 8, 16)
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == 1 - rc
    assert lib.calls == [] and len(lib.run_calls) == 1
    args = lib.run_calls[0]
    assert args[4] == 4 and args[7] == 1  # radius 4, every tap (the dense form)
    assert args[-3:-1] == (cuda_ops.reduce_run_footprint(4), 132)
    weights, rows, dense = cuda_ops._device_reduce_run_taps(op.taps, 4, x.device)
    assert dense and rows.tolist() == [(1 << 9) - 1] * 9
    np.testing.assert_array_equal(weights.numpy(), np.float32([t[2] for t in op.taps]))


# ---- the tap list of bilateral, and the form chooser --------------------------------

SIGMA_SPACES = (0.3, 0.6, 1.2, 2.5, 8.0)


@pytest.mark.parametrize("sigma_space", SIGMA_SPACES)
@pytest.mark.parametrize("r", range(1, 9))
def test_bilateral_tap_list_is_row_major(r, sigma_space):
    """The run form sums each output's taps in (dy, dx) order: bilateral_op's
    list must be in that order, each tap once."""
    rr, op = library.bilateral_op(r, sigma_space, 0.12)
    keys = [dy * (2 * rr + 1) + dx for dy, dx, _ in op.taps]
    assert keys == sorted(set(keys))
    assert cuda_ops.choose_reduce_form(rr, rr, op.taps)[0] == "run"


@pytest.mark.parametrize("sigma_space", SIGMA_SPACES)
@pytest.mark.parametrize("r", range(1, 9))
def test_bilateral_spatial_weights_are_symmetric(r, sigma_space):
    """ws(o) == ws(-o) in f32, bit for bit, and a tap is in the list exactly
    when its mirror is: the range weight of tap o at pixel p then equals
    that of tap -o at pixel p + o, which the bound's pair count uses.
    Small sigma_space drops the corners (and whole rows)."""
    rr, op = library.bilateral_op(r, sigma_space, 0.12)
    ws = {(dy, dx): np.float32(w) for dy, dx, w in op.taps}
    for (dy, dx), w in ws.items():
        mirror = ws.get((2 * rr - dy, 2 * rr - dx))
        assert mirror is not None and mirror.view(np.uint32) == w.view(np.uint32)
    if sigma_space <= 0.6 and r >= 2:
        assert (0, 0) not in ws  # the corners are dropped


def _reduce_form_case(case, monkeypatch):
    """(rh, rw, taps) of a chooser case."""
    _r, op4 = library.bilateral_op(4, 2.5, 0.12)
    if case == "r4 sparse":
        return (4, 4, library.bilateral_op(4, 0.6, 0.12)[1].taps)
    if case in ("r1", "r8", "r9", "r60"):
        r = int(case[1:])
        return (r, r, library.bilateral_op(r, 8.0 if r == 60 else 2.5, 0.12)[1].taps)
    if case == "r4 reversed":
        return (4, 4, tuple(reversed(op4.taps)))
    if case == "r4 a tap twice":
        return (4, 4, op4.taps + op4.taps[-1:])
    if case == "rh != rw":
        return (4, 5, op4.taps)
    if case == "r4 over the budget":
        monkeypatch.setattr(cuda_ops, "REDUCE_RUN_SMEM", 16 * 1024)
    return (4, 4, op4.taps)


@pytest.mark.parametrize("case,form", [
    ("r4", "run"), ("r1", "run"), ("r8", "run"), ("r4 sparse", "run"),
    ("r9", "shared"), ("r4 reversed", "shared"), ("r4 a tap twice", "shared"),
    ("rh != rw", "shared"), ("r4 over the budget", "shared"), ("r60", "global"),
])
def test_reduce_form_chooser(case, form, monkeypatch):
    """The run form only for a compiled radius, a row-major list and a
    window that fits the shared-memory budget; otherwise the general form
    (shared, or global past every tile)."""
    rh, rw, taps = _reduce_form_case(case, monkeypatch)
    got, th, tw, smem = cuda_ops.choose_reduce_form(rh, rw, taps)
    assert got == form
    if form == "run":
        assert (th, tw) == cuda_ops.REDUCE_RUN_TILE and smem == cuda_ops.reduce_run_footprint(rh)
        assert smem <= cuda_ops.REDUCE_RUN_SMEM
    elif form == "shared":
        assert (th, tw, smem) == cuda_ops.choose_reduce_tile(rh, rw, len(taps))
    else:
        assert smem == 0 and cuda_ops.choose_reduce_tile(rh, rw, len(taps)) is None


# ---- samplers and noise -------------------------------------------------------


def test_samplers_match_jax():
    rng = np.random.default_rng(5)
    x = rng.random((4, 20, 30), dtype=np.float32)
    yf = rng.uniform(-3.0, 24.0, (17, 11)).astype(np.float32)
    xf = rng.uniform(-3.0, 34.0, (17, 11)).astype(np.float32)
    got = tops.sample_bilinear(torch.from_numpy(x), torch.from_numpy(yf), torch.from_numpy(xf))
    want = jops.sample_bilinear(jnp.asarray(x), jnp.asarray(yf), jnp.asarray(xf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    yi, xi = np.floor(yf).astype(np.int32), np.floor(xf).astype(np.int32)
    got = tops.sample_nearest(torch.from_numpy(x), torch.from_numpy(yi), torch.from_numpy(xi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.sample_nearest(x, yi, xi)))
    rgb, alpha = torch.from_numpy(x[:3]), torch.from_numpy(x[3])
    np.testing.assert_array_equal(tops.with_alpha(rgb, alpha).numpy(),
                                  np.asarray(jops.with_alpha(x[:3], x[3])))


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_uniform_bit_equal_to_jax_random(seed):
    for fold in (None, 300, -17):
        key = jax.random.PRNGKey(seed)
        if fold is not None:
            key = jax.random.fold_in(key, jnp.int32(fold))
        want = np.asarray(jax.random.uniform(key, (1, 37, 53), minval=-0.5, maxval=0.5))
        got = prng.uniform(seed, (1, 37, 53), -0.5, 0.5, fold=fold, device="cpu").numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("animate", [False, True])
@pytest.mark.parametrize("seed", [0, 5, 99])
def test_noise_builtin_bit_equal_to_jax(seed, animate):
    config = _one_node("noise", f"amount: 0.3, seed: {seed}, animate: {str(animate).lower()}")
    jprog = JProgram(jbuild(jparse(config, expects_input=True)), W, H, "rgba32f")
    x = _image(seed=seed)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)))
    prog = make_program(graph_from_reference(jprog.graph), W, H, device="cpu")
    got = prog._forward(torch.from_numpy(x), T).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if animate:  # a later frame draws other grain
        assert not np.array_equal(prog._forward(torch.from_numpy(x), T + 0.5).numpy(), got)


# ---- the other builtins ---------------------------------------------------------

BUILTIN_GRAPHS = {
    "kuwahara": _one_node("kuwahara", "radius: 3"),
    "levels": _one_node("levels", "in_black: 0.08, in_white: 0.92, gamma: 1.1, out_black: 0.05, "
                                  "out_white: 0.9"),
    "halftone": _one_node("halftone", "size: 6, angle: 15.0"),
    "halftone_square": _one_node("halftone", "size: 1, angle: 0.0"),
    "bilateral": _one_node("bilateral", "radius: 2, sigma_space: 1.5, sigma_range: 0.2"),
}


@pytest.mark.parametrize("name", sorted(BUILTIN_GRAPHS))
def test_builtin_matches_jax(name):
    """Each new builtin against its JAX builtin, rgba32f, per node: the
    same ops in the same order (levels' pow may differ by an ulp)."""
    jprog = JProgram(jbuild(jparse(BUILTIN_GRAPHS[name], expects_input=True)), W, H, "rgba32f")
    x = _image(seed=8)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)))
    graph = graph_from_reference(jprog.graph)
    assert graph.nodes["n"].params == jprog.graph.nodes["n"].params
    got = make_program(graph, W, H, device="cpu")._forward(torch.from_numpy(x), T).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_levels_channel_form_matches_fn():
    x = torch.from_numpy(_image(24, 40, seed=9))
    ctx = KernelContext(width=40, height=24, device="cpu")
    params = dict(in_black=0.04, in_white=0.96, gamma=1.08, out_black=0.0, out_white=1.0)
    want = library.levels(ctx, {"input_image": x}, params)["output_image"]
    got = library.levels.cw_fn(ctx, torch.arange(4).view(4, 1, 1), {"input_image": x}, params)
    assert torch.equal(got, want)


def test_kuwahara_rgba16f_convolves_its_stack_in_f32(monkeypatch):
    """rgba16f kuwahara equals the JAX CPU path (f32 convs): sending the
    (6, H, W) stack through the bf16 conv entry would round its luma and
    luma^2 planes and flip the least-variance quadrant (on this image
    0.9% of values then move by more than 1e-2, up to 0.26).  Every
    quadrant conv takes sep_conv_fused."""
    config = _one_node("kuwahara", "radius: 4")
    x = np.asarray(jnp.asarray(_image(96, 128, seed=10)).astype(jnp.bfloat16).astype(jnp.float32))
    jprog = JProgram(jbuild(jparse(config, expects_input=True)), 128, 96, "rgba16f")
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    calls = []
    for entry in ("sep_conv_fused", "sep_conv_fused_mxu", "sep_conv_fused_mxu_x3"):
        real = getattr(cuda_ops, entry)
        monkeypatch.setattr(cuda_ops, entry, functools.partial(
            lambda f, n, *a, **k: calls.append(n) or f(*a, **k), real, entry))
    prog = make_program(graph_from_reference(jprog.graph), 128, 96, "rgba16f", device="cpu")
    calls.clear()  # make_program's shape check on meta tensors
    got = prog._forward(torch.from_numpy(x), T).float().numpy()
    assert calls == ["sep_conv_fused"] * 4
    d = np.abs(got - want)
    assert d.max() <= 2e-2 and (d > 1e-2).mean() == 0.0, (d.max(), (d > 1e-2).mean())


# ---- the three graphs -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_program(name, fmt, h=H, w=W):
    return JProgram(jbuild(jparse(STYLIZED_GRAPHS[name], expects_input=True)), w, h, fmt)


def _assert_close(got, want, fmt):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    if fmt == "rgba32f":
        # PARITY.md's whole-graph bound (64 ulp; 1e-5 on [0, 1] values).
        assert d.max() <= 1e-5, d.max()
    elif fmt == "rgba16f":
        # The JAX package's rgba16f bound; an ulp before a bf16 store can
        # flip it.
        assert d.max() <= 2e-2, d.max()
    else:
        # rgba8: an ulp before a quantized store flips a 1/255 bucket, and
        # the flip can cascade through one more quantized node.  Halftone
        # puts every pixel in the same cell on both sides (the cell index
        # divides exactly), so no pixel is allowed a cell-edge jump: the
        # fraction bound below is the whole allowance.
        assert d.max() <= 2.0 / 255.0 + 1e-6, d.max()
        assert (d > 1.0 / 512.0).mean() < 1e-3


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(STYLIZED_GRAPHS))
def test_stylized_graph_matches_jax_per_node(name, fmt):
    jprog = _jax_program(name, fmt)
    x = _image(seed=11)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    prog = make_program(graph_from_reference(jprog.graph), W, H, fmt, device="cpu")
    out = prog._forward(torch.from_numpy(x), T)
    assert out.dtype == prog.storage_dtype and tuple(out.shape) == (4, H, W)
    _assert_close(out.float().numpy(), want, fmt)
    per_node, times = prog.run_per_node(torch.from_numpy(x), T)
    assert set(times) == set(jprog.graph.nodes)
    assert torch.equal(per_node, out)


@pytest.mark.parametrize("name", sorted(STYLIZED_GRAPHS))
def test_graph_from_reference_carries_stylized_graphs(name):
    """Params, wiring and layers of the three graphs carry over, and the
    port's own parser builds the same graph."""
    jgraph = _jax_program(name, "rgba32f").graph
    graph = graph_from_reference(jgraph)
    native = build_graph(tconfig.parse(STYLIZED_GRAPHS[name], expects_input=True))
    for ported in (graph, native):
        assert set(ported.nodes) == set(jgraph.nodes)
        for node_name, node in ported.nodes.items():
            ref = jgraph.nodes[node_name]
            assert node.spec.name == ref.spec.name and node.params == ref.params
            assert node.inputs == ref.inputs and node.outputs == ref.outputs
        assert [[n.name for n in layer] for layer in ported.layers] == [
            [n.name for n in layer] for layer in jgraph.layers]


@pytest.mark.parametrize("name", sorted(STYLIZED_GRAPHS))
def test_no_strip_tier_like_jax(name):
    """Neither package plans a strip tier for these graphs (halftone and
    noise have no halo, bilateral and kuwahara no strip form), at the
    test size and at 3840x2160."""
    assert _jax_program(name, "rgba32f")._strip_plan is None
    for fmt in FORMATS:
        for h, w in ((H, W), (2160, 3840)):
            prog = build_program(STYLIZED_GRAPHS[name], w, h, fmt, device="cpu")
            assert prog._strip_plan is None


@pytest.mark.parametrize("name", sorted(STYLIZED_GRAPHS))
def test_stylized_graph_through_engine(tmp_path, name):
    """One-shot (u8 in and out) and the frame path agree, and match the
    JAX engine's one-shot within one code (its sRGB pow may differ by an
    ulp)."""
    from reforge_tpu.engine import Engine as JEngine
    from reforge_tpu.engine import RenderInfo as JRenderInfo

    cfg = tmp_path / f"{name}.rf"
    cfg.write_text(STYLIZED_GRAPHS[name])
    shaders = tmp_path / "shaders"
    shaders.mkdir()  # shaders/kuwahara.comp, tonemap.comp, vignette.comp would replace builtins
    u8 = np.random.default_rng(12).integers(0, 256, (H, W, 4), dtype=np.uint8)
    want = JEngine(JRenderInfo(W, H, config_path=str(cfg), shader_path=str(shaders),
                               has_input_image=True, one_shot=True)).render_one_shot(u8, 0.25)

    def info(one_shot):
        return RenderInfo(W, H, "cpu", config_path=str(cfg), shader_path=str(shaders),
                          has_input_image=True, one_shot=one_shot)

    got = Engine(info(True)).render_one_shot(u8, 0.25)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    engine = Engine(info(False))
    engine.load_input(u8)
    assert np.array_equal(engine.read_output(engine.render_frame(0.25)), got)
