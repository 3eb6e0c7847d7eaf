"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and skips without one.  This file imports nothing of
JAX, so it runs on a machine without it; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from reforge_tpu_torch.benchmarks import build_flagship
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.ops import gaussian_weights

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _image(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32)).cuda()


def _tol(w):
    # One FMA per tap in the kernel, a multiply then an add in the plain
    # version: the difference grows with the taps of both passes.
    return max(2e-6, 6e-8 * 2 * len(w))


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r", [1, 12, 96])
def test_conv_entry_points(r, mode):
    x = _image((4, 37, 71), r)
    w = gaussian_weights(r / 3.0)
    w1 = gaussian_weights(1 / 3.0)
    cases = {
        "sep_conv_fused": (x, [(w, w)], lambda: [cuda_ops.sep_conv_fused(x, w, w, mode)]),
        "sep_conv_fused_mxu": (
            x.to(torch.bfloat16), [(w, w)],
            lambda: [cuda_ops.sep_conv_fused_mxu(x.to(torch.bfloat16), w, w, mode)]),
        "sep_conv_fused_multi": (
            x, [(w, w), (w1, w)],
            lambda: cuda_ops.sep_conv_fused_multi(x, [(w, w), (w1, w)], mode)),
    }
    for name, (xin, plans, run) in cases.items():
        before = cuda_ops.LAUNCHES[name]
        got = run()
        want = cuda_ops.sep_conv_plain(xin, plans, mode)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES[name] == before + 1
        for g, wv in zip(got, want):
            assert float((g - wv).abs().max()) <= _tol(w), name


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
def test_graph_strip(fmt):
    prog = build_flagship(71, 37, fmt, device="cuda")
    x = _image((4, 37, 71), 5).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip"]
    got = prog._forward(x, 0.5)
    want = cuda_ops.graph_strip_plain(x, 0.5, prog._strip_program)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip"] == before + 1
    # rgba16f: a one-ulp difference before a node's bf16 rounding can flip it.
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_stencil_apply(mode):
    from reforge_tpu_torch.kernels import library

    x = _image((4, 37, 71), 7)
    ops = [(1, cuda_ops.wsum(library.SHARPEN_TAPS)), (1, cuda_ops.wsum(library.EMBOSS_TAPS)),
           (1, cuda_ops.MEDIAN9),
           (2, cuda_ops.wsum(np.arange(25, dtype=np.float32).reshape(5, 5) - 7.0))]
    for r, op in ops:
        before = cuda_ops.LAUNCHES["stencil_apply"]
        got = cuda_ops.stencil_apply(x, r, r, op, mode)
        want = cuda_ops.stencil_apply_plain(x, r, r, op, mode)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES["stencil_apply"] == before + 1
        # every product and sum rounds as in the plain version: bit-equal
        assert torch.equal(got, want), (op.kind, r)


@pytest.mark.parametrize("r", [24, 66])
def test_sep_conv_fused_mxu_x3(r):
    x = _image((4, 37, 71), r)
    w = gaussian_weights(r / 3.0)
    before = cuda_ops.LAUNCHES["sep_conv_fused_mxu_x3"]
    got = cuda_ops.sep_conv_fused_mxu_x3(x, w, w, "zero" if r > 64 else "edge")
    want = cuda_ops.sep_conv_plain(x, [(w, w)], "zero" if r > 64 else "edge")[0]
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sep_conv_fused_mxu_x3"] == before + 1
    assert float((got - want).abs().max()) <= _tol(w)


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])  # border blocks only; interior ones too
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize(
    "config", ["DEMO_CONFIG", "EDGES_CONFIG", "CHAIN3_CONFIG", "MIX_SECOND_FIRST_CONFIG"])
def test_graph_strip_mc(config, fmt, hw):
    from reforge_tpu_torch import benchmarks

    h, w = hw
    prog = benchmarks.build_program(getattr(benchmarks, config), w, h, fmt, device="cuda")
    assert prog._strip_plan[0] == "mc"
    x = _image((4, h, w), 9).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip_mc"]
    got = prog._forward(x, 0.5)
    want = cuda_ops.graph_strip_mc_plain(x, 0.5, prog._strip_plan[1])
    per_node = prog._forward_nostrip(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == before + 1
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    # the mix wired second input first reads its base as in0 on the card too
    assert float((got.float() - per_node.float()).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r,sigma_space", [(1, 2.0), (4, 2.5), (60, 8.0)])
def test_stencil_reduce_mc(r, sigma_space, mode):
    """Bilateral's reduction against its plain version; radius 60 fits no
    shared-memory tile and reads its taps from global memory.  Both sides
    call the same expf and round every product and sum alike: within a
    few f32 ulps of [0, 1] values."""
    from reforge_tpu_torch.kernels import library

    x = _image((4, 37, 71), 11)
    rr, op = library.bilateral_op(r, sigma_space, 0.12)
    assert (cuda_ops.choose_reduce_tile(r, r, len(op.taps)) is None) == (r == 60)
    before = cuda_ops.LAUNCHES["stencil_reduce_mc"]
    got = cuda_ops.stencil_reduce_mc(x, rr, rr, op, mode)
    want = cuda_ops.stencil_reduce_mc_plain(x, rr, rr, op, mode)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == before + 1
    assert float((got - want).abs().max()) <= 1e-6


def test_newsprint_4k_frame_against_plain_per_node(monkeypatch):
    """Newsprint's 4K frame through the kernel against the same graph with
    the kernel's plain version on the card."""
    from reforge_tpu_torch import benchmarks

    prog = benchmarks.build_program(benchmarks.NEWSPRINT_CONFIG, 3840, 2160, device="cuda")
    assert prog._strip_plan is None
    x = _image((4, 2160, 3840), 12)
    before = cuda_ops.LAUNCHES["stencil_reduce_mc"]
    got = prog._forward(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == before + 1
    monkeypatch.setattr(cuda_ops, "stencil_reduce_mc", cuda_ops.stencil_reduce_mc_plain)
    want = prog._forward(x, 0.5)
    # halftone's dots turn a few-ulp change of a cell's luma into at most
    # a few ulps of ink
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r", [0, 3, 160, 3000])  # 3000: no shared-memory window, taps from global
@pytest.mark.parametrize("axis", ["h", "w"])
def test_conv1d(axis, r, mode):
    """conv1d_h / conv1d_w against correlate1d: the nonzero taps in
    ascending order with every product and sum rounded alike, bit-equal;
    a 6-channel odd frame (border tiles only) and one with interior
    tiles, a box vector and one with zero taps (kuwahara's quadrant)."""
    entry = cuda_ops.conv1d_h if axis == "h" else cuda_ops.conv1d_w
    along_h = axis == "h"
    box = np.full(2 * r + 1, 1.0 / (2 * r + 1), np.float32)
    half = np.zeros(2 * r + 1, np.float32)
    half[r:] = 1.0 / (r + 1)
    n = len(np.flatnonzero(box))
    assert (cuda_ops.choose_conv1d_tile(along_h, r, n) is None) == (r == 3000)
    for shape in ((6, 33, 47), (4, 300, 520)):
        x = _image(shape, r + len(shape))
        for w in (box, half):
            before = cuda_ops.LAUNCHES[f"conv1d_{axis}"]
            got = entry(x, w, mode)
            want = cuda_ops.correlate1d(x, w, -2 if along_h else -1, mode)
            torch.cuda.synchronize()
            assert cuda_ops.LAUNCHES[f"conv1d_{axis}"] == before + 1
            assert torch.equal(got, want), (shape, float((got - want).abs().max()))


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("config,tier", [("CW_CHECK_CONFIG", "single"), ("MC_CHECK_CONFIG", "mc")])
def test_channel_ops_on_strip_kernels(config, tier, fmt):
    """Every channel-local builtin's cw_op through graph_strip, and every new
    mc point op through graph_strip_mc, against per node on the card.  The
    device forms round every operation as the builtins' PyTorch forms do
    (pow by powf, as PyTorch's CUDA pow): rgba32f within 1e-5; a bf16 or
    1/255 step where an ulp flips a rounding before a store."""
    from reforge_tpu_torch import benchmarks

    prog = benchmarks.build_program(getattr(benchmarks, config), 71, 37, fmt, device="cuda")
    assert prog._strip_plan[0] == tier
    kernel = "graph_strip" if tier == "single" else "graph_strip_mc"
    for hw in ((37, 71), (200, 300)):
        prog = benchmarks.build_program(getattr(benchmarks, config), hw[1], hw[0], fmt,
                                        device="cuda")
        x = _image((4, *hw), 13).to(prog.storage_dtype)
        before = cuda_ops.LAUNCHES[kernel]
        got = prog._forward(x, 0.5)
        per_node = prog._forward_nostrip(x, 0.5)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES[kernel] == before + 1
        d = (got.float() - per_node.float()).abs()
        if fmt == "rgba32f":
            assert float(d.max()) <= 1e-5
        else:
            step = 2e-2 if fmt == "rgba16f" else 2.0 / 255.0 + 1e-6
            assert float((d > step).float().mean()) <= 1e-3, float(d.max())


def test_scanlines_op_without_its_plane():
    """scanlines' own opcode (a program that does not hoist its fade plane)
    on graph_strip against its channel form."""
    from reforge_tpu_torch.kernels import library
    from reforge_tpu_torch.kernels.base import KernelContext

    x = _image((4, 37, 71), 14)
    p = {"period": 3, "darkness": 0.2}
    code, params = library.scanlines.cw_op(p, False)
    strip = cuda_ops.StripProgram(
        plans=[(np.array([0.25, 0.5, 0.25], np.float32),) * 2],
        ops=[cuda_ops.StripOp(code, (0, 0), 2, params, -1, None)], out_slot=2, fmt="rgba32f")
    got = cuda_ops.graph_strip(x, 0.5, strip)
    ctx = KernelContext(width=71, height=37, device="cuda")
    want = library.scanlines.cw_fn(ctx, torch.arange(4, device="cuda").view(4, 1, 1),
                                   {"input_image": x}, p)
    assert torch.equal(got, want)


def test_frost_4k_frame_runs_the_1d_kernels():
    """Frost's 4K frame: one conv1d_h and one conv1d_w, equal to the same
    graph with correlate1d on the card."""
    from reforge_tpu_torch import benchmarks

    prog = benchmarks.build_program(benchmarks.FROST_CONFIG, 3840, 2160, device="cuda")
    assert prog._strip_plan is None
    x = _image((4, 2160, 3840), 15)
    before = dict(cuda_ops.LAUNCHES)
    got = prog._forward(x, 0.5)
    torch.cuda.synchronize()
    assert {k: cuda_ops.LAUNCHES[k] - before[k] for k in before if
            cuda_ops.LAUNCHES[k] != before[k]} == {"conv1d_h": 1, "conv1d_w": 1}
    w = np.full(321, 1.0 / 321, np.float32)
    want = cuda_ops.correlate1d(cuda_ops.correlate1d(x, w, -2), w, -1)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("c_out,rh,rw", [(4, 2, 2), (3, 2, 3), (3, 24, 24)])  # r24: global path
def test_stencil_apply_mc(c_out, rh, rw, mode, dtype):
    """The cross-channel stencil against its plain version: each output's
    products added in the table's order, each rounded alone: bit-equal."""
    w = np.random.default_rng(rh).standard_normal((c_out, 4, 2 * rh + 1, 2 * rw + 1))
    op = cuda_ops.LinearStencilOp(w.astype(np.float32))
    x = _image((4, 37, 71), 16).to(dtype)
    before = cuda_ops.LAUNCHES["stencil_apply_mc"]
    got = cuda_ops.stencil_apply_mc(x, op, mode)
    want = cuda_ops.stencil_apply_mc_plain(x, op, mode)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_apply_mc"] == before + 1
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("graph", ["glsl_blur", "glsl_blur_sharpen"])
def test_glsl_graphs_on_graph_strip_mc(graph, fmt, hw):
    """gaussian_h.comp -> gaussian_v.comp (-> sharpen.comp) on the mc tier:
    synthesized conv and stencil stages and the MC_AFFINE mix, against the
    plain version and the per-node tier (the interpreter) on the card."""
    from reforge_tpu_torch import benchmarks

    h, w = hw
    prog = benchmarks.build_program(benchmarks.GLSL_GRAPHS[graph], w, h, fmt, device="cuda",
                                    shader_path=benchmarks.SHADER_DIR)
    assert prog._strip_plan[0] == "mc"
    x = _image((4, h, w), 17).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip_mc"]
    got = prog._forward(x, 0.5)
    want = cuda_ops.graph_strip_mc_plain(x, 0.5, prog._strip_plan[1])
    per_node = prog._forward_nostrip(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == before + 1
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((got.float() - per_node.float()).abs().max()) <= tol
