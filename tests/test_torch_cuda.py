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


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("graph", ["glsl_chain", "glsl_sharpen", "tonemap_sharpen",
                                   "blur_sharpen_blend", "bloom_glow", "zero_border",
                                   "mixed_border"])
def test_point_graphs_on_graph_strip_mc(graph, fmt, hw, monkeypatch):
    """GLSL point shaders as op-list stages (the kernel's glsl form; in
    tonemap_sharpen the op list starts on an odd word) and nblur.comp's
    zero mode: the mc plan (the mixed graph's zero-mode segment) against
    its plain version, the frame against per node.  bloom_glow runs per
    node (the tier rule against halo recompute); its mc plan, planned with
    the bound lifted, still runs on the card."""
    from reforge_tpu_torch import benchmarks
    from reforge_tpu_torch.graph import program as program_module

    h, w = hw
    config, shader_dir = benchmarks.point_graphs()[graph]
    prog = benchmarks.build_program(config, w, h, fmt, device="cuda", shader_path=shader_dir)
    plan = prog._strip_plan
    if graph == "bloom_glow":
        assert plan is None
        monkeypatch.setattr(program_module, "MC_MAX_HALO_WORK", float("inf"))
        plan = ("mc", prog._plan_strip_mc())
    if plan[0] == "segments":
        plan = plan[1][0][1]._strip_plan
    assert plan[0] == "mc" and (plan[1].mode == "zero") == graph.endswith("border")
    x = _image((4, h, w), 23).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip_mc"]
    got = cuda_ops.graph_strip_mc(x, 0.5, plan[1])
    want = cuda_ops.graph_strip_mc_plain(x, 0.5, plan[1])
    frame, per_node = prog._forward(x, 0.5), prog._forward_nostrip(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == before + (1 if graph == "bloom_glow" else 2)
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert float((frame.float() - per_node.float()).abs().max()) <= tol


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("first", [False, True], ids=["after_blur", "first"])
@pytest.mark.parametrize("graph", ["mandelbrot_after_blur", "iterate_after_blur",
                                   "bits_after_blur"])
def test_loop_graphs_on_graph_strip_mc(graph, first, fmt, hw, monkeypatch):
    """Op lists with loop regions (mandelbrot.comp, iterate.comp) and shift
    ops (bits.comp) on the glsl form against the plain version: after a
    blur (the planned graph; the frame against per node too), and as the
    first node before a gaussian (the plan the tier rule refuses, the op
    list on the input itself).  mandelbrot.comp ignores its input and
    holds bit for bit in either place; after a blur, iterate.comp's trip
    counts and bits.comp's codes jump where a one-rounding difference of
    the conv crosses a threshold, so at most 1e-3 of their values may lie
    past the bound."""
    from reforge_tpu_torch import benchmarks
    from reforge_tpu_torch.graph import program as program_module

    h, w = hw
    config, shader_dir = benchmarks.point_graphs()[graph]
    if first:
        lines = config.splitlines()
        blur, shader = lines[0].split(" -> ")[1:3]
        config = "\n".join([f"input -> {shader} -> {blur} -> output"] + lines[1:]) + "\n"
        monkeypatch.setattr(program_module, "MC_MAX_HALO_WORK", float("inf"))
    prog = benchmarks.build_program(config, w, h, fmt, device="cuda", shader_path=shader_dir)
    plan = prog._strip_plan
    assert plan[0] == "mc" and cuda_ops.MC_GLSL in [st.op.code for st in plan[1].stages]
    x = _image((4, h, w), 29).to(prog.storage_dtype)
    got = cuda_ops.graph_strip_mc(x, 0.5, plan[1])
    want = cuda_ops.graph_strip_mc_plain(x, 0.5, plan[1])
    pairs = [(got, want)]
    if not first:
        pairs.append((prog._forward(x, 0.5), prog._forward_nostrip(x, 0.5)))
    torch.cuda.synchronize()
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    share = 0.0 if first or graph == "mandelbrot_after_blur" else 1e-3
    for a, b in pairs:
        d = (a.float() - b.float()).abs()
        assert float((d > tol).float().mean()) <= share, float(d.max())


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("graph", ["hash_after_blur", "composite3", "composite3_raw_mask",
                                   "wide_after_blur"])
def test_reach_graphs_on_graph_strip_mc(graph, fmt, hw):
    """Bit casts (hash.comp), three images (composite3.comp; with the
    input itself as the third, read by LOADX from the input block) and the
    wide op word (wide.comp, its register files in device memory) on the
    glsl form against the plain version, and the frame against per
    node."""
    from reforge_tpu_torch import benchmarks

    h, w = hw
    config, shader_dir = benchmarks.point_graphs()[graph]
    prog = benchmarks.build_program(config, w, h, fmt, device="cuda", shader_path=shader_dir)
    plan = prog._strip_plan
    assert plan[0] == "mc" and cuda_ops.MC_GLSL in [st.op.code for st in plan[1].stages]
    assert plan[1]._wide == (graph == "wide_after_blur")
    x = _image((4, h, w), 31).to(prog.storage_dtype)
    pairs = [(cuda_ops.graph_strip_mc(x, 0.5, plan[1]),
              cuda_ops.graph_strip_mc_plain(x, 0.5, plan[1])),
             (prog._forward(x, 0.5), prog._forward_nostrip(x, 0.5))]
    torch.cuda.synchronize()
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    for a, b in pairs:
        assert float((a.float() - b.float()).abs().max()) <= tol


YSHADE = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    float f = float(pos.y) / float(size.y) + 0.25 * float(pos.y % 3);
    imageStore(output_image, pos, vec4(c.rgb * f, c.a));
}
"""
ROW_GRAPHS = {
    # graph_strip: vignette's hoisted plane; dither and scanlines read the row
    "flagship": None,
    "dither": ("input -> gs -> d -> s -> output\ngs: gaussian { sigma: 1.0 }\n"
               "d: dither { levels: 4 }\ns: scanlines { period: 3 }\n"),
    # graph_strip_mc: vignette's point op (builtins' form), a GLSL point
    # shader's K_COORD_Y (glsl form)
    "mc_vignette": ("input -> gs -> edge -> v -> output\ngs: gaussian { sigma: 1.0 }\n"
                    "edge: sharpen {}\nv: vignette { strength: 0.8 }\n"),
    "yshade": "input -> gs -> ys -> output\ngs: gaussian { sigma: 1.5 }\n",
}


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("graph", sorted(ROW_GRAPHS))
def test_strip_kernels_take_a_row_offset(graph, fmt, tmp_path):
    """graph_strip and graph_strip_mc on rows 61 - r .. 141 + r of a
    200x300 frame, extended by the plan's halo r, with row0 = 61 - r: the
    kernel against its plain version at the same row0, and its cropped rows
    bit-equal to the kernel's rows 61..141 of the whole frame (a pixel's
    arithmetic does not depend on where its tile falls)."""
    from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG, build_program

    (tmp_path / "ys.comp").write_text(YSHADE)
    config = ROW_GRAPHS[graph] or FLAGSHIP_CONFIG
    h, w, a, b = 200, 300, 61, 141
    prog = build_program(config, w, h, fmt, device="cuda", shader_path=str(tmp_path))
    tier, plan = prog._strip_plan[0], prog._strip_plan[1]
    x = _image((4, h, w), 29).to(prog.storage_dtype)
    frame = prog._forward(x, 0.5)
    if tier == "mc":
        r = plan.input_halo
        slab = x[:, a - r:b + r].contiguous()
        got = cuda_ops.graph_strip_mc(slab, 0.5, plan, a - r)
        want = cuda_ops.graph_strip_mc_plain(slab, 0.5, plan, a - r)
    else:
        r = max((len(wh) - 1) // 2 for _, (wh, _ww) in plan)
        slab = x[:, a - r:b + r].contiguous()
        strip = prog._strip_program_for(x.device, a - r, b - a + 2 * r)
        assert strip.aux is not None
        got = cuda_ops.graph_strip(slab, 0.5, strip, a - r, h)
        want = cuda_ops.graph_strip_plain(slab, 0.5, strip, a - r, h)
    torch.cuda.synchronize()
    assert tier == ("mc" if graph in ("mc_vignette", "yshade") else "single")
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    assert torch.equal(got[:, r:r + b - a], frame[:, a:b])


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("graph", ["demo", "neon_edges"])
def test_mc_interior_and_border_blocks(graph, fmt):
    """333x520, ragged both ways: interior blocks (16-byte window loads)
    and border blocks (clamped loads, slots' outside cells filled) in one
    launch, against the plain version and the per-node tier on the card.
    The conv FMAs round once a tap where the plain version rounds twice
    (rgba32f 1e-5, rgba16f one bf16 step, rgba8 two buckets on few pixels,
    as chip_smoke.py holds them); at 4K neon edges' threshold turns that
    into a bloom disc against plain (chip_smoke.py compares it with per
    node there), here it agrees with both."""
    from reforge_tpu_torch.benchmarks import DEMO_CONFIG, LIBRARY_GRAPHS, build_program

    config = DEMO_CONFIG if graph == "demo" else LIBRARY_GRAPHS["neon_edges"]
    prog = build_program(config, 520, 333, fmt, device="cuda")
    assert prog._strip_plan[0] == "mc"
    mc = prog._strip_plan[1]
    x = _image((4, 333, 520), 7).to(prog.storage_dtype)
    got = cuda_ops.graph_strip_mc(x, 0.5, mc)
    for want in (cuda_ops.graph_strip_mc_plain(x, 0.5, mc), prog._forward_nostrip(x, 0.5)):
        d = (got.float() - want.float()).abs()
        if fmt == "rgba8":
            assert float(d.max()) <= 2 / 255 + 1e-6 and float((d > 1 / 512).float().mean()) <= 1e-3
        else:
            assert float(d.max()) <= (1e-5 if fmt == "rgba32f" else 2e-2)


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("shape", [(4, 37, 71), (4, 333, 520), (4, 64, 1024)])
@pytest.mark.parametrize("axis", ["h", "w"])
def test_conv1d_sparse_taps(axis, shape, mode):
    """A tap vector with gaps (the register window reloads after each) on a
    ragged frame (border tiles only), on 333x520 (interior H tiles; every
    W tile crosses the edge) and on 64x1024 (interior W tiles, 16-byte
    loads): bit-equal to correlate1d."""
    w = np.zeros(61, np.float32)
    w[[0, 3, 4, 5, 17, 30, 31, 44, 60]] = np.linspace(0.05, 0.2, 9, dtype=np.float32)
    x = _image(shape, 5)
    entry = cuda_ops.conv1d_h if axis == "h" else cuda_ops.conv1d_w
    got = entry(x, w, mode)
    want = cuda_ops.correlate1d(x, w, -2 if axis == "h" else -1, mode)
    assert float((got - want).abs().max()) == 0.0


# The run form of stencil_reduce_mc: each compiled radius, full tap lists
# (sigma_space 2.5) and sparse ones (rows with gaps or none: sigma_space
# 0.6 at radius 4, 1.2 at radius 8); a ragged frame (border blocks only,
# element loads) and one with 16-byte rows whose last tiles are ragged.
REDUCE_RUN_CASES = [(r, 2.5) for r in range(1, 9)] + [(4, 0.6), (8, 1.2)]


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("shape", [(4, 37, 71), (4, 133, 260)])
@pytest.mark.parametrize("r,sigma_space", REDUCE_RUN_CASES)
def test_stencil_reduce_run_form(r, sigma_space, shape, mode, monkeypatch):
    """The run form against the general (shared-memory) form, forced:
    bit-equal (each output adds its taps in list order from -0), and
    against the plain version within 1e-6, as test_stencil_reduce_mc."""
    from reforge_tpu_torch.kernels import library

    x = _image(shape, 18 + r)
    rr, op = library.bilateral_op(r, sigma_space, 0.12)
    assert cuda_ops.choose_reduce_form(rr, rr, op.taps)[0] == "run"
    before = cuda_ops.LAUNCHES["stencil_reduce_mc"]
    got = cuda_ops.stencil_reduce_mc(x, rr, rr, op, mode)
    monkeypatch.setattr(cuda_ops, "REDUCE_RUN_RADII", ())
    assert cuda_ops.choose_reduce_form(rr, rr, op.taps)[0] == "shared"
    general = cuda_ops.stencil_reduce_mc(x, rr, rr, op, mode)
    want = cuda_ops.stencil_reduce_mc_plain(x, rr, rr, op, mode)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == before + 2
    assert torch.equal(got, general)
    assert float((got - want).abs().max()) <= 1e-6


R1_TABLES = {
    "sharpen": lambda lib: lib.SHARPEN_TAPS,
    "emboss": lambda lib: lib.EMBOSS_TAPS,
    "emboss x0.9": lambda lib: lib._emboss_mc_table({"amount": 0.9}),
    "sobel_x": lambda lib: lib.SOBEL_X_TAPS,
    "sobel_y": lambda lib: lib.SOBEL_Y_TAPS,
    "laplacian": lambda lib: np.array([[1, 1, 1], [1, -8, 1], [1, 1, 1]], np.float32),
    "no terms": lambda lib: np.zeros((3, 3), np.float32),
}


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("shape", [(4, 37, 71), (1, 133, 260), (4, 300, 520)])
@pytest.mark.parametrize("table", sorted(R1_TABLES) + ["median9"])
def test_stencil_r1_form(table, shape, mode, monkeypatch):
    """The radius-1 form of every shipped 3x3 table and the median against
    the plain version and against the general form, forced: bit-equal.
    37x71: ragged runs (element loads); 133x260 and 300x520: 16-byte
    rows, interior runs and ragged tiles."""
    from reforge_tpu_torch.kernels import library

    op = cuda_ops.MEDIAN9 if table == "median9" else cuda_ops.wsum(R1_TABLES[table](library))
    x = _image(shape, 19)
    assert cuda_ops.choose_stencil_form(1, 1, op) == "r1"
    before = cuda_ops.LAUNCHES["stencil_apply"]
    got = cuda_ops.stencil_apply(x, 1, 1, op, mode)
    monkeypatch.setattr(cuda_ops, "choose_stencil_form", lambda *a: "general")
    general = cuda_ops.stencil_apply(x, 1, 1, op, mode)
    want = cuda_ops.stencil_apply_plain(x, 1, 1, op, mode)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_apply"] == before + 2
    assert torch.equal(got, want)
    assert torch.equal(got, general)


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("shape", [(4, 37, 71), (1, 133, 260)])
def test_stencil_radius2_takes_the_general_form(shape, mode):
    op = cuda_ops.wsum(np.arange(25, dtype=np.float32).reshape(5, 5) / 8.0 - 1.0)
    assert cuda_ops.choose_stencil_form(2, 2, op) == "general"
    x = _image(shape, 20)
    got = cuda_ops.stencil_apply(x, 2, 2, op, mode)
    assert torch.equal(got, cuda_ops.stencil_apply_plain(x, 2, 2, op, mode))


# (C_in, C_out) pairs of the run forms' tests: every C_out with four input
# channels, and fewer input channels.
STENCIL_MC_CHANNELS = [(4, 1), (4, 2), (4, 3), (4, 4), (1, 4), (2, 3), (3, 2)]


def _stencil_mc_table(c_out, c_in, rh, rw, density, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((c_out, c_in, 2 * rh + 1, 2 * rw + 1)).astype(np.float32)
    if density < 1.0:
        w[rng.random(w.shape) >= density] = 0.0
        if c_out > 1:
            w[c_out - 1] = 0.0  # an output channel with no terms
    return cuda_ops.LinearStencilOp(w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("hw", [(37, 71), (100, 264)])  # ragged; 16-byte rows, ragged tiles
@pytest.mark.parametrize("density", [1.0, 0.5])
@pytest.mark.parametrize("rh,rw", [(1, 1), (2, 2), (2, 3), (3, 3)])
def test_stencil_apply_mc_run_forms(rh, rw, density, hw, mode, dtype, monkeypatch):
    """Each run form against the plain version and against the general
    form, forced: bit-equal (each output adds its terms in the table's
    order from -0; an output channel with no terms is +0)."""
    x4 = _image((4, *hw), 21 + rh + rw).to(dtype)
    for c_in, c_out in STENCIL_MC_CHANNELS:
        op = _stencil_mc_table(c_out, c_in, rh, rw, density, 10 * c_in + c_out)
        x = x4[:c_in].contiguous()
        form = cuda_ops.choose_stencil_mc_form(op)[0]
        assert form == ("run" if density == 1.0 else "run_masked")
        before = cuda_ops.LAUNCHES["stencil_apply_mc"]
        got = cuda_ops.stencil_apply_mc(x, op, mode)
        with monkeypatch.context() as m:
            m.setattr(cuda_ops, "choose_stencil_mc_form", lambda op: (
                "shared", *cuda_ops.choose_stencil_mc_tile(op.c_in, op.rh, op.rw, op.n_terms,
                                                           op.c_out)))
            general = cuda_ops.stencil_apply_mc(x, op, mode)
        want = cuda_ops.stencil_apply_mc_plain(x, op, mode)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES["stencil_apply_mc"] == before + 2
        assert got.dtype == dtype and torch.equal(_bits(got), _bits(want)), (c_in, c_out, form)
        assert torch.equal(_bits(got), _bits(general)), (c_in, c_out, form)


def _bits(t):
    """The tensor's bit patterns (so that -0 and +0 differ)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def test_the_gpu_readout_is_the_frames_device_time(tmp_path):
    """The live loop's "GPU:" readout (``Engine.last_gpu_times``) after a
    few frames lies between the frame's kernel time (CUDA events around ten
    back-to-back calls of the program, less a tenth for the clock's jitter)
    and the wall time of a timed frame rendered and waited for."""
    import time

    from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG
    from reforge_tpu_torch.engine import GPU_TIME_EVERY, Engine, RenderInfo

    cfg = tmp_path / "flagship.rf"
    cfg.write_text(FLAGSHIP_CONFIG)
    h, w = 2160, 3840
    eng = Engine(RenderInfo(w, h, "cuda", config_path=str(cfg), shader_path=str(tmp_path),
                            has_input_image=True))
    eng.load_input(np.random.default_rng(7).integers(0, 256, (h, w, 4), dtype=np.uint8))
    for _ in range(5):
        eng.render_frame(0.0)
    assert set(eng.last_gpu_times) == {"graph"}
    x = eng._file_input()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        eng.program(x, 0.0)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end) / 10
    while eng.frames_rendered % GPU_TIME_EVERY:
        eng.render_frame(0.0)
    begin = time.perf_counter()
    eng.render_frame_blocking(0.0)
    wall_ms = (time.perf_counter() - begin) * 1e3
    gpu_ms = eng.last_gpu_times["graph"]
    assert 0.9 * kernel_ms <= gpu_ms <= wall_ms, (kernel_ms, gpu_ms, wall_ms)
    eng.close()


@pytest.mark.parametrize("hw, fmt", [((128, 256), "rgba32f"), ((2160, 3840), "rgba32f"),
                                     ((127, 255), "rgba16f")])  # the last: an odd H * W
@pytest.mark.parametrize("graph", ["flagship", "glsl_chain"])
def test_a_stacked_chunk_is_written_in_place(graph, hw, fmt):
    """A chunk of 8 from ``render_sequence(stack=True)``: each frame's strip
    kernel writes its slice, so the chunk's device work is the 8 launches
    and nothing else (no ``CatArrayBatchedCopy``, no copy), and the frames
    are bit-equal to single-frame renders at their times."""
    from torch.profiler import ProfilerActivity, profile

    from reforge_tpu_torch import benchmarks
    from reforge_tpu_torch.graph import program

    h, w = hw
    if graph == "flagship":
        prog, kernel = build_flagship(w, h, fmt, device="cuda"), "graph_strip_kernel"
    else:
        prog = benchmarks.build_program(benchmarks.GLSL_GRAPHS[graph], w, h, fmt, device="cuda",
                                        shader_path=benchmarks.SHADER_DIR)
        kernel = "graph_strip_mc_kernel"
    x = _image((4, h, w), 11).to(prog.storage_dtype)
    prog.render_sequence(x, 0.5, 1 / 30, 8, stack=True)  # plans and builds before the window
    torch.cuda.synchronize()
    before = dict(program.SEQUENCE_FRAMES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = prog.render_sequence(x, 0.5, 1 / 30, 8, stack=True)
        torch.cuda.synchronize()
    assert program.SEQUENCE_FRAMES == {"in_place": before["in_place"] + 8,
                                       "copied": before["copied"]}
    device = [ev.name for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False) and not ev.name.startswith("rf.")]
    assert len(device) == 8 and all(kernel in name for name in device), device
    for i in range(8):
        assert torch.equal(got[i], prog._forward(x, 0.5 + i * (1 / 30))), i


@pytest.mark.parametrize("hw", [(37, 71), (2160, 3840)])
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("shader", ["crt", "zoom", "glass"])
def test_graph_strip_mc_gather_form(shader, fmt, hw):
    """A shader that gathers its input (texture() at a computed point) as
    one graph_strip_mc launch of the gather form, against the plan's plain
    version on the CPU (point_program_plain, bit-equal there to the
    interpreter) in each storage format.  crt.frag and zoom.comp round as
    the CPU does; glass.comp's sinf and cosf differ from the CPU's by an
    ulp and move its refracted samples with them, past 1e-4 at a few
    pixels of a 4K frame (2e-4), so it is held, as the other storage
    formats are, by the share of values past a step."""
    from reforge_tpu_torch import benchmarks

    h, w = hw
    prog = benchmarks.build_program(f"input -> s -> output\ns: {shader} {{}}\n", w, h, fmt,
                                    device="cuda", shader_path=benchmarks.SHADER_DIR)
    assert prog._strip_plan[0] == "mc"
    mc = prog._strip_plan[1]
    geo = mc.geometry(*mc.tile()[:2])
    assert int(geo[9]) & 8 and int(geo[4]) == 0  # the gather form, no input block
    x = _image((4, h, w), 17)
    if fmt == "rgba8":
        x = torch.round(x * 255.0) / 255.0
    x = x.to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip_mc"]
    got = prog._forward(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == before + 1
    want = cuda_ops.graph_strip_mc_plain(x.cpu(), 0.5, mc)
    d = (got.float().cpu() - want.float()).abs()
    if fmt == "rgba32f" and shader != "glass":
        assert float(d.max()) <= 1e-6
    else:
        step = {"rgba32f": 1e-4, "rgba16f": 2e-2, "rgba8": 1.0 / 255.0 + 1e-6}[fmt]
        assert float((d > step).float().mean()) <= 1e-3, float(d.max())


def test_crt_tv_runs_two_launches_a_frame_written_in_place():
    """examples/crt_tv.rf at 4K: [seg mc: fade, soften] [seg mc: crt], so
    a stacked chunk of 8 is 16 graph_strip_mc launches and nothing else on
    the card (no copy: each frame in its slice), crt counted as an op
    list's run; the frames against per node (crt.frag in the
    interpreter)."""
    from torch.profiler import ProfilerActivity, profile

    from reforge_tpu_torch import benchmarks
    from reforge_tpu_torch.graph import program

    config = (benchmarks.EXAMPLES_DIR / "crt_tv.rf").read_text()
    prog = benchmarks.build_program(config, 3840, 2160, device="cuda",
                                    shader_path=benchmarks.SHADER_DIR)
    assert benchmarks.plan_steps(prog) == [("seg mc", ["fade", "soften"]), ("seg mc", ["crt"])]
    x = _image((4, 2160, 3840), 19)
    prog.render_sequence(x, 0.5, 1 / 30, 8, stack=True)
    torch.cuda.synchronize()
    frames0, runs0 = dict(program.SEQUENCE_FRAMES), dict(program.GLSL_GATHER_RUNS)
    launches = cuda_ops.LAUNCHES["graph_strip_mc"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = prog.render_sequence(x, 0.5, 1 / 30, 8, stack=True)
        torch.cuda.synchronize()
    assert program.SEQUENCE_FRAMES == {"in_place": frames0["in_place"] + 8,
                                       "copied": frames0["copied"]}
    assert program.GLSL_GATHER_RUNS == {"op_list": runs0["op_list"] + 8,
                                        "interpreter": runs0["interpreter"]}
    device = [ev.name for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False) and not ev.name.startswith("rf.")]
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == launches + 16
    assert device and all("graph_strip_mc_kernel" in n for n in device), device
    per_node, _ms = prog.run_per_node(x, 0.5 + 3 / 30)
    d = (got[3] - per_node).abs()
    assert float((d > 1e-5).float().mean()) <= 1e-3, float(d.max())
