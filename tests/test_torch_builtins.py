"""The rest of the builtin library through the PyTorch port against the JAX
package, on the CPU: the 25 builtins this slice adds (all but ``lut1d``),
their channel forms and device forms, the registry, the two check graphs
of the strip tiers and the six graphs (film look, old film, pop art,
psychedelic, neon edges, frost) in three formats.

The JAX side runs its jnp per-node path (``_forward_nostrip``; on the CPU
``pallas_available()`` is false).  Configs resolve no shader path:
shaders/tonemap.comp, vignette.comp and sobel.comp would replace the
builtins of those names.
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
from reforge_tpu.kernels import base as jbase
from reforge_tpu.kernels import library as jlibrary
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    CW_CHECK_CONFIG, LIBRARY_GRAPHS, MC_CHECK_CONFIG, build_program,
)
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.graph import build_graph, graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops, library
from reforge_tpu_torch.kernels.base import KernelContext, builtin_kernels
from reforge_tpu_torch.kernels.ops import pixel_coords

FORMATS = ("rgba32f", "rgba16f", "rgba8")
H, W = 48, 128
T = 0.2137
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _image(h=H, w=W, seed=8):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


# Params of each new builtin under test (the examples' values where they
# use it).
NEW_BUILTINS = {
    "invert": "", "exposure": "stops: 0.7", "gamma": "value: 1.8",
    "brightness_contrast": "brightness: 0.05, contrast: 1.3",
    "white_balance": "temperature: 0.08, tint: -0.05", "posterize": "levels: 5",
    "dither": "levels: 3", "scanlines": "period: 3, darkness: 0.2", "add": "scale: 0.4",
    "multiply": "", "screen": "", "overlay": "", "difference": "", "sepia": "amount: 0.85",
    "hue_saturation": "hue: 40.0, saturation: 1.6, lightness: 0.03", "box_blur": "radius: 5",
    "pixelate": "size: 6", "chromatic_aberration": "shift: 4.0",
    "swirl": "angle: 1.2, radius: 0.6", "wave": "amplitude: 10.0, frequency: 0.03, speed: 1.5",
    "flip": "horizontal: true, vertical: true", "motion_blur": "length: 6.0, angle: 85.0",
    "radial_blur": "strength: 0.08, samples: 10", "checkerboard": "size: 8",
    "solid": "red: 0.2, green: 0.4, blue: 0.6, alpha: 0.9",
}
TWO_INPUTS = {"add", "multiply", "screen", "overlay", "difference"}
GENERATORS = {"checkerboard", "solid"}
# rgba32f bounds where the two packages' math libraries differ (every other
# builtin runs the same operations in the same order: bit-equal):
#   gamma: pow by one ulp (PARITY.md: 1 ulp for a single expression);
#   hue_saturation: XLA's einsum contracts its sums into FMAs (compound:
#     4 ulp of 1.0);
#   swirl: sin and cos by an ulp, which moves the bilinear sample a
#     fraction of 1e-5 px (measured 5.4e-6).
TOL32 = {"gamma": EPS, "hue_saturation": 4 * EPS, "swirl": 1e-5}


def _one_node(name):
    params = NEW_BUILTINS[name]
    if name in GENERATORS:
        return f"n -> output\nn: {name} {{ {params} }}"
    if name in TWO_INPUTS:
        return (f"input -> n -> output\ninput -> f -> n:input_image2\nf: flip {{ }}\n"
                f"n: {name} {{ {params} }}")
    return f"input -> n -> output\nn: {name} {{ {params} }}"


def _storage_input(x, fmt):
    if fmt == "rgba16f":
        return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _assert_fmt(got, want, fmt, tol32=0.0):
    """rgba32f within ``tol32``; rgba16f and rgba8 exact but where an ulp
    before the store flips a bf16 rounding or a 1/255 bucket: one storage
    step, on fewer than 1e-3 of the values."""
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    if fmt == "rgba32f":
        assert d.max() <= tol32, d.max()
        return
    if tol32 == 0.0:
        assert d.max() == 0.0, d.max()
        return
    step = 2.0 ** -8 if fmt == "rgba16f" else 1.0 / 255.0 + 1e-6
    assert d.max() <= step and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(NEW_BUILTINS))
def test_builtin_matches_jax(name, fmt):
    """Each new builtin's fn, per node, against the JAX builtin."""
    config = _one_node(name)
    jprog = JProgram(jbuild(jparse(config, expects_input=name not in GENERATORS)), W, H, fmt)
    x = _storage_input(_image(), fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    graph = graph_from_reference(jprog.graph)
    assert graph.nodes["n"].params == jprog.graph.nodes["n"].params
    prog = make_program(graph, W, H, fmt, device="cpu")
    out = prog._forward_nostrip(torch.from_numpy(x.copy()), T)
    assert out.dtype == prog.storage_dtype and tuple(out.shape) == (4, H, W)
    _assert_fmt(out.float().numpy(), want, fmt, TOL32.get(name, 0.0))


def test_registry_matches_the_reference():
    """The port registers every reference builtin, with its params and
    buffer bindings.  Every reference builtin with a channel form has a
    cw_op in the port; every one of halo 0 with an image input and no
    buffer (the reference's mc point stages, program.py:512-529 there; its
    planners refuse buffer nodes) has an mc_op."""
    ref = jbase.builtin_kernels()
    port = builtin_kernels()
    assert set(port) == set(ref) and len(port) == 47
    for name, spec in port.items():
        rspec = ref[name]
        assert spec.images_in == rspec.images_in, name
        assert {k: (d.kind.value, d.default) for k, d in spec.params.items()} == {
            k: (d.kind.value, d.default) for k, d in rspec.params.items()}, name
        defaults = {k: d.default for k, d in spec.params.items()}
        assert spec.halo_for(defaults) == rspec.halo_for(defaults), name
        if rspec.cw_fn is not None:
            assert spec.cw_fn is not None and spec.cw_op is not None, name
        assert (spec.ssbos_in, spec.ssbos_out, spec.ssbo_sizes) == (
            rspec.ssbos_in, rspec.ssbos_out, rspec.ssbo_sizes), name
        if rspec.halo_for(defaults) == 0 and rspec.images_in and not rspec.ssbos_in:
            assert spec.mc_op is not None, name
        for form in ("conv_weights", "conv_epilogue", "conv_epilogue_cw", "conv_pre",
                     "cw_coord_plane", "cw_plane_fn", "mc_stencil_fn"):
            assert (getattr(spec, form) is None) == (getattr(rspec, form, None) is None), (
                name, form)


# ---- channel and device forms ---------------------------------------------------------

CHANNEL_BUILTINS = {
    "invert": {}, "exposure": {"stops": 0.7}, "gamma": {"value": 1.8},
    "brightness_contrast": {"brightness": 0.05, "contrast": 1.3},
    "white_balance": {"temperature": 0.08, "tint": -0.05}, "posterize": {"levels": 5},
    "dither": {"levels": 3}, "scanlines": {"period": 3, "darkness": 0.2},
    "add": {"scale": 0.4}, "multiply": {}, "screen": {}, "overlay": {}, "difference": {},
    "levels": {"in_black": 0.05, "in_white": 0.95, "gamma": 1.2, "out_black": 0.02,
               "out_white": 0.97},
}


def _forms_case(name, params):
    spec = library.__dict__[name]
    full = {k: d.default for k, d in spec.params.items()}
    full.update(params)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, (4, 24, 40)).astype(np.float32))
    x2 = torch.from_numpy(rng.random((4, 24, 40), dtype=np.float32))
    ctx = KernelContext(width=40, height=24, time=T, device="cpu")
    ins = {d: {"input_image": x, "input_image2": x2}[d] for d in spec.images_in}
    want = spec(ctx, ins, full)["output_image"]
    return spec, full, ctx, ins, x, x2, want


@pytest.mark.parametrize("name", sorted(CHANNEL_BUILTINS))
def test_channel_forms_match_fn(name):
    """cw_fn (and cw_plane_fn over the hoisted plane) over all channels at
    once equal the builtin's fn bit for bit."""
    spec, params, ctx, ins, _x, _x2, want = _forms_case(name, CHANNEL_BUILTINS[name])
    ci = torch.arange(4).view(4, 1, 1)
    assert torch.equal(spec.cw_fn(ctx, ci, ins, params), want)
    if spec.cw_coord_plane is not None:
        plane = spec.cw_coord_plane(ctx, params)
        assert torch.equal(spec.cw_plane_fn(ctx, ci, ins, params, plane), want)


@pytest.mark.parametrize("name", sorted(CHANNEL_BUILTINS))
def test_device_forms_match_fn(name):
    """The plain evaluation of the builtin's cw_op and mc_op (what
    graph_strip and graph_strip_mc compute for it, operation by operation)
    equals its fn bit for bit, on values outside [0, 1] too."""
    spec, params, _ctx, _ins, x, x2, want = _forms_case(name, CHANNEL_BUILTINS[name])
    ys, xs = pixel_coords(24, 40, "cpu")
    code, cw_params = spec.cw_op(params, False)
    assert len(cw_params) <= cuda_ops.STRIP_OP_FLOATS
    op = cuda_ops.CHANNEL_OPS[code - cuda_ops.OP_CH0]
    rgb = cuda_ops.channel_op_plain(op, x[:3], x2[:3], list(cw_params), ys, xs)
    assert torch.equal(torch.cat([rgb, x[3:4]]), want)
    mc = spec.mc_op(params)
    assert cuda_ops.mc_kind(mc.code) == cuda_ops.MC_POINT and len(mc.params) <= 4
    assert mc.code - cuda_ops.MC_CH0 == code - cuda_ops.OP_CH0
    assert torch.equal(cuda_ops.mc_point_plain(mc, x, x2, ys, xs), want)


@pytest.mark.parametrize("name,params", [
    ("sepia", {"amount": 0.85}),
    ("hue_saturation", {"hue": 40.0, "saturation": 1.6, "lightness": 0.03}),
    ("hue_saturation", {"hue": 0.0}),  # zero matrix entries, dropped from the table
])
def test_mixing_device_forms_match_fn(name, params):
    spec, params, _ctx, _ins, x, x2, want = _forms_case(name, params)
    ys, xs = pixel_coords(24, 40, "cpu")
    mc = spec.mc_op(params)
    assert cuda_ops.mc_kind(mc.code) == cuda_ops.MC_POINT and len(mc.params) <= 4
    assert torch.equal(cuda_ops.mc_point_plain(mc, x, None, ys, xs), want)


def test_hue_matrix_and_bayer_match_the_reference():
    for hue in (0.0, 40.0, 120.0, -75.5):
        np.testing.assert_array_equal(library.hue_rotate_matrix(hue),
                                      jlibrary._hue_rotate_matrix(hue))
    ys, xs = pixel_coords(8, 8, "cpu")
    table = torch.from_numpy(library.BAYER4)[(ys % 4).long(), (xs % 4).long()]
    assert torch.equal(cuda_ops.bayer4(ys, xs), table)


def test_box_blur_conv_forms():
    spec, params, ctx, ins, x, _x2, want = _forms_case("box_blur", {"radius": 3})
    wh, ww = spec.conv_weights(params)
    blurred = cuda_ops.sep_conv_fused(x, wh, ww)
    assert torch.equal(spec.conv_epilogue(ctx, x, blurred, params), want)
    ci = torch.arange(4).view(4, 1, 1)
    assert torch.equal(spec.conv_epilogue_cw(ctx, ci, x, blurred, params), want)
    assert spec.conv_weights({"radius": 0}) is None
    assert spec.mc_op({"radius": 0}).code == cuda_ops.MC_COPY
    assert spec.mc_op(params).code == cuda_ops.MC_CONV_IDENTITY


# ---- the check graphs of the strip tiers -------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("config,tier", [(CW_CHECK_CONFIG, "single"), (MC_CHECK_CONFIG, "mc")])
def test_check_graphs_tier_matches_jax_per_node(config, tier, fmt):
    """Every channel-local builtin in one graph_strip plan, and every new mc
    point op in one graph_strip_mc plan, through the tier's plain version
    against the JAX package per node.  Bounds: gamma's and levels' pow and
    hue_saturation's FMAs move rgba32f by a few ulp (1e-6); an ulp before
    a store flips a bf16 rounding or a 1/255 bucket, and a flip carries
    through the later nodes (gains up to 1.6): two storage steps, on fewer
    than 1e-3 of the values."""
    jprog = JProgram(jbuild(jparse(config, expects_input=True)), W, H, fmt)
    x = _storage_input(_image(seed=9), fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    prog = make_program(graph_from_reference(jprog.graph), W, H, fmt, device="cpu")
    assert prog._strip_plan[0] == tier
    got = prog._forward(torch.from_numpy(x.copy()), T).float().numpy()
    d = np.abs(got - want)
    if fmt == "rgba32f":
        assert d.max() <= 1e-6, d.max()
    else:
        step = 2.0 ** -8 if fmt == "rgba16f" else 1.0 / 255.0 + 1e-6
        assert d.max() <= 2 * step and (d > 1e-6).mean() < 1e-3, (d.max(), (d > 1e-6).mean())


def test_check_graph_plans_hold_every_new_op():
    cw = build_program(CW_CHECK_CONFIG, W, H, device="cpu")
    prog = cw._build_strip_program()
    codes = {op.code for op in prog.ops}
    assert {cuda_ops.OP_CH0 + k for k in range(len(cuda_ops.CHANNEL_OPS))} - codes == {
        cuda_ops.OP_CH0 + cuda_ops.CH["scanlines"]}  # hoisted: scanlines multiplies by its plane
    assert cuda_ops.OP_FADE_PLANE in codes and prog.aux.shape == (1, H, W)
    mc = build_program(MC_CHECK_CONFIG, W, H, device="cpu")._strip_plan[1]
    codes = {st.op.code for st in mc.stages}
    assert set(range(cuda_ops.MC_CH0, cuda_ops.MC_HUE_SAT + 1)) <= codes
    hue = next(st for st in mc.stages if st.op.code == cuda_ops.MC_HUE_SAT)
    assert hue.kind == cuda_ops.MC_POINT and np.shape(hue.taps[0]) == (3, 3)
    stage_i, _f, _s, _t = mc.packed(*mc.tile()[:2])
    row = stage_i[mc.stages.index(hue)]
    assert row[18] == 9  # the matrix's nine nonzero terms ride in tap list 0


# ---- the six graphs ---------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_program(name, fmt, h=H, w=W):
    return JProgram(jbuild(jparse(LIBRARY_GRAPHS[name], expects_input=True)), w, h, fmt)


def _assert_graph(got, want, fmt):
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
        # the flip can cascade through one more quantized node.
        assert d.max() <= 2.0 / 255.0 + 1e-6, d.max()
        assert (d > 1.0 / 512.0).mean() < 1e-3


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(LIBRARY_GRAPHS))
def test_library_graph_matches_jax(name, fmt):
    """Each graph on the port's tier (mc for neon edges, per node for the
    rest) and per node against the JAX package per node."""
    jprog = _jax_program(name, fmt)
    x = _storage_input(_image(seed=11), fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    prog = make_program(graph_from_reference(jprog.graph), W, H, fmt, device="cpu")
    out = prog._forward(torch.from_numpy(x.copy()), T)
    assert out.dtype == prog.storage_dtype and tuple(out.shape) == (4, H, W)
    _assert_graph(out.float().numpy(), want, fmt)
    per_node, times = prog.run_per_node(torch.from_numpy(x.copy()), T)
    assert set(times) == set(jprog.graph.nodes)
    _assert_graph(per_node.float().numpy(), want, fmt)


@pytest.mark.parametrize("name", sorted(LIBRARY_GRAPHS))
def test_graph_from_reference_carries_library_graphs(name):
    """Params, wiring and layers carry over, and the port's own parser
    builds the same graph."""
    jgraph = _jax_program(name, "rgba32f").graph
    for ported in (graph_from_reference(jgraph),
                   build_graph(tconfig.parse(LIBRARY_GRAPHS[name], expects_input=True))):
        assert set(ported.nodes) == set(jgraph.nodes)
        for node_name, node in ported.nodes.items():
            ref = jgraph.nodes[node_name]
            assert node.spec.name == ref.spec.name and node.params == ref.params
            assert node.inputs == ref.inputs and node.outputs == ref.outputs
        assert [[n.name for n in layer] for layer in ported.layers] == [
            [n.name for n in layer] for layer in jgraph.layers]


# The reference's tiers at 3840x2160 (its planner on the CPU) and the
# port's: neon edges runs as segments there (its wide-frame conv gate), and
# takes the port's mc tier (one kernel) since a plan fits; the others hold
# no node range that a strip tier takes (a range of point nodes alone has no
# halo work to share; gathers and noise have no device form), so the
# port's segments tier plans nothing for them either.
REFERENCE_TIERS = {"film_look": None, "old_film": None, "pop_art": None, "psychedelic": None,
                   "neon_edges": "segments", "frost": None}


@pytest.mark.parametrize("name", sorted(LIBRARY_GRAPHS))
def test_library_graph_tiers(name):
    jplan = _jax_program(name, "rgba32f", 2160, 3840)._strip_plan
    assert (jplan[0] if jplan else None) == REFERENCE_TIERS[name]
    for fmt in FORMATS:
        plan = build_program(LIBRARY_GRAPHS[name], 3840, 2160, fmt, device="cpu")._strip_plan
        assert (plan[0] if plan else None) == ("mc" if name == "neon_edges" else None)


@pytest.mark.parametrize("name", ["psychedelic", "neon_edges", "frost"])
def test_library_graph_through_engine(tmp_path, name):
    """One-shot (u8 in and out) and the frame path agree, and match the JAX
    engine's one-shot within one code (its sRGB pow may differ by an
    ulp)."""
    from reforge_tpu.engine import Engine as JEngine
    from reforge_tpu.engine import RenderInfo as JRenderInfo

    cfg = tmp_path / f"{name}.rf"
    cfg.write_text(LIBRARY_GRAPHS[name])
    shaders = tmp_path / "shaders"
    shaders.mkdir()  # shaders/sobel.comp would replace the builtin
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
    assert np.abs(engine.read_output(engine.render_frame(0.25)).astype(int)
                  - got.astype(int)).max() <= (1 if name == "neon_edges" else 0)
