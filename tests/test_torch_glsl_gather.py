"""GLSL shaders that read images at computed points (halo None:
``texture()``, a computed ``imageLoad``) as op lists on the mc tier of the
PyTorch port, on the CPU.

Such a read is a GATHER op (glsl/lower.py): a channel of an input image at
a per-pixel integer point, after the interpreter's own clamps and bounds
tests, which are ops of the list.  The op list's plain version is held bit
for bit to the interpreter (crt.frag, zoom.comp, glass.comp at odd sizes
and frame times, the ``texture()`` edge fault that test_torch_texture.py
pins, ``imageLoad``'s zeros out of bounds); a plan may gather only its
own input, so a shader that gathers an image the same launch writes splits
the graph into segments; every op list and plan that lowered before
gathers did packs to the same words; crt_tv runs through Engine like the
JAX package per node, two launches a frame, written in place, counted by
``GLSL_GATHER_RUNS``.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    EXAMPLES_DIR, PORT_SHADER_DIR, REPO_DIR, SHADER_DIR, build_program, plan_steps, point_graphs,
)
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.glsl import affine, interp, lower, translate_shader
from reforge_tpu_torch.graph import program as tprogram
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.base import KernelContext
from reforge_tpu_torch.parallel import HaloShardedProgram, make_row_mesh

from test_torch_glsl_graph import H as ENGINE_H
from test_torch_glsl_graph import W as ENGINE_W
from test_torch_glsl_graph import _check as _engine_check
from test_torch_glsl_graph import _render_both, _u8
from test_torch_texture import EDGE_SHADER

SIZES = [(37, 53), (72, 128)]
TIMES = [0.0, 0.37, 17.25]
GATHER_SHADERS = {"crt": "crt.frag", "zoom": "zoom.comp", "glass": "glass.comp"}

# A computed imageLoad: a point twice as far along x and moved along y by
# the pixel's red, out of bounds for about half the pixels (zeros there).
IMAGE_LOAD_SHADER = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    ivec2 q = ivec2(pos.x * 2 - size.x / 2, pos.y + int(c.r * 9.0) - 4);
    vec4 g = imageLoad(input_image, q);
    imageStore(output_image, pos, vec4(g.rgb, c.a));
}
"""

# The digests of every op list and mc plan that lowered before gathers did
# (``_digest`` of the words, ``_plan_digest``): the shipped shaders' packed words
# at their default params, and the point graphs' whole launch data, each at
# 48x128 and 3840x2160; and the glsl_chain_4k benchmark cell's plan.
PACKED = {
    "bits@128x48": "9a5b2e6ff7c98918",
    "bits@3840x2160": "9a5b2e6ff7c98918",
    "blend@128x48": "8e900f7fd70ce9d7",
    "blend@3840x2160": "8e900f7fd70ce9d7",
    "composite3@128x48": "53ad8f57e5b09c34",
    "composite3@3840x2160": "53ad8f57e5b09c34",
    "hash@128x48": "e674b99011298f22",
    "hash@3840x2160": "e674b99011298f22",
    "invert@128x48": "e79fffff80d813aa",
    "invert@3840x2160": "e79fffff80d813aa",
    "iterate@128x48": "24990884e86a3c33",
    "iterate@3840x2160": "24990884e86a3c33",
    "mandelbrot@128x48": "70c1bc40254fdddf",
    "mandelbrot@3840x2160": "2e3e2620b221a5d9",
    "passthrough@128x48": "3491568f4986a316",
    "passthrough@3840x2160": "3491568f4986a316",
    "sepia@128x48": "20ae91f904794d12",
    "sepia@3840x2160": "20ae91f904794d12",
    "tonemap@128x48": "53f08be1728f172b",
    "tonemap@3840x2160": "53f08be1728f172b",
    "vignette@128x48": "7531a1ea5f273ba9",
    "vignette@3840x2160": "5fb6326d19b9ed24",
    "wide@128x48": "80aee9b439e6b47f",
    "wide@3840x2160": "80aee9b439e6b47f",
}
PLANS = {
    "bits_after_blur@128x48": "72441747007b622b",
    "bits_after_blur@3840x2160": "72441747007b622b",
    "bloom_glow@128x48": "per-node",
    "bloom_glow@3840x2160": "per-node",
    "blur_sharpen_blend@128x48": "d06003873ae1d13d",
    "blur_sharpen_blend@3840x2160": "d06003873ae1d13d",
    "composite3@128x48": "a93df89e47d2a3b4",
    "composite3@3840x2160": "a93df89e47d2a3b4",
    "composite3_raw_mask@128x48": "75ed53bfd31d747b",
    "composite3_raw_mask@3840x2160": "75ed53bfd31d747b",
    "glsl_chain@128x48": "5feda55930cbdcfe",
    "glsl_chain@3840x2160": "5feda55930cbdcfe",
    "glsl_sharpen@128x48": "596b4e615665c756",
    "glsl_sharpen@3840x2160": "596b4e615665c756",
    "hash_after_blur@128x48": "7f4cca27302925fc",
    "hash_after_blur@3840x2160": "7f4cca27302925fc",
    "iterate_after_blur@128x48": "16019bdf47fd1578",
    "iterate_after_blur@3840x2160": "16019bdf47fd1578",
    "mandelbrot_after_blur@128x48": "49b392a5f43d3d71",
    "mandelbrot_after_blur@3840x2160": "3a055c9accb8d0b4",
    "mixed_border@128x48": ["86ef101c704709b8", "node"],
    "mixed_border@3840x2160": ["86ef101c704709b8", "node"],
    "tonemap_sharpen@128x48": "b899b4073a2858dd",
    "tonemap_sharpen@3840x2160": "b899b4073a2858dd",
    "wide_after_blur@128x48": "86b462a8581859e0",
    "wide_after_blur@3840x2160": "86b462a8581859e0",
    "zero_border@128x48": "d9393a0e258e8348",
    "zero_border@3840x2160": "d9393a0e258e8348",
}
GLSL_CHAIN_CELL = "5feda55930cbdcfe"


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()[:16]


def _plan_digest(mc) -> str:
    th, tw, _smem = mc.tile()
    stage_i, stage_f, _s, _t = mc.packed(th, tw)
    return _digest(mc.taps, mc.term_idx, stage_i, stage_f, mc.geometry(th, tw),
                   mc.glsl_inputs(th, tw), np.asarray(mc.tile()))


@pytest.fixture(autouse=True)
def _quiet_and_fresh(tmp_path, monkeypatch):
    tutils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    monkeypatch.setattr(tprogram, "_PROGRAMS", {})
    monkeypatch.setattr(tprogram, "_NODE_CHECKS", {})
    affine._SYNTH_CACHE.clear()
    yield
    affine._SYNTH_CACHE.clear()


def _spec(path):
    with open(path) as f:
        src = f.read()
    return translate_shader(src, os.path.basename(path).split(".")[0], path=path)


def _interp_and_plain(spec, params, prog, h, w, t, seed=3):
    rng = np.random.default_rng(seed)
    ins = [torch.from_numpy(rng.random((4, h, w), dtype=np.float32)) for _ in spec.images_in]
    ctx = KernelContext(width=w, height=h, time=t, device="cpu")
    want = spec(ctx, dict(zip(spec.images_in, ins)), params)["output_image"]
    gy = torch.arange(h).view(-1, 1).expand(h, w)
    gx = torch.arange(w).view(1, -1).expand(h, w)
    return lower.point_program_plain(prog, ins, gy, gx, t), want, ins


def _gathers(prog) -> int:
    return sum(op == lower.K["GATHER"] for op, *_ in prog.ops)


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("stem", sorted(GATHER_SHADERS))
def test_gather_lists_are_bit_equal_to_the_interpreter(stem, size, t):
    """crt.frag, zoom.comp and glass.comp lower with GATHER ops (twelve or
    sixteen: four corners of each colour channel texture() reads), flag
    their packed header for the gather forms, and their plain version is
    bit-equal to the interpreter at odd sizes and frame times, with the
    defaults and a second set of params."""
    h, w = size
    spec = _spec(os.path.join(SHADER_DIR, GATHER_SHADERS[stem]))
    other = {name: {"FLOAT": 0.7, "INT": 3, "BOOL": True}[d.kind.name]
             for name, d in spec.params.items() if not name.startswith("_")}
    for params in (spec.resolve_params({}), spec.resolve_params(other)):
        prog = lower.lower_point(spec, params, w, h)
        assert isinstance(prog, lower.PointProgram), prog
        assert prog.gathers == ("input_image",) and prog.images == ("input_image",)
        assert _gathers(prog) in (12, 16)
        assert prog.packed()[lower.HEAD_INTS - 1] & 8
        assert lower.pixel_reads(prog.packed()) == set()  # the input only at computed points
        plain, want, _ins = _interp_and_plain(spec, params, prog, h, w, t)
        np.testing.assert_array_equal(plain.numpy(), want.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_the_texture_edge_fault_is_the_interpreters(seed):
    """test_torch_texture.py's shader (a quarter texel past the first
    row's and column's centres, one coordinate a constant) lowers, its
    constant point a GATHER operand, and keeps the inherited fault bit for
    bit: row 0 blended with row 1 at weight 0.75."""
    spec = translate_shader(EDGE_SHADER, "texture_edge")
    h, w = 24, 40
    prog = lower.lower_point(spec, {}, w, h)
    assert isinstance(prog, lower.PointProgram), prog
    consts = [refs[2:] for op, _t, _d, refs in prog.ops if op == lower.K["GATHER"]]
    assert any(r < 0 for pair in consts for r in pair)  # a constant row or column
    plain, want, ins = _interp_and_plain(spec, {}, prog, h, w, 0.0, seed)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    x = ins[0].double().numpy()
    top_r = x[0, 0] + (x[0, 1] - x[0, 0]) * 0.75
    np.testing.assert_allclose(plain[0].double().numpy(), np.broadcast_to(top_r, (h, w)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_image_load_gathers_zeros_out_of_bounds(size, tmp_path):
    """A computed imageLoad's general gather (clamped indices, zeros out of
    bounds): the list carries the bounds test and the select, and reads
    zeros where the point leaves the image, bit-equal to the
    interpreter."""
    h, w = size
    path = tmp_path / "far.comp"
    path.write_text(IMAGE_LOAD_SHADER)
    spec = _spec(str(path))
    assert spec.halo_for({}) is None
    prog = lower.lower_point(spec, {}, w, h)
    assert isinstance(prog, lower.PointProgram), prog
    assert _gathers(prog) == 3 and lower.pixel_reads(prog.packed()) == {0}
    plain, want, _ins = _interp_and_plain(spec, {}, prog, h, w, 0.0)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    xs = 2 * torch.arange(w) - w // 2
    outside = (xs < 0) | (xs >= w)
    assert bool((plain[:3, :, outside] == 0).all()) and 0 < int(outside.sum()) < w


def test_gathers_that_stay_refused(tmp_path):
    """A gather of a plane the shader computed, a gather inside a loop
    region (flow_field.comp) and per-lane array indexing
    (kuwahara.comp) stay refused, each with its reason."""
    path = tmp_path / "computed.comp"
    path.write_text(IMAGE_LOAD_SHADER.replace(
        "    vec4 g = imageLoad(input_image, q);\n",
        "    imageStore(output_image, pos, c * 2.0);\n"
        "    vec4 g = imageLoad(output_image, q);\n").replace(
        "writeonly image2D output_image", "image2D output_image"))
    got = lower.lower_point(_spec(str(path)), {}, 53, 37)
    assert isinstance(got, str) and "not an input image's channel" in got
    spec = _spec(os.path.join(SHADER_DIR, "flow_field.comp"))
    assert lower.lower_point(spec, spec.resolve_params({}), 53, 37) == \
        "a gather inside a loop region"
    spec = _spec(os.path.join(SHADER_DIR, "kuwahara.comp"))
    assert lower.lower_point(spec, spec.resolve_params({}), 53, 37) == "per-lane array indexing"


def test_a_gather_of_an_image_the_plan_writes_splits_the_graph():
    """zoom.comp after a conv gathers an image the conv's launch would
    write: no whole-graph plan, and the graph runs as two segments, the
    conv's and zoom's own (its gather of the segment's input).  Before a
    conv, zoom gathers the graph's input: one launch, zoom's stage computed
    over the conv's halo (a narrow one: the tier rule refuses the recompute
    of zoom's list over sigma 2's); both plans' frames equal per node."""
    h, w = 37, 53
    split = ("input -> tm -> gs -> z -> output\ntm: tonemap {}\ngs: gaussian { sigma: 2.0 }\n"
             "z: zoom { zoom: 1.7 }\n")
    prog = build_program(split, w, h, device="cpu", shader_path=SHADER_DIR)
    assert prog._plan_strip_mc() is None
    assert plan_steps(prog) == [("seg mc", ["tm", "gs"]), ("seg mc", ["z"])]
    whole = "input -> z -> gs -> output\nz: zoom { zoom: 1.7 }\ngs: gaussian { sigma: 0.8 }\n"
    prog2 = build_program(whole, w, h, device="cpu", shader_path=SHADER_DIR)
    assert plan_steps(prog2) == [("mc", ["z", "gs"])]
    mc = prog2._strip_plan[1]
    assert mc.input_halo == h and mc.geometry(*mc.tile()[:2])[4] == 0  # no input block
    glsl = next(st for st in mc.stages if st.op.code == cuda_ops.MC_GLSL)
    assert glsl.eh > 0 and glsl.ew > 0  # over the conv's halo
    x = torch.from_numpy(np.random.default_rng(4).random((4, h, w), dtype=np.float32))
    for p in (prog, prog2):
        got = p._forward(x, 0.3)
        want, _ms = p.run_per_node(x, 0.3)
        assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("key", sorted(PACKED))
def test_every_list_that_lowered_before_packs_to_the_same_words(key):
    stem, size = key.split("@")
    w, h = map(int, size.split("x"))
    files = {os.path.basename(p).split(".")[0]: p for d in (SHADER_DIR, PORT_SHADER_DIR)
             for p in (os.path.join(d, f) for f in os.listdir(d))}
    spec = _spec(files[stem])
    prog = lower.lower_point(spec, spec.resolve_params({}), w, h)
    assert isinstance(prog, lower.PointProgram), prog
    assert _digest(prog.packed()) == PACKED[key]
    assert not prog.packed()[lower.HEAD_INTS - 1] & 8


@pytest.mark.parametrize("key", sorted(PLANS))
def test_every_point_graph_plans_the_same_launch(key):
    """The point graphs (benchmarks.point_graphs: glsl_chain, the loop and
    reach graphs among them) plan what they planned before gathers: the
    same stage ints, taps, op lists, geometry and tile."""
    name, size = key.split("@")
    w, h = map(int, size.split("x"))
    config, shader_dir = point_graphs()[name]
    plan = build_program(config, w, h, device="cpu", shader_path=shader_dir)._strip_plan
    if plan is None:
        got = "per-node"
    elif plan[0] == "mc":
        got = _plan_digest(plan[1])
    else:
        got = [_plan_digest(s[1]._strip_plan[1]) if s[0] == "seg" else s[0] for s in plan[1]]
    assert got == PLANS[key]


def test_the_glsl_chain_cell_packs_the_same_launch():
    """The glsl_chain_4k benchmark cell's plan (its frozen shaders at 4K)
    is the launch it was before gathers: the same kernel form's data."""
    d = REPO_DIR / "perfbench" / "configs" / "glsl_chain_4k"
    prog = build_program((d / "graph.rf").read_text(), 3840, 2160, device="cpu",
                         shader_path=str(d / "shaders"))
    assert prog._strip_plan[0] == "mc"
    mc = prog._strip_plan[1]
    assert not mc._gather and int(mc.geometry(*mc.tile()[:2])[9]) & 8 == 0
    assert _plan_digest(mc) == GLSL_CHAIN_CELL


def _crt_engine(fmt="rgba32f"):
    engine = Engine(RenderInfo(ENGINE_W, ENGINE_H, "cpu", fmt=fmt, has_input_image=True,
                               config_path=str(EXAMPLES_DIR / "crt_tv.rf"),
                               shader_path=SHADER_DIR))
    engine.load_input(_u8(5))
    return engine


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
def test_crt_tv_through_engine_like_jax_and_per_node(fmt, tmp_path, monkeypatch):
    """examples/crt_tv.rf through the port's Engine (two segments, crt's an
    op list with gathers) against the JAX Engine per node, and against the
    port's own per-node frame (run_per_node: crt.frag in the interpreter)
    within the tier's bound."""
    monkeypatch.chdir(REPO_DIR)
    path = tmp_path / "crt_tv.rf"
    path.write_text((EXAMPLES_DIR / "crt_tv.rf").read_text())
    engine, frame, per_node, want = _render_both(str(path), fmt, _u8(5))
    assert plan_steps(engine.program) == [("seg mc", ["fade", "soften"]), ("seg mc", ["crt"])]
    _engine_check(fmt, frame if fmt == "rgba32f" else per_node, want, "crt_tv")
    x = engine._file_input()
    by_node, _ms = engine.program.run_per_node(x, 0.25)
    bound = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 1.0 / 255.0 + 1e-6}[fmt]
    assert float(np.abs(frame - by_node.float().numpy()).max()) <= bound
    engine.close()


def test_crt_tv_frames_in_place_and_counted_as_op_lists():
    """render_sequence(stack=True) writes each crt_tv frame in its slice
    (crt's segment takes the output's slice); GLSL_GATHER_RUNS gains one
    op_list a frame and no interpreter run, the shape check counts
    nothing, and the interpreter runs on no frame."""
    before = dict(tprogram.GLSL_GATHER_RUNS)
    engine = _crt_engine()
    assert engine.program.nodes_checked == 3
    assert tprogram.GLSL_GATHER_RUNS == before
    x = engine._file_input()
    frames0, runs0, glsl0 = (dict(tprogram.SEQUENCE_FRAMES), dict(tprogram.GLSL_GATHER_RUNS),
                             dict(interp.COUNTS))
    frames = engine.program.render_sequence(x, 0.0, 0.1, 3, stack=True)
    assert tprogram.SEQUENCE_FRAMES == {"in_place": frames0["in_place"] + 3,
                                        "copied": frames0["copied"]}
    assert tprogram.GLSL_GATHER_RUNS == {"op_list": runs0["op_list"] + 3,
                                         "interpreter": runs0["interpreter"]}
    assert interp.COUNTS == glsl0
    for i in range(3):
        assert torch.equal(frames[i], engine.program._forward(x, 0.1 * i))
    engine.close()


def test_per_node_runs_count_as_interpreter_runs():
    """The same node run per node (run_per_node) counts one interpreter run
    a frame; fade and soften, builtins, count nothing."""
    engine = _crt_engine()
    x = engine._file_input()
    before = dict(tprogram.GLSL_GATHER_RUNS)
    engine.program.run_per_node(x, 0.0)
    engine.program.run_per_node(x, 0.1)
    assert tprogram.GLSL_GATHER_RUNS == {"op_list": before["op_list"],
                                         "interpreter": before["interpreter"] + 2}
    engine.close()


def test_a_gathering_plan_on_slabs_takes_the_per_node_route():
    """A plan that gathers reads any row of its input (``input_halo`` is
    the image's height), so row slabs run it per node, the whole image
    gathered to one device, and match the unsharded frame."""
    h, w = 24, 40
    config = "input -> z -> output\nz: zoom { zoom: 1.7 }\n"
    prog = build_program(config, w, h, device="cpu", shader_path=SHADER_DIR)
    assert plan_steps(prog) == [("mc", ["z"])]
    sharded = HaloShardedProgram(prog, make_row_mesh(2, ["cpu", "cpu"]))
    assert sharded.slab_plans == ["per node", "per node"]
    x = torch.from_numpy(np.random.default_rng(6).random((4, h, w), dtype=np.float32))
    np.testing.assert_array_equal(sharded(x, 0.2).numpy(), prog(x, 0.2).numpy())
