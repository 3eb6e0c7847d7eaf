"""The port's GLSL compiler (``reforge_tpu_torch/glsl``) against the JAX
package's, on the CPU: the parse tree, binding reflection and halo
reflection of all 27 shipped shaders, the 22 that touch only images run
through both interpreters on the same seeded images, the sequential scalar
reference (``tests/scalar_ref.py``) for the numerically stable ones, and
targeted cases of the semantics where PyTorch and XLA differ by default
(integer division, uint wrap, bit casts, data-dependent loops, scatter
stores, ``texture()`` at the edges).

The JAX side runs as its own tests run it: ``translate_shader`` and the
eager interpreter on the CPU.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.glsl import translate_shader as jtranslate
from reforge_tpu.glsl.interp import Interp as JInterp
from reforge_tpu.glsl.parser import parse_shader_source as jparse
from reforge_tpu.kernels.base import KernelContext as JContext
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import EXAMPLES_DIR, SHADER_DIR
from reforge_tpu_torch.glsl import (
    PROBE_EXTENTS, GlslError, dry_stats, reflect_bindings, reflect_spatial, translate_shader,
)
from reforge_tpu_torch.glsl.parser import parse_shader_source as tparse
from reforge_tpu_torch.kernels.base import KernelContext

from scalar_ref import ScalarRef

SHADERS = sorted(os.path.splitext(os.path.basename(p))[0]
                 for p in glob.glob(os.path.join(SHADER_DIR, "*.*")))
# Storage buffers, atomics or workgroup shared arrays: not ported yet.
NOT_PORTED = ("equalize", "expose_apply", "expose_meter", "histogram", "waveform")
IMAGE_ONLY = [s for s in SHADERS if s not in NOT_PORTED]
# Escape-time shaders: an f32 difference of an ulp moves a pixel across an
# iteration boundary and flips its whole colour (tests/test_scalar_ref.py).
ESCAPE_TIME = ("mandelbrot", "raymarch")
# Seen with the scalar reference by the JAX package's own tests.
STABLE = [
    "passthrough", "invert", "sepia", "tonemap", "vignette", "sharpen",
    "sobel", "zoom", "wave", "pixelate", "gaussian_h", "gaussian_v",
    "ink_drip", "light_trails", "kuwahara", "flow_field", "glass",
]
H, W = 24, 40


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _path(stem):
    (path,) = glob.glob(os.path.join(SHADER_DIR, f"{stem}.*"))
    return path


def _source(stem):
    with open(_path(stem)) as f:
        return f.read()


def _stage(stem):
    return "fragment" if _path(stem).endswith(".frag") else "compute"


def _example_params():
    """shader stem -> the params the first example using it sets."""
    found = {}
    for path in sorted(glob.glob(str(EXAMPLES_DIR / "*.rf"))):
        with open(path) as f:
            cfg = tconfig.parse_file(f.read(), True, SHADER_DIR)
        for name, node in cfg.graph_pipelines.items():
            if node.file_path:
                stem = os.path.splitext(os.path.basename(node.file_path))[0]
                inst = cfg.pipeline_instances.get(name)  # None: named by its type
                params = inst.parameters if inst is not None else {}
                found.setdefault(stem, {k: v.value for k, v in params.items()})
    return found


EXAMPLE_PARAMS = _example_params()
# The E graphs' params (benchmarks.GLSL_GRAPHS).
EXAMPLE_PARAMS.setdefault("gaussian_h", {"sigma": 2.0})
EXAMPLE_PARAMS.setdefault("gaussian_v", {"sigma": 2.0})


def _tree(node):
    """A parse tree as nested tuples of class names and fields."""
    if dataclasses.is_dataclass(node):
        return (type(node).__name__,) + tuple(
            (f.name, _tree(getattr(node, f.name))) for f in dataclasses.fields(node))
    if isinstance(node, (list, tuple)):
        return tuple(_tree(v) for v in node)
    if isinstance(node, dict):
        return tuple((k, _tree(v)) for k, v in node.items())
    return node


def _bindings(b):
    out = dict(b)
    out["params"] = {k: (p.name, p.kind.name, p.default) for k, p in b["params"].items()}
    return out


@pytest.mark.parametrize("stem", SHADERS)
def test_parse_tree_and_bindings_match_jax(stem):
    """The lexer, parser and binding reflection are copies: the parse tree,
    the images, SSBOs and their sizes, params and aliases are equal."""
    src = _source(stem)
    jshader, tshader = jparse(src, stage=_stage(stem)), tparse(src, stage=_stage(stem))
    assert _tree(tshader) == _tree(jshader)
    from reforge_tpu.glsl import reflect_bindings as jreflect

    assert _bindings(reflect_bindings(tshader)) == _bindings(jreflect(jshader))


def _jax_dry_stats(shader, images_in, params, h, w):
    """The reference's dry run (glsl/__init__.py:368-386 there): its
    interpreter under ``jax.eval_shape``, which traces every loop body."""
    stats = {"max_shift": 0, "gather": False, "edge_shift": False, "zero_shift": False,
             "dyn_gather": False}

    def dry(time):
        imgs = {n: jnp.zeros((4, h, w), jnp.float32) for n in images_in}
        JInterp(shader, h, w, imgs, params, time=time, stats=stats).run_main()
        return 0

    jax.eval_shape(dry, jax.ShapeDtypeStruct((), jnp.float32))
    return stats


@pytest.mark.parametrize("stem", SHADERS)
def test_halo_reflection_matches_jax(stem):
    """(halo, border, mc_block_ok) equal to the JAX package's with default
    params and with the params an example sets; with default params the
    statistics of each probe extent are equal too."""
    src = _source(stem)
    jspec = jtranslate(src, stem, path=_path(stem))
    shader = tparse(src, stage=_stage(stem))
    images_in = reflect_bindings(shader)["images_in"]
    params = jspec.resolve_params({})
    for h, w in PROBE_EXTENTS:
        assert dry_stats(shader, images_in, params, h, w) == _jax_dry_stats(
            jparse(src, stage=_stage(stem)), images_in, params, h, w), (h, w)
    for given in ({}, EXAMPLE_PARAMS.get(stem, {})):
        params = jspec.resolve_params(given)
        want = (jspec.halo(params), jspec.border(params), jspec.mc_block_ok(params))
        assert reflect_spatial(shader, images_in, params) == want, given


def _run_both(stem, params=None, h=H, w=W, seed=0, t=0.5):
    src = _source(stem)
    jspec = jtranslate(src, stem, path=_path(stem))
    tspec = translate_shader(src, stem, path=_path(stem))
    rng = np.random.default_rng(seed)
    base = {n: rng.random((4, h, w), dtype=np.float32) for n in jspec.images_in}
    jparams = jspec.resolve_params(params or {})
    tparams = tspec.resolve_params(params or {})
    assert tparams == jparams
    want = jspec(JContext(width=w, height=h, time=t),
                 {k: jnp.asarray(v) for k, v in base.items()}, jparams)
    got = tspec(KernelContext(width=w, height=h, time=t, device="cpu"),
                {k: torch.from_numpy(v) for k, v in base.items()}, tparams)
    assert set(got) == set(want)
    return {k: (got[k].numpy(), np.asarray(want[k])) for k in want}, base


@pytest.mark.parametrize("stem", IMAGE_ONLY)
def test_image_only_shader_matches_jax(stem):
    """Each shader that touches only images, with the params its example
    sets, on a seeded 24x40 image: within 1e-5, or for the escape-time
    shaders at most 1% of the values off by more than 1e-4."""
    outs, _base = _run_both(stem, EXAMPLE_PARAMS.get(stem), seed=SHADERS.index(stem))
    for name, (got, want) in outs.items():
        assert got.shape == want.shape and got.dtype == np.float32, name
        d = np.abs(got.astype(np.float64) - want)
        if stem in ESCAPE_TIME:
            assert float(np.mean(d > 1e-4)) <= 0.01, (name, float(np.mean(d > 1e-4)))
        else:
            assert float(d.max()) <= 1e-5, (name, float(d.max()))


@pytest.mark.parametrize("stem", STABLE + ["crt"])
def test_stable_shader_matches_scalar_ref(stem):
    """The sequential f64 scalar reference, as tests/test_scalar_ref.py
    holds the JAX package to it, at its 3e-4."""
    src = _source(stem)
    spec = translate_shader(src, stem, path=_path(stem))
    h, w = 10, 12
    base = np.random.default_rng(7).random((4, h, w)).astype(np.float32)
    params = spec.resolve_params({})
    got = spec(KernelContext(width=w, height=h, time=0.5, device="cpu"),
               {n: torch.from_numpy(base) for n in spec.images_in}, params)["output_image"]
    want = ScalarRef(src, {n: base for n in spec.images_in}, params=params, time=0.5,
                     stage=_stage(stem)).run()["output_image"]
    np.testing.assert_allclose(got.numpy().astype(np.float64), want, atol=3e-4)


@pytest.mark.parametrize("stem", NOT_PORTED)
def test_buffer_atomic_and_shared_shaders_are_not_ported_yet(stem):
    with pytest.raises(GlslError, match="not ported yet"):
        translate_shader(_source(stem), stem, path=_path(stem))


# ---- targeted semantics ------------------------------------------------------

HEADER = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""


def _both(body, h=12, w=16, seed=0, decls=""):
    src = HEADER + decls + "\nvoid main() {\n" + body + "\n}\n"
    jspec, tspec = jtranslate(src, "t"), translate_shader(src, "t")
    x = np.random.default_rng(seed).random((4, h, w), dtype=np.float32)
    want = jspec(JContext(width=w, height=h, time=0.25), {"input_image": jnp.asarray(x)},
                 jspec.resolve_params({}))["output_image"]
    got = tspec(KernelContext(width=w, height=h, time=0.25, device="cpu"),
                {"input_image": torch.from_numpy(x)}, tspec.resolve_params({}))["output_image"]
    return got.numpy(), np.asarray(want), x, (jspec, tspec)


TARGETED = {
    # lax.div truncates and lax.rem keeps the dividend's sign (C's rules).
    "negative_int_div_rem": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        int a = p.x - 9;
        int b = (p.y % 3) - 1;
        b = b == 0 ? -4 : b * 3;
        imageStore(output_image, p, vec4(float(a / b), float(a % b), float(-7 / 2), float(-7 % 3)));
    """,
    # uint arithmetic wraps at 32 bits; conversions to and from int too.
    "uint_wrap": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        uint u = uint(p.x) * 2654435761u + 4294967295u;
        uint v = u >> 7u;
        uint w = 0u - uint(p.y + 1);
        imageStore(output_image, p, vec4(float(u % 1000u), float(v & 1023u), float(w >> 20u),
                                         float(int(w) / 3)));
    """,
    # Bit casts between float and int/uint.
    "bit_casts": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, p);
        int bits = floatBitsToInt(c.r - 0.5);
        uint ubits = floatBitsToUint(c.g);
        float back = intBitsToFloat(bits ^ 1);
        imageStore(output_image, p, vec4(float(bits >> 16), float(ubits >> 16u), back,
                                         uintBitsToFloat(ubits & 4294901760u)));
    """,
    # A switch inside a loop whose trip count depends on the pixel.
    "switch_in_data_dependent_loop": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, p);
        int n = int(c.r * 7.0);
        float acc = 0.0;
        int i = 0;
        while (i < n) {
            switch (i % 3) {
                case 0: acc += c.g; break;
                case 1: acc -= 0.25; break;
                default: acc *= 1.5;
            }
            i++;
        }
        imageStore(output_image, p, vec4(acc, float(i), c.b, 1.0));
    """,
    # Scatter stores that hit one pixel from several lanes: the last lane
    # in row-major order wins (XLA's in-order scatter on the CPU).
    "duplicate_coordinate_scatter": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, p);
        imageStore(output_image, p, vec4(0.0));
        if (c.r > 0.3) {
            imageStore(output_image, ivec2(p.x / 4, p.y / 3), vec4(float(p.x), float(p.y), c.g, 1.0));
        }
    """,
    # texture() with coordinates past the edges (clamp-to-edge, bilinear).
    "texture_at_edges": """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec2 size = vec2(imageSize(input_image));
        vec2 uv = (vec2(p) + 0.5) / size * 1.4 - 0.2;
        vec4 a = texture(input_tex, uv);
        vec4 b = texture(input_tex, vec2(-3.0, 1.7) + uv);
        imageStore(output_image, p, vec4(a.rg, b.ba));
    """,
}
TEXTURE_DECL = "layout (binding = 2) uniform sampler2D input_tex;\n"


@pytest.mark.parametrize("case", sorted(TARGETED))
def test_targeted_semantics_match_jax(case):
    decls = TEXTURE_DECL if "texture" in case else ""
    body = TARGETED[case]
    if "texture" in case:
        src = (HEADER + decls + "\nvoid main() {\n" + body + "\n}\n")
        jspec, tspec = jtranslate(src, "t"), translate_shader(src, "t")
        x = np.random.default_rng(5).random((4, 12, 16), dtype=np.float32)
        imgs = {n: x for n in jspec.images_in}
        want = np.asarray(jspec(JContext(width=16, height=12), {k: jnp.asarray(v) for k, v in
                                                                imgs.items()},
                                jspec.resolve_params({}))["output_image"])
        got = tspec(KernelContext(width=16, height=12, device="cpu"),
                    {k: torch.from_numpy(v) for k, v in imgs.items()},
                    tspec.resolve_params({}))["output_image"].numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        return
    got, want, x, _specs = _both(body, decls=decls)
    np.testing.assert_array_equal(got, want)
    if case == "duplicate_coordinate_scatter":
        # the winner at (0, 0) is the last lane of the 4x3 block that wrote
        block = x[0, :3, :4] > 0.3
        ys, xs = np.nonzero(block)
        if len(ys):
            assert (got[0, 0, 0], got[1, 0, 0]) == (float(xs[-1]), float(ys[-1]))


def test_negative_int_division_truncates():
    got, _want, _x, _s = _both(TARGETED["negative_int_div_rem"])
    assert got[2, 0, 0] == -3.0 and got[3, 0, 0] == -1.0  # -7 / 2, -7 % 3


def test_loop_no_lane_enters_is_seen_by_reflection():
    """A data-dependent loop that no lane enters on the zero probe image
    still has its loads seen: the halo comes from inside the body, as the
    reference's traced body gives it."""
    body = """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, p);
        vec4 acc = c;
        int i = 0;
        while (c.r > 0.5 + float(i) * 0.1 && i < 4) {
            acc += imageLoad(input_image, p + ivec2(3, -2));
            i++;
        }
        imageStore(output_image, p, acc);
    """
    got, want, _x, (jspec, tspec) = _both(body)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tspec.halo({}) == jspec.halo({}) == 3
    assert tspec.border({}) == jspec.border({})


def test_params_take_vector_aliases():
    decls = """
layout (binding = 2) uniform UBO { vec3 tint; float gain; };
"""
    body = """
        ivec2 p = ivec2(gl_GlobalInvocationID.xy);
        vec4 c = imageLoad(input_image, p);
        imageStore(output_image, p, vec4(c.rgb * tint * gain, c.a));
    """
    src = HEADER + decls + "\nvoid main() {\n" + body + "\n}\n"
    tspec, jspec = translate_shader(src, "t"), jtranslate(src, "t")
    given = {"tint.r": 0.5, "tint.y": 2.0, "tint.b": 0.25, "gain": 1.5}
    assert tspec.resolve_params(given) == jspec.resolve_params(given)
    assert tspec.param_aliases == jspec.param_aliases
