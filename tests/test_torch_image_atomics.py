"""Image atomics in the PyTorch port against the JAX package, on the CPU:
the cases of ``tests/test_image_atomics.py`` (imageAtomicAdd/Min/Max/Or/
Exchange/CompSwap on channel 0 of a storage image, atomics in data-
dependent loops and callees, the shipped waveform monitor), each run
through both interpreters on the same seeded image.  Every output is
bit-equal to the JAX package's (counts, min/max, bitwise, exchange and
the CPU's sequential atomicAdd sums), and where the reference's test has
a numpy oracle the port meets it too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.glsl import translate_shader as jtranslate
from reforge_tpu.kernels.base import KernelContext as JContext
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import SHADER_DIR, build_program
from reforge_tpu_torch.glsl import GlslError, translate_shader
from reforge_tpu_torch.kernels.base import KernelContext

HEADER = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, r32f) uniform image2D output_image;
"""


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False


def rand_image(h, w, seed=0):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


def run_both(src, name, img):
    """The port's and the JAX package's outputs on ``img``, as numpy, after
    checking every output bit-equal between the two."""
    h, w = img.shape[1:]
    tspec, jspec = translate_shader(src, name), jtranslate(src, name)
    got = tspec(KernelContext(width=w, height=h, device="cpu"),
                {"input_image": torch.from_numpy(img)}, tspec.resolve_params({}))
    want = jspec(JContext(width=w, height=h), {"input_image": jnp.asarray(img)},
                 jspec.resolve_params({}))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    return got


def test_histogram_splat():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int bucket = clamp(int(c.r * 16.0), 0, 15);
    imageAtomicAdd(output_image, ivec2(bucket, 0), 1.0);
}
"""
    img = rand_image(12, 16, seed=1)
    got = run_both(src, "img_hist", img)["output_image"][0]
    want = np.bincount(np.clip((img[0] * 16.0).astype(int), 0, 15).ravel(), minlength=16)
    np.testing.assert_array_equal(got[0, :16].astype(int), want)
    assert got[1:].sum() == 0.0


def test_oob_coords_dropped():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageAtomicAdd(output_image, ivec2(pos.x - 1000, pos.y), 5.0);
}
"""
    assert run_both(src, "img_oob", rand_image(6, 8, seed=2))["output_image"][0].sum() == 0.0


def test_masked_under_if():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    if (c.r > 0.5) { imageAtomicAdd(output_image, ivec2(0, 0), 1.0); }
}
"""
    img = rand_image(10, 10, seed=3)
    got = run_both(src, "img_masked", img)["output_image"][0]
    assert got[0, 0] == float((img[0] > 0.5).sum())


def test_sequential_calls_accumulate():
    src = HEADER + """
void main() {
    imageAtomicAdd(output_image, ivec2(1, 1), 1.0);
    imageAtomicAdd(output_image, ivec2(1, 1), 2.0);
}
"""
    assert run_both(src, "img_seq", rand_image(4, 4, seed=4))["output_image"][0][1, 1] == 48.0


def test_fractional_sums_in_lane_order():
    """atomicAdd of non-integer values into a few slots: on the CPU the
    port sums in row-major lane order, the JAX package's order, so the
    bits agree (run_both); a float64 sum of the same lanes is within a few
    ulps of the f32 result."""
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageAtomicAdd(output_image, ivec2(pos.x & 3, 0), c.g * 0.3 + c.b);
}
"""
    img = rand_image(24, 32, seed=14)
    got = run_both(src, "img_frac", img)["output_image"][0][0, :4]
    lanes = (np.float32(0.3) * img[1] + img[2]).astype(np.float64)
    want = [lanes[:, k::4].sum() for k in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_depth_max_per_column():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageAtomicMax(output_image, ivec2(pos.x, 0), c.g);
    imageAtomicMin(output_image, ivec2(pos.x, 1), c.g);
}
"""
    img = rand_image(9, 7, seed=5)
    got = run_both(src, "img_max", img)["output_image"][0]
    np.testing.assert_array_equal(got[0], img[1].max(axis=0))
    np.testing.assert_array_equal(got[1], 0.0)


def test_or_flags():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int bit = int(c.b * 255.0) & 7;
    imageAtomicOr(output_image, ivec2(0, 0), 1 << bit);
}
"""
    img = rand_image(8, 8, seed=6)
    got = run_both(src, "img_or", img)["output_image"][0][0, 0]
    bits = (img[2] * 255.0).astype(np.int32) & 7
    assert int(got) == int(np.bitwise_or.reduce(1 << bits, axis=None))


def test_exchange_last_lane_wins():
    """imageAtomicExchange of every lane into one pixel: one lane's value
    lands, and it is the JAX package's CPU tie-break (the last lane in
    row-major order), pinned by run_both's bit-equality and here."""
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageAtomicExchange(output_image, ivec2(2, 3), c.r);
}
"""
    img = rand_image(6, 6, seed=7)
    got = run_both(src, "img_xchg", img)["output_image"][0]
    assert got[3, 2] == img[0, -1, -1]
    rest = got.copy()
    rest[3, 2] = 0.0
    assert rest.sum() == 0.0


def test_compswap_claim():
    """The claim lands the last matching lane's value (the exchange's
    tie-break); a compare that never matches leaves the cell alone."""
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageAtomicCompSwap(output_image, ivec2(0, 0), 0, int(c.r * 100.0) + 1);
    imageAtomicCompSwap(output_image, ivec2(1, 0), 7, 42);
}
"""
    img = rand_image(5, 5, seed=8)
    got = run_both(src, "img_cas", img)["output_image"][0]
    assert got[0, 0] == float(int(img[0, -1, -1] * np.float32(100.0)) + 1)
    assert got[0, 1] == 0.0


def _loop_counts(img, scale, add, cap):
    v = img[0].astype(np.float64).copy()
    n = np.zeros(v.shape, int)
    counts = []
    act = (v < 1.0) & (n < cap)
    while act.any():
        counts.append(int(act.sum()))
        v = np.where(act, v * np.float32(scale) + np.float32(add), v)
        n = np.where(act, n + 1, n)
        act = act & (v < 1.0) & (n < cap)
    return counts


def test_add_inside_data_dependent_loop():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float v = c.r;
    int n = 0;
    while (v < 1.0 && n < 20) {
        imageAtomicAdd(output_image, ivec2(0, 0), 1.0);
        v = v * 1.5 + 0.05;
        n++;
    }
}
"""
    img = rand_image(8, 10, seed=9)
    got = run_both(src, "img_loop", img)["output_image"][0][0, 0]
    assert got == sum(_loop_counts(img, 1.5, 0.05, 20))


def test_add_in_callee_inside_loop():
    src = HEADER + """
void vote(int slot) {
    imageAtomicAdd(output_image, ivec2(slot, 0), 1.0);
}

void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float v = c.r;
    int n = 0;
    while (v < 1.0 && n < 10) {
        vote(n);
        v = v * 2.0 + 0.1;
        n++;
    }
}
"""
    img = rand_image(6, 12, seed=10)
    got = run_both(src, "img_callee", img)["output_image"][0][0]
    counts = _loop_counts(img, 2.0, 0.1, 10)
    np.testing.assert_array_equal(got[:len(counts)].astype(int), counts)


def _luma_rows(img, h):
    luma = np.clip(np.float32(0.2126) * img[0] + np.float32(0.7152) * img[1]
                   + np.float32(0.0722) * img[2], 0.0, 1.0).astype(np.float32)
    rows = ((np.float32(1.0) - luma) * np.float32(h - 1) + np.float32(0.5)).astype(np.int32)
    return np.clip(rows, 0, h - 1)


def test_waveform_meter_matches_2d_histogram():
    h, w = 24, 32
    img = rand_image(h, w, seed=11)
    got = run_both(open(SHADER_DIR + "/waveform.comp").read(), "waveform", img)
    rows = _luma_rows(img, h)
    want = np.stack([np.bincount(rows[:, x], minlength=h) for x in range(w)], axis=1)
    np.testing.assert_array_equal(got["output_image"][0].astype(np.int64), want)
    assert (got["output_image"][0].sum(axis=0) == h).all()  # every column: one count a pixel


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
def test_waveform_scope_pipeline(fmt):
    """The meter and scope_overlay.comp through the port's program per
    node against the JAX program's.  The meter's counts are exact on both
    sides; scope_overlay's exp() differs by an ulp between PyTorch and
    XLA, so the output is held within 1e-6 in rgba32f, one bf16 step of
    the value in rgba16f and one code in rgba8; and in rgba32f against the
    reference's numpy oracle of both passes within its 1e-5."""
    import reforge_tpu.config as jconfig
    from reforge_tpu.graph import build_graph as jbuild_graph
    from reforge_tpu.graph import make_program as jmake_program

    wiring = ("input -> meter\nmeter -> scope:scope_image\ninput -> scope -> output\n"
              "meter: waveform {}\nscope: scope_overlay { scale: 0.4, gain: 0.12 }\n")
    h, w = 40, 60
    img = rand_image(h, w, seed=12)
    prog = build_program(wiring, w, h, fmt, device="cpu", shader_path=SHADER_DIR)
    out = prog._forward(torch.from_numpy(img), 0.0).float().numpy()
    jprog = jmake_program(jbuild_graph(jconfig.parse_file(wiring, True, SHADER_DIR)), w, h, fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(img), jnp.float32(0.0))).astype(np.float32)
    d = np.abs(out.astype(np.float64) - want)
    if fmt == "rgba16f":
        mag = np.maximum(np.abs(out), np.abs(want)).clip(2.0 ** -126)
        assert (d <= np.exp2(np.floor(np.log2(mag)) - 7) + 1e-7).all(), float(d.max())
        return
    if fmt == "rgba8":
        assert d.max() <= 1.0 / 255.0 + 1e-6, float(d.max())
        return
    assert d.max() <= 1e-6, float(d.max())
    rows = _luma_rows(img, h)
    scope = np.stack([np.bincount(rows[:, x], minlength=h) for x in range(w)],
                     axis=1).astype(np.float32)
    s, g = np.float32(0.4), np.float32(0.12)
    cx, cy = w - int(np.float32(w) * s), h - int(np.float32(h) * s)
    oracle = img.copy()
    for y in range(cy, h):
        for x in range(cx, w):
            n = scope[int(np.float32(y - cy) / s), int(np.float32(x - cx) / s)]
            trace = 1.0 - np.exp(-n * g)
            bg = img[:3, y, x] * np.float32(0.25)
            fg = np.asarray([0.2, 1.0, 0.35], np.float32)
            oracle[:3, y, x] = bg + (fg - bg) * trace
    np.testing.assert_allclose(out, oracle, atol=1e-5)


def test_atomic_target_is_output():
    src = HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    imageAtomicAdd(output_image, ivec2(0, 0), c.r);
}
"""
    spec = translate_shader(src, "img_refl")
    assert "output_image" in spec.images_out and "output_image" not in spec.images_in
    assert spec.halo_for({}) is None  # a gather: per node


@pytest.mark.parametrize("body,match", [
    ("imageAtomicAdd(output_image, 3, 1.0);", "ivec2"),
    ("imageAtomicCompSwap(output_image, ivec2(0, 0), 1.0);", "compare, data"),
])
def test_bad_calls_rejected(body, match):
    spec = translate_shader(HEADER + "void main() {\n" + body + "\n}\n", "img_bad")
    with pytest.raises(GlslError, match=match):
        spec(KernelContext(width=4, height=4, device="cpu"),
             {"input_image": torch.zeros((4, 4, 4))}, {})
