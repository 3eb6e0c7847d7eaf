"""Storage buffers, atomics and workgroup ``shared`` arrays in the PyTorch
port against the JAX package, on the CPU.

The cases of ``tests/test_ssbo.py`` (but its sharded one) and the
``shared``, atomic-in-loop and barrier cases of ``tests/test_glsl.py``,
each through both interpreters on the same seeded inputs: every buffer
and image is bit-equal to the JAX package's (counts, min/max, bitwise,
exchange/compSwap, and atomicAdd sums, which the port adds in the CPU's
row-major lane order), and the reference's numpy oracles hold as it
states them.  Then the buffer graphs: the histogram -> equalize,
auto-exposure and waveform examples and a lut1d graph through the port's
Engine against the JAX Engine's per-node path in three formats, and the
lut1d builtin alone.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reforge_tpu.config as jconfig
from reforge_tpu import utils as jutils
from reforge_tpu.glsl import translate_shader as jtranslate
from reforge_tpu.graph import build_graph as jbuild_graph
from reforge_tpu.graph import make_program as jmake_program
from reforge_tpu.kernels.base import KernelContext as JContext
from reforge_tpu.kernels.base import builtin_kernels as jbuiltins
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    BUFFER_EXAMPLES, LUT1D_CONFIG, PORT_SHADER_DIR, REPO_DIR, SHADER_DIR, build_program,
    example_config,
)
from reforge_tpu_torch.glsl import GlslError, interp, translate_shader
from reforge_tpu_torch.graph import build_graph, make_program
from reforge_tpu_torch.kernels import library
from reforge_tpu_torch.kernels.base import KernelContext

from test_torch_glsl_graph import _check, _render_both, _u8

HIST_SRC = open(os.path.join(SHADER_DIR, "histogram.comp")).read()
EQ_SRC = open(os.path.join(SHADER_DIR, "equalize.comp")).read()
WIRING = "input -> histogram\nhistogram:Bins -> equalize:Bins\ninput -> equalize -> output\n"
IMG_HEADER = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False


def rand_image(h=32, w=48, seed=0):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


def _ulps(a, b):
    def mono(v):
        i = np.ascontiguousarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(mono(a) - mono(b))


def run_both(src, name, img, buffers=None, ulps=0):
    """Outputs of the port and of the JAX package on the same inputs, as
    numpy, after checking each output between the two: bit-equal, or
    within ``ulps`` where a data-dependent loop computes ``v * a + b`` (XLA
    fuses it into an FMA inside its while_loop on the CPU, one rounding
    fewer than the port and the GLSL source, and the difference grows with
    the rounds: PARITY.md's 8 ulps of a compound chain; the loops' counters
    are held exactly to the reference's oracles)."""
    h, w = img.shape[1:]
    buffers = buffers or {}
    tspec, jspec = translate_shader(src, name), jtranslate(src, name)
    assert (tspec.ssbos_in, tspec.ssbos_out, tspec.ssbo_sizes) == (
        jspec.ssbos_in, jspec.ssbos_out, jspec.ssbo_sizes)
    tin = {"input_image": torch.from_numpy(img),
           **{k: torch.from_numpy(v) for k, v in buffers.items()}}
    jin = {"input_image": jnp.asarray(img), **{k: jnp.asarray(v) for k, v in buffers.items()}}
    got = tspec(KernelContext(width=w, height=h, device="cpu"), tin, tspec.resolve_params({}))
    want = jspec(JContext(width=w, height=h), jin, jspec.resolve_params({}))
    assert set(got) == set(want)
    got = {k: v.numpy() for k, v in got.items()}
    for k, v in want.items():
        if not ulps:
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        else:
            assert _ulps(got[k], np.asarray(v)).max() <= ulps, k
    return got


# ---- reflection ------------------------------------------------------------------


def test_histogram_and_equalize_bindings():
    hist, eq = translate_shader(HIST_SRC, "histogram"), translate_shader(EQ_SRC, "equalize")
    assert (hist.images_in, hist.images_out, hist.ssbos_out, hist.ssbo_sizes) == (
        ("input_image",), (), ("Bins",), {"Bins": 256})
    assert (eq.ssbos_in, eq.ssbos_out, eq.images_out) == (("Bins",), (), ("output_image",))


RUNTIME_SRC = IMG_HEADER + """
layout (binding = 2) buffer B { float data[]; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    atomicAdd(data[0], 1.0);
    imageStore(output_image, p, vec4(float(data.length())));
}
"""


def test_runtime_sized_array_defaults():
    spec = translate_shader(RUNTIME_SRC, "runtime")
    assert spec.ssbo_sizes == {"B": interp.DEFAULT_RUNTIME_SSBO_ELEMS}
    out = run_both(RUNTIME_SRC, "runtime", np.zeros((4, 8, 8), np.float32))
    assert out["B"][0] == 64.0  # one atomicAdd a pixel
    np.testing.assert_array_equal(out["output_image"][0], interp.DEFAULT_RUNTIME_SSBO_ELEMS)


def test_runtime_array_sizes_from_bound_buffer():
    src = IMG_HEADER + """
layout (binding = 2) readonly buffer B { float head[8]; float data[]; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, p, vec4(float(data.length()), data[1], head[2], 0.0));
}
"""
    out = run_both(src, "runtime_bound", np.zeros((4, 4, 4), np.float32),
                   {"B": np.arange(40, dtype=np.float32)})
    o = out["output_image"]
    assert (o[0] == 32.0).all() and (o[1] == 9.0).all() and (o[2] == 2.0).all()


def test_runtime_array_must_be_last():
    src = IMG_HEADER + """
layout (binding = 2) buffer B { float data[]; float tail; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    atomicAdd(data[0], 1.0);
    imageStore(output_image, p, vec4(0.0));
}
"""
    with pytest.raises(GlslError, match="last member"):
        spec = translate_shader(src, "bad")
        spec(KernelContext(width=8, height=8, device="cpu"),
             {"input_image": torch.zeros((4, 8, 8))}, {})


MULTI_SRC = IMG_HEADER + """
layout (binding = 2) buffer Stats { uint count; float lo[2]; float sums[4]; };
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    float v = imageLoad(input_image, p).r;
    atomicAdd(count, 1u);
    int bin = clamp(int(v * 4.0), 0, 3);
    atomicAdd(sums[bin], 1.0);
    imageStore(output_image, p, vec4(v));
}
"""


def test_multi_member_offsets_do_not_alias():
    assert translate_shader(MULTI_SRC, "stats").ssbo_sizes == {"Stats": 7}  # 1 + 2 + 4
    img = rand_image(8, 8)
    buf = run_both(MULTI_SRC, "stats", img)["Stats"]
    assert buf[0] == 64.0 and (buf[1:3] == 0.0).all()
    want = np.bincount(np.clip((img[0] * 4).astype(int), 0, 3).ravel(), minlength=4)
    np.testing.assert_array_equal(buf[3:7], want)


def test_scalar_member_assign_and_read():
    src = IMG_HEADER + """
layout (binding = 2) buffer B { float bias; float data[4]; } blk;
void main() {
    ivec2 p = ivec2(gl_GlobalInvocationID.xy);
    bias = 2.5;
    blk.data[1] = 7.0;
    imageStore(output_image, p, vec4(bias + blk.data[1], blk.bias, 0.0, 1.0));
}
"""
    out = run_both(src, "scalar_member", np.zeros((4, 4, 4), np.float32))
    assert (out["output_image"][0] == 9.5).all() and (out["output_image"][1] == 2.5).all()
    assert out["B"][0] == 2.5 and out["B"][2] == 7.0


@pytest.mark.parametrize("body,match", [
    ("data[p.x] = 1.0;", "uniform index"),
    ("if (p.x > 2) { data[0] = 1.0; }", "non-uniform"),
    ("data[0] = float(p.x);", "uniform value"),
])
def test_plain_store_diagnostics(body, match):
    """A plain SSBO store needs a uniform index, value and control flow,
    with the reference's diagnostics."""
    src = IMG_HEADER + "layout (binding = 2) buffer B { float data[4]; };\nvoid main() {\n" \
        "    ivec2 p = ivec2(gl_GlobalInvocationID.xy);\n    " + body + \
        "\n    imageStore(output_image, p, vec4(0.0));\n}\n"
    with pytest.raises(GlslError, match=match):
        translate_shader(src, "store")(KernelContext(width=8, height=4, device="cpu"),
                                       {"input_image": torch.zeros((4, 4, 8))}, {})


# ---- execution -------------------------------------------------------------------


def test_histogram_counts():
    img = rand_image(16, 16, seed=3)
    bins = run_both(HIST_SRC, "histogram", img)["Bins"]
    luma = 0.2126 * img[0] + 0.7152 * img[1] + 0.0722 * img[2]
    ref = np.bincount(np.clip((luma * 255).astype(int), 0, 255).ravel(), minlength=256)
    np.testing.assert_array_equal(bins.astype(int), ref)
    assert bins.sum() == 256


def test_expose_meter_sums_in_lane_order():
    """expose_meter's peak (atomicMax) and summed luma (atomicAdd of
    non-integer values): bit-equal to the JAX package on the CPU, and the
    sum within 1e-5 relative of a float64 sum of the same lanes."""
    img = rand_image(24, 40, seed=6)
    src = open(os.path.join(SHADER_DIR, "expose_meter.comp")).read()
    stats = run_both(src, "expose_meter", img)["Expo"]
    luma = (np.float32(0.2126) * img[0] + np.float32(0.7152) * img[1]
            + np.float32(0.0722) * img[2])
    assert stats[0] == luma.max()
    np.testing.assert_allclose(stats[1], luma.astype(np.float64).sum(), rtol=1e-5)


def _loop_oracle(img, scale, add, cap, stop=1.0, mark=None):
    v = img[0].astype(np.float64).copy()
    n = np.zeros_like(v)
    total = marked = 0
    act = (v < stop) & (n < cap)
    while act.any():
        v = np.where(act, v * np.float32(scale) + np.float32(add), v)
        total += act.sum()
        if mark is not None:
            marked += (act & (v > mark)).sum()
        n = np.where(act, n + 1, n)
        act = act & (v < stop) & (n < cap)
    return n, total, marked


def test_atomic_add_inside_data_dependent_loop():
    src = IMG_HEADER + """
layout (binding = 2) buffer Stats { float total[4]; } stats;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float v = c.r;
    int n = 0;
    while (v < 1.0 && n < 30) {
        v = v * 1.4 + 0.03;
        atomicAdd(stats.total[0], 1.0);
        if (v > 0.9) { atomicAdd(stats.total[1], 1.0); }
        n++;
    }
    imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
}
"""
    img = rand_image(12, 16, seed=7)
    out = run_both(src, "loop_atomic", img, ulps=8)
    n, t0, t1 = _loop_oracle(img, 1.4, 0.03, 30, mark=0.9)
    np.testing.assert_allclose(out["output_image"][1], n.astype(np.float32))
    assert out["Stats"][0] == t0 and out["Stats"][1] == t1


def test_atomic_min_max_reduction():
    src = IMG_HEADER + """
layout (binding = 2) buffer Stats { float cells[4]; } stats;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float y = dot(c.rgb, vec3(0.2126, 0.7152, 0.0722));
    atomicMax(stats.cells[0], y);
    atomicMin(stats.cells[1], y - 1.0);
    if (c.a > 0.5) { atomicMax(stats.cells[2], y); }
    imageStore(output_image, pos, c);
}
"""
    img = rand_image(12, 16, seed=11)
    cells = run_both(src, "minmax", img)["Stats"]
    y = 0.2126 * img[0] + 0.7152 * img[1] + 0.0722 * img[2]
    np.testing.assert_allclose(cells[0], y.max(), atol=1e-6)
    np.testing.assert_allclose(cells[1], (y - 1.0).min(), atol=1e-6)
    np.testing.assert_allclose(cells[2], max(y[img[3] > 0.5].max(), 0.0), atol=1e-6)
    assert cells[3] == 0.0


def test_atomic_max_inside_loop_carry():
    src = IMG_HEADER + """
layout (binding = 2) buffer S { float peak[2]; } s;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    float v = imageLoad(input_image, pos).r;
    int n = 0;
    while (v < 1.2 && n < 12) {
        atomicMax(s.peak[0], v);
        v = v * 1.3 + 0.02;
        n++;
    }
    imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
}
"""
    img = rand_image(10, 16, seed=13)
    peak = run_both(src, "loop_max", img, ulps=8)["S"][0]
    v, n, best = img[0].astype(np.float64).copy(), np.zeros(img[0].shape), 0.0
    for _ in range(12):
        live = (v < 1.2) & (n < 12)
        if not live.any():
            break
        best = max(best, float(np.float32(v[live]).max()))
        v = np.where(live, np.float32(np.float32(v * 1.3) + 0.02), v)
        n = np.where(live, n + 1, n)
    np.testing.assert_allclose(peak, best, atol=1e-6)


BITWISE_SRC = IMG_HEADER + """
layout (binding = 2) buffer B { int bits[4]; } b;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int v = int(c.r * 255.0);
    b.bits[2] = 255;
    atomicOr(b.bits[0], 1 << (v & 7));
    atomicXor(b.bits[1], v - 128);
    atomicAnd(b.bits[2], v | 240);
    if (c.a > 0.5) { atomicOr(b.bits[3], 1 << (v & 3)); }
    imageStore(output_image, pos, c);
}
"""


def test_atomic_or_xor_and_reduction():
    img = rand_image(12, 16, seed=21)
    cells = run_both(BITWISE_SRC, "bitwise", img)["B"].astype(np.int64)
    v = (img[0] * 255.0).astype(np.int32)
    sel = v[img[3] > 0.5]
    assert cells[0] == np.bitwise_or.reduce(1 << (v & 7), axis=None)
    assert cells[1] == np.bitwise_xor.reduce((v - 128).ravel())
    assert cells[2] == np.bitwise_and.reduce((v | 240).ravel()) & 255
    assert cells[3] == np.bitwise_or.reduce(1 << (sel & 3), axis=None)


def test_atomic_and_empty_mask_keeps_initial():
    src = IMG_HEADER + """
layout (binding = 2) buffer B { int m[2]; } b;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    b.m[0] = 77;
    if (c.a > 2.0) { atomicAnd(b.m[0], 1); }
    imageStore(output_image, pos, c);
}
"""
    assert run_both(src, "and_empty", rand_image(8, 8, seed=3))["B"][0] == 77.0


def test_atomic_exchange_last_lane_wins():
    """atomicExchange: a uniform value lands; a varying one is the last
    lane's in row-major order, the JAX package's CPU tie-break (pinned by
    the bit-equality and here); no active lane leaves the cell alone."""
    src = IMG_HEADER + """
layout (binding = 2) buffer B { float cells[3]; } b;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    atomicExchange(b.cells[0], 7.25);
    atomicExchange(b.cells[1], c.r);
    if (c.a > 2.0) { atomicExchange(b.cells[2], 99.0); }
    imageStore(output_image, pos, c);
}
"""
    img = rand_image(8, 12, seed=5)
    cells = run_both(src, "exchange", img)["B"]
    assert cells[0] == 7.25 and cells[1] == img[0, -1, -1] and cells[2] == 0.0


def test_atomic_compswap_sequences():
    src = IMG_HEADER + """
layout (binding = 2) buffer B { int cells[3]; } b;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    atomicCompSwap(b.cells[0], 0, 3);
    atomicCompSwap(b.cells[0], 3, 9);
    atomicCompSwap(b.cells[1], 1, 5);
    atomicCompSwap(b.cells[2], 0, int(c.g * 100.0) + 1);
    imageStore(output_image, pos, c);
}
"""
    img = rand_image(8, 8, seed=7)
    cells = run_both(src, "compswap", img)["B"]
    assert cells[0] == 9.0 and cells[1] == 0.0
    assert cells[2] == float(int(img[1, -1, -1] * np.float32(100.0)) + 1)


def test_atomic_or_on_shared_array():
    src = IMG_HEADER + """
shared int flags[2];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int v = int(c.r * 255.0);
    atomicOr(flags[0], 1 << (v & 7));
    barrier();
    imageStore(output_image, pos, vec4(float(flags[0]), 0.0, 0.0, 1.0));
}
"""
    img = rand_image(12, 16, seed=9)
    v = (img[0] * 255.0).astype(np.int32)
    np.testing.assert_array_equal(run_both(src, "shared_or", img)["output_image"][0],
                                  float(np.bitwise_or.reduce(1 << (v & 7), axis=None)))


def test_atomic_or_inside_loop_carry():
    src = IMG_HEADER + """
layout (binding = 2) buffer B { int m[1]; } b;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    float v = imageLoad(input_image, pos).r;
    int n = 0;
    while (v < 1.0 && n < 8) {
        atomicOr(b.m[0], 1 << n);
        v = v * 1.4 + 0.05;
        n++;
    }
    imageStore(output_image, pos, vec4(v, float(n), 0.0, 1.0));
}
"""
    img = rand_image(8, 12, seed=15)
    got = run_both(src, "loop_or", img, ulps=8)["B"][0]
    v, n, want = img[0].astype(np.float64).copy(), np.zeros(img[0].shape, int), 0
    for it in range(8):
        live = (v < 1.0) & (n < 8)
        if not live.any():
            break
        want |= 1 << it
        v = np.where(live, np.float32(np.float32(v * 1.4) + 0.05), v)
        n = np.where(live, n + 1, n)
    assert got == want


SELF_OWNED_SRC = IMG_HEADER + """
layout (binding = 2) buffer Flags { int mask[2]; } f;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int band = int(c.r * 7.99);
    atomicOr(f.mask[0], 1 << band);
    float occupancy = float(bitCount(f.mask[0])) / 8.0;
    imageStore(output_image, pos, vec4(c.rgb * occupancy, c.a));
}
"""


def test_self_owned_buffer_builds_and_runs(tmp_path):
    """A buffer the same shader writes and reads needs no upstream edge:
    each frame it starts at zeros; its int member reads as int."""
    spec = translate_shader(SELF_OWNED_SRC, "flagmeter")
    assert "Flags" in spec.ssbos_in and "Flags" in spec.ssbos_out
    (tmp_path / "flagmeter.comp").write_text(SELF_OWNED_SRC)
    cfg = tconfig.parse_file("input -> flagmeter -> output\n", True, str(tmp_path))
    prog = make_program(build_graph(cfg), 16, 8, "rgba32f", device="cpu")
    img = rand_image(8, 16, seed=33)
    for _ in range(2):  # the second frame starts from zeros again
        out = prog(torch.from_numpy(img), 0.0).numpy()
        occ = len(np.unique((img[0] * 7.99).astype(np.int32))) / 8.0
        np.testing.assert_allclose(out[:3], img[:3] * occ, atol=1e-6)
    got = run_both(SELF_OWNED_SRC, "flagmeter", img, {"Flags": np.zeros(2, np.float32)})
    assert got["output_image"].shape == (4, 8, 16)


# ---- workgroup-shared arrays (tests/test_glsl.py) -------------------------------------

HIST_SHARED = """
#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1) buffer Hist { float bins[16]; };
shared float local_hist[16];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    if (lid < 16u) { local_hist[lid] = 0.0; }
    barrier();
    vec4 c = imageLoad(input_image, pos);
    int bin = clamp(int(c.r * 16.0), 0, 15);
    atomicAdd(local_hist[bin], 1.0);
    barrier();
    if (lid < 16u) { atomicAdd(bins[lid], local_hist[lid]); }
}
"""
HIST_GLOBAL = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1) buffer Hist { float bins[16]; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int bin = clamp(int(c.r * 16.0), 0, 15);
    atomicAdd(bins[bin], 1.0);
}
"""


def test_shared_histogram_matches_global():
    img = rand_image(32, 48, seed=3)
    got = run_both(HIST_SHARED, "hist_shared", img)["Hist"]
    np.testing.assert_array_equal(got, run_both(HIST_GLOBAL, "hist_global", img)["Hist"])
    assert got.sum() == 32 * 48
    assert translate_shader(HIST_SHARED, "hist_shared2").halo_for({}) is None


def test_shared_plain_store_and_read():
    src = """
#version 450
layout (local_size_x = 8, local_size_y = 8) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
shared float corner[1];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    if (lid == 0u) { corner[0] = imageLoad(input_image, pos).r; }
    barrier();
    imageStore(output_image, pos, vec4(corner[0], 0.0, 0.0, 1.0));
}
"""
    img = rand_image(16, 16, seed=4)
    out = run_both(src, "corner_fill", img)["output_image"]
    for ty in range(2):
        for tx in range(2):
            assert (out[0, ty * 8:(ty + 1) * 8, tx * 8:(tx + 1) * 8] == img[0, ty * 8, tx * 8]).all()


def test_shared_budget_diagnostic():
    src = """
#version 450
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
shared float big[1048576];
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    imageStore(output_image, pos, vec4(big[0]));
}
"""
    spec = translate_shader(src, "big_shared")
    with pytest.raises(GlslError, match="lowering budget"):
        spec(KernelContext(width=64, height=64, device="cpu"),
             {"input_image": torch.zeros((4, 64, 64))}, {})


SHM_HDR = """
#version 450
layout (local_size_x = 4, local_size_y = 4) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""
SHM_LOOP = """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    uint lid = gl_LocalInvocationIndex;
    int n = int(imageLoad(input_image, pos).r * 4.0) + 1;
    int i = 0;
    while (i < n) {
%s
        i++;
    }
    barrier();
    imageStore(output_image, pos, vec4(%s, 0.0, 1.0));
}
"""
# name: (declarations, loop body, stored .rg, seed)
SHARED_IN_LOOP = {
    "own_slot_store": ("shared float mine[16];", "mine[lid] = float(i + 1);",
                       "mine[lid], 0.0", 0),
    "single_writer_cross_lane_read": ("shared float cnt[1];",
                                      "if (lid == 0u) { cnt[0] = cnt[0] + 1.0; }",
                                      "cnt[0], 0.0", 0),
    "callee_store": ("shared float mine[16];\nvoid mark(uint i, float v) { mine[i] = v; }",
                     "mark(lid, float(i + 1));", "mine[lid], 0.0", 1),
    "compound_store": ("shared float acc[16];", "acc[lid] += 2.0;", "acc[lid], 0.0", 2),
    "out_param_store": ("shared float mine[16];\nvoid setv(out float x, float v) { x = v; }",
                        "setv(mine[lid], float(i + 1));", "mine[lid], 0.0", 3),
    "mixed_with_atomic": ("shared float mine[16];\nshared float total[1];",
                          "mine[lid] = float(i + 1);\n        atomicAdd(total[0], 1.0);",
                          "mine[lid], total[0]", 3),
}


@pytest.mark.parametrize("case", sorted(SHARED_IN_LOOP))
def test_shared_write_in_data_dependent_loop(case):
    """Plain shared stores (and an atomic) in a data-dependent loop: the
    shared planes ride the round loop's carry, so writes of one round are
    seen in the next and after the loop; against the reference's oracle of
    each group's trip counts."""
    decls, body, stored, seed = SHARED_IN_LOOP[case]
    img = rand_image(8, 8, seed=seed)
    out = run_both(SHM_HDR + decls + SHM_LOOP % (body, stored), "shm_loop", img)["output_image"]
    trips = (img[0] * 4.0).astype(np.int32) + 1
    for ty in range(2):
        for tx in range(2):
            tile = (slice(ty * 4, ty * 4 + 4), slice(tx * 4, tx * 4 + 4))
            if case == "single_writer_cross_lane_read":
                assert (out[0][tile] == trips[ty * 4, tx * 4]).all()
            elif case == "compound_store":
                np.testing.assert_array_equal(out[0][tile], 2.0 * trips[tile])
            else:
                np.testing.assert_array_equal(out[0][tile], trips[tile])
            if case == "mixed_with_atomic":
                assert (out[1][tile] == trips[tile].sum()).all()


LOOP_HDR = IMG_HEADER + "layout(std430, binding = 2) buffer Stats { float count[4]; } stats;\n"


@pytest.mark.parametrize("callee", [False, True])
def test_atomic_inside_loop_direct_and_in_callee(callee):
    decl = "void bump() { atomicAdd(stats.count[0], 1.0); }\n" if callee else ""
    call = "bump();" if callee else "atomicAdd(stats.count[0], 1.0);"
    src = LOOP_HDR + decl + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    float v = imageLoad(input_image, pos).r;
    while (v < 1.0) {
        %s
        v += 0.25;
    }
    imageStore(output_image, pos, vec4(v));
}
""" % call
    img = rand_image(12, 16, seed=0)
    out = run_both(src, "loop_callee" if callee else "loop", img)
    want, count = img[0].copy(), 0
    while (want < 1.0).any():
        count += int((want < 1.0).sum())
        want = np.where(want < 1.0, want + np.float32(0.25), want)
    np.testing.assert_array_equal(out["output_image"][0], want)
    assert out["Stats"][0] == count


def test_barrier_in_loop_rejected():
    src = IMG_HEADER + """
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    float v = imageLoad(input_image, pos).r;
    while (v < 1.0) {
        barrier();
        v += 0.25;
    }
    imageStore(output_image, pos, vec4(v));
}
"""
    with pytest.raises(GlslError, match="barrier"):
        translate_shader(src, "barrier_loop")(KernelContext(width=16, height=12, device="cpu"),
                                              {"input_image": torch.zeros((4, 12, 16))}, {})


def test_equalize_unrolled_and_lowered_agree(monkeypatch):
    """equalize.comp's 256-round CDF loop unrolled and through the fori
    lowering (threshold lowered to 64) gives the same bits, and the JAX
    package's."""
    img = rand_image(12, 16, seed=5)
    hist = np.random.default_rng(5).random(256, dtype=np.float32)
    unrolled = run_both(EQ_SRC, "equalize", img, {"Bins": hist})["output_image"]
    monkeypatch.setattr(interp.Interp, "_SCAN_THRESHOLD", 64)
    spec = translate_shader(EQ_SRC, "equalize")
    stats = {}
    orig = interp.Interp.__init__

    def spy(self, *a, **k):
        orig(self, *a, **k)
        stats.update(self=self)

    monkeypatch.setattr(interp.Interp, "__init__", spy)
    lowered = spec(KernelContext(width=16, height=12, device="cpu"),
                   {"input_image": torch.from_numpy(img), "Bins": torch.from_numpy(hist)},
                   {})["output_image"].numpy()
    assert stats["self"].stats.get("fori_loop")
    np.testing.assert_array_equal(lowered, unrolled)


# ---- graphs ---------------------------------------------------------------------------


def test_histogram_equalize_program_and_kind_mismatch():
    cfg = tconfig.parse_file(WIRING, True, SHADER_DIR)
    graph = build_graph(cfg)
    assert graph.resource_kinds["histogram:Bins"] == "buffer"
    assert graph.buffer_sizes["histogram:Bins"] == 256
    prog = make_program(graph, 48, 32, "rgba32f", device="cpu")
    assert prog._strip_plan is None  # buffer nodes stay off the strip tiers
    mid = np.clip(rand_image(seed=9) * 0.3 + 0.4, 0, 1).astype(np.float32)
    out = prog(torch.from_numpy(mid), 0.0).numpy()
    luma = lambda i: 0.2126 * i[0] + 0.7152 * i[1] + 0.0722 * i[2]  # noqa: E731
    assert np.isfinite(out).all() and luma(out).std() > luma(mid).std()
    tutils.clear_warnings()
    bad = tconfig.parse_file("input -> gaussian:Bins -> equalize:Bins\n"
                             "input -> equalize -> output\n", True, SHADER_DIR)
    assert build_graph(bad) is None
    assert "Bins" in " ".join(tutils.recent_warnings())


def _share_off(got, want, fmt):
    """The share of values beyond the format's bound (_check's bounds)."""
    d = np.abs(got.astype(np.float64) - want)
    if fmt == "rgba32f":
        return float(np.mean(d > 1e-5))
    if fmt == "rgba16f":
        mag = np.maximum(np.abs(got), np.abs(want)).clip(2.0 ** -126)
        return float(np.mean(d > np.exp2(np.floor(np.log2(mag)) - 7) + 1e-7))
    return float(np.mean(d > 1.0 / 255.0 + 1e-6))


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("graph", list(BUFFER_EXAMPLES) + ["lut1d"])
def test_engine_renders_buffer_graphs_like_jax(graph, fmt, tmp_path, monkeypatch):
    """equalize, auto_expose, waveform_scope (examples/) and the lut1d graph
    through the port's Engine from the repository root against the JAX
    Engine's per-node path, with test_torch_glsl_graph's bounds (rgba32f
    64 ulps, rgba16f one bf16 step, rgba8 one code).  The buffers are
    bit-equal on the CPU, so nothing flips: an ulp of a node's input that
    moved equalize's bin int(luma * 255) would be held as a share of
    pixels, as test_torch_glsl_examples does, at 0.5%; none is seen."""
    monkeypatch.chdir(REPO_DIR)
    path = tmp_path / f"{graph}.rf"
    path.write_text(LUT1D_CONFIG if graph == "lut1d" else example_config(graph))
    kw = dict(shader_path=PORT_SHADER_DIR) if graph == "lut1d" else {}
    engine, frame, per_node, want = _render_both(str(path), fmt, _u8(5), **kw)
    assert engine.program._strip_plan is None
    np.testing.assert_array_equal(frame, per_node)
    # Every route carries the buffers, each frame from fresh ones.
    x = engine._file_input()
    seq = engine.program.render_sequence(x, 0.25, 0.0, 2, stack=True).float().numpy()
    timed, _times = engine.program.run_per_node(x, 0.25)
    for got in (seq[0], seq[1], timed.float().numpy()):
        np.testing.assert_array_equal(got, frame)
    if graph == "equalize":
        assert _share_off(frame, want, fmt) <= 0.005
    else:
        _check(fmt, frame, want, graph)


def test_lut1d_alone_matches_jax():
    """The lut1d builtin on a seeded image and curve: bit-equal, including
    values outside [0, 1] (clamped) in every channel but alpha."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-0.2, 1.2, (4, 24, 40)).astype(np.float32)
    curve = np.sort(rng.random(256, dtype=np.float32))
    got = library.lut1d(KernelContext(width=40, height=24, device="cpu"),
                        {"input_image": torch.from_numpy(x), "Curve": torch.from_numpy(curve)},
                        {})["output_image"].numpy()
    want = jbuiltins()["lut1d"](JContext(width=40, height=24),
                                {"input_image": jnp.asarray(x), "Curve": jnp.asarray(curve)},
                                {})["output_image"]
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (library.lut1d.ssbos_in, library.lut1d.ssbo_sizes) == (("Curve",), {"Curve": 256})


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba8"])
def test_lut1d_graph_with_its_producer_matches_jax(fmt):
    """benchmarks.LUT1D_CONFIG (the port's gamma_curve.comp writes the
    Curve that lut1d reads) per node against the JAX package's program on
    the same graph: bit-equal (the curve is a uniform loop of pow)."""
    x = rand_image(24, 40, seed=12)
    prog = build_program(LUT1D_CONFIG, 40, 24, fmt, device="cpu", shader_path=PORT_SHADER_DIR)
    got = prog._forward(torch.from_numpy(x), 0.0).float().numpy()
    jprog = jmake_program(jbuild_graph(jconfig.parse_file(LUT1D_CONFIG, True, PORT_SHADER_DIR)),
                          40, 24, fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(0.0)))
    np.testing.assert_array_equal(got, want.astype(np.float32))
