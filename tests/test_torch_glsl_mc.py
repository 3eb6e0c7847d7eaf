"""GLSL point shaders and zero-border GLSL convs on the mc tier of the
PyTorch port, on the CPU.

A point shader becomes an op list (``glsl/lower.py``), lowered from the
port's interpreter; its plain version is held bit-equal to the
interpreter for every shipped shader that lowers, and every other shader
is refused with a reason.  The graphs that plan the mc tier with such a
stage (the reference's ``TestGlslMegakernel`` cases, tests/test_graph.py,
and the examples with the shipped shaders) and the zero-border graphs (its
``test_zero_border_glsl_conv_fuses`` and
``test_mixed_borders_fall_to_segments``) run here on their plans, every
kernel in its plain version, against the JAX package per node.
"""

import dataclasses
import glob
import os
import re
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.config import parse_file as jparse_file
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph.program import GraphProgram as JProgram
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    DEMO_CONFIG, EXAMPLES_DIR, PORT_SHADER_DIR, REPO_DIR, SHADER_DIR, build_program, plan_steps,
    point_graphs,
)
from reforge_tpu_torch.glsl import affine, lower, translate_shader
from reforge_tpu_torch.graph import program as tprogram
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.base import KernelContext

from test_torch_glsl_graph import _check as _engine_check
from test_torch_glsl_graph import _render_both, _u8

H, W = 48, 128
T = 0.3
SHADERS = sorted(glob.glob(os.path.join(SHADER_DIR, "*")) +
                 glob.glob(os.path.join(PORT_SHADER_DIR, "*")))
# The shipped shaders that must lower, and the refusals pinned with the
# word their reason holds.
MUST_LOWER = {"invert", "sepia", "tonemap", "blend", "vignette", "passthrough", "mandelbrot",
              "iterate", "bits", "hash", "composite3", "wide", "crt", "zoom", "glass"}
REFUSED = {"histogram": "atomics", "kuwahara": "per-lane array indexing",
           "gamma_curve": "storage buffers", "gaussian_h": "halo",
           "flow_field": "a gather inside a loop region", "ink_drip": "scatter"}

# The op set beyond the shipped shaders: the frame time, uint arithmetic
# that wraps, int division and remainder, casts, a per-pixel branch, a
# counted loop, transcendentals, comparisons and selects.
OPS_PROBE = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform UBO { float gain; int levels; float _rf_time; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    uint h = uint(pos.x) * 2654435761u + uint(pos.y) * 40503u;
    float noise = float(h % 1024u) / 1023.0;
    int q = pos.x / 3 - pos.y % 5 - 7;
    float t = fract(_rf_time * 0.37 + float(q) * 0.01);
    vec3 v = c.rgb * gain;
    if (c.r > 0.5) {
        v = sqrt(v) + vec3(sin(t), cos(t), exp2(-t));
    } else {
        v = pow(v, vec3(2.2)) * abs(sign(c.g - 0.5)) + atan(c.b, 0.5 - t);
    }
    for (int i = 0; i < 3; i++) {
        v += 0.01 * float(i) * v;
    }
    float m = mod(float(pos.x) + _rf_time, 7.0);
    v = clamp(mix(v, vec3(noise), 0.1), 0.0, 1.0) + step(3.5, m) * 0.05;
    float lv = floor(v.r * float(levels)) / float(levels);
    bool edge = pos.x == 0 || pos.y == size.y - 1;
    int iq = int(lv * 255.0) / -2;
    imageStore(output_image, pos,
               vec4(edge ? 1.0 : lv, log(1.0 + v.g) + float(iq) * 1e-3,
                    max(v.b, min(t, 0.5)), c.a * inversesqrt(1.0 + c.a)));
}
"""
# Shifts of i32 and uint by counts 0, 31, 32, 33 and -1 (a count outside
# [0, 32) shifts every bit out), of negative ints (>> keeps the sign) and
# of uints past 2^31, with the builtins built on shifts.
SHIFT_PROBE = OPS_PROBE.replace("uint(pos.y) * 40503u", "(uint(pos.y) >> 1u)").replace(
    "    float m = mod(",
    """    int k = 0;
    if (pos.x % 5 == 1) { k = 31; } else if (pos.x % 5 == 2) { k = 32; }
    else if (pos.x % 5 == 3) { k = 33; } else if (pos.x % 5 == 4) { k = -1; }
    int sv = int(c.g * 4000.0) - 2000;
    uint big = 2147483648u + uint(c.r * 2000000000.0);
    int sl = sv << k;
    int sr = sv >> k;
    uint ul = big << uint(k);
    uint ur = big >> uint(k);
    int bc = bitCount(big) + findMSB(sv) + findLSB(big) + bitCount(ur);
    v.g += float(sl & 1023) * 1e-4 + float(sr) * 1e-5 + float(ul >> 20u) * 1e-7
           + float(ur >> 16u) * 1e-6 + float(bc) * 1e-3;
    float m = mod(""")


@pytest.fixture(autouse=True)
def _quiet_and_fresh(tmp_path, monkeypatch):
    tutils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    affine._SYNTH_CACHE.clear()
    yield
    affine._SYNTH_CACHE.clear()


def tmp_empty():
    """An empty shader path: the builtins under their own names."""
    return tempfile.TemporaryDirectory(prefix="rf_empty_")


def _spec(path):
    with open(path) as f:
        src = f.read()
    return translate_shader(src, os.path.basename(path).split(".")[0], path=path)


def _param_sets(spec):
    """The defaults, and a second set of every declared param."""
    other = {}
    for name, decl in spec.params.items():
        kind = decl.kind.name
        other[name] = {"FLOAT": 0.7, "INT": 3, "BOOL": True}[kind]
    return [spec.resolve_params({}), spec.resolve_params(other)]


def _interp_and_plain(spec, params, prog, t=T, seed=3):
    rng = np.random.default_rng(seed)
    ins = [torch.from_numpy(rng.random((4, H, W), dtype=np.float32)) for _ in spec.images_in]
    ctx = KernelContext(width=W, height=H, time=t, device="cpu")
    want = spec(ctx, dict(zip(spec.images_in, ins)), params)["output_image"]
    gy = torch.arange(H).view(-1, 1).expand(H, W)
    gx = torch.arange(W).view(1, -1).expand(H, W)
    return lower.point_program_plain(prog, ins, gy, gx, t), want


@pytest.mark.parametrize("path", SHADERS, ids=lambda p: os.path.basename(p))
def test_every_shader_lowers_or_is_refused(path):
    """(a) Each shipped shader either lowers, and then the op list's plain
    version is bit-equal to the port's interpreter at 48x128 in f32 (with
    the coordinates, and two parameter sets), or is refused with a
    reason."""
    stem = os.path.basename(path).split(".")[0]
    spec = _spec(path)
    for params in _param_sets(spec):
        got = lower.lower_point(spec, params, W, H)
        if isinstance(got, str):
            assert got and stem not in MUST_LOWER, (stem, got)
            if stem in REFUSED:
                assert REFUSED[stem] in got, (stem, got)
            continue
        assert stem not in REFUSED
        # the narrow op word, but for wide.comp at its default 48 taps
        assert got.n_f <= lower.WIDE_MAX and got.n_i <= lower.WIDE_MAX
        assert got.narrow or (stem == "wide" and params["taps"] == 0)
        # the images it reads, in the spec's order (mandelbrot.comp reads none)
        assert got.images == tuple(n for n in spec.images_in if n in got.images)
        assert got.images == spec.images_in or stem == "mandelbrot"
        plain, want = _interp_and_plain(spec, params, got)
        np.testing.assert_array_equal(plain.numpy(), want.numpy())
    if stem in MUST_LOWER:
        got = lower.lower_point(spec, spec.resolve_params({}), W, H)
        assert isinstance(got, lower.PointProgram)


def test_vignette_reads_coordinates_and_tonemap_not():
    vig = lower.lower_point(_spec(os.path.join(SHADER_DIR, "vignette.comp")), {}, W, H)
    tm = lower.lower_point(_spec(os.path.join(SHADER_DIR, "tonemap.comp")), {}, W, H)
    assert vig.reads_coords and not vig.reads_time
    assert not tm.reads_coords and not tm.reads_time
    # imageSize folds in: the same shader lowers to other constants elsewhere.
    vig2 = lower.lower_point(_spec(os.path.join(SHADER_DIR, "vignette.comp")), {}, W + 8, H)
    assert vig2.consts != vig.consts


@pytest.mark.parametrize("t", [0.0, 0.3, 17.25])
@pytest.mark.parametrize("params", [{"gain": 1.3, "levels": 7}, {"gain": 0.4, "levels": 2}])
def test_op_probe_is_bit_equal(tmp_path, params, t):
    """The op set beyond the shipped shaders (time, wrapping uint, int
    division, casts, a branch, a counted loop, transcendentals), bit-equal
    to the interpreter; the op list reads the time and the coordinates."""
    path = tmp_path / "probe.comp"
    path.write_text(OPS_PROBE)
    spec = _spec(str(path))
    params = spec.resolve_params(params)
    prog = lower.lower_point(spec, params, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    assert prog.reads_time and prog.reads_coords
    names = {lower.KERNEL_OPS[op[0]] for op in prog.ops}
    for name in ("F2I", "I2F", "L2I", "IDIV", "IFMOD", "FWHERE", "FSIN", "FPOW", "FATAN2",
                 "FFLOOR", "FCLAMP", "FLOG", "ILNOT"):
        assert name in names, name
    assert any(op[1] == lower.I64 for op in prog.ops)  # uint arithmetic in int64
    # sin and cos: the header flags the list for the kernel's trig forms
    assert prog.packed()[lower.HEAD_INTS - 1] == 1
    plain, want = _interp_and_plain(spec, params, prog, t=t)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())


@pytest.mark.parametrize("t", [0.0, 17.25])
def test_shift_is_refused(tmp_path, t):
    """Shifts lower now (ISHL, ISHR, in i32 and in the uint's int64),
    bit-equal to the interpreter: counts 0, 31, 32, 33 and -1, negative
    ints, uints past 2^31, bitCount, findMSB and findLSB.  A shift of
    booleans (no GLSL shader makes one) is still refused, with that
    reason."""
    path = tmp_path / "shift.comp"
    path.write_text(SHIFT_PROBE)
    spec = _spec(str(path))
    params = spec.resolve_params({"gain": 1.3, "levels": 7})
    prog = lower.lower_point(spec, params, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    kinds = {(lower.KERNEL_OPS[op], typ) for op, typ, *_ in prog.ops}
    for want in (("ISHL", lower.I32), ("ISHR", lower.I32), ("ISHL", lower.I64),
                 ("ISHR", lower.I64)):
        assert want in kinds, want
    assert prog.packed()[lower.HEAD_INTS - 1] == 3  # sinf and cosf, and shifts
    plain, want = _interp_and_plain(spec, params, prog, t=t)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    rec = lower._Recorder(H, W)
    with pytest.raises(lower.Refused, match="a shift of torch.bool"):
        rec.binary(torch.ops.aten.__lshift__, "__lshift__",
                   [rec.emit("LOAD", lower.F32, (0, 0)), lower._Py(1)], {}, lower.BOOL)


def test_in_place_update_is_refused_and_a_shift_is_not():
    """An aten op that updates a per-pixel value in place is refused as
    "in-place update"; a shift's dunder name (``__rshift__``) is no
    in-place update (the refusal label once matched it)."""
    rec = lower._Recorder(H, W)
    x = torch.empty((H, W), dtype=torch.int32, device="meta")
    rec.bind(x, rec.emit("COORD_X", lower.I64))
    with rec:
        y = x >> 1
        z = torch.bitwise_left_shift(y, x)
        with pytest.raises(lower.Refused, match=r"in-place update \(add_\)"):
            z.add_(1)
    assert rec.refused == "in-place update (add_)"
    names = [lower.KERNEL_OPS[op] for op, *_ in rec.nodes]
    assert "ISHR" in names and "ISHL" in names
    rec = lower._Recorder(H, W)
    x = torch.empty((H, W), dtype=torch.int32, device="meta")
    rec.bind(x, rec.emit("COORD_X", lower.I64))
    with rec:
        with pytest.raises(lower.Refused, match=r"in-place update \(__irshift__\)"):
            x.__irshift__(1)


# Per-pixel loops: each lowers to loop regions, bit-equal to the
# interpreter's whole-image rounds (a while, a for with a per-pixel
# bound, a do, nested loops, break, continue, a function's loop with a
# valued return).
LOOP_CASES = {
    "while": """
    float v = c.r; int n = 0;
    while (v < 1.3 && n < 20) { v = v * 1.2 + 0.05; n++; }
    o = vec4(v, float(n), c.b, 1.0);""",
    "for_per_pixel_bound": """
    int m = int(c.g * 9.0) + pos.x % 3; float a = 0.0;
    for (int i = 0; i < m; i++) { a += c.r * float(i) + 0.1; }
    o = vec4(a, float(m), c.b, 1.0);""",
    "do": """
    float v = c.r; int n = 0;
    do { v = v * 1.5; n += 2; } while (v < 2.0);
    o = vec4(v, float(n), c.b, 1.0);""",
    "nested": """
    float s = 0.0; int i = 0;
    while (i < int(c.r * 6.0)) {
        int j = 0;
        while (j < int(c.g * 5.0) + i) { s += float(j) * 0.01 + c.b; j++; }
        i++;
    }
    o = vec4(s, float(i), c.b, 1.0);""",
    "break": """
    float v = c.r; int n = 0;
    while (n < 30) { if (v > 1.4) { break; } v = v * 1.1 + 0.02; n++; }
    o = vec4(v, float(n), c.b, 1.0);""",
    "continue": """
    float a = 0.0; int k = int(c.r * 12.0);
    for (int i = 0; i < k; i++) { if (i % 3 == int(c.g * 3.0)) { continue; } a += float(i) * c.b; }
    o = vec4(a, float(k), c.b, 1.0);""",
    "function_return": """
    o = vec4(run(c.r, 1.5), run(c.g, 0.9 + c.b), c.b, 1.0);""",
}
LOOP_FN = """float run(float v0, float lim) {
    float v = v0; int n = 0;
    while (v < lim && n < 25) {
        if (v > 1.2) { return v * 2.0 + float(n); }
        v = v * 1.3 + 0.05; n++;
    }
    return v - float(n);
}
"""


def _loop_source(body: str) -> str:
    return ("#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
            "layout (binding = 0, rgba32f) uniform readonly image2D input_image;\n"
            "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
            + LOOP_FN + "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
            "    vec4 c = imageLoad(input_image, pos);\n    vec4 o;" + body
            + "\n    imageStore(output_image, pos, o);\n}\n")


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_loop_lowers_bit_equal(case, tmp_path):
    """Each loop case lowers to an op list with a loop region (two for
    nested loops and the function called twice), whose plain version runs
    the interpreter's rounds bit for bit at 48x128; each back-edge names
    the body's first op, which lies before it, and the round cap."""
    path = tmp_path / f"{case}.comp"
    path.write_text(_loop_source(LOOP_CASES[case]))
    spec = _spec(str(path))
    prog = lower.lower_point(spec, {}, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    loops = [(j, refs) for j, (op, _t, _d, refs) in enumerate(prog.ops)
             if op == lower.K["LOOP"]]
    assert len(loops) == (2 if case in ("nested", "function_return") else 1)
    assert prog.packed()[lower.HEAD_INTS - 1] == 2  # the kernel's forms with loops
    for j, (active, cap, target, trips) in loops:
        assert 0 <= target < j and active >= lower.I_BASE
        assert prog.consts[-1 - cap].value == lower.Interp._WHILE_CAP
        assert 1 <= trips <= lower.Interp._WHILE_CAP
    plain, want = _interp_and_plain(spec, {}, prog)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())


def test_loop_trip_bounds():
    """The back-edge's trip bound: mandelbrot's ``n < cap`` at max_iter
    128 (its first round runs unrolled, the loop from n = 1) bounds the
    loop at 127 rounds, iterate.comp's two loops at max_n; a loop whose
    condition compares no stepped counter takes the interpreter's cap."""
    mb = _spec(os.path.join(SHADER_DIR, "mandelbrot.comp"))
    it = _spec(os.path.join(PORT_SHADER_DIR, "iterate.comp"))

    def trips(spec, params):
        prog = lower.lower_point(spec, spec.resolve_params(params), W, H)
        return [refs[3] for op, _t, _d, refs in prog.ops if op == lower.K["LOOP"]]

    assert trips(mb, {"max_iter": 128.0}) == [127]
    assert trips(mb, {}) == [95]  # the default cap, 96
    assert trips(it, {"max_n": 24}) == [24, 24]
    assert trips(it, {"max_n": 7}) == [7, 7]


def _ops_at(words) -> int:
    """Where a packed program's ops start within it: past the header, the
    float constants (padded to an even count) and the integer constants'
    two words each; in the wide op word (header flag 4) on a multiple of
    four words."""
    k_f, k_i = int(words[3]), int(words[4])
    at = lower.HEAD_INTS + k_f + k_f % 2 + 2 * k_i
    return at + at % 4 if int(words[lower.HEAD_INTS - 1]) & 4 else at


def test_packed_program_layout():
    """The words the kernel reads: the header (ending in a zero pad), the
    float constants' bits (a zero after them where their count is odd), the
    integer constants' two words, then two words an op, the ops on an even
    word of the list; each operand its register's index in its file, or
    CONST | k for the k-th constant of its class, which the constant
    tables hold at k (no constant is a register any more)."""
    prog = lower.lower_point(_spec(os.path.join(SHADER_DIR, "vignette.comp")), {}, W, H)
    words = prog.packed().astype(np.int64) & 0xFFFFFFFF
    fk = [c for c in prog.consts if c.typ == lower.F32]
    ik = [c for c in prog.consts if c.typ != lower.F32]
    assert fk and ik and prog.n_i > 0
    assert list(words[:5]) == [prog.n_ops, prog.n_f, prog.n_i, len(fk), len(ik)]
    head = lower.HEAD_INTS
    assert head % 2 == 0 and words[head - 1] == 0  # flags: no sinf, cosf or tanf
    ftab = [int(w) for w in words[head:head + len(fk)]]
    assert ftab == [lower._register_bits(lower.F32, c.value) for c in fk]
    at_i = head + len(fk) + len(fk) % 2
    assert at_i % 2 == 0 and (len(fk) % 2 == 0 or words[at_i - 1] == 0)
    ints = words[at_i:at_i + 2 * len(ik)]
    itab = [int(lo) | int(hi) << 32 for lo, hi in zip(ints[0::2], ints[1::2])]
    assert itab == [lower._register_bits(c.typ, c.value) for c in ik]
    start = _ops_at(words)
    assert start == at_i + 2 * len(ik) and start % 2 == 0
    ops = words[start:]
    assert len(ops) == 2 * prog.n_ops

    def field_value(field, is_float):
        """The constant a CONST field names, from the tables, else None."""
        if not field & lower.CONST:
            return None
        k = field & (lower.CONST - 1)
        return ftab[k] if is_float else itab[k]

    def want_field(ref):
        if ref >= 0:
            return ref - lower.I_BASE if ref >= lower.I_BASE else ref
        return lower.CONST | prog._slots()[-1 - ref]

    n_const = 0
    for (op, typ, dst, refs), w0, w1 in zip(prog.ops, ops[0::2], ops[1::2]):
        assert w0 & 255 == op
        assert (w0 >> 8) & 255 == (dst - lower.I_BASE if dst >= lower.I_BASE else dst)
        assert (w1 >> 16) & 1 == (typ == lower.I32)
        fields = [(w0 >> 16) & 255, w0 >> 24, w1 & 255, (w1 >> 8) & 255]
        if op == lower.K["LOAD"]:
            assert fields[:2] == list(refs)
            continue
        for a, got in zip(refs, fields):
            assert got == want_field(a)
            if a < 0:
                n_const += 1
                c = prog.consts[-1 - a]
                assert field_value(got, c.typ == lower.F32) == lower._register_bits(c.typ, c.value)
            else:
                assert not got & lower.CONST
    assert n_const > 0
    assert list(words[5:9]) == [want_field(o) for o in prog.outputs]


def test_kernel_opcodes_match_the_kernel_source():
    """glsl/lower.py KERNEL_OPS and the kernel's GlslKop enum: the same
    names in the same order (the packed opcodes index both)."""
    src = (REPO_DIR / "reforge_tpu_torch" / "csrc" / "graph_strip_mc.cu").read_text()
    body = src.split("enum GlslKop : int {")[1].split("};")[0]
    names = [item.strip().split("=")[0].strip() for item in body.split(",") if item.strip()]
    assert names == [f"K_{name}" for name in lower.KERNEL_OPS]
    assert f"kGlslHead = {lower.HEAD_INTS}, kGlslConst = {lower.CONST:#x};" in src
    # the glsl form is compiled for each of the pixels a thread a plan may
    # take, without and with the trig ops, without and with the ops of
    # loops and shifts
    forms = set(re.findall(r"launch<T, true, (\d)(, true|, false)?(, true)?>", src))
    assert forms - {("0", "", "")} == {
        (str(p), t, e) for p in cuda_ops.MC_GLSL_PIXELS
        for t, e in (("", ""), (", true", ""), (", false", ", true"), (", true", ", true"))}
    # and the wide form: one pixel a thread, every op, the wide word's bit
    assert src.count("return launch<T, true, 1, true, true, true>(") == 1
    assert f"kGlslWideConst = {lower.WIDE_CONST:#x};" in src
    assert "constexpr int kThreads = 256;" in (
        REPO_DIR / "reforge_tpu_torch" / "csrc" / "conv_tile.cuh").read_text()


# ---- the mc tier -----------------------------------------------------------------

# The reference's TestGlslMegakernel.CASES (tests/test_graph.py:1137-1166).
MEGAKERNEL_CASES = {
    "pair_compose": (
        "input -> gh -> gv -> tm -> output\n"
        "gh: gaussian_h { sigma: 2.0 }\ngv: gaussian_v { sigma: 2.0 }\n"
        "tm: tonemap { exposure: 1.1 }"
    ),
    "stencil_synth": (
        "input -> sh -> tm -> output\n"
        "sh: sharpen { amount: 0.7 }\ntm: tonemap { exposure: 1.0 }"
    ),
    "conv_point": "input -> gh -> sep -> output\ngh: gaussian_h { sigma: 3.0 }\nsep: sepia {}",
    "glsl_point_builtin_conv": (
        "input -> tm -> b -> output\n"
        "tm: tonemap { exposure: 1.2 }\nb: blur { sigma: 2.0 }"
    ),
    "single_1d": "input -> gv -> tm -> output\ngv: gaussian_v { sigma: 2.0 }\ntm: tonemap {}",
}
FORMATS = ("rgba32f", "rgba16f", "rgba8")


def _jax_per_node(config, shader_dir, fmt, x, t=T):
    jprog = JProgram(jbuild(jparse_file(config, True, shader_dir)), W, H, fmt)
    return np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(t)).astype(jnp.float32))


def _input(fmt, seed=5):
    x = np.random.default_rng(seed).random((4, H, W), dtype=np.float32)
    if fmt == "rgba16f":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _within_tier(fmt, got, want, what, codes=2):
    """PERF.md's tier bounds against per node: rgba32f 1e-5 (here the
    reference test's 5e-5 where it says so), rgba16f 2e-2, rgba8 a few
    codes (a rounding that flips a bucket before a store, carried on)."""
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    bound = {"rgba16f": 2e-2, "rgba8": codes / 255.0 + 1e-6}[fmt]
    assert d <= bound, (what, d)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(MEGAKERNEL_CASES))
def test_glsl_megakernel_cases(name, fmt):
    """(b) Each case plans the mc tier with a GLSL point or synthesized
    stage and matches the JAX package per node: within the reference
    test's 5e-5 in rgba32f, within the tier's bounds in rgba16f and rgba8
    (sharpen.comp at 0.7 amplifies a flipped code up to 1 + 8 * 0.7)."""
    config = MEGAKERNEL_CASES[name]
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=SHADER_DIR)
    plan = prog._strip_plan
    assert plan is not None and plan[0] == "mc" and plan[1].mode == "edge"
    codes = [st.op.code for st in plan[1].stages]
    assert cuda_ops.MC_GLSL in codes  # tonemap.comp or sepia.comp
    x = _input(fmt)
    got = prog._forward(torch.from_numpy(x.copy()), T).float().numpy()
    want = _jax_per_node(config, SHADER_DIR, fmt, x)
    if fmt == "rgba32f":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    else:
        _within_tier(fmt, got, want, name, codes=7 if name == "stencil_synth" else 2)


@pytest.mark.parametrize("name", ["glsl_chain", "glsl_sharpen", "tonemap_sharpen",
                                  "blur_sharpen_blend", "bloom_glow", "mandelbrot_after_blur",
                                  "iterate_after_blur", "bits_after_blur", "hash_after_blur",
                                  "composite3", "composite3_raw_mask", "wide_after_blur"])
def test_point_graphs_plan_mc_with_no_per_node_step(name, monkeypatch):
    """glsl-chain, glsl-sharpen, tonemap.comp before sharpen.comp and
    blur_sharpen_blend with the shipped shaders, the loop and shift
    graphs (mandelbrot.comp, iterate.comp, bits.comp after a blur), and
    the bit-cast, three-image and wide graphs (hash.comp, composite3.comp
    with a threshold's mask and with the input's, wide.comp): the mc
    tier, a GLSL point stage each, at 48x128 and at 4K (planning only).  bloom_glow's mc plan
    (a GLSL point stage too) passes the tier rule's bound on halo work a
    stage, so the graph runs per node (no segment takes a node of it)."""
    config, shader_dir = point_graphs()[name]
    for w, h in ((W, H), (3840, 2160)):
        prog = build_program(config, w, h, device="cpu", shader_path=shader_dir)
        if name == "bloom_glow":
            assert prog._strip_plan is None and plan_steps(prog)[0][0] == "per-node", w
            with monkeypatch.context() as m:
                m.setattr(tprogram, "MC_MAX_HALO_WORK", float("inf"))
                mc = prog._plan_strip_mc()
            assert cuda_ops.MC_GLSL in [st.op.code for st in mc.stages]
            assert mc.halo_work()[1] / len(mc.stages) > tprogram.MC_MAX_HALO_WORK
            continue
        assert plan_steps(prog)[0][0] == "mc", (name, w)
        assert cuda_ops.MC_GLSL in [st.op.code for st in prog._strip_plan[1].stages]
        assert prog._strip_plan[1].tile() is not None


def _op_list_word(mc, stage: int) -> int:
    """The shared-memory word (a float's index) where the kernel finds the
    ops of MC_GLSL stage ``stage``: past the float taps, the list's start
    in the int words, the header and the constants."""
    th, tw, _smem = mc.tile()
    stage_i, _f, _scratch, taps_off = mc.packed(th, tw)
    words = np.asarray(mc.stages[stage].taps[0])
    return taps_off + len(mc.taps) + int(stage_i[stage][17]) + _ops_at(words)


@pytest.mark.parametrize("fmt", FORMATS)
def test_point_stage_before_an_odd_length_stencil(fmt):
    """tonemap.comp before sharpen.comp: the stencil's tap lists leave the
    taps an odd count, and the planner pads them, so the op list's ops
    still start on an even word of shared memory (the kernel reads an op
    as one 8-byte load); against the JAX package per node, within
    PERF.md's tier bounds (sharpen.comp at 0.7 amplifies a flipped code up
    to 1 + 8 * 0.7)."""
    config, shader_dir = point_graphs()["tonemap_sharpen"]
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=shader_dir)
    plan = prog._strip_plan
    assert plan is not None and plan[0] == "mc"
    mc = plan[1]
    codes = [st.op.code for st in mc.stages]
    assert sum(mc._lists[i][1] + mc._lists[i][3] for i, c in enumerate(codes)
               if c != cuda_ops.MC_GLSL) % 2 == 1  # the stencil's terms: an odd count
    assert _op_list_word(mc, codes.index(cuda_ops.MC_GLSL)) % 2 == 0
    x = _input(fmt, seed=13)
    got = prog._forward(torch.from_numpy(x.copy()), T).float().numpy()
    want = _jax_per_node(config, shader_dir, fmt, x)
    if fmt == "rgba32f":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        _within_tier(fmt, got, want, "tonemap_sharpen", codes=7)


@pytest.mark.parametrize("size", [(W, H), (3840, 2160)], ids=["48x128", "4K"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(point_graphs()))
def test_every_glsl_stage_starts_its_ops_on_an_even_word(name, fmt, size, monkeypatch):
    """Every MC_GLSL stage of every point_graphs() mc plan (bloom_glow's
    the plan the tier rule refuses): its list starts on an even word of
    the tap lists, the taps' count is even and the taps start on an even
    word of shared memory, so each op is one aligned 8-byte read (the wide
    graphs' lists: a multiple of four words, one 16-byte read); plans
    with no op list (the border graphs) keep their tap lists unpadded."""
    config, shader_dir = point_graphs()[name]
    prog = build_program(config, *size, fmt, device="cpu", shader_path=shader_dir)
    with monkeypatch.context() as m:
        m.setattr(tprogram, "MC_MAX_HALO_WORK", float("inf"))
        mc = prog._plan_strip_mc()
    if mc is None:  # mixed_border: the segment child's plan
        mc = next(step[1] for step in prog._strip_plan[1] if step[0] == "seg")._strip_plan[1]
    codes = [st.op.code for st in mc.stages]
    th, tw, _smem = mc.tile()
    _i, _f, _scratch, taps_off = mc.packed(th, tw)
    if cuda_ops.MC_GLSL not in codes:
        assert name in ("zero_border", "mixed_border")
        assert len(mc.taps) == sum(n for lists in mc._lists for n in lists[1::2])
        return
    assert len(mc.taps) % 2 == 0 and taps_off % 2 == 0
    wide = name == "wide_after_blur"
    align = 4 if wide else 2  # the wide word's ops: one 16-byte read each
    assert len(mc.taps) % align == 0 and taps_off % align == 0
    for i, code in enumerate(codes):
        if code == cuda_ops.MC_GLSL:
            assert lower.is_wide(mc.stages[i].taps[0]) == wide
            assert mc._lists[i][0] % align == 0
            assert _op_list_word(mc, i) % align == 0


@pytest.mark.parametrize("fmt", FORMATS)
def test_zero_border_glsl_conv_fuses(fmt):
    """(c) nblur.comp (zeros out of bounds) before the builtin tonemap: the
    mc tier in zero mode, within 5e-6 of the JAX package per node in
    rgba32f, borders included."""
    config, shader_dir = point_graphs()["zero_border"]
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=shader_dir)
    plan = prog._strip_plan
    assert plan is not None and plan[0] == "mc" and plan[1].mode == "zero"
    x = _input(fmt, seed=11)
    got = prog._forward(torch.from_numpy(x.copy()), 0.0).float().numpy()
    want = _jax_per_node(config, shader_dir, fmt, x, t=0.0)
    if fmt == "rgba32f":
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
        # the borders read zeros: the first column misses two taps' weight
        zero_pad = want[:3, :, 0]
        assert np.abs(got[:3, :, 0] - zero_pad).max() <= 5e-6
    else:
        _within_tier(fmt, got, want, "zero_border")


@pytest.mark.parametrize("fmt", FORMATS)
def test_mixed_borders_fall_to_segments(fmt):
    """(d) nblur.comp (zero) before the builtin gaussian (edge): no whole
    plan; segments, nblur a child in zero mode, gs per node; against the
    JAX package per node."""
    config, shader_dir = point_graphs()["mixed_border"]
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=shader_dir)
    assert prog._plan_strip_mc() is None
    plan = prog._strip_plan
    assert plan is not None and plan[0] == "segments"
    kinds = [(s[0], s[1].name if s[0] == "node" else [n.name for n in s[4]]) for s in plan[1]]
    assert kinds == [("seg", ["nblur"]), ("node", "gs")], kinds
    assert plan[1][0][1]._strip_plan[1].mode == "zero"
    x = _input(fmt, seed=12)
    got = prog._forward(torch.from_numpy(x.copy()), T).float().numpy()
    want = _jax_per_node(config, shader_dir, fmt, x)
    if fmt == "rgba32f":
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    else:
        _within_tier(fmt, got, want, "mixed_border")


def test_zero_mode_reading_an_intermediate_is_refused():
    """Zero mode holds only where no conv or stencil reads an intermediate:
    nblur.comp after a builtin point node plans no whole mc plan."""
    config = "input -> tm -> nblur -> output\ntm: tonemap {}\n"
    prog = build_program(config, W, H, device="cpu", shader_path=PORT_SHADER_DIR)
    assert prog._plan_strip_mc() is None
    assert plan_steps(prog) == [("node", ["tm"]), ("seg mc", ["nblur"])]


def test_point_only_graph_plans_no_mc_tier():
    """A graph of point stages only keeps no mc plan (nothing of halo work
    to share), as in the reference."""
    config = "input -> tm -> inv -> output\ntm: tonemap {}\ninv: invert {}\n"
    prog = build_program(config, W, H, device="cpu", shader_path=SHADER_DIR)
    assert prog._plan_strip_mc() is None


def test_refused_point_shader_keeps_its_old_plan(tmp_path):
    """mandelbrot.comp (a data-dependent loop, refused before loops
    lowered) after a conv now plans the mc tier, one kernel for both
    nodes, as the reference's mc planner does, and so does a bit cast
    (floatBitsToInt, refused before FBITS); a point shader the lowering
    still refuses (packHalf2x16: no f16 conversion in the op set) keeps
    the plan it had: segments, the conv a segment, the shader per node."""
    config = "input -> gv -> mb -> output\ngv: gaussian_v { sigma: 2.0 }\nmb: mandelbrot {}\n"
    prog = build_program(config, W, H, device="cpu", shader_path=SHADER_DIR)
    assert plan_steps(prog) == [("mc", ["gv", "mb"])]
    assert [st.op.code for st in prog._strip_plan[1].stages][-1] == cuda_ops.MC_GLSL
    jprog = JProgram(jbuild(jparse_file(config, True, SHADER_DIR)), W, H, "rgba32f")
    assert jprog._strip_plan[0] == "mc"
    (tmp_path / "bitcast.comp").write_text(
        "#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
        "layout (binding = 0, rgba32f) uniform readonly image2D input_image;\n"
        "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
        "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
        "    vec4 c = imageLoad(input_image, pos);\n"
        "    imageStore(output_image, pos, vec4(float(floatBitsToInt(c.r) & 255), c.gba));\n}\n")
    spec = _spec(str(tmp_path / "bitcast.comp"))
    prog = lower.lower_point(spec, {}, W, H)
    assert isinstance(prog, lower.PointProgram) and lower.K["FBITS"] in [op[0] for op in prog.ops]
    plain, want = _interp_and_plain(spec, {}, prog)
    np.testing.assert_array_equal(plain.numpy(), want.numpy())
    config = "input -> gv -> bc -> output\ngv: gaussian_v { sigma: 2.0 }\nbc: bitcast {}\n"
    (tmp_path / "gaussian_v.comp").write_text(
        open(os.path.join(SHADER_DIR, "gaussian_v.comp")).read())
    prog = build_program(config, W, H, device="cpu", shader_path=str(tmp_path))
    assert plan_steps(prog) == [("mc", ["gv", "bc"])]
    (tmp_path / "half.comp").write_text(
        (tmp_path / "bitcast.comp").read_text().replace(
            "float(floatBitsToInt(c.r) & 255)", "float(packHalf2x16(c.rg) & 255u)"))
    assert "float16" in lower.lower_point(_spec(str(tmp_path / "half.comp")), {}, W, H)
    prog = build_program(config.replace("bc: bitcast", "bc: half"), W, H, device="cpu",
                         shader_path=str(tmp_path))
    assert plan_steps(prog) == [("seg mc", ["gv"]), ("node", ["bc"])]


def test_loop_counts_by_its_trip_bound(monkeypatch):
    """McProgram._work counts an op of a loop region times the loop's
    trip bound (``lower.packed_work``, the back-edge's own field):
    mandelbrot.comp between a gaussian and a stencil that extends it by a
    halo is refused by the tier rule (MC_MAX_HALO_WORK), which a guess of
    one trip would pass; after the gaussian alone it plans the mc tier."""
    mb = lower.lower_point(_spec(os.path.join(SHADER_DIR, "mandelbrot.comp")),
                           {"max_iter": 128.0}, W, H)
    words = mb.packed()
    (loop_at, (_a, _c, target, trips)), = [
        (j, op[3]) for j, op in enumerate(mb.ops) if op[0] == lower.K["LOOP"]]
    body = loop_at + 1 - target
    assert lower.packed_work(words) == mb.n_ops - body + body * trips
    config = ("input -> gs -> mb -> sh -> output\ngs: gaussian { sigma: 2.0 }\n"
              "mb: mandelbrot { max_iter: 128.0 }\nsh: sharpen { amount: 0.5 }\n")
    prog = build_program(config, W, H, device="cpu", shader_path=SHADER_DIR)
    assert prog._plan_strip_mc() is None
    limit = tprogram.MC_MAX_HALO_WORK
    with monkeypatch.context() as m:
        m.setattr(tprogram, "MC_MAX_HALO_WORK", float("inf"))
        mc = prog._plan_strip_mc()
    assert mc is not None and mc.halo_work()[1] / len(mc.stages) > limit
    with monkeypatch.context() as m:
        m.setattr(lower, "packed_work", lambda w: int(w[0]))  # one trip
        assert prog._plan_strip_mc() is not None
    after = "input -> gs -> mb -> output\ngs: gaussian { sigma: 2.0 }\nmb: mandelbrot {}\n"
    prog = build_program(after, W, H, device="cpu", shader_path=SHADER_DIR)
    assert plan_steps(prog) == [("mc", ["gs", "mb"])]


def test_warm_rebuild_lowers_nothing(monkeypatch):
    """The op list is cached by source, params, frame and output: a second
    program of the same graph, and a graph that shares the node, lower
    nothing; a param edit lowers again."""
    monkeypatch.setattr(tprogram, "_POINT_PROGRAMS", {})
    monkeypatch.setattr(tprogram, "_PROGRAMS", {})
    calls = []
    real = tprogram.lower_point
    monkeypatch.setattr(tprogram, "lower_point",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    config, shader_dir = point_graphs()["glsl_chain"]
    build_program(config, W, H, device="cpu", shader_path=shader_dir)._strip_plan
    assert len(calls) == 1
    tprogram._PROGRAMS.clear()
    build_program(config, W, H, device="cpu", shader_path=shader_dir)._strip_plan
    assert len(calls) == 1
    edited = config.replace("exposure: 1.1", "exposure: 1.3")
    build_program(edited, W, H, device="cpu", shader_path=shader_dir)._strip_plan
    assert len(calls) == 2 and calls[-1]["exposure"] == 1.3


def test_glsl_stage_packs_its_words_into_the_tap_lists():
    config, shader_dir = point_graphs()["glsl_chain"]
    prog = build_program(config, W, H, device="cpu", shader_path=shader_dir)
    mc = prog._strip_plan[1]
    i = [st.op.code for st in mc.stages].index(cuda_ops.MC_GLSL)
    st = mc.stages[i]
    off, n = mc._lists[i][:2]
    assert off % 2 == 0 and len(mc.taps) % 2 == 0  # the kernel's 8-byte reads
    np.testing.assert_array_equal(mc.term_idx[off:off + n], st.taps[0])
    assert not mc.taps[off:off + n].any()
    assert cuda_ops.mc_kind(cuda_ops.MC_GLSL) == cuda_ops.MC_POINT
    with pytest.raises(ValueError, match="border mode"):
        cuda_ops.McProgram(stages=mc.stages, n_slots=mc.n_slots, rh_in=0, ew_in=0, width=W,
                           height=H, fmt="rgba32f", mode="wrap")


def _without_files(mc, monkeypatch):
    """``mc``'s stages planned again with register files of no bytes."""
    with monkeypatch.context() as m:
        m.setattr(cuda_ops, "glsl_file_floats", lambda words, pixels: 0)
        return cuda_ops.McProgram(stages=mc.stages, n_slots=mc.n_slots, rh_in=mc.rh_in,
                                  ew_in=mc.ew_in, width=mc.width, height=mc.height, fmt=mc.fmt,
                                  mode=mc.mode)


@pytest.mark.parametrize("name", ["glsl_chain", "glsl_sharpen", "tonemap_sharpen",
                                  "blur_sharpen_blend", "zero_border", "demo"])
def test_tile_model_adds_the_files_only_for_op_lists(name, monkeypatch):
    """At 4K (planning only): a plan with an MC_GLSL stage adds its largest
    register files (a plane of 256 x pixels floats a float register, two
    floats wide an integer one) to the shared-memory layout only past the
    conv windows and scratch they overlay; it takes four pixels a thread
    only where those files fit beside the tile two pixels leave, in the
    same budget.  A plan with no op list (zero mode's nblur.comp before the
    builtin tonemap, the demo) adds nothing and keeps its tile and bytes."""
    if name == "demo":
        with tmp_empty() as empty:
            prog = build_program(DEMO_CONFIG, 3840, 2160, device="cpu", shader_path=empty)
    else:
        config, shader_dir = point_graphs()[name]
        prog = build_program(config, 3840, 2160, device="cpu", shader_path=shader_dir)
    mc = prog._strip_plan[1]
    bare = _without_files(mc, monkeypatch)
    glsl = [st.taps[0] for st in mc.stages if st.op.code == cuda_ops.MC_GLSL]
    for pixels in cuda_ops.MC_GLSL_PIXELS:
        files = max(((int(w[1]) + 2 * int(w[2])) * 256 * pixels for w in glsl), default=0)
        assert mc._files(pixels) == files
        for th, tw in cuda_ops.MC_TILES:
            for n_win in cuda_ops.MC_WINDOW_BUFFERS:
                _slots, nbytes, geo = mc._layout(th, tw, n_win, pixels)
                _slots0, bare_bytes, bare_geo = bare._layout(th, tw, n_win, pixels)
                assert list(geo[[0, 2, 3, 4, 5, 6, 7, 8, 9]]) == \
                    list(bare_geo[[0, 2, 3, 4, 5, 6, 7, 8, 9]])
                if not glsl:
                    assert nbytes == bare_bytes
                    continue
                span_end = int(bare_geo[1])  # windows and scratch end where the taps start
                files_end = int(geo[5]) + files
                extra = max(0, files_end + files_end % 2 - span_end - span_end % 2)
                assert nbytes == bare_bytes + 4 * extra + 4 * (span_end % 2)
    th, tw, nbytes = mc.tile()
    pixels = int(mc.geometry(th, tw)[8])
    assert mc.tile()[:2] == bare.tile()[:2] or glsl
    if not glsl:
        assert mc.tile() == bare.tile() and mc.refusal() is None
        assert pixels == cuda_ops.MC_GLSL_PIXELS[0]
        return
    # the tile is the one the files at the fewest pixels leave; more pixels
    # only where their files fit beside it in the same budget
    first = cuda_ops.MC_GLSL_PIXELS[0]
    n_win = int(mc.geometry(th, tw)[7])
    budget = (cuda_ops.MC_SMEM_SOFT if mc._layout(th, tw, n_win, first)[1] <= cuda_ops.MC_SMEM_SOFT
              else cuda_ops.MC_SMEM_LIMIT)
    fitting = [p for p in cuda_ops.MC_GLSL_PIXELS if mc._layout(th, tw, n_win, p)[1] <= budget]
    assert pixels == fitting[-1] and nbytes == mc._layout(th, tw, n_win, pixels)[1]


def test_files_that_fit_no_tile_are_refused_with_a_reason(tmp_path, monkeypatch):
    """A point shader with 120 live float registers after a gaussian: its
    op list lowers in the narrow word, but its register files fit no tile
    at two pixels a thread, so the planner widens it (the wide form, one
    pixel a thread, the files in device memory, none in the layout).
    wide.comp at 80 taps (241 float registers) is wide from its lowering;
    where its files pass MC_FILES_DEVICE_LIMIT the mc planner refuses the
    plan while planning, warns with the reason, and the graph keeps the
    plan it has when the shader has no op list (per node)."""
    body = "".join(f"    float v{k} = c.r * {1.0 + k / 128.0};\n" for k in range(118))
    total = " + ".join(f"v{k}" for k in range(118))
    (tmp_path / "wide.comp").write_text(
        "#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
        "layout (binding = 0, rgba32f) uniform readonly image2D input_image;\n"
        "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
        "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
        "    vec4 c = imageLoad(input_image, pos);\n" + body
        + f"    imageStore(output_image, pos, vec4({total}, c.g, c.b, c.a));\n}}\n")
    config = "input -> gs -> wide -> output\ngs: gaussian { sigma: 2.0 }\nwide: wide {}\n"
    prog = build_program(config, W, H, device="cpu", shader_path=str(tmp_path))
    point = prog._glsl_point(next(n for n in prog.graph.ordered_nodes if n.name == "wide"))
    assert isinstance(point, lower.PointProgram) and point.n_f > 100 and point.narrow
    mc = prog._plan_strip_mc()
    glsl = [st.taps[0] for st in mc.stages if st.op.code == cuda_ops.MC_GLSL]
    assert lower.is_wide(glsl[0]) and mc._wide
    th, tw, nbytes = mc.tile()
    geo = mc.geometry(th, tw)
    assert int(geo[8]) == 1 and int(geo[9]) & 4
    assert nbytes == mc._layout(th, tw, int(geo[7]))[1] < 4 * mc._files(1)
    narrow = cuda_ops.McProgram(stages=[st for st in mc.stages if st.op.code != cuda_ops.MC_GLSL]
                                + [dataclasses.replace(mc.stages[-1], taps=(point.packed(),))],
                                n_slots=mc.n_slots, rh_in=mc.rh_in, ew_in=mc.ew_in, width=W,
                                height=H, fmt=mc.fmt)
    assert narrow.tile() is None and "register files" in narrow.refusal()
    config = config.replace("wide: wide {}", "wide: wide { taps: 80 }")
    prog = build_program(config, W, H, device="cpu", shader_path=PORT_SHADER_DIR)
    assert plan_steps(prog) == [("mc", ["gs", "wide"])] and prog._strip_plan[1]._wide
    need = prog._strip_plan[1].device_file_bytes()
    monkeypatch.setattr(cuda_ops, "MC_FILES_DEVICE_LIMIT", need - 4)
    monkeypatch.setattr(tprogram, "_PROGRAMS", {})
    prog = build_program(config, W, H, device="cpu", shader_path=PORT_SHADER_DIR)
    tutils.clear_warnings()
    assert prog._plan_strip_mc() is None
    said = [w for w in tutils.recent_warnings() if "wide" in w]
    assert said and "register files" in said[0] and f"{need} bytes a block" in said[0], said
    steps = plan_steps(prog)
    with monkeypatch.context() as m:
        m.setattr(tprogram, "_PROGRAMS", {})
        m.setattr(tprogram.GraphProgram, "_glsl_point", lambda self, node: None)
        plain = build_program(config, W, H, device="cpu", shader_path=PORT_SHADER_DIR)
        assert plan_steps(plain) == steps == [("per-node", ["gs", "wide"])]


SHIPPED_POINT = {"invert": "", "sepia": "", "tonemap": "", "vignette": "", "passthrough": "",
                 "blend": "input -> s:input_image2\n"}


@pytest.mark.parametrize("size", [(W, H), (3840, 2160)], ids=["48x128", "4K"])
@pytest.mark.parametrize("stem", sorted(SHIPPED_POINT))
def test_every_shipped_point_shader_plans_the_mc_tier(stem, size):
    """Each shipped point shader that lowers, after a builtin gaussian (a
    point stage after a conv adds no halo recompute), plans the mc tier
    with its MC_GLSL stage, its register files inside the tile's layout."""
    config = ("input -> gs -> s -> output\n" + SHIPPED_POINT[stem]
              + f"gs: gaussian {{ sigma: 2.0 }}\ns: {stem} {{}}\n")
    prog = build_program(config, *size, device="cpu", shader_path=SHADER_DIR)
    assert plan_steps(prog) == [("mc", ["gs", "s"])], stem
    mc = prog._strip_plan[1]
    assert cuda_ops.MC_GLSL in [st.op.code for st in mc.stages]
    th, tw, nbytes = mc.tile()
    geo = mc.geometry(th, tw)
    files = mc._files(int(geo[8]))
    assert nbytes <= cuda_ops.MC_SMEM_LIMIT and files > 0
    assert int(geo[5]) + files <= int(geo[1])


@pytest.mark.parametrize("example", ["blur_sharpen_blend", "bloom_glow"])
def test_examples_render_through_engine_like_jax(example, tmp_path, monkeypatch):
    """(e) The examples through the port's Engine from the repository root
    (the default shader path, shaders/) against the JAX Engine per node
    within PARITY.md's graph bound: blur_sharpen_blend on the mc tier with
    a GLSL point stage, bloom_glow per node (the tier rule against halo
    recompute refuses its mc plan)."""
    monkeypatch.chdir(REPO_DIR)
    path = tmp_path / f"{example}.rf"
    path.write_text((EXAMPLES_DIR / f"{example}.rf").read_text())
    engine, frame, per_node, want = _render_both(str(path), "rgba32f", _u8(4))
    plan = engine.program._strip_plan
    if example == "bloom_glow":
        assert plan is None
    else:
        assert plan is not None and plan[0] == "mc"
        assert cuda_ops.MC_GLSL in [st.op.code for st in plan[1].stages]
    _engine_check("rgba32f", frame, want, example)
    assert float(np.abs(frame - per_node).max()) <= 1e-5


@pytest.mark.parametrize("name", ["mandelbrot_after_blur", "iterate_after_blur",
                                  "bits_after_blur"])
def test_loop_graphs_render_through_engine_like_jax(name, tmp_path, monkeypatch):
    """The loop and shift graphs through the port's Engine (the mc tier,
    one MC_GLSL stage with its loop regions or shift ops) against the JAX
    Engine per node, and against the port's own per-node frame within
    1e-5.  mandelbrot.comp is held to the FMA watch item's share, as
    tests/test_torch_goldens.py holds it: XLA:CPU contracts its
    escape-time loop into FMAs, so at most 1% of the values may differ by
    more than one code; the others within PARITY.md's graph bound."""
    monkeypatch.chdir(REPO_DIR)
    config, shader_dir = point_graphs()[name]
    path = tmp_path / f"{name}.rf"
    path.write_text(config)
    engine, frame, per_node, want = _render_both(str(path), "rgba32f", _u8(6),
                                                 shader_path=shader_dir)
    plan = engine.program._strip_plan
    assert plan is not None and plan[0] == "mc"
    stages = plan[1].stages
    assert [st.op.code for st in stages].count(cuda_ops.MC_GLSL) == 1
    words = next(st.taps[0] for st in stages if st.op.code == cuda_ops.MC_GLSL)
    ops = np.asarray(words)[_ops_at(words)::2] & 255
    assert (lower.K["LOOP"] in ops) == (name != "bits_after_blur")
    assert (lower.K["ISHL"] in ops) == (name == "bits_after_blur")
    if name == "mandelbrot_after_blur":
        share = float((np.abs(frame - want) > 1.0 / 255.0).mean())
        assert share <= 0.01, share
    else:
        _engine_check("rgba32f", frame, want, name)
    assert float(np.abs(frame - per_node).max()) <= 1e-5
