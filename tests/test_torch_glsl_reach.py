"""The last reach of the mc planner's GLSL point stages in the PyTorch
port, on the CPU: bit casts (FBITS, IBITS), point shaders of three or
more input images (LOADX, the launch's table of inputs past the second)
and op lists past the narrow op word's 128 registers or constants of a
class, or past a tile's shared memory (the wide op word, one pixel a
thread, register files in device memory).

Each op list's plain version is held bit-equal to the port's
interpreter, the packed words to the ops they encode (read as the kernel
reads them), and the graphs of ``benchmarks.REACH_GRAPHS`` and the
three- and four-image composites against the JAX package per node.
"""

import os

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
    PORT_SHADER_DIR, REACH_GRAPHS, REPO_DIR, SHADER_DIR, build_program, plan_steps, point_graphs,
)
from reforge_tpu_torch.glsl import affine, lower, translate_shader
from reforge_tpu_torch.graph import program as tprogram
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.base import KernelContext

from test_torch_glsl_graph import _check as _engine_check
from test_torch_glsl_graph import _render_both, _u8

H, W = 48, 128
FORMATS = ("rgba32f", "rgba16f", "rgba8")
HEAD = ("#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
        "layout (binding = 0, rgba32f) uniform readonly image2D input_image;\n")
# f32 bit patterns of NaN payloads (quiet and signalling, both signs), both
# infinities, denormals, -0.0 and ordinary values.
SPECIALS = (0x7FC01234, 0xFFC00001, 0x7F800001, 0xFFBFFFFF, 0x7F800000, 0xFF800000, 0x00000001,
            0x807FFFFF, 0x80000000, 0x00000000, 0x3F800000, 0xBF000000)
# The four bit casts on those values and on negative integers: a view of
# the red channel's bits as an int and back, the green's as a uint with
# its sign flipped, a negative int (from the coordinates) as a float, the
# exponent and sign fields read with shifts.
BITCAST_PROBE = HEAD + """layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
layout (binding = 2) uniform UBO { float _rf_time; };
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    int bi = floatBitsToInt(c.r);
    uint bu = floatBitsToUint(c.g);
    float neg = intBitsToFloat(-pos.x * 40503 - 1 - (pos.y << 20));
    float flip = uintBitsToFloat(bu ^ 0x80000000u);
    int expo = (floatBitsToInt(c.b) >> 23) & 255;
    uint tb = floatBitsToUint(_rf_time) >> 31u;
    imageStore(output_image, pos,
               vec4(intBitsToFloat(bi), flip, neg,
                    float(expo) + float(bi < 0) * 0.5 + float(tb) * 0.25
                    + float(floatBitsToInt(flip) == int(bu ^ 0x80000000u)) * 0.125));
}
"""


@pytest.fixture(autouse=True)
def _quiet_and_fresh(tmp_path, monkeypatch):
    tutils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    affine._SYNTH_CACHE.clear()
    yield
    affine._SYNTH_CACHE.clear()


def _spec_of(path, text=None):
    if text is not None:
        with open(path, "w") as f:
            f.write(text)
    with open(path) as f:
        src = f.read()
    return translate_shader(src, os.path.basename(path).split(".")[0], path=path)


def _planes(h=H, w=W):
    return (torch.arange(h).view(-1, 1).expand(h, w), torch.arange(w).view(1, -1).expand(h, w))


def _interp(spec, params, ins, t):
    ctx = KernelContext(width=W, height=H, time=t, device="cpu")
    return spec(ctx, dict(zip(spec.images_in, ins)), params)["output_image"]


def _random_ins(spec, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((4, H, W), dtype=np.float32)) for _ in spec.images_in]


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    """Every word the same bits (NaN payloads too)."""
    np.testing.assert_array_equal(a.contiguous().view(torch.int32).numpy(),
                                  b.contiguous().view(torch.int32).numpy())


# ---- bit casts ---------------------------------------------------------------------


@pytest.mark.parametrize("t", [0.3, -17.25])
def test_bit_casts_on_special_values_are_bit_equal(tmp_path, t):
    """floatBitsToInt, floatBitsToUint, intBitsToFloat and uintBitsToFloat
    over NaN payloads, both infinities, denormals, -0.0 and negative
    integers: the op list (FBITS, IBITS; the uint forms the interpreter
    builds from them) bit-equal to the port's interpreter, every word,
    NaN payloads kept; the header flags the forms with the bit casts."""
    spec = _spec_of(str(tmp_path / "casts.comp"), BITCAST_PROBE)
    prog = lower.lower_point(spec, {}, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    names = [lower.KERNEL_OPS[op[0]] for op in prog.ops]
    assert "FBITS" in names and "IBITS" in names
    assert prog.packed()[lower.HEAD_INTS - 1] == 2 and prog.reads_time
    x = np.random.default_rng(4).random((4, H, W), dtype=np.float32)
    specials = np.array(SPECIALS, np.uint32).view(np.float32)
    for ch, step in ((0, 1), (1, 5), (2, 7)):
        flat = x[ch].reshape(-1)[::step]
        k = min(len(flat), 40 * len(specials))
        flat[:k] = np.resize(specials, k)
    ins = [torch.from_numpy(x)]
    want = _interp(spec, {}, ins, t)
    got = lower.point_program_plain(prog, ins, *_planes(), t)
    _bit_equal(got, want)
    # the payloads came through both ways, and negative ints became NaNs
    assert int((got[0].view(torch.int32) == 0x7FC01234).sum()) >= 40
    assert bool(torch.isnan(got[2]).any())


def test_bit_cast_recording():
    """A view of f32 as i32 records FBITS, of i32 as f32 IBITS; a
    constant's bits fold on the CPU; a view to another size or of a whole
    image is refused."""
    rec = lower._Recorder(H, W)
    x = torch.empty((H, W), dtype=torch.float32, device="meta")
    rec.bind(x, rec.emit("LOAD", lower.F32, (0, 0)))
    with rec:
        i = x.view(torch.int32)
        f = i.view(torch.float32)
    assert [lower.KERNEL_OPS[op] for op, *_ in rec.nodes][1:] == ["FBITS", "IBITS"]
    assert rec.vals[id(f)] == 2 and rec.nodes[2][1] == lower.F32
    out = torch.empty((H, W), dtype=torch.int32, device="meta")
    got = rec.bitcast(lower.Const(lower.F32, -0.0), torch.float32, out)
    assert got == lower.Const(lower.I32, -(1 << 31))
    got = rec.bitcast(lower.Const(lower.I32, 0x3F800000), torch.int32,
                      torch.empty((H, W), dtype=torch.float32, device="meta"))
    assert got == lower.Const(lower.F32, 1.0)
    with pytest.raises(lower.Refused, match="bit cast of torch.float32 as torch.int16"):
        rec.bitcast(1, torch.float32, torch.empty((2, H, W), dtype=torch.int16, device="meta"))
    with pytest.raises(lower.Refused, match="bit cast of a whole image"):
        rec.bitcast(lower._Img(0), torch.float32, out)


def test_isinf_lowers_as_an_abs_and_a_compare(tmp_path):
    """isinf (aten.isinf, once outside the op set) lowers as |x| == inf:
    bit-equal to the interpreter over infinities, NaNs and finite values."""
    spec = _spec_of(str(tmp_path / "inf.comp"), HEAD + (
        "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
        "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
        "    vec4 c = imageLoad(input_image, pos);\n"
        "    float q = c.r / (c.g - 0.5);\n"
        "    imageStore(output_image, pos, vec4(isinf(q) ? 1.0 : 0.0, isinf(c.b) ? 1.0 : 0.5,"
        " isnan(c.b) ? 1.0 : 0.0, c.a));\n}\n"))
    prog = lower.lower_point(spec, {}, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    x = np.random.default_rng(6).random((4, H, W), dtype=np.float32)
    x[1, ::3] = 0.5  # q: +-inf (and NaN where c.r is 0)
    x[0, ::6, ::2] = 0.0
    x[2].reshape(-1)[::4][:len(SPECIALS)] = np.array(SPECIALS, np.uint32).view(np.float32)
    ins = [torch.from_numpy(x)]
    got = lower.point_program_plain(prog, ins, *_planes(), 0.0)
    want = _interp(spec, {}, ins, 0.0)
    _bit_equal(got, want)
    assert float(got[0].sum()) > 0 and float(got[1].sum()) > 0.5 * H * W


# ---- the shaders of REACH_GRAPHS ------------------------------------------------------


@pytest.mark.parametrize("size", [(W, H), (3840, 2160)], ids=["48x128", "4K"])
@pytest.mark.parametrize("stem", ["hash", "composite3", "wide"])
def test_reach_shaders_lower_bit_equal(stem, size):
    """hash.comp (bit casts), composite3.comp (three images) and wide.comp
    (the wide op word at its default 48 taps and at 80) lower at 48x128
    and at 4K; at 48x128 each op list's plain version is bit-equal to the
    port's interpreter in f32, at two frame times."""
    path = os.path.join(PORT_SHADER_DIR, f"{stem}.comp")
    spec = _spec_of(path)
    for params in ({}, {"taps": 80} if stem == "wide" else {}):
        params = spec.resolve_params(params)
        prog = lower.lower_point(spec, params, *size)
        assert isinstance(prog, lower.PointProgram), prog
        names = {lower.KERNEL_OPS[op[0]] for op in prog.ops}
        assert ("FBITS" in names and "IBITS" in names) == (stem == "hash")
        assert ("LOADX" in names) == (stem == "composite3")
        assert prog.narrow == (stem != "wide")
        if stem == "wide":
            assert prog.n_f > lower.MAX_F and len(prog.consts) > lower.CONST
        if stem == "composite3":
            assert prog.images == spec.images_in and len(spec.images_in) == 3
        if size != (W, H):
            continue
        ins = _random_ins(spec)
        for t in (0.3, 5.5):
            _bit_equal(lower.point_program_plain(prog, ins, *_planes(), t),
                       _interp(spec, params, ins, t))


# ---- the wide op word ----------------------------------------------------------------


def _decode(words):
    """The ops of a packed program as the kernel reads them (either op
    word): (op, dst, a, b, c, d, last word, wrap flag), and the constant
    bit of its fields."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    wide = bool(w[lower.HEAD_INTS - 1] & 4)
    at = lower.ops_at(w)
    ops = []
    for j in range(int(w[0])):
        if wide:
            w0, w1, w2, w3 = (int(v) for v in w[at + 4 * j:at + 4 * j + 4])
            ops.append((w0 & 255, w0 >> 16, w1 & 0xFFFF, w1 >> 16, w2 & 0xFFFF, w2 >> 16, w3,
                        (w0 >> 8) & 1))
        else:
            w0, w1 = (int(v) for v in w[at + 2 * j:at + 2 * j + 2])
            ops.append((w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255, w0 >> 24, w1 & 255,
                        (w1 >> 8) & 255, w1, (w1 >> 16) & 1))
    return ops, (lower.WIDE_CONST if wide else lower.CONST)


def _run_words(words, ins):
    """A float-only op list (LOAD, FMUL, FADD, FSUB) evaluated from its
    packed words as the kernel reads them: fields, constant tables and
    output operands."""
    w = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    ops, cbit = _decode(words)
    table = w[lower.HEAD_INTS:lower.HEAD_INTS + int(w[3])].astype(np.uint32).view(np.float32)
    regs = {}

    def src(a):
        return table[a & (cbit - 1)] if a & cbit else regs[a]

    fns = {"FMUL": np.multiply, "FADD": np.add, "FSUB": np.subtract}
    for op, d, a, b, *_ in ops:
        name = lower.KERNEL_OPS[op]
        regs[d] = ins[a][b].numpy() if name == "LOAD" else fns[name](src(a), src(b))
    return np.stack([np.broadcast_to(src(int(o)), (H, W)) for o in w[5:9]]).astype(np.float32)


def _wide_shader(n: int) -> str:
    """n float values of the input live at once, each with a constant of
    its own, then summed."""
    body = "".join(f"    float v{k} = c.r * {1.0 + (k + 1) / 1024.0};\n" for k in range(n))
    total = " + ".join(f"v{k}" for k in range(n))
    return (HEAD + "layout (binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
            "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
            "    vec4 c = imageLoad(input_image, pos);\n" + body
            + f"    imageStore(output_image, pos, vec4({total}, c.g - c.b, c.b, c.a));\n}}\n")


@pytest.mark.parametrize("n", [129, 300])
def test_lists_past_128_float_registers(n, tmp_path):
    """Lists of 129 and 300 live float registers (and as many constants):
    past the narrow word, so packed in the wide one (header flag 4, ops on
    a multiple of four words); evaluated from those words as the kernel
    reads them, bit-equal to the plain version and to the interpreter.
    After a gaussian, 129 registers' files fit a tile at one pixel a
    thread (shared memory), 300's none (device memory)."""
    (tmp_path / "many.comp").write_text(_wide_shader(n))
    spec = _spec_of(str(tmp_path / "many.comp"))
    prog = lower.lower_point(spec, {}, W, H)
    assert isinstance(prog, lower.PointProgram), prog
    assert prog.n_f >= n and not prog.narrow
    words = prog.packed()
    assert lower.is_wide(words) and lower.ops_at(words) % 4 == 0
    assert len(words) == lower.ops_at(words) + 4 * prog.n_ops
    with pytest.raises(ValueError, match="narrow op word"):
        prog.packed(wide=False)
    ins = _random_ins(spec)
    want = _interp(spec, {}, ins, 0.0)
    plain = lower.point_program_plain(prog, ins, *_planes(), 0.0)
    _bit_equal(plain, want)
    np.testing.assert_array_equal(_run_words(words, ins), want.numpy())
    config = "input -> gs -> many -> output\ngs: gaussian { sigma: 2.0 }\n"
    gprog = build_program(config, W, H, device="cpu", shader_path=str(tmp_path))
    assert plan_steps(gprog) == [("mc", ["gs", "many"])]
    mc = gprog._strip_plan[1]
    assert mc._wide
    geo = mc.geometry(*mc.tile()[:2])
    assert int(geo[8]) == 1 and int(geo[9]) == 4
    x = torch.from_numpy(np.random.default_rng(2).random((4, H, W), dtype=np.float32))
    np.testing.assert_allclose(gprog._forward(x, 0.0).numpy(),
                               gprog._forward_nostrip(x, 0.0).numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["vignette", "op_probe", "mandelbrot"])
def test_widen_gives_the_wide_packing(name, tmp_path):
    """``widen`` of a narrow packed list is the list's own wide packing,
    word for word (fields, constant bits, a LOOP's target and trips);
    the two forms decode to the same ops and count the same work at the
    loops' trip bounds (the tier rule counts a wide list as any other)."""
    if name == "op_probe":
        from test_torch_glsl_mc import OPS_PROBE

        spec = _spec_of(str(tmp_path / "probe.comp"), OPS_PROBE)
        params = spec.resolve_params({"gain": 1.3, "levels": 7})
    else:
        spec = _spec_of(os.path.join(SHADER_DIR, f"{name}.comp"))
        params = spec.resolve_params({})
    prog = lower.lower_point(spec, params, W, H)
    narrow, wide = prog.packed(), prog.packed(wide=True)
    assert not lower.is_wide(narrow) and lower.is_wide(wide)
    np.testing.assert_array_equal(lower.widen(narrow), wide)
    np.testing.assert_array_equal(lower.widen(wide), wide)
    assert int(wide[lower.HEAD_INTS - 1]) == int(narrow[lower.HEAD_INTS - 1]) | 4
    assert lower.packed_work(wide) == lower.packed_work(narrow)
    (n_ops, cn), (w_ops, cw) = _decode(narrow), _decode(wide)
    assert (cn, cw) == (lower.CONST, lower.WIDE_CONST)

    def field(f, cbit):
        return ("k", f & (cbit - 1)) if f & cbit else ("r", f)

    for a, b in zip(n_ops, w_ops):
        assert a[0] == b[0] and a[1] == b[1]
        if a[0] == lower.K["LOOP"]:
            assert (a[6] & 0xFFFF, a[6] >> 16) == (b[6] & 0xFFFF, b[6] >> 16)
            assert [field(f, cn) for f in a[2:4]] == [field(f, cw) for f in b[2:4]]
            continue
        assert a[7] == b[7]  # the i32 wrap flag
        if a[0] in (lower.K["LOAD"], lower.K["LOADX"]):
            assert a[2:4] == b[2:4]
        else:
            assert [field(f, cn) for f in a[2:6]] == [field(f, cw) for f in b[2:6]]
    assert [field(int(f), cn) for f in narrow[5:9]] == [field(int(f), cw) for f in wide[5:9]]


# ---- three and more images ---------------------------------------------------------------

MIX4 = ("#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
        "layout (binding = 0, rgba32f) uniform readonly image2D base_image;\n"
        "layout (binding = 1, rgba32f) uniform readonly image2D a_image;\n"
        "layout (binding = 2, rgba32f) uniform readonly image2D b_image;\n"
        "layout (binding = 3, rgba32f) uniform readonly image2D c_image;\n"
        "layout (binding = 4, rgba32f) uniform writeonly image2D output_image;\n"
        "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
        "    vec4 s = imageLoad(base_image, pos);\n"
        "    vec4 a = imageLoad(a_image, pos);\n    vec4 b = imageLoad(b_image, pos);\n"
        "    vec4 c = imageLoad(c_image, pos);\n"
        "    imageStore(output_image, pos, vec4(mix(s.rgb, a.rgb * 0.5 + b.gbr * 0.25 + c.brg *"
        " 0.25, a.r), s.a));\n}\n")
# Wired last image first: the node's inputs in another order than the
# spec declares them.
MIX4_CONFIG = ("input -> t -> mix4:c_image\ninput -> sh -> mix4:b_image\n"
               "input -> g -> mix4:a_image\ninput -> mix4:base_image\nmix4 -> output\n"
               "g: gaussian { sigma: 2.0 }\nsh: sharpen { amount: 0.6 }\n"
               "t: tonemap { exposure: 1.2 }\n")


def _mix_source(n: int) -> str:
    if n == 4:
        return MIX4
    return (MIX4.replace("layout (binding = 3, rgba32f) uniform readonly image2D c_image;\n", "")
            .replace("    vec4 c = imageLoad(c_image, pos);\n", "")
            .replace(" + b.gbr * 0.25 + c.brg * 0.25", " + b.gbr * 0.5"))


def _mix_config(n: int) -> str:
    if n == 4:
        return MIX4_CONFIG
    return MIX4_CONFIG.replace("input -> t -> mix4:c_image\n", "").replace(
        "t: tonemap { exposure: 1.2 }\n", "")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("n", [3, 4])
def test_three_and_four_images_wired_out_of_order(n, fmt, tmp_path):
    """A point shader of three and of four input images, wired in another
    order than it declares them: one MC_GLSL stage whose inputs follow the
    spec's order (the third and fourth through LOADX and the launch's
    table: the stage's list 1 their first index and count), every input's
    slot live until the stage (no slot reused before its last read), and
    the frame against the JAX package per node within PARITY.md's bounds."""
    (tmp_path / "mix4.comp").write_text(_mix_source(n))
    config = _mix_config(n)
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=str(tmp_path))
    assert plan_steps(prog)[0][0] == "mc"
    mc = prog._strip_plan[1]
    (i, st), = [(i, st) for i, st in enumerate(mc.stages) if st.op.code == cuda_ops.MC_GLSL]
    node = next(nd for nd in prog.graph.ordered_nodes if nd.name == "mix4")
    by_desc = {desc: res for res, desc in node.inputs}
    assert [d for _r, d in node.inputs] != list(node.spec.images_in)
    assert by_desc["base_image"] == tprogram.FILE_INPUT
    # each input's slot holds, at the stage, the output of the node wired to
    # that image (its last writer before the stage): the spec's order
    writer = {}
    for st2 in mc.stages[:i]:
        writer[st2.out] = st2.kind
    kinds = ["input" if slot == cuda_ops.MC_INPUT else writer[slot] for slot, _e, _w in st.ins]
    assert kinds == ["input", cuda_ops.MC_CONV, cuda_ops.MC_STENCIL, cuda_ops.MC_POINT][:n]
    assert len(set(slot for slot, _e, _w in st.ins)) == n  # no slot shared by two inputs
    th, tw, _ = mc.tile()
    stage_i, *_rest = mc.packed(th, tw)
    table = mc.glsl_inputs(th, tw)
    assert mc.n_glsl_inputs == n - 2 and len(table) == 3 * (n - 2)
    assert list(stage_i[i][[19, 20]]) == [0, n - 2]
    assert int(stage_i[i][2]) == n
    words = st.taps[0]
    assert int(words[lower.HEAD_INTS - 1]) & 2  # LOADX: the forms with the extra ops
    x = np.random.default_rng(8).random((4, H, W), dtype=np.float32)
    if fmt == "rgba16f":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = prog._forward(torch.from_numpy(x.copy()), 0.3).float().numpy()
    jprog = JProgram(jbuild(jparse_file(config, True, str(tmp_path))), W, H, fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(0.3))
                      .astype(jnp.float32))
    bound = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 2 / 255.0 + 1e-6}[fmt]
    assert float(np.abs(got - want).max()) <= bound


# Nine images, seven of them past the second: the input block three
# times (one view), a conv's slot and a stencil's twice each.
NINE = ("#version 450\nlayout (local_size_x = 16, local_size_y = 16) in;\n"
        + "".join(f"layout (binding = {k}, rgba32f) uniform readonly image2D im{k};\n"
                  for k in range(9))
        + "layout (binding = 9, rgba32f) uniform writeonly image2D output_image;\n"
        "void main() {\n    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);\n"
        "    imageStore(output_image, pos, ("
        + " + ".join(f"imageLoad(im{k}, pos) * {1.0 + k / 8.0}" for k in range(9))
        + ") * 0.1);\n}\n")
NINE_CONFIG = ("input -> a -> n:im0\ninput -> b -> n:im1\ninput -> n:im2\ninput -> n:im3\n"
               "a -> n:im4\nb -> n:im5\ninput -> n:im6\na -> n:im7\nb -> n:im8\nn -> output\n"
               "a: gaussian { sigma: 2.0 }\nb: sharpen { amount: 0.6 }\nn: nine {}\n")


@pytest.mark.parametrize("fmt", FORMATS)
def test_nine_images_plan_one_stage_like_jax(fmt, tmp_path):
    """A point shader of nine input images lowers (no limit of its own on
    images): one MC_GLSL stage whose seven inputs past the second fill
    seven views of the launch's table, the input block's among them, and
    the frame against the JAX package per node within PARITY.md's
    bounds."""
    (tmp_path / "nine.comp").write_text(NINE)
    prog = build_program(NINE_CONFIG, W, H, fmt, device="cpu", shader_path=str(tmp_path))
    assert plan_steps(prog) == [("mc", ["a", "b", "n"])]
    mc = prog._strip_plan[1]
    th, tw, _ = mc.tile()
    table = mc.glsl_inputs(th, tw).reshape(-1, 3)
    assert mc.n_glsl_inputs == 7 and len(table) == 7
    in_block = mc.glsl_inputs(th, tw).reshape(-1, 3)[0]
    lo, pitch = cuda_ops._window_cols(tw, int(mc.geometry(th, tw)[3]))
    assert int(in_block[1]) == pitch and int(in_block[0]) >= lo
    assert [tuple(v) for v in table[[0, 1, 4]]] == [tuple(table[0])] * 3
    x = np.random.default_rng(9).random((4, H, W), dtype=np.float32)
    if fmt == "rgba16f":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = prog._forward(torch.from_numpy(x.copy()), 0.3).float().numpy()
    jprog = JProgram(jbuild(jparse_file(NINE_CONFIG, True, str(tmp_path))), W, H, fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(0.3))
                      .astype(jnp.float32))
    bound = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 2 / 255.0 + 1e-6}[fmt]
    assert float(np.abs(got - want).max()) <= bound


def test_inputs_past_the_launch_table_are_refused_with_a_reason(tmp_path, monkeypatch):
    """The one limit on a point stage's images is the launch's table of
    op-list inputs past the second (MC_GLSL_INPUTS, a plan's): a plan past
    it is refused while planning, the planner warns why, and the graph
    takes the plan it has when the shader has no op list."""
    (tmp_path / "nine.comp").write_text(NINE)
    prog = build_program(NINE_CONFIG, W, H, device="cpu", shader_path=str(tmp_path))
    mc = prog._plan_strip_mc()
    assert mc.n_glsl_inputs == 7 and mc.refusal() is None
    monkeypatch.setattr(cuda_ops, "MC_GLSL_INPUTS", 6)
    monkeypatch.setattr(tprogram, "_PROGRAMS", {})
    prog = build_program(NINE_CONFIG, W, H, device="cpu", shader_path=str(tmp_path))
    tutils.clear_warnings()
    assert prog._plan_strip_mc() is None
    said = [w for w in tutils.recent_warnings() if "table" in w]
    assert said and "7 images past their second" in said[0] and "table of 6" in said[0], said
    with monkeypatch.context() as m:
        m.setattr(tprogram, "_PROGRAMS", {})
        m.setattr(tprogram.GraphProgram, "_glsl_point", lambda self, node: None)
        plain = build_program(NINE_CONFIG, W, H, device="cpu", shader_path=str(tmp_path))
        assert plan_steps(plain) == plan_steps(prog)


# ---- the graphs: plans, the tile model, Engine ------------------------------------------


@pytest.mark.parametrize("size", [(W, H), (3840, 2160)], ids=["48x128", "4K"])
@pytest.mark.parametrize("name", REACH_GRAPHS)
def test_reach_graphs_plan_one_mc_launch(name, size):
    """Each of REACH_GRAPHS plans the mc tier in three formats at 48x128
    and at 4K: hash and the composites in the narrow word at two or four
    pixels a thread, wide.comp in the wide word at one, its files in
    device memory.  The tile model counts the files only where they lie in
    shared memory: a wide plan's layout is the one of files of no bytes.
    composite3_raw_mask's third image is the input block, read through
    the block's own view (``_window_cols``'s column and pitch, as the
    kernel's run_tile places it)."""
    config, shader_dir = point_graphs()[name]
    for fmt in FORMATS:
        prog = build_program(config, *size, fmt, device="cpu", shader_path=shader_dir)
        assert plan_steps(prog)[0][0] == "mc", (name, fmt)
        mc = prog._strip_plan[1]
        th, tw, nbytes = mc.tile()
        geo = mc.geometry(th, tw)
        wide = name.startswith("wide")
        assert mc._wide == wide
        assert int(geo[8]) in ((1,) if wide else cuda_ops.MC_GLSL_PIXELS)
        assert bool(geo[9] & 4) == wide and int(geo[9]) < 8
        assert nbytes <= cuda_ops.MC_SMEM_LIMIT
        files = mc._files(int(geo[8]))
        if wide:
            assert mc.device_file_bytes() == 4 * files <= cuda_ops.MC_FILES_DEVICE_LIMIT
            with pytest.MonkeyPatch.context() as m:
                m.setattr(cuda_ops, "glsl_file_floats", lambda words, pixels: 0)
                bare = cuda_ops.McProgram(stages=mc.stages, n_slots=mc.n_slots,
                                          rh_in=mc.rh_in, ew_in=mc.ew_in, width=mc.width,
                                          height=mc.height, fmt=mc.fmt)
                assert nbytes == bare._layout(th, tw, int(geo[7]), 1)[1]
        else:
            assert int(geo[5]) + files <= int(geo[1])
        table = mc.glsl_inputs(th, tw)
        if name.startswith("composite3"):
            (st,) = [st for st in mc.stages if st.op.code == cuda_ops.MC_GLSL]
            assert len(table) == 3 and (st.ins[2][0] == cuda_ops.MC_INPUT) == (
                name == "composite3_raw_mask")
            if st.ins[2][0] == cuda_ops.MC_INPUT:
                in_eh, in_ew, used = int(geo[2]), int(geo[3]), int(geo[4])
                lo, pitch = cuda_ops._window_cols(tw, in_ew)
                assert used and list(table) == [lo + in_eh * pitch + in_ew, pitch,
                                                (th + 2 * in_eh) * pitch]
        else:
            assert len(table) == 0


def test_a_wide_list_counts_its_work_as_a_narrow_one():
    """The tier rule and the tile choice count a list by its ops at the
    loops' trip bounds whatever its word: a plan widened (mandelbrot's
    loop) has the narrow plan's estimated work and halo work."""
    config, shader_dir = point_graphs()["mandelbrot_after_blur"]
    mc = build_program(config, W, H, device="cpu", shader_path=shader_dir)._strip_plan[1]
    wide = mc.widened()
    assert wide is not None and wide.widened() is None and wide._wide
    for th, tw in cuda_ops.MC_TILES:
        assert wide._work(th, tw) == mc._work(th, tw)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", REACH_GRAPHS)
def test_reach_graphs_render_through_engine_like_jax(name, fmt, tmp_path, monkeypatch):
    """The graphs through the port's Engine (the mc tier, one MC_GLSL
    stage) against the JAX Engine per node: rgba32f within PARITY.md's
    graph bound, rgba16f and rgba8 within the tier's bounds (2e-2, two
    codes), the port's per-node frame within PARITY.md's bounds too."""
    monkeypatch.chdir(REPO_DIR)
    config, shader_dir = point_graphs()[name]
    path = tmp_path / f"{name}.rf"
    path.write_text(config)
    engine, frame, per_node, want = _render_both(str(path), fmt, _u8(7), shader_path=shader_dir)
    plan = engine.program._strip_plan
    assert plan is not None and plan[0] == "mc"
    assert [st.op.code for st in plan[1].stages].count(cuda_ops.MC_GLSL) == 1
    _engine_check(fmt, per_node, want, name)
    if fmt == "rgba32f":
        _engine_check(fmt, frame, want, name)
    else:
        bound = {"rgba16f": 2e-2, "rgba8": 2 / 255.0 + 1e-6}[fmt]
        assert float(np.abs(frame - want).max()) <= bound, name
