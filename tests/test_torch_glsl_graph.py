"""GLSL graphs through the PyTorch port against the JAX package, on the
CPU: conv synthesis (``glsl/affine.py``), the mc planner's synthesized
conv and stencil stages, the engine with the shipped shaders from the
repository root (the default config and the GLSL graphs on the mc tier;
the reference's GLSL graphs and the examples are in
``test_torch_glsl_examples.py``), and the "not ported yet" diagnostic of
storage-buffer shaders.

The JAX side runs its per-node path eagerly (``_forward_nostrip``), as its
own tests run it on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.engine import Engine as JEngine
from reforge_tpu.engine import RenderInfo as JRenderInfo
from reforge_tpu.glsl import affine as jaffine
from reforge_tpu.glsl import translate_shader as jtranslate
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import GLSL_GRAPHS, REPO_DIR, SHADER_DIR, build_program
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.glsl import affine, translate_shader
from reforge_tpu_torch.graph import build_graph
from reforge_tpu_torch.kernels import cuda_ops

H, W = 48, 64
FORMATS = ("rgba32f", "rgba16f", "rgba8")
E_PARAMS = {"gaussian_h": {"sigma": 2.0}, "gaussian_v": {"sigma": 2.0}, "sharpen": {"amount": 0.7}}


@pytest.fixture(autouse=True)
def _quiet_and_fresh_synthesis(tmp_path, monkeypatch):
    """No stderr noise, and the port's conv-synthesis cache empty in memory
    and on disk (a tmp directory), so every probe runs in the test."""
    tutils.print_warnings = False
    jutils.print_warnings = False
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    affine._SYNTH_CACHE.clear()
    yield
    affine._SYNTH_CACHE.clear()


def _specs(stem):
    path = os.path.join(SHADER_DIR, f"{stem}.comp")
    with open(path) as f:
        src = f.read()
    return jtranslate(src, stem, path=path), translate_shader(src, stem, path=path)


def _synth_pair(stem):
    jspec, tspec = _specs(stem)
    params = E_PARAMS[stem]
    return (jaffine.synthesize_conv(jspec, jspec.resolve_params(params)),
            affine.synthesize_conv(tspec, tspec.resolve_params(params)))


def _same_synth(got, want):
    assert type(got).__name__ == type(want).__name__
    for field in ("scale", "passthrough", "offset", "border"):
        assert getattr(got, field) == tuple(getattr(want, field)) or getattr(got, field) == \
            getattr(want, field), field
    if hasattr(want, "w"):
        np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w), atol=1e-6, rtol=0)
    else:
        for taps in ("wh", "ww"):
            assert len(getattr(got, taps)) == len(getattr(want, taps))
            np.testing.assert_allclose(getattr(got, taps), getattr(want, taps), atol=1e-6, rtol=0)


@pytest.mark.parametrize("stem", sorted(E_PARAMS))
def test_synthesis_matches_jax(stem):
    """gaussian_h and gaussian_v give separable convs, sharpen a 2-D
    stencil: taps within 1e-6, scale, passthrough and offset exact; the
    disk entry reads back equal."""
    want, got = _synth_pair(stem)
    assert got is not None and want is not None
    _same_synth(got, want)
    tspec = _specs(stem)[1]
    params = tspec.resolve_params(E_PARAMS[stem])
    affine._SYNTH_CACHE.clear()
    assert affine.synthesize_conv(tspec, params) == got  # from the disk cache
    assert len(list(affine.CACHE_DIR.glob("*.json"))) == 1


def test_compose_matches_jax():
    (jh, th), (jv, tv) = _synth_pair("gaussian_h"), _synth_pair("gaussian_v")
    got, want = affine.compose(th, tv), jaffine.compose(jh, jv)
    _same_synth(got, want)
    assert len(got.wh) == len(got.ww) == 13
    assert affine.compose(tv, tv) is None  # two vertical passes do not compose exactly


def test_point_shader_and_loops_are_not_synthesized():
    _jspec, tonemap = _specs("tonemap")
    assert affine.synthesize_conv(tonemap, tonemap.resolve_params({"exposure": 1.1})) is None
    _jspec, sobel = _specs("sobel")  # a gradient magnitude: not affine
    assert affine.synthesize_conv(sobel, sobel.resolve_params({})) is None


def _plan(name, fmt):
    prog = build_program(GLSL_GRAPHS[name], W, H, fmt, device="cpu", shader_path=SHADER_DIR)
    plan = prog._strip_plan
    if plan is None:
        return prog, None
    return prog, [(st.kind, st.op.code, len(st.taps[0]) + len(st.taps[1])
                   if st.kind == cuda_ops.MC_CONV else np.size(st.taps[0])) for st in plan[1].stages]


# (kind, opcode, taps) of each mc stage: a synthesized conv is an identity
# conv (f32) then an MC_AFFINE point stage with its input (gaussian's alpha
# passes through); sharpen.comp's sum is exactly an emboss-form stencil.
# In rgba32f gaussian_h -> gaussian_v composes into one 13+13-tap conv;
# where storage rounds between nodes it stays two (1+13 and 13+1 taps).
MIX = (cuda_ops.MC_POINT, cuda_ops.MC_AFFINE, 15)
CONV = (cuda_ops.MC_CONV, cuda_ops.MC_CONV_IDENTITY)
STENCIL = (cuda_ops.MC_STENCIL, cuda_ops.MC_EMBOSS, 9)
PLANS = {
    ("glsl_blur", "rgba32f"): [CONV + (26,), MIX],
    ("glsl_blur", "rgba16f"): [CONV + (14,), MIX, CONV + (14,), MIX],
    ("glsl_blur_sharpen", "rgba32f"): [CONV + (26,), MIX, STENCIL],
    ("glsl_blur_sharpen", "rgba8"): [CONV + (14,), MIX, CONV + (14,), MIX, STENCIL],
    ("glsl_chain", "rgba32f"): None,  # tonemap.comp: a point shader, no device form
    ("glsl_sharpen", "rgba32f"): None,
}


@pytest.mark.parametrize("name,fmt", sorted(PLANS))
def test_glsl_graph_plans(name, fmt):
    prog, stages = _plan(name, fmt)
    assert stages == PLANS[(name, fmt)]
    if stages is not None:
        mc = prog._strip_plan[1]
        assert mc.tile() is not None
        x = torch.from_numpy(np.random.default_rng(1).random((4, H, W), dtype=np.float32))
        xin = x.to(prog.storage_dtype)
        got = cuda_ops.graph_strip_mc(xin, 0.5, mc)  # the plain version on the CPU
        want = prog._forward_nostrip(xin, 0.5)
        tol = 1e-5 if fmt == "rgba32f" else 2e-2
        assert float((got.float() - want.float()).abs().max()) <= tol


def test_affine_stage_plain_forms():
    """The mix out_c = s_c v + p_c x_c + b_c in the reference's order, and
    the table it rides in (row c: s_c, p_c, b_c)."""
    synth = affine.ConvSynth(wh=(0.25, 0.5, 0.25), ww=(1.0,), scale=(0.5, 1.0, 0.0, 2.0),
                             passthrough=(0.0, 0.0, 1.0, -1.0), offset=(0.0, 0.125, 0.0, 0.25))
    table = cuda_ops.affine_table(synth)
    assert table.shape == (5, 3) and not table[4].any()
    assert table[:4].tolist() == [[0.5, 0.0, 0.0], [1.0, 0.0, 0.125], [0.0, 1.0, 0.0],
                                  [2.0, -1.0, 0.25]]
    v, x = torch.rand(4, 5, 6), torch.rand(4, 5, 6)
    got = cuda_ops.affine_mix_plain(synth, v, x)
    assert torch.equal(got[0], v[0] * 0.5) and torch.equal(got[1], v[1] + 0.125)
    assert torch.equal(got[2], v[2] * 0.0 + x[2]) and torch.equal(got[3], v[3] * 2.0 - x[3] + 0.25)
    assert cuda_ops.mc_kind(cuda_ops.MC_AFFINE) == cuda_ops.MC_POINT


def test_mix_stage_reads_the_sum_and_the_node_input():
    prog, _stages = _plan("glsl_blur_sharpen", "rgba16f")
    mc = prog._strip_plan[1]
    sums = [st for st in mc.stages if st.kind != cuda_ops.MC_POINT]
    mixes = [st for st in mc.stages if st.op.code == cuda_ops.MC_AFFINE]
    assert [st.store for st in sums] == [False, False, True]  # sharpen's sum is the node
    assert all(st.store for st in mixes)
    for lin, mix in zip(sums, mixes):
        assert mix.ins[0][0] == lin.out and mix.ins[1] == lin.ins[0]
    row = mc._lists[mc.stages.index(mixes[0])]
    np.testing.assert_array_equal(mc.taps[row[0]:row[0] + row[1]], [1.0, 1.0, 1.0, 1.0])


# ---- the engine from the repository root ---------------------------------------


def _ulps(a, b):
    """Distance in float32 units of the last place (a monotonic map of the
    bit patterns)."""
    def mono(v):
        i = np.ascontiguousarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(mono(a) - mono(b))


def _check(fmt, got, want, what):
    """rgba32f: PARITY.md's whole-graph bound (64 ulps, with its 2e-6
    absolute floor where a gradient cancels towards 0); rgba16f: one bf16
    step of the value; rgba8: one code."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape == (4, H, W)
    d = np.abs(got.astype(np.float64) - want)
    if fmt == "rgba32f":
        bad = (_ulps(got, want) > 64) & (d > 2e-6)
        assert not bad.any(), (what, float(d.max()))
    elif fmt == "rgba16f":
        mag = np.maximum(np.abs(got), np.abs(want)).clip(2.0 ** -126)
        step = np.exp2(np.floor(np.log2(mag)) - 7)
        assert (d <= step + 1e-7).all(), (what, float(d.max()))
    else:
        assert d.max() <= 1.0 / 255.0 + 1e-6, (what, float(d.max()))


def _u8(seed=11):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 4), dtype=np.uint8)


def _render_both(config_path, fmt, u8, t=0.25):
    """The port's Engine (a frame on its tier, and per node) and the JAX
    Engine's per-node path on the same linear input (the port's decode of
    ``u8``; the two decodes differ by an ulp of pow), both engines built
    the way a user builds them, from the repository root."""
    kw = dict(fmt=fmt, has_input_image=True)
    if config_path is not None:
        kw.update(config_path=config_path)
    engine = Engine(RenderInfo(W, H, "cpu", **kw))
    engine.load_input(u8)
    frame = engine.render_frame_blocking(t).float().numpy()
    x = engine._file_input()
    per_node = engine.program._forward_nostrip(x, t).float().numpy()
    jengine = JEngine(JRenderInfo(W, H, one_shot=True, **kw))
    want = jengine.program._forward_nostrip(jnp.asarray(x.numpy()), jnp.float32(t))
    return engine, frame, per_node, np.asarray(want).astype(np.float32)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("graph", ["default", "glsl_blur", "glsl_blur_sharpen"])
def test_engine_renders_e1_to_e3_like_jax(graph, fmt, tmp_path, monkeypatch):
    """E1 (the default config, passthrough.comp), E2 and E3 through Engine
    from the repository root, against the JAX Engine's per-node path: the
    frame on its tier in rgba32f, and per node in rgba16f and rgba8 (where
    the mc tier's roundings differ from per node's within the tier's own
    bound: 2e-2, or seven codes where sharpen.comp amplifies a flip by up
    to 1 + 8 * 0.7)."""
    monkeypatch.chdir(REPO_DIR)
    path = None
    if graph != "default":
        path = tmp_path / f"{graph}.rf"
        path.write_text(GLSL_GRAPHS[graph])
    engine, frame, per_node, want = _render_both(None if path is None else str(path), fmt, _u8())
    assert (engine.program._strip_plan is not None) == (graph != "default")
    if graph == "default":
        stored = engine.program.store_output(engine._file_input()).float().numpy()
        np.testing.assert_array_equal(frame, stored)
    _check(fmt, frame if fmt == "rgba32f" else per_node, want, graph)
    tier_bound = {"rgba32f": 1e-5, "rgba16f": 2e-2,
                  "rgba8": (7 if graph == "glsl_blur_sharpen" else 2) / 255.0 + 1e-6}[fmt]
    assert float(np.abs(frame - per_node).max()) <= tier_bound


def test_storage_buffer_shader_is_a_not_ported_diagnostic(tmp_path):
    """A config naming SSBO shaders (histogram.comp, equalize.comp) fails its build with
    the compiler's "not ported yet" diagnostic: no graph, no program, and an
    engine keeps what it had (here: it cannot start)."""
    text = (REPO_DIR / "examples" / "equalize.rf").read_text()
    cfg = tconfig.parse_file(text, True, SHADER_DIR)
    assert cfg is not None
    tutils.clear_warnings()
    assert build_graph(cfg) is None
    assert any("not ported yet" in w and "histogram.comp" in w for w in tutils.recent_warnings())
    path = tmp_path / "equalize.rf"
    path.write_text(text)
    with pytest.raises(RuntimeError, match="Failed to build"):
        Engine(RenderInfo(W, H, "cpu", config_path=str(path), shader_path=SHADER_DIR,
                          has_input_image=True))


def test_loader_caches_specs_by_source_and_refuses_py_kernels(tmp_path):
    """A shader file's spec is reused while its text is unchanged and
    rebuilt after an edit; a .py kernel (JAX code in the reference) gives
    a "not ported" diagnostic and no spec."""
    from reforge_tpu_torch.kernels import loader

    path = tmp_path / "tint.comp"
    src = (REPO_DIR / "shaders" / "invert.comp").read_text()
    path.write_text(src)
    first = loader.load_kernel_file(str(path))
    assert first is not None and first.images_in == ("input_image",)
    assert loader.load_kernel_file(str(path)) is first
    path.write_text(src + "\n// edited\n")
    assert loader.load_kernel_file(str(path)) is not first
    py = tmp_path / "mykernel.py"
    py.write_text("def kernel(ctx, input_image):\n    return input_image\n")
    tutils.clear_warnings()
    assert loader.load_kernel_file(str(py)) is None
    assert any("not ported" in w and "mykernel.py" in w for w in tutils.recent_warnings())
