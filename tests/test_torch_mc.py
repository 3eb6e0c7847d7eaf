"""The PyTorch port's mc tier (``graph_strip_mc``'s plain version, the
tier's CPU path) against the JAX package, on the CPU.

Graphs: the JAX package's mc test graphs (tests/test_graph.py:434-471,
copied into ``benchmarks.MC_TEST_GRAPHS``), the classic demo, edges,
chain3 and a mix wired second input first.  The JAX side runs as its own
tests run it: ``_forward_nostrip`` is its per-node jnp path, and
``_strip_fused_forward`` runs ``graph_strip_fused_mc`` in Pallas
interpret mode where the JAX planner picks the mc tier at 128x48 (a
graph for each feature of the tier, ``INTERPRET_CASES``: interpret mode
takes seconds a graph, and per-node covers every graph and format).
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
from reforge_tpu.kernels import ops as jops
from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    CHAIN3_CONFIG, DEMO_CONFIG, EDGES_CONFIG, GLSL_GRAPHS, LIBRARY_GRAPHS, MC_TEST_GRAPHS,
    MIX_SECOND_FIRST_CONFIG, SHADER_DIR, build_program,
)
from reforge_tpu_torch.glsl import affine
from reforge_tpu_torch.graph import graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops

MC_CASES = {
    **MC_TEST_GRAPHS,
    "demo": DEMO_CONFIG,
    "edges": EDGES_CONFIG,
    "chain3": CHAIN3_CONFIG,
    "mix_second_first": MIX_SECOND_FIRST_CONFIG,
}
FORMATS = ("rgba32f", "rgba16f", "rgba8")
H, W = 48, 128  # the JAX mc tests' size (its mc kernel needs a lane-multiple width)
T = 0.3
KIND_NAMES = {cuda_ops.MC_POINT: "point", cuda_ops.MC_STENCIL: "stencil", cuda_ops.MC_CONV: "conv"}


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


def _image(h=H, w=W, seed=11):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_program(name, fmt, h=H, w=W):
    return JProgram(jbuild(jparse(MC_CASES[name], expects_input=True)), w, h, fmt)


def _port(name, fmt, h=H, w=W):
    graph = graph_from_reference(_jax_program(name, fmt, h, w).graph)
    prog = make_program(graph, w, h, fmt, device="cpu")
    assert prog is not None
    return prog


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _assert_close(got, want, fmt, bf16_tol=2e-2):
    d = np.abs(_f32(got) - _f32(want))
    if fmt == "rgba32f":
        # PARITY.md's whole-graph bound: 1e-5 on values near [0, 1].
        assert d.max() <= 1e-5, d.max()
    elif fmt == "rgba16f":
        # One rounding apart before a bf16 store flips it by one bf16 ulp,
        # and a flip can carry through later nodes.
        assert d.max() <= bf16_tol, d.max()
    else:
        # One rounding apart before the UNORM store flips a 1/255 bucket
        # where a value sits on its edge; bound the flipped fraction.
        assert d.max() <= 1.0 / 255.0 + 1e-6, d.max()
        assert (d > 1.0 / 512.0).mean() < 1e-3


@functools.lru_cache(maxsize=None)
def _jax_per_node(name, fmt, h=H, w=W):
    prog = _jax_program(name, fmt, h, w)
    out = prog._forward_nostrip(jnp.asarray(_image(h, w)), jnp.float32(T))
    return np.asarray(out.astype(jnp.float32))


def _jax_plans_mc(name, fmt):
    plan = _jax_program(name, fmt)._strip_plan
    return plan is not None and plan[0] == "mc"


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_port_plans_mc_like_jax(name, fmt):
    """Every graph plans mc in the port (which drops the TPU's width, MXU
    and VMEM gates); where JAX plans mc too, the stage kinds agree in
    order (bloom's pre-map is a point stage in both)."""
    prog = _port(name, fmt)
    plan = prog._strip_plan
    assert plan is not None and plan[0] == "mc", name
    kinds = [KIND_NAMES[st.kind] for st in plan[1].stages]
    assert kinds.count("conv") + kinds.count("stencil") >= 1
    assert plan[1].stages[-1].out == cuda_ops.MC_OUTPUT
    assert plan[1].tile() is not None
    if _jax_plans_mc(name, fmt):
        jstages = _jax_program(name, fmt)._strip_plan[1]["stages"]
        assert kinds == [st.kind for st in jstages]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_mc_tier_matches_jax_per_node(name, fmt):
    prog = _port(name, fmt)
    got = prog._forward(torch.from_numpy(_image()), T)
    assert got.dtype == prog.storage_dtype and tuple(got.shape) == (4, H, W)
    _assert_close(got, _jax_per_node(name, fmt), fmt)


# Interpret mode takes seconds a graph: one graph for each stage kind,
# epilogue, pre-map, wiring and coordinate use in rgba32f, one bf16 and
# one rgba8 graph.  The demo plans mc in JAX only in rgba16f (its sigma-8
# conv has 98 taps, which JAX's planner gives its MXU x3 kernel per node
# below 2560 wide).
INTERPRET_CASES = [
    ("conv_stencil_point", "rgba32f"),  # conv -> sobel -> tonemap
    ("conv_of_conv", "rgba32f"),  # a conv's extent lifted through a conv
    ("bloom_pre_conv", "rgba32f"),  # f32 pre-map, epilogue reading x
    ("point_feeding_conv_fan", "rgba32f"),  # threshold, fan-out, mix with the input
    ("median_saturation", "rgba32f"),  # median9
    ("emboss_unsharp_chain", "rgba32f"),  # emboss, unsharp epilogue
    ("coord_point_feeding_conv", "rgba32f"),  # vignette's coordinates
    ("mix_second_first", "rgba32f"),  # input_image2 wired first
    ("demo", "rgba16f"),
    ("chain3", "rgba8"),
]


@pytest.mark.parametrize("name,fmt", INTERPRET_CASES)
def test_mc_tier_matches_jax_mc_kernel(name, fmt, monkeypatch):
    """Against ``graph_strip_fused_mc`` in interpret mode.  Its rgba16f
    conv stages of 24 taps or more run as single-product bf16 band
    matmuls, rounding taps and operands to bf16, which moves it further
    from the JAX per-node path than one bf16 ulp where values exceed 1;
    there the bound is that distance, so the port is never further from
    the kernel than the JAX package's own per-node path."""
    assert _jax_plans_mc(name, fmt)
    jprog = _jax_program(name, fmt)
    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(
        pallas_ops, "graph_strip_fused_mc",
        functools.partial(pallas_ops.graph_strip_fused_mc, interpret=True),
    )
    x = _image()
    want = jprog._strip_fused_forward(jnp.asarray(x).astype(jprog.storage_dtype), jnp.float32(T))
    assert want is not None
    monkeypatch.undo()
    want = np.asarray(want.astype(jnp.float32))
    got = _port(name, fmt)._forward(torch.from_numpy(x), T)
    own = float(np.abs(_jax_per_node(name, fmt) - want).max())
    _assert_close(got, want, fmt, bf16_tol=max(2e-2, own))


@pytest.mark.parametrize("fmt", FORMATS)
def test_clamped_coordinates_one_pixel_band(fmt):
    """vignette -> blur, on a frame one pixel wider and taller than the
    port's tile: the last tile row and column hold a one-pixel band, whose
    blur reads vignette values only through clamped coordinates.  The mc
    tier must equal per-node edge padding there."""
    prog = _port("coord_point_feeding_conv", "rgba32f")
    th, tw, _ = prog._strip_plan[1].tile()
    h, w = th + 1, tw + 1
    band = _port("coord_point_feeding_conv", fmt, h, w)
    assert band._strip_plan[0] == "mc" and band._strip_plan[1].tile()[:2] == (th, tw)
    got = band._forward(torch.from_numpy(_image(h, w)), T)
    _assert_close(got, _jax_per_node("coord_point_feeding_conv", fmt, h, w), fmt)


def test_planner_pool_reuse_and_gates():
    # a -> b -> c -> d: each slot is freed after its last read and reused.
    src = ("input -> a -> b -> c -> d -> output\n"
           "a: blur { sigma: 1.0 }\nb: sobel {}\nc: blur { sigma: 1.0 }\nd: tonemap {}")
    plan = build_program(src, 64, 40, device="cpu")._strip_plan
    assert plan[0] == "mc"
    outs = [st.out for st in plan[1].stages]
    assert outs[-1] == cuda_ops.MC_OUTPUT and plan[1].n_slots == 2
    assert outs[:3] == [0, 1, 0]
    # extents lift exactly in reverse order: tonemap 0, blur 0, sobel 3, blur 4
    assert [(st.eh, st.ew) for st in plan[1].stages] == [(4, 4), (3, 3), (0, 0), (0, 0)]
    assert (plan[1].rh_in, plan[1].ew_in) == (7, 7)
    # bloom: the pre-map is an f32 point stage, the conv reads it and x
    plan = build_program(MC_CASES["bloom_pre_conv"], 64, 40, device="cpu")._strip_plan[1]
    pre, conv = plan.stages
    assert (pre.kind, pre.store, conv.kind) == (cuda_ops.MC_POINT, False, cuda_ops.MC_CONV)
    assert conv.ins[0][0] == pre.out and conv.x[0] == cuda_ops.MC_INPUT
    # point-only graphs have no mc plan
    assert build_program("input -> t -> output\nt: tonemap {}", 64, 40,
                         device="cpu")._strip_plan is None
    # two sigma-16 convs chained: the input block (extent 96) fits no
    # shared-memory tile, so the planner refuses and the graph runs per node
    src = "input -> a -> b -> output\na: blur { sigma: 16.0 }\nb: blur { sigma: 16.0 }"
    prog = build_program(src, 64, 40, device="cpu")
    assert prog._plan_strip_single() is None and prog._strip_plan is None


@pytest.mark.parametrize("name,base,second", [
    ("mix_second_first", "conv", "stencil"),  # input_image2 wired first
    ("point_feeding_conv_fan", "conv", "input"),
    ("demo", "conv", "stencil"),
])
def test_mc_stage_inputs_follow_declared_images(name, base, second):
    """A two-input stage lists its inputs in the kernel's declared order
    (mix's in0 is input_image, its base), whatever order the config wires
    them in; the plain stage reads them in that order too, so the tier
    agrees with per-node at an asymmetric factor only if the order holds."""
    prog = _port(name, "rgba32f")
    stages = prog._strip_plan[1].stages
    mix = stages[-1]
    assert mix.kind == cuda_ops.MC_POINT and mix.op.code == cuda_ops.MC_MIX

    def producer(slot):
        if slot == cuda_ops.MC_INPUT:
            return "input"
        return KIND_NAMES[[st for st in stages[:-1] if st.out == slot][-1].kind]

    assert [producer(slot) for slot, _eh, _ew in mix.ins] == [base, second]
    x = torch.from_numpy(_image())
    np.testing.assert_allclose(_f32(prog._forward(x, T)), _f32(prog._forward_nostrip(x, T)),
                               atol=1e-5, rtol=0)


def test_mc_plain_counts_nothing_and_checks_shapes():
    cuda_ops.reset_launches()
    prog = _port("edges", "rgba32f")
    mc = prog._strip_plan[1]
    x = torch.from_numpy(_image())
    cuda_ops.graph_strip_mc(x, T, mc)
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    with pytest.raises(TypeError):
        cuda_ops.graph_strip_mc(x.to(torch.bfloat16), T, mc)
    # A slab of the frame's rows is an input (a row-sharded slab, with its
    # row0); another width or channel count is not.
    with pytest.raises(ValueError):
        cuda_ops.graph_strip_mc(x[:, :, :-1], T, mc)
    with pytest.raises(ValueError):
        cuda_ops.graph_strip_mc(x[:3], T, mc)
    assert cuda_ops.graph_strip_mc(x[:, 2:-3], T, mc, 2).shape == x[:, 2:-3].shape
    stage_i, stage_f, _scratch, _taps = mc.packed(*mc.tile()[:2])
    assert stage_i.shape == (len(mc.stages), cuda_ops.MC_STAGE_INTS)
    assert stage_f.shape == (len(mc.stages), 4)


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_graph_from_reference_carries_params(name):
    """Params, wiring and conv tap vectors of every mc graph carry over
    bit for bit (graph_from_reference raises on differing taps)."""
    jgraph = _jax_program(name, "rgba32f").graph
    graph = graph_from_reference(jgraph)
    for node_name, node in graph.nodes.items():
        ref = jgraph.nodes[node_name]
        assert node.params == ref.params
        assert node.inputs == ref.inputs and node.outputs == ref.outputs
        if ref.spec.conv_weights is not None:
            for got, want in zip(node.spec.conv_weights(node.params),
                                 ref.spec.conv_weights(ref.params)):
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---- the kernel's shared-memory layout --------------------------------------------

LAYOUT_GRAPHS = {
    "demo": (DEMO_CONFIG, None),
    "edges": (EDGES_CONFIG, None),
    "chain3": (CHAIN3_CONFIG, None),
    "neon_edges": (LIBRARY_GRAPHS["neon_edges"], None),
    "glsl_blur": (GLSL_GRAPHS["glsl_blur"], SHADER_DIR),
    "glsl_blur_sharpen": (GLSL_GRAPHS["glsl_blur_sharpen"], SHADER_DIR),
    **{name: (config, None) for name, config in MC_TEST_GRAPHS.items()},
}


@pytest.mark.parametrize("h,w", [(2160, 3840), (37, 71), (333, 520)])
@pytest.mark.parametrize("name", sorted(LAYOUT_GRAPHS))
def test_mc_layout_fits_and_buffers_do_not_overlap(name, h, w, tmp_path, monkeypatch):
    """For each format: the chosen tile's layout fits its budget (two blocks
    an SM where any tile does), the input block, pool slots, window
    buffers, scratch and taps lie apart inside it, and ``packed`` keeps
    MC_STAGE_INTS ints a stage, a conv of the input marked to read its own
    windows."""
    monkeypatch.setattr(affine, "CACHE_DIR", tmp_path / "convsynth")
    config, shaders = LAYOUT_GRAPHS[name]
    for fmt in ("rgba32f", "rgba16f"):
        plan = build_program(config, w, h, fmt, device="cpu", shader_path=shaders)._strip_plan
        assert plan is not None and plan[0] == "mc", (name, fmt)
        mc = plan[1]
        th, tw, nbytes = mc.tile()
        assert nbytes <= cuda_ops.MC_SMEM_LIMIT
        soft = [t for t in cuda_ops.MC_TILES
                if min(mc._layout(*t, n)[1] for n in cuda_ops.MC_WINDOW_BUFFERS)
                <= cuda_ops.MC_SMEM_SOFT]
        assert nbytes <= cuda_ops.MC_SMEM_SOFT or not soft
        geo = mc.geometry(th, tw)
        slot_off, layout_bytes, _geo = mc._layout(th, tw, int(geo[7]), int(geo[8]))
        assert layout_bytes == nbytes and list(_geo) == list(geo)
        scratch_off, taps_off, in_eh, in_ew, in_used, win_off, win, n_win, pixels, trig = (
            int(v) for v in geo)
        assert pixels in cuda_ops.MC_GLSL_PIXELS and trig in (0, 1)
        # [start, end) of each buffer in floats
        spans = []
        if in_used:
            spans.append((0, 4 * (th + 2 * in_eh) * cuda_ops._window_cols(tw, in_ew)[1]))
        cap = {}
        for st in mc.stages:
            if st.out >= 0:
                cap[st.out] = max(cap.get(st.out, 0), 4 * (th + 2 * st.eh) * ((tw + 2 * st.ew) | 1))
        spans += [(slot_off[k], slot_off[k] + c) for k, c in cap.items()]
        spans += [(win_off + k * win, win_off + (k + 1) * win) for k in range(n_win) if win]
        spans += [(scratch_off, taps_off), (taps_off, taps_off + 2 * len(mc.taps))]
        spans = sorted(sp for sp in spans if sp[1] > sp[0])
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), spans
        assert spans[-1][1] * 4 == nbytes
        assert win_off % cuda_ops.CONV_ALIGN == 0 and win % cuda_ops.CONV_ALIGN == 0
        stage_i, stage_f, s_off, t_off = mc.packed(th, tw)
        assert stage_i.shape == (len(mc.stages), cuda_ops.MC_STAGE_INTS)
        assert stage_f.shape == (len(mc.stages), 4) and (s_off, t_off) == (scratch_off, taps_off)
        for st, row in zip(mc.stages, stage_i):
            if st.kind == cuda_ops.MC_CONV and st.ins[0][0] == cuda_ops.MC_INPUT:
                assert row[3] == cuda_ops.MC_BUF_GLOBAL and win > 0
            for ref, at in ((st.ins[0], 3), (st.x, 9)):
                if ref is not None and ref[0] == cuda_ops.MC_INPUT and row[at] != cuda_ops.MC_BUF_GLOBAL:
                    assert row[at] == cuda_ops.MC_BUF_INPUT_BLOCK and in_used
                    assert tuple(row[at + 1:at + 3]) == (in_eh, in_ew)
