"""The flagship graph through the PyTorch port against the JAX package, on
the CPU: per-node tier (with conv bundles) and single strip tier, in
rgba32f, rgba16f and rgba8.

The JAX reference runs as its own tests run it: ``GraphProgram._forward``
is the jnp per-node path on the CPU, and ``_strip_fused_forward`` runs
``graph_strip_fused`` in Pallas interpret mode (tests/test_graph.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu.config import parse as jparse
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph.program import GraphProgram as JProgram
from reforge_tpu.kernels import ops as jops
from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import FLAGSHIP_CONFIG
from reforge_tpu_torch.graph import build_graph, graph_from_reference, make_program
from reforge_tpu_torch.kernels import cuda_ops, library
from reforge_tpu_torch.kernels.base import KernelContext

FORMATS = ("rgba32f", "rgba16f", "rgba8")
SIZES = ((48, 72), (96, 128))
T = 0.3


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    tutils.clear_warnings()
    yield


def _jax_graph():
    return jbuild(jparse(FLAGSHIP_CONFIG, expects_input=True))


def _image(h, w, seed=6):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


def _assert_close(got, want, fmt):
    d = np.abs(_f32(got) - _f32(want))
    if fmt == "rgba32f":
        # PARITY.md's whole-graph bound is 64 ulp; 1e-5 on [0, 1] values.
        assert d.max() <= 1e-5, d.max()
    elif fmt == "rgba16f":
        # The JAX package's own rgba16f bound (tests/test_graph.py:330):
        # its strip kernel rounds band weights and the H pass to bf16.
        assert d.max() <= 2e-2, d.max()
    else:
        # rgba8: mix averages two grid values, so about half its outputs
        # sit on a rounding tie that one bit decides.  Jitted XLA divides
        # by 255 as a multiply by the reciprocal (one bit off on 126 of the
        # 256 grid values; the port divides exactly, as eager jnp does), and
        # interpret-mode Pallas rounds each multiply and add where XLA-CPU
        # contracts FMAs.  So ties break both ways, and a flipped bucket can
        # cascade through one more quantized node: the JAX package's own
        # bound for its strip kernel against its per-node path
        # (tests/test_graph.py:373-384).  Measured here: 8% of values.
        assert d.max() <= 2.0 / 255.0 + 1e-6, d.max()
        assert (d > 1.0 / 512.0).mean() < 0.15


@functools.lru_cache(maxsize=None)
def _jax_per_node(h, w, fmt):
    prog = JProgram(_jax_graph(), w, h, fmt)
    out = jax.jit(prog._forward)(jnp.asarray(_image(h, w)), jnp.float32(T))
    return np.asarray(out.astype(jnp.float32))


def _port(h, w, fmt, plan_strips):
    prog = make_program(graph_from_reference(_jax_graph()), w, h, fmt, plan_strips=plan_strips,
                        device="cpu")
    assert prog is not None
    return prog


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_per_node_tier_matches_jax(fmt, h, w):
    x = torch.from_numpy(_image(h, w))
    want = _jax_per_node(h, w, fmt)
    bundled = _port(h, w, fmt, plan_strips=False)
    assert bundled._strip_plan is None
    out = bundled._forward(x, T)
    assert out.dtype == bundled.storage_dtype and tuple(out.shape) == (4, h, w)
    _assert_close(out, want, fmt)
    _assert_close(bundled.run_unfused(x, T), want, fmt)
    per_node, times = bundled.run_per_node(x, T)
    _assert_close(per_node, want, fmt)
    assert set(times) == {"soften", "crisp", "mixer", "tone", "vig"}


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("fmt", FORMATS)
def test_strip_tier_matches_jax_per_node(fmt, h, w):
    prog = _port(h, w, fmt, plan_strips=True)
    assert prog._strip_plan is not None
    out = prog._forward(torch.from_numpy(_image(h, w)), T)
    assert out.dtype == prog.storage_dtype
    _assert_close(out, _jax_per_node(h, w, fmt), fmt)


@pytest.mark.parametrize(
    "fmt,h,w", [(f, 48, 72) for f in FORMATS] + [("rgba16f", 96, 128)]
)
def test_strip_tier_matches_jax_strip_kernel(fmt, h, w, monkeypatch):
    """Against graph_strip_fused in interpret mode; at 96x128 the rgba16f
    convs take its bf16 band-matmul stage."""
    jprog = JProgram(_jax_graph(), w, h, fmt)
    monkeypatch.setattr(jops, "_use_pallas", lambda: True)
    monkeypatch.setattr(pallas_ops, "TRANSPOSE_MIN_WIDTH", 1)
    monkeypatch.setattr(
        pallas_ops, "graph_strip_fused",
        functools.partial(pallas_ops.graph_strip_fused, interpret=True),
    )
    x = _image(h, w)
    want = jprog._strip_fused_forward(jnp.asarray(x).astype(jprog.storage_dtype), jnp.float32(T))
    assert want is not None
    monkeypatch.undo()
    prog = _port(h, w, fmt, plan_strips=True)
    got = prog._forward(torch.from_numpy(x), T)
    _assert_close(got, np.asarray(want.astype(jnp.float32)), fmt)


def test_single_plan_shape_and_op_list():
    prog = _port(48, 72, "rgba32f", plan_strips=True)
    tag, conv_items, pointwise = prog._strip_plan
    assert tag == "single"
    assert sorted(n.name for n, _ in conv_items) == ["crisp", "soften"]
    assert [n.name for n in pointwise] == ["mixer", "tone", "vig"]
    strip = prog._build_strip_program()
    codes = [op.code for op in strip.ops]
    assert codes == [cuda_ops.OP_UNSHARP, cuda_ops.OP_TAKE1, cuda_ops.OP_MIX,
                     cuda_ops.OP_ACES, cuda_ops.OP_FADE_PLANE]
    mix_op = strip.ops[2]
    # mix reads soften as input_image and crisp as input_image2
    assert mix_op.ins == (strip.ops[1].out, strip.ops[0].out)
    assert strip.out_slot == strip.ops[-1].out
    assert strip.aux is not None and tuple(strip.aux.shape) == (1, 48, 72)


def test_graph_from_reference_tap_vectors_bitwise():
    jgraph = _jax_graph()
    graph = graph_from_reference(jgraph)
    assert set(graph.nodes) == set(jgraph.nodes)
    for name, node in graph.nodes.items():
        ref = jgraph.nodes[name]
        assert node.params == ref.params
        assert node.inputs == ref.inputs and node.outputs == ref.outputs
        if ref.spec.conv_weights is not None:
            for got, want in zip(node.spec.conv_weights(node.params),
                                 ref.spec.conv_weights(ref.params)):
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert [[n.name for n in layer] for layer in graph.layers] == [
        [n.name for n in layer] for layer in jgraph.layers
    ]


def test_port_parser_matches_reference_parser():
    ours = tconfig.parse(FLAGSHIP_CONFIG, expects_input=True)
    ref = jparse(FLAGSHIP_CONFIG, expects_input=True)
    assert repr(ours.graph_pipelines) == repr(ref.graph_pipelines)
    assert repr(ours.pipeline_instances) == repr(ref.pipeline_instances)
    native = build_graph(ours)
    assert [[n.name for n in layer] for layer in native.layers] == [["crisp", "soften"], ["mixer"], ["tone"], ["vig"]]


def test_glsl_kernel_file_is_a_build_diagnostic(tmp_path):
    """A shader the GLSL compiler refuses fails the build with the
    compiler's diagnostic (keep-last-good), as in the reference."""
    (tmp_path / "tonemap.comp").write_text("#version 450\nvoid main() {}\n")
    cfg = tconfig.parse_file(FLAGSHIP_CONFIG, True, str(tmp_path))
    assert cfg.graph_pipelines["tone"].file_path.endswith("tonemap.comp")
    assert build_graph(cfg) is None
    assert any("Error compiling GLSL kernel" in w and "tonemap.comp" in w
               and "never stores" in w for w in tutils.recent_warnings())


def test_make_program_rejects_bad_wiring():
    cfg = tconfig.parse("input -> mixer -> output\nmixer: mix { factor: 0.5 }", True)
    assert build_graph(cfg) is None  # input_image2 unwired
    cfg = tconfig.parse("input -> soften -> output\nsoften: gaussian { sigma: 2.0 }", True)
    prog = make_program(build_graph(cfg), 64, 32, "rgba8", device="cpu")
    assert prog is not None and prog._strip_plan is not None


def test_entry_points_default_to_the_card():
    """Without a device argument the port runs on the card, and without a
    card it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot be shown here")
    from reforge_tpu_torch.benchmarks import build_flagship, make_test_image
    from reforge_tpu_torch.kernels.ops import pixel_coords

    graph = build_graph(tconfig.parse(FLAGSHIP_CONFIG, True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_program(graph, 64, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flagship(64, 32)
    with pytest.raises((RuntimeError, AssertionError)):
        make_test_image(8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        pixel_coords(8, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        library.vignette.cw_coord_plane(KernelContext(width=8, height=8), {"strength": 0.5, "radius": 0.75})


@pytest.mark.parametrize("name", ["passthrough", "tonemap", "mix", "vignette", "gaussian", "unsharp"])
def test_channel_forms_match_fn(name):
    """cw_fn / conv_epilogue_cw / cw_plane_fn over all channels at once (ci a
    (4, 1, 1) index) equal the builtin's fn bit for bit."""
    spec = library.__dict__[name]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((4, 24, 40), dtype=np.float32))
    x2 = torch.from_numpy(rng.random((4, 24, 40), dtype=np.float32))
    ctx = KernelContext(width=40, height=24, time=T, device="cpu")
    params = {k: d.default for k, d in spec.params.items()}
    ci = torch.arange(4).view(4, 1, 1)
    images = {"input_image": x, "input_image2": x2}
    ins = {d: images[d] for d in spec.images_in}
    want = spec(ctx, ins, params)["output_image"]
    if spec.conv_weights is not None:
        wh, ww = spec.conv_weights(params)
        blurred = cuda_ops.sep_conv_fused(x, wh, ww)
        got = spec.conv_epilogue_cw(ctx, ci, x, blurred, params)
        assert torch.equal(spec.conv_epilogue(ctx, x, blurred, params), want)
    else:
        got = spec.cw_fn(ctx, ci, ins, params)
    assert torch.equal(got, want)
    if spec.cw_coord_plane is not None:
        plane = spec.cw_coord_plane(ctx, params)
        assert torch.equal(spec.cw_plane_fn(ctx, ci, ins, params, plane), want)
