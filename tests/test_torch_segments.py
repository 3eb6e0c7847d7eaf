"""The segments tier of the PyTorch port's GraphProgram (the reference's
``TestSegmentFusion``, tests/test_graph.py), on the CPU.

The reference triggers its segments at test sizes by monkeypatching its
wide-frame conv gate; the port has no such gate, so its segments come from
what its planners see: a node with no device form (a gather such as
pixelate or pixelate.comp, a ``.py`` kernel) between nodes that the single
or mc tier takes.  Each segment graph renders on its plan (the
children's kernels run their plain versions on the CPU) against the JAX
package's per-node path (``_forward_nostrip``), in three formats.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.config import parse as jparse
from reforge_tpu.config import parse_file as jparse_file
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph.program import GraphProgram as JProgram
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    GLSL_GRAPHS, LUT1D_CONFIG, PORT_SHADER_DIR, SHADER_DIR, build_program, plan_steps,
)
from reforge_tpu_torch.graph import GraphTraceError, build_graph, make_program

from test_torch_glsl_graph import _ulps

H, W = 48, 128
T = 0.25
FORMATS = ("rgba32f", "rgba16f", "rgba8")

# Builtin graphs with pixelate (a gather: no cw_op, no mc_op) as the
# per-node blocker.
BLOCKER_MID = (
    "input -> gs -> edge -> px -> gs2 -> tone -> output\n"
    "gs: gaussian { sigma: 2.0 }\nedge: sobel {}\npx: pixelate { size: 4 }\n"
    "gs2: gaussian { sigma: 1.5 }\ntone: tonemap {}\n"
)
BLOCKER_HEAD = (
    "input -> px -> edge -> tone -> output\n"
    "px: pixelate { size: 4 }\nedge: sobel {}\ntone: tonemap {}\n"
)
HEADS_TAILS = (
    "input -> tm -> gs -> px -> edge -> tm2 -> output\n"
    "tm: tonemap {}\ngs: gaussian { sigma: 2.0 }\npx: pixelate { size: 4 }\n"
    "edge: sobel {}\ntm2: tonemap {}\n"
)
LONE_STENCIL = "input -> edge -> px -> output\nedge: sobel {}\npx: pixelate { size: 4 }\n"
LONE_GLSL_CONV = "input -> gv -> px -> output\ngv: gaussian_v { sigma: 2.0 }\npx: pixelate { size: 4 }\n"
# The reference's GLSL graphs with pixelate.comp (a gather) after them: the
# graph and its point shader (tonemap.comp, an op-list stage) a segment.
GLSL_CHAIN_PX = GLSL_GRAPHS["glsl_chain"].replace("tm -> output", "tm -> px -> output") + \
    "px: pixelate { size: 4 }\n"
GLSL_SHARPEN_PX = GLSL_GRAPHS["glsl_sharpen"].replace("tm -> output", "tm -> px -> output") + \
    "px: pixelate { size: 4 }\n"
# A .py kernel at the head, written once for each package.
PY_GRAPH = (
    "input -> dbl -> gs -> edge -> tone -> output\n"
    "gs: gaussian { sigma: 2.0 }\nedge: sobel {}\ntone: tonemap {}\n"
)
PY_KERNEL = (
    "from {package}.kernels import kernel\n"
    "@kernel('dbl', register=False)\n"
    "def dbl(ctx, input_image, *, gain=0.8):\n"
    "    return input_image * gain + 0.05\n"
)

# name -> (config, shader path: None for builtins only, "py" for PY_GRAPH's
# kernel directory), and the plan's steps.
SEGMENT_GRAPHS = {
    "blocker_mid": (BLOCKER_MID, None,
                    [("seg mc", ["gs", "edge"]), ("node", ["px"]), ("seg single", ["gs2", "tone"])]),
    "blocker_head": (BLOCKER_HEAD, None, [("node", ["px"]), ("seg mc", ["edge", "tone"])]),
    "heads_tails": (HEADS_TAILS, None,
                    [("seg mc", ["tm", "gs"]), ("node", ["px"]), ("seg mc", ["edge", "tm2"])]),
    "lone_stencil": (LONE_STENCIL, None, [("seg mc", ["edge"]), ("node", ["px"])]),
    # shaders/pixelate.comp gathers the image before it: a segment of its
    # own, its op list's gather of the segment's input
    "glsl_chain": (GLSL_CHAIN_PX, SHADER_DIR,
                   [("seg mc", ["gh", "gv", "tm"]), ("seg mc", ["px"])]),
    "glsl_sharpen": (GLSL_SHARPEN_PX, SHADER_DIR,
                     [("seg mc", ["sh", "tm"]), ("seg mc", ["px"])]),
    "lone_glsl_conv": (LONE_GLSL_CONV, SHADER_DIR, [("seg mc", ["gv"]), ("seg mc", ["px"])]),
    "py_head": (PY_GRAPH, "py", [("node", ["dbl"]), ("seg mc", ["gs", "edge", "tone"])]),
}


def _check(fmt, got, want, what):
    """rgba32f: PARITY.md's whole-graph bound (64 ulps, with its 2e-6
    absolute floor where a gradient cancels towards 0); rgba16f: the strip
    tiers' bound against per node, 2e-2 (an ulp of a stencil stage's sum
    before a bf16 store flips a rounding, and a per-node tonemap after it
    carries the flip on: glsl-sharpen 7.8e-3); rgba8: one code."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got.astype(np.float64) - want)
    if fmt == "rgba32f":
        bad = (_ulps(got, want) > 64) & (d > 2e-6)
        assert not bad.any(), (what, float(d.max()))
    else:
        assert d.max() <= (2e-2 if fmt == "rgba16f" else 1.0 / 255.0 + 1e-6), (what, float(d.max()))


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    yield


@pytest.fixture
def kernel_dirs(tmp_path):
    """PY_KERNEL as dbl.py for each package: (port dir, JAX dir)."""
    dirs = []
    for package in ("reforge_tpu_torch", "reforge_tpu"):
        d = tmp_path / package
        d.mkdir()
        (d / "dbl.py").write_text(PY_KERNEL.format(package=package))
        dirs.append(str(d))
    return tuple(dirs)


def _programs(name, fmt, kernel_dirs=None, w=W):
    """The port's program of a segment graph (plans lazily) and the JAX
    package's."""
    config, shader_path, _steps = SEGMENT_GRAPHS[name]
    if shader_path == "py":
        tdir, jdir = kernel_dirs
    else:
        tdir = jdir = shader_path
    if tdir is None:
        prog = build_program(config, w, H, fmt, device="cpu")
        jgraph = jbuild(jparse(config, expects_input=True))
    else:
        prog = make_program(build_graph(tconfig.parse_file(config, True, tdir)), w, H, fmt,
                            device="cpu")
        jgraph = jbuild(jparse_file(config, True, jdir))
    return prog, JProgram(jgraph, w, H, fmt)


def _input(fmt, seed=5):
    x = np.random.default_rng(seed).random((4, H, W), dtype=np.float32)
    if fmt == "rgba16f":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x


@pytest.mark.parametrize("name", sorted(SEGMENT_GRAPHS))
def test_segment_plan_structure(name, kernel_dirs):
    """Plan structure: the blocker per node, the ranges around it as
    segments whose children plan the single or mc tier, a lone stencil or
    GLSL node as its own segment (pixelate.comp too, whose gather of an
    image the range before it writes keeps it out of that range's launch);
    the child reads the resource before it."""
    prog, _ = _programs(name, "rgba32f", kernel_dirs)
    assert prog._plan_strip_single() is None and prog._plan_strip_mc() is None
    assert plan_steps(prog) == SEGMENT_GRAPHS[name][2]
    for step in prog._strip_plan[1]:
        if step[0] == "seg":
            _, child, r_in, r_out, nodes = step
            assert r_in == nodes[0].inputs[0][0]
            assert r_out in {res for res, _ in nodes[-1].outputs}
            assert child.device == prog.device and child._segments_ok is False


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(SEGMENT_GRAPHS))
def test_segments_match_jax_per_node(name, fmt, kernel_dirs):
    """Segments (the children's plain kernels on the CPU) against the JAX
    package per node, within ``_check``'s bounds."""
    prog, jprog = _programs(name, fmt, kernel_dirs)
    x = _input(fmt)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)).astype(jnp.float32))
    got = prog._forward(torch.from_numpy(x.copy()), T)
    assert prog._strip_plan[0] == "segments"
    assert got.dtype == prog.storage_dtype
    _check(fmt, got.float().numpy(), want, name)


def test_two_chained_builtin_convs_around_a_blocker_have_no_segment():
    """A lone builtin conv on each side of the blocker: no segment (each has
    its own per-node kernel), so the plan is None."""
    config = ("input -> a -> px -> b -> output\na: gaussian { sigma: 2.0 }\n"
              "px: pixelate { size: 4 }\nb: gaussian { sigma: 2.0 }\n")
    assert build_program(config, W, H, device="cpu")._strip_plan is None


def test_storage_buffer_graph_is_refused():
    """A graph with a storage-buffer node plans no segments (buffer
    resources do not rename), though gs -> edge alone would fuse."""
    config = LUT1D_CONFIG.replace("input -> lut -> output",
                                  "input -> gs -> edge -> lut -> output")
    config += "gs: gaussian { sigma: 2.0 }\nedge: sobel {}\n"
    prog = make_program(build_graph(tconfig.parse_file(config, True, PORT_SHADER_DIR)), W, H,
                        device="cpu")
    assert prog._strip_plan is None


def test_width_not_a_multiple_of_128_plans():
    """The reference's ``width % 128`` gate is dropped: 120 wide plans the
    same segments, and they match per node."""
    prog, jprog = _programs("blocker_mid", "rgba32f", w=120)
    assert plan_steps(prog) == SEGMENT_GRAPHS["blocker_mid"][2]
    x = np.random.default_rng(6).random((4, H, 120), dtype=np.float32)
    want = np.asarray(jprog._forward_nostrip(jnp.asarray(x), jnp.float32(T)))
    got = prog._forward(torch.from_numpy(x.copy()), T).numpy()
    _check("rgba32f", got, want, "blocker_mid 120 wide")


def test_a_child_with_no_kernel_at_run_time_raises(monkeypatch):
    """A segment's plan is fixed when it is taken: a child that has nothing
    to run is a fault, never a quiet per-node fallback."""
    prog, _ = _programs("blocker_mid", "rgba32f")
    child = prog._strip_plan[1][0][1]
    monkeypatch.setattr(child, "_strip_fused_forward", lambda x, t: None)
    with pytest.raises(GraphTraceError, match="no strip plan at run time"):
        prog._forward(torch.from_numpy(_input("rgba32f")), T)


def test_sequence_and_per_node_modes_keep_their_paths():
    """render_sequence runs the segments plan frame by frame; run_unfused
    and run_per_node stay node by node."""
    prog, _ = _programs("blocker_mid", "rgba32f")
    x = torch.from_numpy(_input("rgba32f"))
    seq = prog.render_sequence(x, T, 0.5, 2, stack=True)
    assert torch.equal(seq[0], prog._forward(x, T))
    assert torch.equal(seq[1], prog._forward(x, T + 0.5))
    unfused = prog.run_unfused(x, T)
    per_node, times = prog.run_per_node(x, T)
    assert torch.equal(unfused, per_node) and set(times) == {"gs", "edge", "px", "gs2", "tone"}
    assert torch.equal(unfused, prog._forward_nostrip(x, T))
