"""The port's parallel/ package (row sharding with halo exchange, batches
and pipeline stages) against the JAX package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's meshes name the CPU eight times (``["cpu"] * 8``), its counterpart.
Each case of tests/test_parallel.py has one here, on the same numpy seed
inputs: rgba32f within 1e-5, rgba8 within one code (a bucket may flip
between tiers), rgba16f within the strip tiers' 2e-2 where the port's tier
differs from the reference's per-node path.  The port's own cases: the
per-slab strip route (graph_strip and graph_strip_mc's plain versions on
extended slabs with a row offset) against the per-node route and the
unsharded program, ``halo_pad`` bit for bit against the reference's
``ppermute`` chain, the row offset of each strip kernel's plain version,
the noise grain each slab inherits, and the Engine and CLI with ``shard``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from reforge_tpu import utils as jutils
from reforge_tpu.config import parse as jparse
from reforge_tpu.config import parse_file as jparse_file
from reforge_tpu.graph import build_graph as jbuild
from reforge_tpu.graph import make_program as jmake
from reforge_tpu.parallel import BatchProgram as JBatch
from reforge_tpu.parallel import HaloShardedProgram as JHalo
from reforge_tpu.parallel import PipelineStagedProgram as JStaged
from reforge_tpu.parallel import make_batch_mesh as jbatch_mesh
from reforge_tpu.parallel import make_row_mesh as jrow_mesh
from reforge_tpu.parallel import shard_program as jshard_program
from reforge_tpu.parallel.halo import halo_pad as jhalo_pad
from reforge_tpu.parallel.pipeline import split_layers as jsplit
from reforge_tpu_torch import config as tconfig
from reforge_tpu_torch import parallel
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    CHAIN3_CONFIG, DEMO_CONFIG, FLAGSHIP_CONFIG, PORT_SHADER_DIR, SHADER_DIR, ZERO_BORDER_CONFIG,
)
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.graph import build_graph, make_program
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.parallel import (
    BatchProgram, HaloShardedProgram, PipelineStagedProgram, halo_pad, make_batch_mesh,
    make_row_mesh, shard_program, split_layers,
)

N_DEV = 8
CPU8 = ["cpu"] * N_DEV

# tests/test_parallel.py's graphs.
CASES = {
    "pointwise": "input -> invert -> tonemap -> output",
    "coordinate": "input -> vignette -> scanlines -> output",
    "conv": "input -> gs -> sharpen -> output\ngs: gaussian { sigma: 2.0 }",
    "gather": "input -> px -> output\npx: pixelate { size: 8 }",
    "branching": (
        "input -> gs -> mixit -> output\n"
        "input -> sharpen -> mixit:input_image2\n"
        "gs: gaussian { sigma: 1.5 }\nmixit: mix { factor: 0.5 }"
    ),
    "generator_blend": (
        "input -> mixit -> output\n"
        "cb -> mixit:input_image2\n"
        "cb: checkerboard { size: 8 }\nmixit: mix { factor: 0.3 }"
    ),
    "edge_preserving": (
        "input -> med -> smooth -> output\n"
        "med: median3 {}\n"
        "smooth: bilateral { radius: 3, sigma_range: 0.1 }"
    ),
    "stylized": (
        "input -> grade -> dots -> output\n"
        "grade: levels { in_black: 0.05 }\ndots: halftone { size: 8 }"
    ),
}

SHADER_HEADER = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0, rgba32f) uniform readonly  image2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
"""
# fwidth reads the next row: a 1-row halo.
OUTLINE = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 c = imageLoad(input_image, pos);
    float y = dot(c.rgb, vec3(0.2126, 0.7152, 0.0722));
    imageStore(output_image, pos, vec4(vec3(fwidth(y) * 4.0), c.a));
}
"""
# A clamp-origin conv.
HBLUR = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 acc = vec4(0.0);
    for (int d = -2; d <= 2; d++) {
        acc += imageLoad(input_image, clamp(pos + ivec2(0, d), ivec2(0), size - ivec2(1)));
    }
    imageStore(output_image, pos, acc / 5.0);
}
"""
# gl_GlobalInvocationID.y against imageSize: a global gradient.
YGRAD = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    float v = float(pos.y) / float(size.y - 1);
    imageStore(output_image, pos, vec4(v, v, v, 1.0));
}
"""
# Unclamped reads: zeros out of bounds.
VBLUR0 = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec4 acc = vec4(0.0);
    for (int d = -2; d <= 2; d++) {
        acc += imageLoad(input_image, pos + ivec2(0, d));
    }
    imageStore(output_image, pos, acc / 5.0);
}
"""
# A point shader reading its row (an op list's K_COORD_Y on the mc tier).
YSHADE = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 c = imageLoad(input_image, pos);
    float f = float(pos.y) / float(size.y) + 0.25 * float(pos.y % 3);
    imageStore(output_image, pos, vec4(c.rgb * f, c.a));
}
"""
MIXED = SHADER_HEADER + """void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    ivec2 size = imageSize(input_image);
    vec4 a = imageLoad(input_image, pos + ivec2(0, 1));
    vec4 b = imageLoad(input_image, clamp(pos + ivec2(0, -1), ivec2(0), size - ivec2(1)));
    imageStore(output_image, pos, (a + b) * 0.5);
}
"""
HIST_WIRING = ("input -> histogram\nhistogram:Bins -> equalize:Bins\n"
               "input -> equalize -> output\n")


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    jutils.print_warnings = False
    tutils.clear_warnings()
    yield


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= N_DEV
    return jrow_mesh(N_DEV)


@pytest.fixture(scope="module")
def mesh():
    return make_row_mesh(N_DEV, CPU8)


def rand_image(h=64, w=64, seed=0):
    return np.random.default_rng(seed).random((4, h, w), dtype=np.float32)


def tprog(src, w=64, h=64, fmt="rgba32f", shader_dir=None, plan_strips=True):
    cfg = (tconfig.parse(src, True) if shader_dir is None
           else tconfig.parse_file(src, True, str(shader_dir)))
    assert cfg is not None, tutils.recent_warnings()
    prog = make_program(build_graph(cfg), w, h, fmt, plan_strips=plan_strips, device="cpu")
    assert prog is not None, tutils.recent_warnings()
    return prog


def jprog(src, w=64, h=64, fmt="rgba32f", shader_dir=None):
    cfg = jparse(src, True) if shader_dir is None else jparse_file(src, True, str(shader_dir))
    assert cfg is not None, jutils.recent_warnings()
    prog = jmake(jbuild(cfg), w, h, fmt)
    assert prog is not None
    return prog


def t_out(prog, img, t=0.0):
    return prog(torch.from_numpy(img.copy()), t).float().numpy()


def t_sharded(prog, img, t=0.0, devices=CPU8):
    sharded = HaloShardedProgram(prog, make_row_mesh(len(devices), devices))
    return sharded(sharded.shard_input(torch.from_numpy(img.copy())), t).float().numpy()


def j_sharded(prog, jmesh, img, t=0.0):
    sharded = JHalo(prog, jmesh)
    return np.asarray(sharded(sharded.shard_input(jnp.asarray(img)), t), np.float32)


def _close(fmt, got, want, what=""):
    """rgba32f within 1e-5 (tests/test_parallel.py's bound), rgba16f
    within the strip tiers' 2e-2, rgba8 within one code."""
    d = float(np.abs(np.asarray(got, np.float64) - want).max())
    bound = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 1.0 / 255.0 + 1e-6}[fmt]
    assert d <= bound, (what, fmt, d)


def _shader_dir(tmp_path, **shaders):
    for name, src in shaders.items():
        (tmp_path / f"{name}.comp").write_text(src)
    return tmp_path


# ---- halo_pad -------------------------------------------------------------------


@pytest.mark.parametrize("r", [3, 8, 20, 70])
@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_halo_pad_bit_equal_to_the_reference(jmesh, r, mode):
    """Single hop (r <= h), a whole slab, chained hops (r > h) and a radius
    past the whole mesh: every slab's extended block equals the
    reference's ppermute chain bit for bit."""
    img = rand_image(seed=1)

    def body(x):
        return jhalo_pad(x, r, N_DEV, jax.lax.axis_index("rows"), mode=mode)

    rows = P(None, "rows", None)
    want = np.asarray(shard_map(body, mesh=jmesh, in_specs=rows, out_specs=rows,
                                check_vma=False)(jnp.asarray(img)))
    slabs = list(torch.from_numpy(img).split(64 // N_DEV, dim=1))
    got = torch.cat([halo_pad(slabs, r, i, mode) for i in range(N_DEV)], dim=1).numpy()
    np.testing.assert_array_equal(got, want)


# ---- the halo executor against the reference's ----------------------------------------


class TestHaloSharding:
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_single_device(self, mesh, jmesh, name):
        img = rand_image()
        prog = tprog(CASES[name])
        got = t_sharded(prog, img, 0.25)
        np.testing.assert_array_equal(got, t_out(prog, img, 0.25), err_msg=name)
        want = j_sharded(jprog(CASES[name]), jmesh, img, 0.25)
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)

    @pytest.mark.parametrize("plan_strips", [True, False])
    def test_wide_halo_multihop_exchange(self, jmesh, plan_strips):
        # sigma 8 -> halo 24 > h_local 8: neighbour rows over 3 hops, no
        # gather; the strip route (one exchange of the plan's input halo)
        # and the per-node route.
        src = "input -> gs -> output\ngs: gaussian { sigma: 8.0 }"
        img = rand_image()
        prog = tprog(src, plan_strips=plan_strips)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, j_sharded(jprog(src), jmesh, img), atol=1e-5)
        assert not any("all-gather" in w for w in tutils.recent_warnings())

    def test_sigma16_on_128_rows_multihop(self, jmesh):
        src = "input -> gs -> output\ngs: gaussian { sigma: 16.0 }"
        img = rand_image(h=128)
        got = t_sharded(tprog(src, h=128, plan_strips=False), img)
        np.testing.assert_allclose(got, j_sharded(jprog(src, h=128), jmesh, img), atol=1e-5)
        assert not any("all-gather" in w for w in tutils.recent_warnings())

    def test_whole_image_radius_still_gathers(self, jmesh):
        src = "input -> gs -> output\ngs: gaussian { sigma: 24.0 }"
        prog = tprog(src)
        assert prog.graph.layers[0][0].halo >= 64
        img = rand_image()
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-5)
        np.testing.assert_allclose(got, j_sharded(jprog(src), jmesh, img), atol=1e-5)
        assert any("all-gather" in w for w in tutils.recent_warnings())

    def test_indivisible_height_rejected(self, mesh):
        with pytest.raises(ValueError, match="not divisible"):
            HaloShardedProgram(tprog("input -> invert -> output", h=60), mesh)

    @pytest.mark.parametrize("fmt", ["rgba8", "rgba16f"])
    def test_non_f32_formats_sharded(self, jmesh, fmt):
        """The sharded program applies the unsharded one's storage cast
        before the first node: equal to it; against the reference's
        per-node path within the format's bound."""
        img = rand_image()
        prog = tprog(CASES["conv"], fmt=fmt)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-5, err_msg=fmt)
        _close(fmt, got, j_sharded(jprog(CASES["conv"], fmt=fmt), jmesh, img))

    def test_ssbo_pipeline_sharded(self, jmesh):
        """histogram -> equalize: the buffer nodes gather the image, and the
        buffer is one whole copy a slab."""
        img = rand_image(seed=5)
        prog = tprog(HIST_WIRING, shader_dir=SHADER_DIR)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-5)
        want = j_sharded(jprog(HIST_WIRING, shader_dir=SHADER_DIR), jmesh, img)
        np.testing.assert_allclose(got, want, atol=1e-5)

    @pytest.mark.parametrize("name,src,atol", [("outline", OUTLINE, 1e-6), ("hblur", HBLUR, 1e-5),
                                               ("ygrad", YGRAD, 1e-6)])
    def test_glsl_kernels_sharded(self, jmesh, tmp_path, name, src, atol):
        """A derivative (fwidth reads the next row), a clamp-origin conv and
        gl_GlobalInvocationID.y against imageSize: each slab's rows are the
        image's."""
        d = _shader_dir(tmp_path, **{name: src})
        config = f"input -> {name} -> output"
        img = rand_image(seed=6)
        prog = tprog(config, shader_dir=d)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=atol)
        np.testing.assert_allclose(got, j_sharded(jprog(config, shader_dir=d), jmesh, img),
                                   atol=atol)
        if name == "ygrad":  # a gradient spanning 0..1 over the whole image
            assert got[0, 0, 0] == 0.0 and abs(got[0, -1, 0] - 1.0) < 1e-6


class TestGspmdSharding:
    @pytest.mark.parametrize("name", ["pointwise", "conv", "branching"])
    def test_matches_single_device(self, mesh, jmesh, name):
        img = rand_image()
        prog = tprog(CASES[name])
        sharded = shard_program(prog, mesh)
        got = sharded(sharded.shard_input(torch.from_numpy(img)), 0.25).numpy()
        np.testing.assert_allclose(got, t_out(prog, img, 0.25), atol=1e-5, err_msg=name)
        jsh = jshard_program(jprog(CASES[name]), jmesh)
        want = np.asarray(jsh(jsh.shard_input(jnp.asarray(img)), 0.25))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)


class TestBorderModes:
    def test_zero_border_glsl_sharded(self, jmesh, tmp_path):
        """Unclamped imageLoad (zeros out of bounds): the image's top and
        bottom slabs read zeros past it, not replicated rows."""
        d = _shader_dir(tmp_path, vblur0=VBLUR0)
        prog = tprog("input -> vblur0 -> output", shader_dir=d)
        assert prog.graph.nodes["vblur0"].spec.border_for({}) == "zero"
        img = rand_image()
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-5)
        want = j_sharded(jprog("input -> vblur0 -> output", shader_dir=d), jmesh, img)
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_mixed_borders_fall_back_to_gather(self, jmesh, tmp_path):
        d = _shader_dir(tmp_path, mixed=MIXED)
        prog = tprog("input -> mixed -> output", shader_dir=d)
        assert prog.graph.nodes["mixed"].spec.halo_for({}) is None  # the gather route
        img = rand_image(seed=2)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-6)
        want = j_sharded(jprog("input -> mixed -> output", shader_dir=d), jmesh, img)
        np.testing.assert_allclose(got, want, atol=1e-6)


# ---- the per-slab strip route ------------------------------------------------------------

# name -> (config, shader dir, rows, slab route)
STRIP_GRAPHS = {
    "flagship": (FLAGSHIP_CONFIG, None, 64, "strip single"),
    "demo": (DEMO_CONFIG, None, 64, "strip mc"),
    "chain3": (CHAIN3_CONFIG, None, 128, "strip mc mid"),
    "yshade": ("input -> gs -> ys -> output\ngs: gaussian { sigma: 1.5 }\n", "yshade", 64,
               "strip mc"),
    "yshade_hazard": ("input -> ys -> gs -> output\ngs: gaussian { sigma: 1.5 }\n", "yshade",
                      128, "strip mc mid"),
    "zero_border": (ZERO_BORDER_CONFIG, PORT_SHADER_DIR, 64, "strip mc"),
}


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
@pytest.mark.parametrize("name", sorted(STRIP_GRAPHS))
def test_strip_route_matches_per_node_route(name, fmt, tmp_path):
    """Each slab exchanges the plan's input halo once and runs the
    whole-graph kernel's plain version on its extended slab with its row
    offset (the flagship's hoisted vignette plane built for the slab's
    rows; a GLSL point shader's K_COORD_Y; zero mode; chain3's edge hazard
    on the top, inner and bottom slab variants): equal to the unsharded
    program bit for bit, and to the per-node route within the strip tiers'
    bound."""
    config, shader_dir, h, route = STRIP_GRAPHS[name]
    if shader_dir == "yshade":  # a GLSL point stage reading its row
        shader_dir = _shader_dir(tmp_path, ys=YSHADE)
    img = rand_image(h=h, seed=3)
    prog = tprog(config, h=h, fmt=fmt, shader_dir=shader_dir)
    sharded = HaloShardedProgram(prog, make_row_mesh(N_DEV, CPU8))
    assert sharded.slab_plans[1] == route, sharded.slab_plans
    if route == "strip mc mid":
        assert (sharded.slab_plans[0], sharded.slab_plans[-1]) == ("strip mc top",
                                                                   "strip mc bottom")
    got = sharded(torch.from_numpy(img.copy()), 0.3).float().numpy()
    np.testing.assert_array_equal(got, t_out(prog, img, 0.3))
    per_node = t_sharded(tprog(config, h=h, fmt=fmt, shader_dir=shader_dir, plan_strips=False),
                         img, 0.3)
    _close(fmt, got, per_node, name)


def test_hazard_slab_thinner_than_its_halo_runs_per_node():
    """chain3's input halo (7 rows) past a 4-row slab: the edge-hazard
    variants need a slab of neighbour data, so every slab runs per node."""
    img = rand_image(h=32, seed=4)
    prog = tprog(CHAIN3_CONFIG, h=32)
    assert prog._strip_plan[1].edge_hazard and prog._strip_plan[1].input_halo == 7
    sharded = HaloShardedProgram(prog, make_row_mesh(N_DEV, CPU8))
    assert sharded.slab_plans == ["per node"] * N_DEV
    got = sharded(torch.from_numpy(img.copy()), 0.0).numpy()
    np.testing.assert_allclose(got, t_out(prog, img), atol=1e-5)


# ---- the strip kernels' row offset ---------------------------------------------------------

STRIP_ROW_GRAPHS = {
    # single tier: the hoisted vignette plane, and dither and scanlines
    # (channel ops reading the row)
    "flagship": FLAGSHIP_CONFIG,
    "dither": ("input -> gs -> d -> s -> output\ngs: gaussian { sigma: 1.0 }\n"
               "d: dither { levels: 4 }\ns: scanlines { period: 3 }\n"),
    # mc tier: vignette's point op after a conv and a stencil
    "mc_vignette": ("input -> gs -> edge -> v -> output\ngs: gaussian { sigma: 1.0 }\n"
                    "edge: sharpen {}\nv: vignette { strength: 0.8 }\n"),
}


@pytest.mark.parametrize("name", sorted(STRIP_ROW_GRAPHS))
def test_strip_plain_versions_take_a_row_offset(name):
    """graph_strip_plain / graph_strip_mc_plain on rows a-r .. b+r of the
    frame with row0 = a - r, cropped by r, equal the unsharded output's
    rows a .. b bit for bit."""
    h, a, b = 48, 20, 31
    img = torch.from_numpy(rand_image(h=h, seed=7))
    prog = tprog(STRIP_ROW_GRAPHS[name], h=h)
    tier = prog._strip_plan[0]
    want = prog._strip_fused_forward(img, 0.5)[:, a:b]
    if tier == "mc":
        mc = prog._strip_plan[1]
        r = mc.input_halo
        got = cuda_ops.graph_strip_mc(img[:, a - r:b + r].contiguous(), 0.5, mc, a - r)
    else:
        r = max((len(wh) - 1) // 2 for _, (wh, _ww) in prog._strip_plan[1])
        strip = prog._build_strip_program("cpu", a - r, b - a + 2 * r)
        assert strip.aux is not None  # vignette's or scanlines' plane, for these rows
        got = cuda_ops.graph_strip(img[:, a - r:b + r].contiguous(), 0.5, strip, a - r, h)
    assert tier == ("mc" if name.startswith("mc") else "single")
    np.testing.assert_array_equal(got[:, r:r + b - a].numpy(), want.numpy())


def test_glsl_point_stage_takes_a_row_offset(tmp_path):
    """An op list's K_COORD_Y reads the image row: graph_strip_mc_plain on
    a slab with row0 equals the frame's rows."""
    d = _shader_dir(tmp_path, ys=YSHADE)
    h, a, b = 48, 13, 40
    prog = tprog(STRIP_GRAPHS["yshade"][0], h=h, shader_dir=d)
    mc = prog._strip_plan[1]
    assert cuda_ops.MC_GLSL in [st.op.code for st in mc.stages]
    img = torch.from_numpy(rand_image(h=h, seed=8))
    r = mc.input_halo
    got = cuda_ops.graph_strip_mc_plain(img[:, a - r:b + r], 0.5, mc, a - r)
    want = cuda_ops.graph_strip_mc_plain(img, 0.5, mc)
    np.testing.assert_array_equal(got[:, r:r + b - a].numpy(), want[:, a:b].numpy())


# ---- batches ---------------------------------------------------------------------


class TestBatch:
    def test_batch_mesh_rejects_oversubscription(self):
        with pytest.raises(ValueError, match="have"):
            make_batch_mesh(N_DEV + 1, CPU8)

    @pytest.mark.parametrize("name", ["conv", "coordinate", "branching"])
    def test_batch_sharded_matches_loop(self, name):
        """Shares of the batch on the mesh's devices == the single-frame
        program frame by frame with per-frame times, and the reference's
        BatchProgram on its mesh."""
        prog = tprog(CASES[name])
        bp = BatchProgram(prog, make_batch_mesh(N_DEV, CPU8))
        batch = np.random.default_rng(7).random((N_DEV, 4, 64, 64), dtype=np.float32)
        times = np.linspace(0.0, 1.5, N_DEV).astype(np.float32)
        got = bp(bp.shard_input(torch.from_numpy(batch)), torch.from_numpy(times)).numpy()
        for b in range(N_DEV):
            np.testing.assert_allclose(got[b], t_out(prog, batch[b], float(times[b])), atol=1e-5,
                                       err_msg=f"{name} frame {b}")
        jbp = JBatch(jprog(CASES[name]), jbatch_mesh(N_DEV))
        want = np.asarray(jbp(jbp.shard_input(jnp.asarray(batch)), jnp.asarray(times)))
        np.testing.assert_allclose(got, want, atol=1e-5, err_msg=name)

    def test_batch_scalar_time_broadcasts(self):
        prog = tprog(CASES["pointwise"])
        bp = BatchProgram(prog)  # no mesh: the frames in turn
        batch = np.random.default_rng(3).random((3, 4, 64, 64), dtype=np.float32)
        got = bp(torch.from_numpy(batch), 0.5).numpy()
        for b in range(3):
            np.testing.assert_allclose(got[b], t_out(prog, batch[b], 0.5), atol=1e-6)

    def test_batch_time_vector_shape_checked(self):
        bp = BatchProgram(tprog(CASES["pointwise"]))
        with pytest.raises(ValueError, match="times shape"):
            bp(torch.zeros((3, 4, 64, 64)), np.zeros((2,), np.float32))

    def test_pad_batch_to_the_mesh(self):
        bp = BatchProgram(tprog(CASES["pointwise"]), make_batch_mesh(4, ["cpu"] * 4))
        batch = torch.from_numpy(np.random.default_rng(4).random((5, 4, 8, 8), dtype=np.float32))
        padded, n = bp.pad_batch(batch)
        assert n == 5 and padded.shape[0] == 8
        assert torch.equal(padded[5:], batch[:1].expand(3, -1, -1, -1))
        assert [s.shape[0] for s in bp.shard_input(padded)] == [2, 2, 2, 2]


# ---- pipeline stages ----------------------------------------------------------------------


class TestPipelineParallel:
    def test_staged_matches_single_device(self):
        src = ("input -> gs -> sharpen -> tone -> vig -> output\n"
               "gs: gaussian { sigma: 2.0 }\ntone: tonemap {}\nvig: vignette {}\n")
        prog, jp = tprog(src), jprog(src)
        img = rand_image()
        staged = PipelineStagedProgram(prog, devices=["cpu"] * 4)
        jstaged = JStaged(jp, devices=jax.devices()[:4])
        names = [[n.name for layer in g for n in layer] for g in staged.stage_layers]
        assert len(names) >= 2
        assert names == [[n.name for layer in g for n in layer] for g in jstaged.stage_layers]
        got = staged(torch.from_numpy(img), 0.1).numpy()
        np.testing.assert_allclose(got, t_out(prog, img, 0.1), atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jstaged(jnp.asarray(img), 0.1)), atol=1e-5)

    def test_staged_branching_graph(self):
        prog = tprog(CASES["branching"])
        img = rand_image(seed=5)
        got = PipelineStagedProgram(prog, devices=["cpu"] * 2)(torch.from_numpy(img), 0.0)
        np.testing.assert_allclose(got.numpy(), t_out(prog, img), atol=1e-5)

    def test_more_stages_than_layers_clamps(self):
        prog = tprog("input -> invert -> output")
        staged = PipelineStagedProgram(prog, devices=CPU8)
        assert len(staged.stage_layers) == 1 and len(staged.devices) == 1
        img = rand_image()
        np.testing.assert_allclose(staged(torch.from_numpy(img), 0.0).numpy(), t_out(prog, img),
                                   atol=1e-6)

    def test_measured_costs_balance_stages(self):
        """split_layers balances on measured per-node ms when given, with
        the reference's partition."""
        src = ("input -> a -> b -> c -> d -> output\n"
               "a: invert {}\nb: invert {}\nc: invert {}\nd: invert {}\n")
        layers, jlayers = tprog(src).graph.layers, jprog(src).graph.layers
        for costs in ({"a": 10.0, "b": 1.0, "c": 1.0, "d": 1.0},
                      {k: 1.0 for k in "abcd"}, None):
            groups = split_layers(layers, 2, costs)
            assert [[n.name for layer in g for n in layer] for g in groups] == \
                [[n.name for layer in g for n in layer] for g in jsplit(jlayers, 2, costs)]
        assert [n.name for layer in split_layers(layers, 2, {"a": 10.0})[0] for n in layer] == ["a"]

    def test_measure_true_runs_and_matches(self):
        prog = tprog(CASES["conv"])
        img = rand_image()
        staged = PipelineStagedProgram(prog, devices=["cpu"] * 2, measure=True)
        assert staged.node_costs and all(v >= 0.0 for v in staged.node_costs.values())
        np.testing.assert_allclose(staged(torch.from_numpy(img), 0.0).numpy(), t_out(prog, img),
                                   atol=1e-5)

    def test_render_stream_matches_sequential(self):
        """Frames in flight == one at a time, with per-frame times, in
        order."""
        prog = tprog(CASES["coordinate"])
        staged = PipelineStagedProgram(prog, devices=["cpu"] * 3)
        rng = np.random.default_rng(11)
        frames = [rng.random((4, 64, 64), dtype=np.float32) for _ in range(5)]
        times = [0.0, 0.3, 0.6, 0.9, 1.2]
        got = list(staged.render_stream([torch.from_numpy(f) for f in frames], times, depth=3))
        assert len(got) == 5
        for i, (f, t) in enumerate(zip(frames, times)):
            np.testing.assert_allclose(got[i].numpy(), t_out(prog, f, t), atol=1e-5,
                                       err_msg=f"frame {i}")


# ---- storage buffers (tests/test_ssbo.py's TestSharded) ----------------------------------


class TestSharded:
    def test_histogram_pipeline_sharded(self, jmesh):
        img = rand_image(h=32, w=48)
        prog = tprog(HIST_WIRING, w=48, h=32, shader_dir=SHADER_DIR)
        got = t_sharded(prog, img)
        np.testing.assert_allclose(got, t_out(prog, img), atol=1e-4)
        want = j_sharded(jprog(HIST_WIRING, w=48, h=32, shader_dir=SHADER_DIR), jmesh, img)
        np.testing.assert_allclose(got, want, atol=1e-4)


# ---- a reference gap, inherited ----------------------------------------------------------------


def test_noise_grain_of_a_slab(jmesh):
    """noise draws its block's shape with the same key, as the reference
    does: on a slab it would repeat the grain of the image's first rows (a
    reference gap, inherited: the kernel on a slab's context equals the
    reference's bit for bit).  The executors never run it on a slab: its
    halo is None, so the sharded program gathers and equals the unsharded
    one, as the reference's does."""
    from reforge_tpu.kernels.base import KernelContext as JContext
    from reforge_tpu.kernels.base import builtin_kernels as jbuiltins
    from reforge_tpu_torch.kernels.base import KernelContext, builtin_kernels

    src = "input -> n -> output\nn: noise { amount: 0.2, seed: 3 }"
    img = np.full((4, 64, 64), 0.5, np.float32)
    got = t_sharded(tprog(src), img)
    np.testing.assert_array_equal(got, t_out(tprog(src), img))
    np.testing.assert_array_equal(got, j_sharded(jprog(src), jmesh, img))
    params = {"amount": 0.2, "seed": 3}
    slab = img[:, 8:16]
    tspec, jspec = builtin_kernels()["noise"], jbuiltins()["noise"]
    t_slab = tspec(KernelContext(width=64, height=64, device="cpu", row_offset=8, local_height=8),
                   {"input_image": torch.from_numpy(slab.copy())},
                   tspec.resolve_params(params))["output_image"].numpy()
    j_slab = jspec(JContext(width=64, height=64, row_offset=8, local_height=8),
                   {"input_image": jnp.asarray(slab)}, jspec.resolve_params(params))
    np.testing.assert_array_equal(t_slab, np.asarray(j_slab["output_image"]))
    np.testing.assert_array_equal(t_slab, got[:, :8])  # the first rows' grain


# ---- meshes ----------------------------------------------------------------------------


def test_row_mesh_counts_the_cards(monkeypatch):
    """The default devices are the distinct cards; asking for more raises
    the reference's message; an explicit list may repeat a device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_row_mesh()
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.shape == {parallel.ROW_AXIS: 2}
    assert make_row_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 3 devices, have 2"):
        make_row_mesh(3)
    assert make_row_mesh(4, ["cuda:0"] * 4).devices == (torch.device("cuda", 0),) * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="requested 1 devices, have 0"):
        make_row_mesh(1)


def test_parallel_imports_no_jax():
    """parallel/, and the Engine and CLI that import it, load nothing of JAX
    or of the JAX package."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import json, sys\n"
            "import reforge_tpu_torch.parallel, reforge_tpu_torch.engine, reforge_tpu_torch.cli\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('jax', 'jaxlib', 'reforge_tpu'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=repo), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_exported_names_match_the_reference():
    import reforge_tpu.parallel as jparallel

    assert parallel.__all__ == jparallel.__all__


# ---- the Engine and the command line ------------------------------------------------------------


def _engine(tmp_path, config, **kw):
    path = tmp_path / "g.rf"
    path.write_text(config)
    return Engine(RenderInfo(64, 64, "cpu", config_path=str(path), shader_path=str(tmp_path),
                             **kw))


@pytest.mark.parametrize("kw", [dict(shard=8, devices=tuple(CPU8)), dict(shard=1),
                                dict(pipeline_stages=2, devices=("cpu", "cpu")),
                                dict(pipeline_stages=2, shard=4, devices=("cpu",) * 4)])
def test_engine_frames_through_the_parallel_program(tmp_path, kw):
    """The frame path dispatches through ``program.sharded``: equal to the
    unsharded engine's frame."""
    u8 = np.random.default_rng(9).integers(0, 256, (64, 64, 4), dtype=np.uint8)
    engine = _engine(tmp_path, FLAGSHIP_CONFIG, has_input_image=True, **kw)
    plain = _engine(tmp_path, FLAGSHIP_CONFIG, has_input_image=True)
    kinds = {"shard": HaloShardedProgram, "pipeline_stages": PipelineStagedProgram}
    assert isinstance(engine.program.sharded,
                      kinds["pipeline_stages" if "pipeline_stages" in kw else "shard"])
    for e in (engine, plain):
        e.load_input(u8)
    got, want = engine.render_frame_blocking(0.5), plain.render_frame_blocking(0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    engine.close()
    plain.close()


def test_engine_refuses_a_shard_it_cannot_run(tmp_path):
    """No single-device fallback: an indivisible height or more devices
    than there are raise at construction, and a rebuild that cannot be
    sharded keeps the last good program."""
    with pytest.raises(RuntimeError, match="not divisible"):
        _engine(tmp_path, "input -> invert -> output", shard=3, devices=("cpu",) * 3,
                has_input_image=True)
    with pytest.raises(RuntimeError, match="requested 2 devices, have 1"):
        _engine(tmp_path, "input -> invert -> output", shard=2, has_input_image=True)
    engine = _engine(tmp_path, "input -> invert -> output", shard=4, devices=("cpu",) * 4,
                     has_input_image=True)
    first = engine.program
    engine.info.shard = 3  # the next rebuild cannot shard 64 rows 3 ways
    (tmp_path / "g.rf").write_text("input -> invert -> tonemap -> output")
    import os
    st = os.stat(tmp_path / "g.rf")
    os.utime(tmp_path / "g.rf", (st.st_atime + 5, st.st_mtime + 5))
    assert not engine.trigger_reloads()
    assert engine.program is first
    assert any("not divisible" in w for w in tutils.recent_warnings())
    engine.close()


def test_cli_batch_with_shard(tmp_path, capsys):
    """Batch mode with ``--shard N`` shares the images out over N devices
    (a BatchProgram): ``--shard 1`` writes what batch mode without it
    writes; more devices than there are exit 1 and write nothing."""
    from reforge_tpu_torch.cli import main
    from reforge_tpu_torch.io import encode

    indir = tmp_path / "in"
    indir.mkdir()
    for i in range(3):
        encode(str(indir / f"f{i}.png"),
               np.random.default_rng(60 + i).integers(0, 256, (16, 24, 4), np.uint8))
    cfg = tmp_path / "g.rf"
    cfg.write_text(FLAGSHIP_CONFIG)
    common = ["--config", str(cfg), "--shader-path", str(tmp_path), "--backend", "cpu"]
    outs = {}
    for flags in ([], ["--shard", "1"]):
        out = tmp_path / f"out{len(flags)}"
        assert main(["-i", str(indir), "-o", str(out)] + common + flags) == 0
        outs[len(flags)] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert len(outs[0]) == 3 and outs[0] == outs[2]
    assert main(["-i", str(indir), "-o", str(tmp_path / "out3")] + common + ["--shard", "2"]) == 1
    assert "requested 2 devices, have 1" in capsys.readouterr().err
    assert not (tmp_path / "out3").exists()
