"""The PyTorch port's Engine on the CPU, against the JAX package's Engine,
and the port's independence from JAX."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu.engine import Engine as JEngine
from reforge_tpu.io import srgb as jsrgb
from reforge_tpu.engine import RenderInfo as JRenderInfo
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import CHAIN3_CONFIG, DEMO_CONFIG, EDGES_CONFIG, FLAGSHIP_CONFIG
from reforge_tpu_torch.engine import Engine, RenderInfo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 48, 72


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    yield


@pytest.fixture
def flagship(tmp_path):
    """The flagship config and an empty shader path (the shipped
    shaders/tonemap.comp and vignette.comp would replace the builtins)."""
    cfg = tmp_path / "flagship.rf"
    cfg.write_text(FLAGSHIP_CONFIG)
    shaders = tmp_path / "shaders"
    shaders.mkdir()
    return str(cfg), str(shaders)


def _u8(seed=2):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 4), dtype=np.uint8)


def _info(flagship, fmt, one_shot, **kw):
    cfg, shaders = flagship
    return RenderInfo(W, H, "cpu", config_path=cfg, shader_path=shaders, fmt=fmt,
                      has_input_image=True, one_shot=one_shot, **kw)


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
def test_one_shot_matches_jax_engine(flagship, fmt):
    """u8 in, u8 out, through both engines: within one code value (the
    OETF's pow may differ by an ulp between torch and jnp, and rgba16f
    node outputs may round the other way where an ulp decides)."""
    cfg, shaders = flagship
    u8 = _u8()
    want = JEngine(JRenderInfo(W, H, config_path=cfg, shader_path=shaders, fmt=fmt,
                               has_input_image=True, one_shot=True)).render_one_shot(u8, 0.25)
    got = Engine(_info(flagship, fmt, True)).render_one_shot(u8, 0.25)
    assert got.dtype == np.uint8 and got.shape == (H, W, 4)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f", "rgba8"])
def test_engine_tiers_agree(flagship, fmt):
    u8 = _u8(3)
    one_shot = Engine(_info(flagship, fmt, True)).render_one_shot(u8, 0.5)
    engine = Engine(_info(flagship, fmt, False))
    assert engine.program._strip_plan is not None
    engine.load_input(u8)
    frame = engine.render_frame(0.5)
    assert set(engine.last_gpu_times) == {"graph"}
    blocking = engine.render_frame_blocking(0.5)
    seq = engine.program.render_sequence(engine._file_input(), 0.5, 0.01, 3, stack=True)
    assert tuple(seq.shape) == (3, 4, H, W)
    assert torch.equal(seq[0], frame) and torch.equal(blocking, frame)
    assert np.array_equal(engine.read_output(frame), one_shot)
    timed = Engine(_info(flagship, fmt, False, timing="per-node"))
    timed.load_input(u8)
    per_node = timed.render_frame(0.5)
    assert set(timed.last_gpu_times) == {"soften", "crisp", "mixer", "tone", "vig"}
    assert np.array_equal(timed.read_output(per_node), one_shot)
    engine.close()


MULTISTAGE = {"demo": DEMO_CONFIG, "edges": EDGES_CONFIG, "chain3": CHAIN3_CONFIG}


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize("graph", sorted(MULTISTAGE))
def test_multistage_graph_through_engine(tmp_path, graph, fmt):
    """The demo, edges and chain3 one-shot (u8 in and out) against the
    JAX package's per-node path between its own sRGB decode and encode,
    within one code as for the flagship; in rgba32f also against the JAX
    engine.  (In rgba16f the JAX engine's jitted program may keep f32
    precision past a bf16 store, which the demo's sharpen then amplifies:
    4 codes on a dark pixel, where the eager path and the port agree.)
    Then the port's mc tier (render_frame) against its own one-shot
    per-node render."""
    cfg = tmp_path / f"{graph}.rf"
    cfg.write_text(MULTISTAGE[graph])
    shaders = tmp_path / "shaders"
    shaders.mkdir()  # shaders/sharpen.comp, sobel.comp, blend.comp would replace builtins
    paths = (str(cfg), str(shaders))
    u8 = _u8(5)
    jengine = JEngine(JRenderInfo(W, H, config_path=paths[0], shader_path=paths[1], fmt=fmt,
                                  has_input_image=True, one_shot=True))
    linear = jengine.program._forward_nostrip(jsrgb.decode_image_to_planar(jnp.asarray(u8)),
                                              jnp.float32(0.25))
    want = [np.asarray(jsrgb.encode_planar_to_image(linear.astype(jnp.float32)))]
    if fmt == "rgba32f":
        want.append(jengine.render_one_shot(u8, 0.25))
    got = Engine(_info(paths, fmt, True)).render_one_shot(u8, 0.25)
    for ref in want:
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    engine = Engine(_info(paths, fmt, False))
    assert engine.program._strip_plan[0] == "mc"
    engine.load_input(u8)
    assert np.array_equal(engine.read_output(engine.render_frame(0.25)), got)


def test_default_config_is_passthrough():
    engine = Engine(RenderInfo(W, H, "cpu", has_input_image=True, shader_path="/nonexistent"))
    u8 = _u8(4)
    assert np.array_equal(engine.render_one_shot(u8), u8)


def test_cuda_engine_raises_without_a_gpu(flagship):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(RenderInfo(W, H, "cuda", config_path=flagship[0], shader_path=flagship[1],
                          has_input_image=True))


def test_port_imports_and_renders_without_jax():
    code = (
        "import json, sys\n"
        "from reforge_tpu_torch.benchmarks import (\n"
        "    DEMO_CONFIG, EDGES_CONFIG, FLAGSHIP_CONFIG, build_program, make_test_image)\n"
        "for config in (FLAGSHIP_CONFIG, DEMO_CONFIG, EDGES_CONFIG):\n"
        "    for fmt in ('rgba32f', 'rgba16f'):\n"
        "        for strips in (True, False):\n"
        "            build_program(config, 40, 24, fmt, device='cpu', plan_strips=strips)._forward(\n"
        "                make_test_image(24, 40, device='cpu'), 0.1)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'reforge_tpu'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
