"""``.py`` kernel files in the PyTorch port (the reference's
``tests/test_engine.py:75-140`` and ``tests/test_ssbo.py:274-294``), on the
CPU.  Each kernel file is written twice, in jnp for the JAX package and in
torch for the port, to the reference's contract: ``@kernel`` from the
package's ``kernels``, f32 ``(4, H, W)`` images in, a tensor or a dict out.
The same config renders through both engines on the same linear input.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu import utils as jutils
from reforge_tpu.cli import main as jmain
from reforge_tpu.engine import Engine as JEngine
from reforge_tpu.engine import RenderInfo as JRenderInfo
from reforge_tpu_torch import utils
from reforge_tpu_torch.benchmarks import LUT1D_CONFIG, REPO_DIR
from reforge_tpu_torch.engine import Engine, RenderInfo
from reforge_tpu_torch.io import encode
from reforge_tpu_torch.kernels import KernelContext, builtin_kernels, kernel, loader

from test_torch_cli import _read
from test_torch_reload import bump

H, W = 16, 24
# The array module of each kernel body in the JAX package's terms and the
# port's, and its import.
NP = {"reforge_tpu": "jnp", "reforge_tpu_torch": "torch"}
IMPORT = {"reforge_tpu": "import jax.numpy as jnp", "reforge_tpu_torch": "import torch"}
DOUBLER = (
    "{imp}\n"
    "from {package}.kernels import kernel\n"
    "@kernel('doubler', register=False)\n"
    "def doubler(ctx, input_image, *, gain={gain}):\n"
    "    return {np}.sqrt(input_image) * gain\n"
)
HALF = (
    "from {package}.kernels import kernel\n"
    "@kernel('half', register=False)\n"
    "def half(ctx, input_image):\n"
    "    return input_image * 0.5\n"
)
# A buffer producer for lut1d's Curve (the reference's .py form of the
# port's gamma_curve.comp), with no image binding.
CURVE = (
    "{imp}\n"
    "from {package}.kernels import kernel\n"
    "@kernel('gamma_curve', images_in=(), images_out=(), ssbos_out=('Curve',),\n"
    "        ssbo_sizes={{'Curve': 256}}, register=False)\n"
    "def gamma_curve(ctx, *, gamma=0.6):\n"
    "    x = {np}.arange(256{dev}, dtype={np}.float32) / 255.0\n"
    "    return {{'Curve': x ** gamma}}\n"
)


@pytest.fixture(autouse=True)
def _quiet():
    utils.print_warnings = False
    jutils.print_warnings = False
    yield


def _write_both(tmp_path, stem, template, **fmt):
    """``template`` as ``<stem>.py`` in a directory for each package: (the
    port's path, the JAX package's path)."""
    paths = []
    for package in ("reforge_tpu_torch", "reforge_tpu"):
        d = tmp_path / package
        d.mkdir(exist_ok=True)
        path = d / f"{stem}.py"
        dev = ", device=ctx.device" if package == "reforge_tpu_torch" else ""
        path.write_text(template.format(package=package, np=NP[package], imp=IMPORT[package],
                                        dev=dev, **fmt))
        paths.append(path)
    return tuple(paths)


def _engines(tmp_path, config_text, **kw):
    """The port's Engine and the JAX Engine on ``config_text``, each with
    its own package's kernel directory, the JAX one fed the port's decoded
    input (the two decodes differ by an ulp of pow)."""
    engines = []
    for package, make, info in (("reforge_tpu_torch", Engine, lambda **a: RenderInfo(W, H, "cpu", **a)),
                                ("reforge_tpu", JEngine, lambda **a: JRenderInfo(W, H, **a))):
        d = tmp_path / package
        d.mkdir(exist_ok=True)
        cfg = d / "graph.rf"
        cfg.write_text(config_text)
        engines.append(make(info(config_path=str(cfg), shader_path=str(d), has_input_image=True,
                                 **kw)))
    port, jax_engine = engines
    port.load_input(np.random.default_rng(0).integers(0, 256, (H, W, 4), dtype=np.uint8))
    jax_engine._input_planar = jnp.asarray(port._input_planar.numpy())
    return port, jax_engine


def _frames(port, jax_engine):
    got = port.render_frame_blocking(0.0).numpy()
    want = np.asarray(jax_engine.render_frame_blocking(0.0))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    return got


def test_py_kernel_file_and_reload(tmp_path):
    """A .py kernel renders, and an edit of its file rebuilds with the new
    code, in both packages alike."""
    tpath, jpath = _write_both(tmp_path, "doubler", DOUBLER, gain=2.0)
    port, jax_engine = _engines(tmp_path, "input -> doubler -> output")
    inp = port._input_planar.numpy()
    np.testing.assert_allclose(_frames(port, jax_engine), np.sqrt(inp) * 2.0, atol=1e-6)
    assert port.program.graph.nodes["doubler"].spec.source_path == str(tpath)
    for path, package in ((tpath, "reforge_tpu_torch"), (jpath, "reforge_tpu")):
        bump(path, DOUBLER.format(package=package, np=NP[package], imp=IMPORT[package], gain=3.0))
    assert port.trigger_reloads() is True and jax_engine.trigger_reloads() is True
    np.testing.assert_allclose(_frames(port, jax_engine), np.sqrt(inp) * 3.0, atol=1e-6)
    port.close()


def test_broken_kernel_edit_keeps_last_good(tmp_path):
    tpath, _ = _write_both(tmp_path, "half", HALF)
    port, jax_engine = _engines(tmp_path, "input -> half -> output")
    before = _frames(port, jax_engine)
    utils.clear_warnings()
    bump(tpath, "this is not python !!!")
    assert port.trigger_reloads() is False
    warnings = utils.recent_warnings()
    assert any(f"Error loading kernel module {tpath}" in w and "SyntaxError" in w
               for w in warnings), warnings
    np.testing.assert_array_equal(port.render_frame_blocking(0.0).numpy(), before)
    bump(tpath, HALF.format(package="reforge_tpu_torch"))
    assert port.trigger_reloads() is True
    np.testing.assert_array_equal(port.render_frame_blocking(0.0).numpy(), before)
    port.close()


def test_single_shader_mode(tmp_path):
    """``Engine(shader_file_path=...)`` with a .py file, as the JAX Engine
    runs it."""
    tpath, jpath = _write_both(tmp_path, "half", HALF)
    port = Engine(RenderInfo(W, H, "cpu", shader_file_path=str(tpath), has_input_image=True))
    port.load_input(np.random.default_rng(1).integers(0, 256, (H, W, 4), dtype=np.uint8))
    jax_engine = JEngine(JRenderInfo(W, H, shader_file_path=str(jpath), has_input_image=True))
    jax_engine._input_planar = jnp.asarray(port._input_planar.numpy())
    np.testing.assert_allclose(_frames(port, jax_engine), port._input_planar.numpy() * 0.5,
                               atol=1e-6)


def test_single_shader_mode_through_python_m(tmp_path):
    """``python -m reforge_tpu_torch half.py -i in.png -o out.png --backend
    cpu`` against the JAX package's CLI on the same PNG, within one code."""
    tpath, jpath = _write_both(tmp_path, "half", HALF)
    rgba = np.random.default_rng(2).integers(0, 256, (H, W, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    encode(str(tmp_path / "in.png"), rgba)
    outs = [tmp_path / "port.png", tmp_path / "jax.png"]
    env = dict(os.environ, PYTHONPATH=str(REPO_DIR))
    proc = subprocess.run([sys.executable, "-m", "reforge_tpu_torch", str(tpath), "-i",
                           str(tmp_path / "in.png"), "-o", str(outs[0]), "--backend", "cpu"],
                          capture_output=True, text=True, env=env, timeout=300, cwd=REPO_DIR)
    assert proc.returncode == 0, proc.stderr
    assert jmain([str(jpath), "-i", str(tmp_path / "in.png"), "-o", str(outs[1]),
                  "--backend", "cpu"]) == 0
    got, want = _read(outs[0]).astype(int), _read(outs[1]).astype(int)
    assert got.shape == (H, W, 4) and np.abs(got - want).max() <= 1


def test_register_false_leaves_the_registry_alone(tmp_path):
    """A reference-style ``@kernel(..., register=False)`` file loads and the
    builtin registry stays as it was; the default registers."""
    before = builtin_kernels()
    tpath, _ = _write_both(tmp_path, "half", HALF)
    spec = loader.load_kernel_file(str(tpath))
    assert spec is not None and spec.name == "half" and builtin_kernels() == before

    @kernel("rf_test_registered")
    def registered(ctx, input_image):
        return input_image

    try:
        assert builtin_kernels()["rf_test_registered"] is registered
    finally:
        from reforge_tpu_torch.kernels import base

        del base._REGISTRY["rf_test_registered"]
    assert builtin_kernels() == before


def test_python_ssbo_kernel():
    """``ssbos_out`` declares a buffer output (reference:
    tests/test_ssbo.py::test_python_ssbo_kernel), against the jnp kernel."""
    from reforge_tpu.kernels import KernelContext as JKernelContext
    from reforge_tpu.kernels import kernel as jkernel

    def decl(deco):
        return deco("rowsum", images_in=("input_image",), images_out=(), ssbos_out=("sums",),
                    ssbo_sizes={"sums": 64}, register=False)

    @decl(kernel)
    def rowsum(ctx, input_image):
        s = torch.sum(input_image[0], dim=1)
        out = torch.zeros((64,), dtype=torch.float32)
        out[: s.shape[0]] = s
        return {"sums": out}

    @decl(jkernel)
    def jrowsum(ctx, input_image):
        s = jnp.sum(input_image[0], axis=1)
        return {"sums": jnp.zeros((64,), jnp.float32).at[: s.shape[0]].set(s)}

    assert rowsum.ssbos_out == ("sums",) and rowsum.outputs_all == ("sums",)
    img = np.random.default_rng(3).random((4, 16, 8), dtype=np.float32)
    got = rowsum(KernelContext(width=8, height=16, device="cpu"),
                 {"input_image": torch.from_numpy(img)}, {})["sums"]
    want = jrowsum(JKernelContext(width=8, height=16), {"input_image": jnp.asarray(img)}, {})["sums"]
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy()[:16], img[0].sum(axis=1), atol=1e-5)


def test_py_buffer_producer_through_the_engine(tmp_path):
    """A .py kernel whose only output is a storage buffer (lut1d's Curve)
    renders through both engines alike."""
    _write_both(tmp_path, "gamma_curve", CURVE)
    port, jax_engine = _engines(tmp_path, LUT1D_CONFIG)
    assert port.program.graph.resource_kinds["curve:Curve"] == "buffer"
    _frames(port, jax_engine)
