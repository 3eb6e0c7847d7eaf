"""The reference's GLSL benchmark graphs (glsl-chain, glsl-sharpen) and
the examples whose shaders touch only images, through the PyTorch port's
Engine from the repository root against the JAX Engine's per-node path,
on the CPU, in rgba32f (the helpers and bounds of
``test_torch_glsl_graph.py``).  Most of the time here is the JAX side's
eager compiles of the examples' builtins.
"""

import numpy as np
import pytest

from reforge_tpu_torch.benchmarks import GLSL_EXAMPLES, GLSL_GRAPHS, REPO_DIR, example_config

from test_torch_glsl_graph import _check, _quiet_and_fresh_synthesis, _render_both, _u8  # noqa: F401


E4_E5 = ["glsl_chain", "glsl_sharpen"] + list(GLSL_EXAMPLES)
# Escape-time and ray-marched shaders: an ulp moves an iteration count or
# a hit, which flips a pixel (as tests/test_scalar_ref.py notes).
FLIPS = ("mandelzoom", "raymarch")


@pytest.mark.parametrize("graph", E4_E5)
def test_engine_renders_e4_and_examples_like_jax(graph, tmp_path, monkeypatch):
    """E4 (the reference's GLSL benchmark graphs) and the image-only
    examples in rgba32f, through Engine from the repository root, against
    the JAX Engine's per-node path; the escape-time ones as a share of
    pixels (at most 1% off by more than 1e-4)."""
    monkeypatch.chdir(REPO_DIR)
    path = tmp_path / f"{graph}.rf"
    path.write_text(GLSL_GRAPHS.get(graph) or example_config(graph))
    _engine, frame, _per_node, want = _render_both(str(path), "rgba32f", _u8(3))
    if graph in FLIPS:
        share = float(np.mean(np.abs(frame.astype(np.float64) - want) > 1e-4))
        assert share <= 0.01, share
    else:
        _check("rgba32f", frame, want, graph)
