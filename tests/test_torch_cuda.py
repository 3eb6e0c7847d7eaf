"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and skips without one.  This file imports nothing of
JAX, so it runs on a machine without it; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from reforge_tpu_torch.benchmarks import build_flagship
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.ops import gaussian_weights

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _image(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32)).cuda()


def _tol(w):
    # One FMA per tap in the kernel, a multiply then an add in the plain
    # version: the difference grows with the taps of both passes.
    return max(2e-6, 6e-8 * 2 * len(w))


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r", [1, 12, 96])
def test_conv_entry_points(r, mode):
    x = _image((4, 37, 71), r)
    w = gaussian_weights(r / 3.0)
    w1 = gaussian_weights(1 / 3.0)
    cases = {
        "sep_conv_fused": (x, [(w, w)], lambda: [cuda_ops.sep_conv_fused(x, w, w, mode)]),
        "sep_conv_fused_mxu": (
            x.to(torch.bfloat16), [(w, w)],
            lambda: [cuda_ops.sep_conv_fused_mxu(x.to(torch.bfloat16), w, w, mode)]),
        "sep_conv_fused_multi": (
            x, [(w, w), (w1, w)],
            lambda: cuda_ops.sep_conv_fused_multi(x, [(w, w), (w1, w)], mode)),
    }
    for name, (xin, plans, run) in cases.items():
        before = cuda_ops.LAUNCHES[name]
        got = run()
        want = cuda_ops.sep_conv_plain(xin, plans, mode)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES[name] == before + 1
        for g, wv in zip(got, want):
            assert float((g - wv).abs().max()) <= _tol(w), name


@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
def test_graph_strip(fmt):
    prog = build_flagship(71, 37, fmt, device="cuda")
    x = _image((4, 37, 71), 5).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip"]
    got = prog._forward(x, 0.5)
    want = cuda_ops.graph_strip_plain(x, 0.5, prog._strip_program)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip"] == before + 1
    # rgba16f: a one-ulp difference before a node's bf16 rounding can flip it.
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["edge", "zero"])
def test_stencil_apply(mode):
    from reforge_tpu_torch.kernels import library

    x = _image((4, 37, 71), 7)
    ops = [(1, cuda_ops.wsum(library.SHARPEN_TAPS)), (1, cuda_ops.wsum(library.EMBOSS_TAPS)),
           (1, cuda_ops.MEDIAN9),
           (2, cuda_ops.wsum(np.arange(25, dtype=np.float32).reshape(5, 5) - 7.0))]
    for r, op in ops:
        before = cuda_ops.LAUNCHES["stencil_apply"]
        got = cuda_ops.stencil_apply(x, r, r, op, mode)
        want = cuda_ops.stencil_apply_plain(x, r, r, op, mode)
        torch.cuda.synchronize()
        assert cuda_ops.LAUNCHES["stencil_apply"] == before + 1
        # every product and sum rounds as in the plain version: bit-equal
        assert torch.equal(got, want), (op.kind, r)


@pytest.mark.parametrize("r", [24, 66])
def test_sep_conv_fused_mxu_x3(r):
    x = _image((4, 37, 71), r)
    w = gaussian_weights(r / 3.0)
    before = cuda_ops.LAUNCHES["sep_conv_fused_mxu_x3"]
    got = cuda_ops.sep_conv_fused_mxu_x3(x, w, w, "zero" if r > 64 else "edge")
    want = cuda_ops.sep_conv_plain(x, [(w, w)], "zero" if r > 64 else "edge")[0]
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["sep_conv_fused_mxu_x3"] == before + 1
    assert float((got - want).abs().max()) <= _tol(w)


@pytest.mark.parametrize("hw", [(37, 71), (200, 300)])  # border blocks only; interior ones too
@pytest.mark.parametrize("fmt", ["rgba32f", "rgba16f"])
@pytest.mark.parametrize(
    "config", ["DEMO_CONFIG", "EDGES_CONFIG", "CHAIN3_CONFIG", "MIX_SECOND_FIRST_CONFIG"])
def test_graph_strip_mc(config, fmt, hw):
    from reforge_tpu_torch import benchmarks

    h, w = hw
    prog = benchmarks.build_program(getattr(benchmarks, config), w, h, fmt, device="cuda")
    assert prog._strip_plan[0] == "mc"
    x = _image((4, h, w), 9).to(prog.storage_dtype)
    before = cuda_ops.LAUNCHES["graph_strip_mc"]
    got = prog._forward(x, 0.5)
    want = cuda_ops.graph_strip_mc_plain(x, 0.5, prog._strip_plan[1])
    per_node = prog._forward_nostrip(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["graph_strip_mc"] == before + 1
    tol = 1e-5 if fmt == "rgba32f" else 2e-2
    assert float((got.float() - want.float()).abs().max()) <= tol
    # the mix wired second input first reads its base as in0 on the card too
    assert float((got.float() - per_node.float()).abs().max()) <= tol


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r,sigma_space", [(1, 2.0), (4, 2.5), (60, 8.0)])
def test_stencil_reduce_mc(r, sigma_space, mode):
    """Bilateral's reduction against its plain version; radius 60 fits no
    shared-memory tile and reads its taps from global memory.  Both sides
    call the same expf and round every product and sum alike: within a
    few f32 ulps of [0, 1] values."""
    from reforge_tpu_torch.kernels import library

    x = _image((4, 37, 71), 11)
    rr, op = library.bilateral_op(r, sigma_space, 0.12)
    assert (cuda_ops.choose_reduce_tile(r, r, len(op.taps)) is None) == (r == 60)
    before = cuda_ops.LAUNCHES["stencil_reduce_mc"]
    got = cuda_ops.stencil_reduce_mc(x, rr, rr, op, mode)
    want = cuda_ops.stencil_reduce_mc_plain(x, rr, rr, op, mode)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == before + 1
    assert float((got - want).abs().max()) <= 1e-6


def test_newsprint_4k_frame_against_plain_per_node(monkeypatch):
    """Newsprint's 4K frame through the kernel against the same graph with
    the kernel's plain version on the card."""
    from reforge_tpu_torch import benchmarks

    prog = benchmarks.build_program(benchmarks.NEWSPRINT_CONFIG, 3840, 2160, device="cuda")
    assert prog._strip_plan is None
    x = _image((4, 2160, 3840), 12)
    before = cuda_ops.LAUNCHES["stencil_reduce_mc"]
    got = prog._forward(x, 0.5)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["stencil_reduce_mc"] == before + 1
    monkeypatch.setattr(cuda_ops, "stencil_reduce_mc", cuda_ops.stencil_reduce_mc_plain)
    want = prog._forward(x, 0.5)
    # halftone's dots turn a few-ulp change of a cell's luma into at most
    # a few ulps of ink
    assert float((got - want).abs().max()) <= 1e-5
