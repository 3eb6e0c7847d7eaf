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
