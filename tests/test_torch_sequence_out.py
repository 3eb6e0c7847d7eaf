"""Stacked sequences written in place (``GraphProgram.render_sequence`` with
``stack=True``), on the CPU: each frame's strip kernel writes its slice of
the one (n, 4, H, W) output, a frame whose final output comes from a
per-node step is copied there, and the stack is bit-equal to single-frame
renders on every tier.  The strip wrappers' ``out`` is checked as strictly
as their input."""

import numpy as np
import pytest
import torch

from reforge_tpu_torch import utils
from reforge_tpu_torch.benchmarks import (
    DEMO_CONFIG, FLAGSHIP_CONFIG, HASH_AFTER_BLUR_CONFIG, PORT_SHADER_DIR, build_program,
)
from reforge_tpu_torch.graph import program
from reforge_tpu_torch.kernels import cuda_ops

from test_torch_segments import BLOCKER_MID

# An odd H * W: a bf16 frame's slice starts only 8-byte aligned.
H, W = 15, 41
FORMATS = ("rgba32f", "rgba16f", "rgba8")
T0, DT, N = 0.25, 0.375, 3

# name -> (config, shader path, tier, the key each frame is counted under).
# wave reads the frame time and is a gather, so it runs per node.
CASES = {
    "single": (FLAGSHIP_CONFIG, None, "single", "in_place"),
    "mc_builtins": (DEMO_CONFIG, None, "mc", "in_place"),
    "mc_glsl": (HASH_AFTER_BLUR_CONFIG, PORT_SHADER_DIR, "mc", "in_place"),
    "segments_to_segment": (BLOCKER_MID, None, "segments", "in_place"),
    "segments_to_node": ("input -> gs -> edge -> wv -> output\ngs: gaussian { sigma: 2.0 }\n"
                         "edge: sobel {}\nwv: wave { amplitude: 3.0 }\n",
                         None, "segments", "copied"),
    "per_node": ("input -> wv -> output\nwv: wave { amplitude: 3.0 }\n", None, "per-node",
                 "copied"),
}


@pytest.fixture(autouse=True)
def _quiet_and_counted(monkeypatch):
    utils.print_warnings = False
    monkeypatch.setattr(program, "SEQUENCE_FRAMES", {"in_place": 0, "copied": 0})
    yield


def _input(seed=3):
    return torch.from_numpy(np.random.default_rng(seed).random((4, H, W), dtype=np.float32))


def _program(name, fmt):
    config, shader_path, tier, _key = CASES[name]
    prog = build_program(config, W, H, fmt, device="cpu", shader_path=shader_path)
    assert prog.tier == tier
    return prog


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_a_stacked_sequence_is_its_single_frames(name, fmt):
    prog = _program(name, fmt)
    x = _input()
    got = prog.render_sequence(x, T0, DT, N, stack=True)
    key = CASES[name][3]
    assert program.SEQUENCE_FRAMES == {"in_place": 0, "copied": 0, key: N}
    want = torch.stack([prog._forward(x, T0 + i * DT) for i in range(N)])
    assert got.dtype == prog.storage_dtype and got.shape == (N, 4, H, W)
    assert torch.equal(got, want)
    # the last frame alone, unstacked, is the stack's last frame, and
    # render_frame's path counts nothing
    assert torch.equal(prog.render_sequence(x, T0, DT, N), got[-1])
    assert sum(program.SEQUENCE_FRAMES.values()) == N


def test_frames_see_their_own_time():
    prog = _program("mc_glsl", "rgba32f")
    got = prog.render_sequence(_input(), T0, DT, 2, stack=True)
    assert not torch.equal(got[0], got[1])


def test_a_slice_the_kernels_cannot_take_is_copied(monkeypatch):
    """``out_aligned`` decides from the slice alone; a refused slice takes
    the copied path, with the same frames."""
    prog = _program("single", "rgba16f")
    x = _input()
    want = prog.render_sequence(x, T0, DT, N, stack=True)
    assert program.SEQUENCE_FRAMES == {"in_place": N, "copied": 0}
    monkeypatch.setattr(cuda_ops, "out_aligned", lambda out: False)
    got = prog.render_sequence(x, T0, DT, N, stack=True)
    assert program.SEQUENCE_FRAMES == {"in_place": N, "copied": N}
    assert torch.equal(got, want)


def _misaligned(shape, dtype):
    """A contiguous tensor one byte past an element boundary."""
    n = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    buf = bytearray(n * size + size)
    return torch.frombuffer(buf, dtype=dtype, offset=1, count=n).view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_aligned(dtype):
    stack = torch.empty((4, 4, H, W), dtype=dtype)
    assert all(cuda_ops.out_aligned(stack[i]) for i in range(4))
    assert stack[1].data_ptr() % 16 != 0 or dtype == torch.float32
    assert not cuda_ops.out_aligned(_misaligned((4, H, W), dtype))


@pytest.fixture(scope="module")
def strip_calls():
    """The two wrappers as (x, out) -> frame, on the flagship's single plan
    and the demo's mc plan in rgba32f."""
    utils.print_warnings = False
    single = build_program(FLAGSHIP_CONFIG, W, H, device="cpu")
    mc = build_program(DEMO_CONFIG, W, H, device="cpu")
    strip = single._strip_program_for("cpu", 0, H)
    return {
        "graph_strip": lambda x, out: cuda_ops.graph_strip(x, 0.5, strip, out=out),
        "graph_strip_mc": lambda x, out: cuda_ops.graph_strip_mc(x, 0.5, mc._strip_plan[1],
                                                                 out=out),
    }


def _wrong_out(kind, x):
    """(input, out) with ``out`` wrong in one way."""
    if kind == "dtype":
        return x, torch.empty_like(x, dtype=torch.bfloat16)
    if kind == "shape":
        return x, torch.empty((4, H, W + 1))
    if kind == "device":
        return x, torch.empty_like(x, device="meta")
    if kind == "non_contiguous":
        return x, torch.empty((4, W, H)).transpose(1, 2)
    if kind == "overlapping":  # one row apart in one buffer
        base = torch.cat([x.flatten(), torch.zeros(W)])
        return base[:x.numel()].view(x.shape), base[W:].view(x.shape)
    return x, _misaligned(tuple(x.shape), x.dtype)


# What each wrong out is refused for.
REFUSALS = {"dtype": "has dtype", "shape": "has shape", "device": "is on meta",
            "non_contiguous": "must be contiguous", "overlapping": "overlaps the input",
            "misaligned": "not aligned"}


@pytest.mark.parametrize("kind", list(REFUSALS))
@pytest.mark.parametrize("wrapper", ["graph_strip", "graph_strip_mc"])
def test_the_wrappers_refuse_a_wrong_out(wrapper, kind, strip_calls):
    x = _input()
    call = strip_calls[wrapper]
    out = torch.empty_like(x)
    assert call(x, out) is out and torch.equal(out, call(x, None))
    xin, wrong = _wrong_out(kind, x)
    with pytest.raises((TypeError, ValueError), match=f"^{wrapper}: .*{REFUSALS[kind]}"):
        call(xin, wrong)
