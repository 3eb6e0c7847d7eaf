"""tests/test_fuzz.py's generated shaders through the PyTorch port's op
lists, on the CPU (the rest of that file's counterpart is
tests/test_torch_fuzz.py).

Every expression shader of its grammar (``_gen_expr_shader``, seeds 0-149:
swizzles, compound assignment, per-pixel branches, static loops, user
functions, switches, mat2 math, and uint bit ops built on shifts) lowers
to an op list (glsl/lower.py) whose plain version is bit-equal to the
port's interpreter; the reference test's seeds also hold against the
sequential scalar reference, tests/scalar_ref.py.  Its data-dependent
loop shaders (``_loop_shader_src``) of halo 0 lower to loop regions whose
plain version holds against ``_loop_oracle`` within the reference test's
3e-5, bit-equal to the interpreter; those that store at a computed
coordinate (a gather) are refused, as the reference's mc planner refuses
them.
"""

import numpy as np
import pytest
import torch

from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.glsl import lower, translate_shader
from reforge_tpu_torch.kernels.base import KernelContext

import test_fuzz as ref

LOOP_HEADER = (
    "#version 450\n"
    "layout(local_size_x = 16, local_size_y = 16) in;\n"
    "layout(binding = 0, rgba32f) uniform readonly image2D input_image;\n"
    "layout(binding = 1, rgba32f) uniform writeonly image2D output_image;\n"
)


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    yield


def _planes(h: int, w: int):
    gy = torch.arange(h).view(-1, 1).expand(h, w)
    gx = torch.arange(w).view(1, -1).expand(h, w)
    return gy, gx


def _lowered(spec, h: int, w: int, base: np.ndarray):
    """(op list's plain output, interpreter's output) on ``base``."""
    prog = lower.lower_point(spec, spec.resolve_params({}), w, h)
    assert isinstance(prog, lower.PointProgram), prog
    img = torch.from_numpy(base)
    ctx = KernelContext(width=w, height=h, time=0.0, device="cpu")
    want = spec(ctx, {"input_image": img}, spec.resolve_params({}))["output_image"]
    gy, gx = _planes(h, w)
    return prog, lower.point_program_plain(prog, [img], gy, gx, 0.0), want


@pytest.mark.parametrize("seed", range(150))
def test_expr_shader_lowers_bit_equal(seed):
    """Each expression shader lowers, and its op list's plain version is
    bit-equal to the interpreter at the reference test's 9x11 (seeds
    300 + k of its inputs)."""
    src = ref._gen_expr_shader(seed)
    spec = translate_shader(src, f"exprfuzz{seed}")
    base = np.random.default_rng(300 + seed).random((4, 9, 11)).astype(np.float32)
    _prog, got, want = _lowered(spec, 9, 11, base)
    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=src)


@pytest.mark.parametrize("seed", range(16))
def test_expr_shader_against_scalar_ref(seed):
    """The reference test's seeds: the op list's plain version against the
    sequential scalar reference, within its 5e-4."""
    from scalar_ref import ScalarRef

    src = ref._gen_expr_shader(seed)
    spec = translate_shader(src, f"exprfuzz{seed}")
    base = np.random.default_rng(300 + seed).random((4, 9, 11)).astype(np.float32)
    _prog, got, _want = _lowered(spec, 9, 11, base)
    want = ScalarRef(src, {"input_image": base}).run()["output_image"]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, err_msg=src)


@pytest.mark.parametrize("seed", range(12))
def test_loop_shader_op_list_against_oracle(seed):
    """The loop shaders (seeds 9000 + k of the reference's draws, its
    10x12 inputs): a halo-0 one lowers to loop regions (its while, and the
    function's loop with a valued return) that hold against the lane-mask
    oracle within 3e-5 and are bit-equal to the interpreter; one that
    stores at a computed coordinate is refused as a gather."""
    p = ref._loop_case(seed)
    src = LOOP_HEADER + ref._loop_shader_src(p)
    spec = translate_shader(src, f"loopfuzz{seed}")
    h, w = 10, 12
    base = np.random.default_rng(100 + seed).random((4, h, w)).astype(np.float32)
    if p["use_scatter"] and not p["loop_in_fn"]:
        got = lower.lower_point(spec, spec.resolve_params({}), w, h)
        assert isinstance(got, str) and "gather" in got, got
        return
    prog, got, want = _lowered(spec, h, w, base)
    assert any(op == lower.K["LOOP"] for op, *_ in prog.ops)
    torch.testing.assert_close(got, want, rtol=0, atol=0, msg=str(p))
    np.testing.assert_allclose(got.numpy(), ref._loop_oracle(p, base), atol=3e-5,
                               err_msg=str(p))
