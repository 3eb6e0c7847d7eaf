"""The single tier's op list on the CPU: value slots numbered by liveness
(``GraphProgram._strip_slots``) fit graph_strip's fixed slot count and
give the same output, bit for bit, as a fresh slot per node; graphs past
the kernel's compiled plan count take another tier when planned, never a
failure at launch; and the conv kernels' tile footprint.
"""

import dataclasses

import numpy as np
import pytest
import torch

from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.benchmarks import (
    CW_CHECK_CONFIG, FLAGSHIP_CONFIG, PLAN_LIMIT_CONFIG, build_program, plan_steps,
)
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels.base import builtin_kernels

FORMATS = ("rgba32f", "rgba16f", "rgba8")
H, W = 24, 40
T = 0.37


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    yield


def _pointwise_builtins():
    """Every channel-local pointwise builtin of the registry (a cw_op and
    a channel form, halo 0)."""
    out = []
    for name, spec in sorted(builtin_kernels().items()):
        defaults = {k: d.default for k, d in spec.params.items()}
        if spec.cw_op is not None and spec.cw_fn is not None and spec.halo_for(defaults) == 0:
            out.append((name, len(spec.images_in)))
    return out


def _after_conv(name: str, n_in: int) -> str:
    """``name`` after a gaussian of the input, its second image the input."""
    second = "input -> n:input_image2\n" if n_in == 2 else ""
    return (f"input -> soft -> n -> output\n{second}soft: gaussian {{ sigma: 1.5 }}\n"
            f"n: {name} {{ }}\n")


# Three convs of the input: the compiled plan count (cuda_ops.MAX_PLANS).
THREE_CONVS = PLAN_LIMIT_CONFIG
FOUR_CONVS = THREE_CONVS.replace("m2 -> tone", "m2 -> m3 -> tone") + (
    "input -> d -> m3:input_image2\nd: gaussian { sigma: 3.0 }\nm3: mix { factor: 0.6 }\n")

GRAPHS = {"flagship": FLAGSHIP_CONFIG, "cw_check": CW_CHECK_CONFIG, "three_convs": THREE_CONVS,
          **{f"after_conv_{n}": _after_conv(n, k) for n, k in _pointwise_builtins()}}


def _image(fmt, seed=3):
    x = np.random.default_rng(seed).uniform(-0.05, 1.05, (4, H, W)).astype(np.float32)
    x = torch.from_numpy(x)
    return x.to(torch.bfloat16) if fmt == "rgba16f" else x


def _fresh(strip: cuda_ops.StripProgram) -> cuda_ops.StripProgram:
    """The same op list with a fresh slot for every node (the numbering
    before liveness): slot 0 the input, 1 + k conv k, then one a node."""
    n_plans = len(strip.plans)
    cur = {s: s for s in range(1 + n_plans)}
    ops, nxt = [], 1 + n_plans
    for op in strip.ops:
        ins = tuple(cur[s] for s in op.ins)
        cur[op.out] = nxt
        ops.append(dataclasses.replace(op, ins=ins, out=nxt))
        nxt += 1
    return cuda_ops.StripProgram(strip.plans, ops, cur[strip.out_slot], strip.fmt, strip.aux)


def test_every_channel_local_builtin_has_a_graph():
    names = {n for n, _ in _pointwise_builtins()}
    assert {"mix", "tonemap", "vignette", "levels", "invert", "difference"} <= names
    assert len(names) == 19


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_compacted_slots_fit_and_match_fresh_slots(graph, fmt, monkeypatch):
    prog = build_program(GRAPHS[graph], W, H, fmt, device="cpu")
    assert prog._strip_plan is not None and prog._strip_plan[0] == "single"
    strip = prog._build_strip_program()
    slots = [strip.out_slot] + [s for op in strip.ops for s in (*op.ins, op.out)]
    assert max(slots) < cuda_ops.MAX_SLOTS
    monkeypatch.setattr(cuda_ops, "MAX_SLOTS", 64)
    fresh = _fresh(strip)
    x = _image(fmt)
    got = cuda_ops.graph_strip_plain(x, T, strip)
    want = cuda_ops.graph_strip_plain(x, T, fresh)
    assert got.dtype == want.dtype
    assert torch.equal(got.float().view(torch.int32), want.float().view(torch.int32))


def test_flagship_reuses_slots():
    """The flagship's five ops fit three slots: the conv epilogues and the
    nodes after them write slots that held values read before."""
    strip = build_program(FLAGSHIP_CONFIG, W, H, device="cpu")._build_strip_program()
    written = set(range(1 + len(strip.plans)))
    reused = 0
    for op in strip.ops:
        reused += op.out in written
        written.add(op.out)
    assert reused >= 3
    assert max(op.out for op in strip.ops) == 1 and len(strip.ops) == 5


def test_three_convs_take_the_single_tier_at_the_compiled_limit():
    prog = build_program(THREE_CONVS, W, H, device="cpu")
    strip = prog._build_strip_program()
    assert len(strip.plans) == cuda_ops.MAX_PLANS == 3
    x = _image("rgba32f", seed=5)
    got = prog._forward(x, T)
    want = prog._forward_nostrip(x, T)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("fmt", FORMATS)
def test_more_convs_than_the_kernel_takes_plan_another_tier(fmt):
    """Four convs of the input: the single planner refuses them (no
    failure at launch) and the mc tier takes the graph, which runs on the
    CPU and matches per node within the tier's bound."""
    prog = build_program(FOUR_CONVS, W, H, fmt, device="cpu")
    assert prog._plan_strip_single() is None
    assert prog._strip_plan is not None and prog._strip_plan[0] == "mc"
    x = _image(fmt, seed=6)
    got, want = prog._forward(x, T).float(), prog._forward_nostrip(x, T).float()
    bound = {"rgba32f": 1e-5, "rgba16f": 2e-2, "rgba8": 2 / 255 + 1e-6}[fmt]
    assert float((got - want).abs().max()) <= bound


def test_more_ops_than_the_kernel_takes_plan_another_tier():
    """One conv and 32 pointwise nodes: 33 ops, past the op list the
    kernel's parameters hold, and the mc tier holds 24 stages; the segments
    tier runs the conv and the first 31 as one graph_strip, the last per
    node."""
    chain = " -> ".join(f"n{k}" for k in range(32))
    config = (f"input -> soft -> {chain} -> output\nsoft: gaussian {{ sigma: 1.0 }}\n"
              + "".join(f"n{k}: invert {{ }}\n" for k in range(32)))
    prog = build_program(config, W, H, device="cpu")
    assert cuda_ops.MAX_OPS == 32 and prog._plan_strip_single() is None
    assert prog._plan_strip_mc() is None
    assert plan_steps(prog) == [("seg single", ["soft"] + [f"n{k}" for k in range(31)]),
                                ("node", ["n31"])]
    x = _image("rgba32f", seed=7)
    assert torch.equal(prog._forward(x, T), prog._forward_nostrip(x, T))


def test_strip_program_refuses_past_the_compiled_limits():
    strip = build_program(THREE_CONVS, W, H, device="cpu")._build_strip_program()
    with pytest.raises(ValueError, match="convs"):
        cuda_ops.StripProgram(strip.plans * 2, strip.ops, strip.out_slot, strip.fmt)
    with pytest.raises(ValueError, match="ops"):
        cuda_ops.StripProgram(strip.plans, strip.ops * 7, strip.out_slot, strip.fmt)
    op = dataclasses.replace(strip.ops[0], out=cuda_ops.MAX_SLOTS)
    with pytest.raises(ValueError, match="slots"):
        cuda_ops.StripProgram(strip.plans, [op], op.out, strip.fmt)


@pytest.mark.parametrize("h, w, r, interior", [(2160, 3840, 12, True), (333, 520, 12, True),
                                                (37, 71, 1, False), (48, 68, 6, False),
                                                (2160, 3840, 108, False)])
def test_conv_tile_kinds(h, w, r, interior):
    """Interior (16-byte loads) blocks where the window lies in an image
    of rows 16-byte aligned (w a multiple of 8) and the layout is the
    aligned one; border blocks at its edges, and every block of radius
    108, whose window fits shared memory only packed."""
    th, tw, inner, border = cuda_ops.conv_tile_kinds(h, w, r, r, 2 * (2 * r + 1))
    assert inner + border == -(-h // th) * -(-w // tw)
    assert (inner > 0) == interior and border > 0


@pytest.mark.parametrize("r, align", [(12, 8), (96, 8), (104, 8), (105, 1), (108, 1)])
def test_conv_layout_packs_only_the_largest_windows(r, align):
    """The aligned window layout wherever it fits shared memory; the
    packed one keeps radius 108 (the largest the fused tiles held before
    the layout was aligned) on the fused kernels."""
    n_taps = 2 * (2 * r + 1)
    th, tw, nbytes = cuda_ops.pick_tile(r, r, n_taps)
    assert cuda_ops.conv_layout(th, tw, r, r, n_taps) == (align, nbytes)
    assert nbytes <= cuda_ops.SMEM_LIMIT
    assert cuda_ops.choose_tile(109, 109, 2 * 219) is None
