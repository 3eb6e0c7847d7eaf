"""The least work of both graphs at 4K against a count by hand."""

import pytest

from perfbench import harness

PIXELS = 3840 * 2160


def _work(config):
    return harness.config_module(config, "work").least_work(harness.load_config(config))


def test_flagship_4k():
    # soften: 25 taps a pass, two passes, four channels, an FMA (2) a tap: 400.
    # crisp: 13 taps, two passes, rgb: 156; x + 0.8 (x - b) on rgb: 9.
    # mixer: a + (b - a) f on four channels: 12.  tone: ACES on rgb, 11 each: 33.
    # vig: the fade 18 (nx, ny, d^2, sqrt, smoothstep, 1 - s x), rgb * fade 3.
    w = _work("flagship_4k")
    assert w["flops"] == PIXELS * (400 + 156 + 9 + 12 + 33 + 18 + 3) == PIXELS * 631
    assert w["bytes"] == PIXELS * 32 == 265_420_800
    # The least time on the H100 is the bytes': 0.0792 ms against 0.0781.
    assert w["bytes"] / 3.35e12 == pytest.approx(7.923e-5, rel=1e-3)
    assert w["flops"] / 67e12 == pytest.approx(7.812e-5, rel=1e-3)


def test_glsl_chain_4k():
    # gh and gv: 13 taps each on rgb, an FMA a tap: 156; tonemap.comp: 33.
    w = _work("glsl_chain_4k")
    assert w["flops"] == PIXELS * (2 * 13 * 2 * 3 + 33) == PIXELS * 189
    assert w["bytes"] == PIXELS * 32
