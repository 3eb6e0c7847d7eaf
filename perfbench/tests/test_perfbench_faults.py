"""The comparison fails what it must: the control (the program's own
bfloat16 storage, rgba16f, in the place of the configuration's rgba32f)
and a run with the timed path broken underneath.  Each drives the rest of
a run through the harness on the CPU at a small size."""

import pytest
import torch

from perfbench import harness
from reforge_tpu_torch.engine import Engine
from reforge_tpu_torch.graph import GraphProgram

SIZE = (72, 128)
FAST = {"warmup": 2, "hold": 4, "preview_px": 32}
SEQ = ["flagship_4k.seq", "glsl_chain_4k.seq"]
LIVE = ["glsl_chain_4k.live", "flagship_4k.live"]


def _run(cell, fmt=None, seed=2**31 + 5):
    return harness.run_cell(cell, seed, 0.2, False, device="cpu", size=SIZE,
                            mix_overrides=FAST, fmt=fmt)


@pytest.mark.parametrize("cell", SEQ + LIVE)
def test_the_control_is_not_correct(cell):
    line = _run(cell, fmt="rgba16f")
    assert not line["correct"]
    assert line["checks"]["frame_err"]["value"] > line["checks"]["frame_err"]["limit"]


@pytest.mark.parametrize("cell", SEQ + LIVE)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(GraphProgram, "_forward",
                        lambda self, x, t: x.to(self.storage_dtype).clone())
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SEQ)
def test_half_of_a_chunk_left_out(cell, monkeypatch):
    real = GraphProgram.render_sequence

    def half(self, x, t0, dt, n, stack=False):
        frames = real(self, x, t0, dt, n // 2, stack=True)
        return torch.cat([frames, torch.zeros_like(frames[: n - n // 2])])

    monkeypatch.setattr(GraphProgram, "render_sequence", half)
    line = _run(cell)
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("cell", LIVE)
def test_half_of_the_frames_left_out(cell, monkeypatch):
    real = Engine.render_frame
    calls = []

    def every_other(self, t=None):
        calls.append(1)
        out = real(self, t)
        return out if len(calls) % 2 else torch.zeros_like(out)

    monkeypatch.setattr(Engine, "render_frame", every_other)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", SEQ + LIVE)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    real = GraphProgram._forward

    def altered(self, x, t):
        out = real(self, x, t).clone()
        out[1, 7, 9] += 0.01
        return out

    monkeypatch.setattr(GraphProgram, "_forward", altered)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["frame_err"]["value"] == pytest.approx(0.01, rel=1e-3)


@pytest.mark.parametrize("cell", LIVE)
def test_a_preview_code_altered_where_it_is_produced(cell, monkeypatch):
    real = Engine.read_output_scaled

    def altered(self, out, target_px):
        preview = real(self, out, target_px).copy()
        preview[3, 5, 0] = (int(preview[3, 5, 0]) + 3) % 256
        return preview

    monkeypatch.setattr(Engine, "read_output_scaled", altered)
    line = _run(cell)
    assert not line["correct"]
    assert line["checks"]["frame_err"]["value"] <= line["checks"]["frame_err"]["limit"]
    assert line["checks"]["preview_err"]["value"] >= 2.0
