"""Each configuration's plain reference against the port's CPU path at a
small size, through the harness's own loops: the frames the timed path
renders, and the live loop's downsampled, encoded preview."""

import pytest
import torch

from perfbench import check, harness, refmath

SIZE = (72, 128)
FAST = {"warmup": 2, "hold": 3, "preview_px": 32}


def _engine(config, fmt="rgba32f"):
    from reforge_tpu_torch.engine import Engine, RenderInfo

    cfg = harness.load_config(config)
    d = harness.config_dir(config)
    return Engine(RenderInfo(width=SIZE[1], height=SIZE[0], device="cpu",
                             config_path=str(d / cfg["graph"]),
                             shader_path=str(d / cfg["shader_path"]), fmt=fmt,
                             has_input_image=True)), cfg


@pytest.mark.parametrize("config", ["flagship_4k", "glsl_chain_4k"])
def test_reference_against_the_port(config):
    engine, cfg = _engine(config)
    cfg["height"], cfg["width"] = SIZE
    u8 = harness.make_input(123, *SIZE, torch.device("cpu"))
    engine.load_input(u8.numpy())
    out = engine.render_frame_blocking()
    ref = harness.config_module(config, "reference").frame(u8, cfg)
    assert check.frame_err(out, ref) < 2e-6
    # The preview: the engine's box downsample by 4 and its sRGB encode.
    preview = engine.read_output_scaled(out, 32)
    codes = refmath.preview(ref, 32)
    assert preview.shape == (18, 32, 4) and codes.shape == (18, 32, 4)
    assert check.preview_err(preview, codes) < 1e-3
    assert (torch.as_tensor(preview).to(torch.int16) - codes.round().to(torch.int16)).abs().max() <= 1
    # The whole frame read back agrees too (read_output_scaled with no bound).
    assert check.preview_err(engine.read_output_scaled(out, None), refmath.preview(ref, None)) < 1e-3
    engine.close()


def test_reference_plans_the_tiers_the_cells_name():
    from reforge_tpu_torch.benchmarks import plan_steps

    flagship, _ = _engine("flagship_4k")
    glsl, _ = _engine("glsl_chain_4k")
    assert [t for t, _ in plan_steps(flagship.program)] == ["single"]
    assert [t for t, _ in plan_steps(glsl.program)] == ["mc"]
    flagship.close()
    glsl.close()


@pytest.mark.parametrize("cell", ["flagship_4k.seq", "glsl_chain_4k.seq",
                                  "glsl_chain_4k.live", "flagship_4k.live"])
def test_a_sound_run_is_correct(cell):
    line = harness.run_cell(cell, 2**31 + 77, 0.2, False, device="cpu", size=SIZE,
                            mix_overrides=FAST)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in harness.reported(
        harness.manifest(), cell, traced=False)}
