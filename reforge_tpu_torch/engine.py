"""Render engine: program construction, input upload, frame dispatch with
a bounded in-flight queue, and one-shot renders (the port of
``reforge_tpu/engine.py``).

Live reload, resize, the preview downscale, sharding and pipelining are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import numpy as np
import torch

from .config import Config, parse_file, single_shader_parse
from .graph import GraphProgram, build_graph, make_program
from .io import decode_image_to_planar, encode_planar_to_image
from .utils import warnln

DEFAULT_CONFIG = "input -> passthrough -> output"


@dataclasses.dataclass
class RenderInfo:
    """Engine construction parameters (reference: RenderInfo, render.rs:30-40).

    ``device`` is where the program runs: ``"cuda"`` (the hand-written
    kernels; raises without a GPU) or ``"cpu"`` (their plain versions)."""

    width: int
    height: int
    device: str
    num_frames: int = 2
    config_path: Optional[str] = None
    shader_path: str = "shaders"
    fmt: str = "rgba32f"  # "rgba8" | "rgba16f" | "rgba32f"
    has_input_image: bool = False
    shader_file_path: Optional[str] = None
    timing: str = "fused"  # "fused" | "per-node"
    # Single-frame headless render: skip strip planning and run per node
    # (with same-input conv bundles).
    one_shot: bool = False


class Engine:
    def __init__(self, info: RenderInfo):
        self.device = torch.device(info.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RenderInfo(device='cuda') but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {info.device!r}")
        self.info = info
        self.start_time = _time.perf_counter()
        self.last_gpu_times: dict[str, float] = {}
        self._inflight: list = []
        self._input_planar: Optional[torch.Tensor] = None

        config = self._create_config()
        if config is None:
            raise RuntimeError("Failed to parse initial pipeline configuration")
        program = self._build_program(config)
        if program is None:
            raise RuntimeError("Failed to build initial pipeline graph")
        self.config = config
        self.program = program

    # ---- construction helpers ------------------------------------------

    def _create_config(self) -> Optional[Config]:
        """Config source priority: --config file, single-shader, default
        passthrough chain (reference: render.rs:100-118)."""
        info = self.info
        if info.config_path is not None:
            contents = _read_file(info.config_path)
            if contents is None:
                warnln("Empty configuration file")
                return None
            return parse_file(contents, info.has_input_image, info.shader_path)
        if info.shader_file_path is not None:
            return single_shader_parse(info.shader_file_path, info.has_input_image)
        return parse_file(DEFAULT_CONFIG, True, info.shader_path)

    def _build_program(self, config: Config) -> Optional[GraphProgram]:
        graph = build_graph(config)
        if graph is None:
            return None
        program = make_program(
            graph, self.info.width, self.info.height, self.info.fmt,
            plan_strips=not self.info.one_shot, device=self.device,
        )
        if program is not None and self.info.one_shot:
            program._use_unfused = True
        return program

    # ---- input ----------------------------------------------------------

    def load_input(self, rgba_u8: np.ndarray) -> None:
        """Upload the decoded sRGB image and linearize it on the device."""
        self._input_planar = self.decode_to_planar(rgba_u8)

    def decode_to_planar(self, rgba_u8: np.ndarray) -> torch.Tensor:
        return decode_image_to_planar(torch.from_numpy(np.ascontiguousarray(rgba_u8)).to(self.device))

    def _file_input(self) -> torch.Tensor:
        if self._input_planar is not None:
            return self._input_planar
        return torch.zeros(
            (4, self.info.height, self.info.width), dtype=torch.float32, device=self.device
        )

    # ---- frame execution ------------------------------------------------

    @property
    def time_since_start(self) -> float:
        return _time.perf_counter() - self.start_time

    def render_frame(self, t: Optional[float] = None) -> torch.Tensor:
        """Dispatch one frame; returns the (4, H, W) linear output.

        Launches are asynchronous on a GPU; at most ``num_frames`` frames
        are in flight, the oldest waited on through its CUDA event (the
        analog of wait_for_frame_fence, render.rs:328-337)."""
        if t is None:
            t = self.time_since_start
        if self.info.timing == "per-node":
            out, times = self.program.run_per_node(self._file_input(), t)
            self.last_gpu_times = times
        else:
            start = _time.perf_counter()
            out = self.program(self._file_input(), t)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                self._inflight.append(done)
                if len(self._inflight) >= max(1, self.info.num_frames):
                    self._inflight.pop(0).synchronize()
            self.last_gpu_times = {"graph": (_time.perf_counter() - start) * 1000.0}
        return out

    def render_frame_blocking(self, t: Optional[float] = None) -> torch.Tensor:
        out = self.render_frame(t)
        self._drain()
        return out

    def render_one_shot(self, rgba_u8: Optional[np.ndarray], t: Optional[float] = None) -> np.ndarray:
        """Render ONE frame: decode -> graph -> sRGB encode, from the host
        u8 image to the host u8 result."""
        if t is None:
            t = self.time_since_start
        if rgba_u8 is None:
            rgba_u8 = np.zeros((self.info.height, self.info.width, 4), np.uint8)
        planar = self.decode_to_planar(rgba_u8)
        out = self.program._forward(planar, t)
        return encode_planar_to_image(out).cpu().numpy()

    def read_output(self, out: torch.Tensor) -> np.ndarray:
        """Device linear (4, H, W) -> host sRGB (H, W, 4) uint8 (render.rs:406-433)."""
        return encode_planar_to_image(out).cpu().numpy()

    def close(self) -> None:
        """Wait for the frames still in flight."""
        self._drain()

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._inflight.clear()


def _read_file(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            contents = f.read()
        return contents if contents else None
    except OSError:
        return None
