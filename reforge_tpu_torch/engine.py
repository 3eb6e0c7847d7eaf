"""Render engine: program construction, input upload, frame dispatch with
a bounded in-flight queue, one-shot renders, and live reload with
keep-last-good (the port of ``reforge_tpu/engine.py``; reference:
src/render.rs).

  * own the graph program and the input image           (render.rs:42-57)
  * frame lifecycle driven by the caller's loop          (render.rs:328-495)
  * live reload: poll the config and kernel-file mtimes, rebuild, keep the
    last good program on any failure                     (render.rs:497-519)
  * ``_rf_time`` changes every frame without a rebuild   (render.rs:212-223)
  * per-node and whole-frame timing readouts             (render.rs:521-523)

A rebuild is parse, kernel load (GLSL translation and reflection, or a
``.py`` module; a text loaded before keeps its spec), graph build, the
program's shape check on ``meta`` tensors (of the nodes whose signature is
new), strip planning with the GLSL affine probe (none for a graph built
before), and the first use's nvcc build of the kernels.  There is no
compile per program: the kernels are built once a process.  With
``async_compile`` all of it runs on a build thread while the old program
keeps rendering; the new program is adopted on a later poll, the last edit
winning.

``RenderInfo.shard`` row-shards each frame over that many devices with
halo exchange, ``pipeline_stages`` stages the graph's layers over devices
(parallel/): the program keeps its single-device form for per-node timing,
and ``program.sharded`` takes the frames.  A graph that cannot be sharded
as asked raises (at construction) or keeps the last good program (a
rebuild): nothing runs unsharded in its place.
"""

from __future__ import annotations

import dataclasses
import threading
import time as _time
from typing import Optional

import numpy as np
import torch

from . import trace, utils
from .config import FINAL_OUTPUT, Config, parse_file, single_shader_parse
from .graph import GraphProgram, build_graph, make_program
from .io import decode_image_to_planar, encode_planar_to_image
from .kernels import cuda_ops
from .parallel import HaloShardedProgram, PipelineStagedProgram, make_row_mesh
from .parallel.mesh import available_devices
from .utils import warnln

DEFAULT_CONFIG = "input -> passthrough -> output"
# One frame in GPU_TIME_EVERY is timed on the card for the "GPU:" readout:
# a pair of timing events costs the host some 15 us a frame (H100), an
# untimed event a few, and a status line needs no more.
GPU_TIME_EVERY = 8


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
    # Rebuild on a background thread while the old program keeps rendering.
    async_compile: bool = False
    # Single-frame headless render: skip strip planning and run per node
    # (with same-input conv bundles).
    one_shot: bool = False
    # Raise on a NaN in a frame's output (and in each node's output when
    # timed per node), naming the node (the CLI's --debug-nans).
    debug_nans: bool = False
    # Row-shard each frame across N devices with explicit halo exchange
    # (0: one device; 1: the one-slab sharded program).
    shard: int = 0
    # Stage graph layers across S devices (pipeline parallelism); --shard
    # is ignored when given.
    pipeline_stages: int = 0
    # The devices of the mesh or the stages, which may repeat one device
    # (default: every card, or the CPU with device "cpu").
    devices: Optional[tuple] = None


class Engine:
    def __init__(self, info: RenderInfo):
        self.device = torch.device(info.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RenderInfo(device='cuda') but no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {info.device!r}")
        self.info = info
        self.frame_index = 0
        # Frames dispatched by this engine; the frame spans' request number.
        self.frames_rendered = 0
        self.start_time = _time.perf_counter()
        self.last_gpu_times: dict[str, float] = {}
        self._inflight: list = []
        # Timing-event pairs of timed frames already waited on, for reuse:
        # a new pair costs the host more than re-recording one.
        self._spare_events: list = []
        self._input_planar: Optional[torch.Tensor] = None
        self._compile_lock = threading.Lock()
        self._pending: Optional[tuple] = None
        self._build_seq = 0
        self._pending_seq = 0
        self._build_threads: list[threading.Thread] = []
        self._resize_target: Optional[tuple[int, int]] = None

        with trace.build_span("build", **{"async": False}):
            config = self._create_config()
            if config is None:
                raise RuntimeError("Failed to parse initial pipeline configuration")
            program = self._build_program(config)
        if program is None:
            raise RuntimeError("Failed to build initial pipeline graph")
        self.config = config
        self.program = program

        self._last_config_mtime = (
            utils.get_modified_time(info.config_path) if info.config_path else 0
        )
        self._last_kernel_mtimes = self._kernel_mtimes()
        self._watcher = self._make_watcher()
        self._force_poll = False

    # ---- construction helpers ------------------------------------------

    def _create_config(self) -> Optional[Config]:
        """Config source priority: --config file, single-shader, default
        passthrough chain (reference: render.rs:100-118)."""
        with trace.build_span("build.config"):
            return self._parse_config()

    def _parse_config(self) -> Optional[Config]:
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
        """Graph build, shape check and strip planning (the kernels' first
        build included on the card), so that no frame plans."""
        with trace.build_span("build.graph") as sp:
            graph = build_graph(config)
            if graph is None:
                return None
            sp.attrs["nodes"] = len(graph.ordered_nodes)
        width, height = self._target_size()
        if self.device.type == "cuda":
            cuda_ops.load_library()
        info = self.info
        one_shot = info.one_shot and not info.shard and not info.pipeline_stages
        with trace.build_span("build.check") as sp:
            program = make_program(
                graph, width, height, info.fmt, plan_strips=not one_shot, device=self.device,
            )
            if program is None:
                return None
            sp.attrs.update(nodes_checked=program.nodes_checked, from_cache=program.from_cache)
        if one_shot:
            program._use_unfused = True
        else:
            program._strip_plan  # noqa: B018  (plans now, not in the first frame)
        if info.pipeline_stages or info.shard:
            with trace.build_span("build.shard"):
                self._shard(program)
        return program

    def _shard(self, program: GraphProgram) -> None:
        """The program's multi-device form, as ``info`` asks."""
        info = self.info
        devices = info.devices or available_devices(self.device.type)
        if info.pipeline_stages:
            if info.shard:
                warnln("--shard is ignored when --pipeline is given; running pipeline-staged only")
            # Stages balance on measured per-node times (a few frames at build).
            program.sharded = PipelineStagedProgram(
                program, devices=list(devices), n_stages=info.pipeline_stages, measure=True)
        elif info.shard:
            try:
                program.sharded = HaloShardedProgram(program, make_row_mesh(info.shard, devices))
            except ValueError as e:
                raise RuntimeError(f"Cannot shard graph: {e}") from e
            program.sharded.compile()  # each slab's planes and taps, before any frame

    def _kernel_mtimes(self) -> dict[str, int]:
        """mtimes of the file-backed kernels (reference: render.rs:225-249)."""
        return {gp.file_path: utils.get_modified_time(gp.file_path)
                for gp in self.config.graph_pipelines.values() if gp.file_path}

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

    # ---- live reload ----------------------------------------------------

    def trigger_reloads(self) -> bool:
        """Poll the config and kernel mtimes and rebuild as needed.

        Returns True when the program was swapped.  Any failure keeps the
        last good program (render.rs:121-136).  With ``async_compile`` the
        rebuild runs on a build thread and its program is adopted on a
        later poll; frames keep coming from the old one meanwhile."""
        with trace.span("poll", self.frames_rendered) as sp:
            swapped = self._poll()
            if sp is not None:
                sp.attrs["swapped"] = swapped
        return swapped

    def _poll(self) -> bool:
        swapped = self._adopt_pending()
        # The inotify watcher skips the mtime stats on quiet frames; the
        # mtime comparison stays the authority.  The first poll after a
        # swap compares mtimes whatever the watcher says: the swap made a
        # new watcher, and an edit racing it may have no event.
        if (
            self._watcher is not None
            and not self._force_poll
            and not self._watcher.poll()
        ):
            return swapped
        self._force_poll = False
        if self._config_changed():
            swapped = self._recreate_program() or swapped
        else:
            swapped = self._reload_changed_kernels() or swapped
        return swapped

    def _make_watcher(self):
        from .runtime.watcher import FileWatcher

        paths = list(self._last_kernel_mtimes)
        if self.info.config_path:
            paths.append(self.info.config_path)
        if not paths:
            return None
        watcher = FileWatcher(paths)
        return watcher if watcher.active else None

    def _adopt_pending(self) -> bool:
        with self._compile_lock:
            pending = self._pending
            self._pending = None
        if pending is None:
            return False
        self._swap(*pending)
        return True

    def _finish_build(self, config: Config) -> bool:
        """Build the program for ``config`` inline and swap it in, or start
        a build thread (``async_compile``) whose program a later poll
        adopts; a generation counter makes the last edit win."""
        if not self.info.async_compile:
            try:
                with trace.build_span("build", **{"async": False}):
                    program = self._build_program(config)
            except Exception as e:  # a kernel that cannot build: keep last good
                warnln(f"Rebuild failed: {e}")
                return False
            if program is None:
                return False
            self._swap(config, program)
            return True

        with self._compile_lock:
            self._build_seq += 1
            seq = self._build_seq

        def work():
            try:
                with trace.build_span("build", **{"async": True}):
                    if self.device.type == "cuda":
                        # Anything the build puts on the card goes to a stream
                        # of its own, never the render thread's.
                        stream = torch.cuda.Stream(self.device)
                        with torch.cuda.stream(stream):
                            program = self._build_program(config)
                        stream.synchronize()
                    else:
                        program = self._build_program(config)
            except Exception as e:  # any failure: keep last good
                warnln(f"Background rebuild failed: {e}")
                return
            if program is None:
                return  # warned already; keep last good
            with self._compile_lock:
                if seq >= self._pending_seq:
                    self._pending = (config, program)
                    self._pending_seq = seq

        thread = threading.Thread(target=work, daemon=True, name="rf-build")
        self._build_threads = [th for th in self._build_threads if th.is_alive()]
        self._build_threads.append(thread)
        thread.start()
        return False

    def wait_for_compiles(self) -> None:
        """Block until every background rebuild has finished, then adopt
        the result."""
        for th in list(self._build_threads):
            th.join()
        self._adopt_pending()

    def _config_changed(self) -> bool:
        path = self.info.config_path
        if path is None:
            return False
        current = utils.get_modified_time(path)
        if current == 0:
            if self._last_config_mtime != 0:
                warnln(f"Unable to access config file: {path}")
                self._last_config_mtime = 0
            return False
        if current == self._last_config_mtime:
            return False
        self._last_config_mtime = current
        return True

    def _reload_changed_kernels(self) -> bool:
        current = self._kernel_mtimes()
        changed = False
        for path, last in self._last_kernel_mtimes.items():
            now = current.get(path, 0)
            if now == 0:
                if last != 0:
                    warnln(f"Unable to access kernel file: {path}")
            elif now != last:
                changed = True
        self._last_kernel_mtimes = current
        if not changed:
            return False
        # Kernel sources are re-read by the graph build (an unchanged one
        # keeps its spec), so a kernel edit rebuilds the program with the
        # same config.
        return self._rebuild_keeping_config()

    def _recreate_program(self) -> bool:
        config = self._create_config()
        if config is None:
            return False
        return self._finish_build(config)

    def _rebuild_keeping_config(self) -> bool:
        return self._finish_build(self.config)

    def resize(self, width: int, height: int) -> bool:
        """Rebuild the graph at a new extent (a window resize, no input
        image).  With an input image the extent stays the image's (the
        preview scales instead; render.rs:529-532).  The old extent stays
        in force until the rebuilt program swaps in."""
        if self.info.has_input_image:
            return False
        if (width, height) == self._target_size():
            return False
        self._resize_target = (width, height)
        return self._rebuild_keeping_config()

    def _target_size(self) -> tuple[int, int]:
        return self._resize_target or (self.info.width, self.info.height)

    def _swap(self, config: Config, program: GraphProgram) -> None:
        self._drain()
        self.config = config
        self.program = program
        # A pending resize takes effect with the program built for it.
        self.info.width, self.info.height = program.width, program.height
        if self._resize_target == (program.width, program.height):
            self._resize_target = None
        self.frame_index = 0
        self.last_gpu_times = {}
        self._last_kernel_mtimes = self._kernel_mtimes()
        # The new graph may name other kernel files and directories.
        if self._watcher is not None:
            self._watcher.close()
        self._watcher = self._make_watcher()
        self._force_poll = True

    def close(self) -> None:
        """Join the build threads, wait for the frames still in flight and
        close the watcher."""
        for th in self._build_threads:
            th.join()
        self._drain()
        if self._watcher is not None:
            self._watcher.close()
            self._watcher = None

    # ---- frame execution ------------------------------------------------

    @property
    def time_since_start(self) -> float:
        return _time.perf_counter() - self.start_time

    def render_frame(self, t: Optional[float] = None) -> torch.Tensor:
        """Dispatch one frame; returns the (4, H, W) linear output.

        Launches are asynchronous on a GPU; at most ``num_frames`` frames
        are in flight, the oldest waited on through its CUDA event (the
        analog of wait_for_frame_fence, render.rs:328-337).
        ``last_gpu_times`` (the live loop's "GPU:") is then the device time
        of the last timed frame waited on (one in ``GPU_TIME_EVERY``); on
        the CPU, the call's host time; with ``timing="per-node"``, each
        node's host time after a synchronize."""
        if t is None:
            t = self.time_since_start
        with trace.span("render", self.frames_rendered):
            if self.info.timing == "per-node":
                out, times = self.program.run_per_node(self._file_input(), t,
                                                       check_nans=self.info.debug_nans)
                self.last_gpu_times = times
            elif self.device.type == "cuda":
                out = self._render_queued(t)
            else:  # synchronous: the host's time is the frame's
                start = _time.perf_counter()
                out = self._dispatch(t)
                self.last_gpu_times = {"graph": (_time.perf_counter() - start) * 1000.0}
        self.frames_rendered += 1
        self.frame_index = (self.frame_index + 1) % max(1, self.info.num_frames)
        return out

    def _dispatch(self, t: float) -> torch.Tensor:
        with trace.span("render.dispatch") as sp:
            sharded = self.program.sharded
            if sp is not None:
                sp.attrs["tier"] = "sharded" if sharded is not None else self.program.tier
            if sharded is not None:
                out = sharded(self._file_input(), t)
            else:
                out = self.program(self._file_input(), t)
        self.check_nans(out)
        return out

    def _render_queued(self, t: float) -> torch.Tensor:
        """Dispatch and queue the frame's ``done`` event (a timed frame: its
        launches between two timing events); with ``num_frames`` in flight,
        wait on the oldest."""
        begin = None
        if self.frames_rendered % GPU_TIME_EVERY == 0:
            if self._spare_events:
                begin, done = self._spare_events.pop()
            else:
                begin, done = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            begin.record()
        else:
            done = torch.cuda.Event()
        out = self._dispatch(t)
        done.record()
        self._inflight.append((begin, done))
        if len(self._inflight) >= max(1, self.info.num_frames):
            with trace.span("render.inflight_wait"):
                oldest = self._inflight.pop(0)
                oldest[1].synchronize()
            self._read_gpu_time([oldest])
        return out

    def _read_gpu_time(self, done_frames: list) -> None:
        """The "GPU:" readout from the newest timed frame of ``done_frames``
        (frames waited on already, so no wait of its own): its device time
        from its launches' first to its last.  Their timing pairs are kept
        for reuse."""
        timed = [(b, d) for b, d in done_frames if b is not None]
        if timed:
            self.last_gpu_times = {"graph": timed[-1][0].elapsed_time(timed[-1][1])}
            self._spare_events.extend(timed)

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
        self.check_nans(out)
        return encode_planar_to_image(out).cpu().numpy()

    def check_nans(self, out: torch.Tensor) -> None:
        """With ``debug_nans``, raise FloatingPointError if ``out`` (a
        frame's output) holds a NaN, naming the node that wrote it."""
        if self.info.debug_nans and bool(torch.isnan(out).any()):
            node = next((n.name for n in self.program.graph.ordered_nodes
                         if any(res == FINAL_OUTPUT for res, _ in n.outputs)), FINAL_OUTPUT)
            raise FloatingPointError(f"NaN in the frame's output, written by node '{node}'")

    def read_output(self, out: torch.Tensor) -> np.ndarray:
        """Device linear (4, H, W) -> host sRGB (H, W, 4) uint8 (render.rs:406-433)."""
        with trace.span("preview", self.frames_rendered - 1, step=1):
            return self._encode_and_read(out)

    def _encode_and_read(self, out: torch.Tensor) -> np.ndarray:
        with trace.span("preview.encode"):
            u8 = encode_planar_to_image(out)
        with trace.span("preview.readback") as sp:
            if sp is not None:
                sp.attrs["bytes"] = u8.nbytes
            return u8.cpu().numpy()

    def read_output_scaled(self, out: torch.Tensor, target_px: Optional[int]) -> np.ndarray:
        """``read_output`` box-downsampled on the device, so that only the
        preview-sized image crosses to the host: an integer step that keeps
        the longer edge at or above ``target_px`` (at most the short edge),
        averaged in linear light before the sRGB encode.  None, or a bound
        at or above the frame size, reads the full frame."""
        if target_px is None or target_px <= 0:
            return self.read_output(out)
        h, w = out.shape[1], out.shape[2]
        step = max(1, min(max(h, w) // int(target_px), min(h, w)))
        if step == 1:
            return self.read_output(out)
        with trace.span("preview", self.frames_rendered - 1, step=step):
            with trace.span("preview.downsample"):
                x = out.to(torch.float32)
                hc, wc = h // step, w // step
                cells = x[:, :hc * step, :wc * step].reshape(x.shape[0], hc, step, wc, step)
                small = cells.mean(dim=(2, 4))
            return self._encode_and_read(small)

    def gpu_times_str(self) -> str:
        return ", ".join(f"{k}: {v:.3f}ms" for k, v in self.last_gpu_times.items())

    def _drain(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self._read_gpu_time(self._inflight)
        self._inflight.clear()


def _read_file(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            contents = f.read()
        return contents if contents else None
    except OSError:
        return None
