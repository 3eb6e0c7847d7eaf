"""CLI and frame driver (the port of ``reforge_tpu/cli.py``).

Flag-compatible with the reference binary (reference: src/main.rs:43-71):
positional single-shader path, -i/--input-file, -o/--output-file,
--width/--height, --shader-format, --config, --shader-path, --num-frames,
plus the JAX package's extensions (--frames benchmark cap, --timing,
--preview backend, video and batch modes, --profile, --debug-nans).

The program runs on the card: ``--backend auto`` (the default) and
``cuda`` need a CUDA device and exit 1 without one; ``cpu`` runs every
kernel's plain PyTorch version on the host.  ``--shard N`` row-shards
each frame over N cards with halo exchange (``--shard 1``: the one-slab
sharded program), ``--pipeline S`` stages the graph over S cards (and
``--shard`` is then ignored), and batch mode with ``--shard N`` shares the
frames out over N cards (parallel/).  Asking for more cards than there are,
or a frame height that N does not divide, exits 1.

Headless mode (an --output-file given) runs one frame and encodes it
(main.rs:220-224); otherwise the live loop previews frames, polling config
and kernel files for live reload each frame and printing the
``Frame: Xms, Frame-Avg: Yms, GPU: {...}`` status line (main.rs:152-157).
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time
from typing import Optional

import torch

from . import utils
from .engine import Engine, RenderInfo
from .io import ImageFileDecoder, ImageFileError, encode
from .parallel import BatchProgram, make_batch_mesh
from .parallel.mesh import available_devices
from .utils import TERM_CLEAR, warnln


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="reforge-tpu-torch",
        description="Image-processing graph engine on PyTorch and CUDA",
    )
    p.add_argument(
        "positionals",
        nargs="*",
        default=[],
        metavar="<shader|input-file> [output-file]",
        help="Reference-style positionals (main.rs:45-48): an input image "
        "and optional output image; a kernel file (.comp/.frag/.glsl/.py) "
        "anywhere in the list runs single-shader mode instead of a config",
    )
    p.add_argument("-i", "--input-file", help="File to read from")
    p.add_argument("-o", "--output-file", help="Image file to write to (png/jpg)")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument(
        "--shader-format",
        choices=["rgba8", "rgba16f", "rgba32f"],
        default="rgba32f",
        help="Intermediate format: rgba8 quantizes between nodes, rgba16f stores bfloat16",
    )
    p.add_argument("--config", help="Path to the pipeline configuration file")
    p.add_argument(
        "--shader-path",
        default="shaders",
        help="Path to the kernel directory (.comp / .frag / .glsl files)",
    )
    p.add_argument(
        "--start",
        type=float,
        default=0.0,
        metavar="SEC",
        help="Video mode: seek to this timestamp before processing",
    )
    p.add_argument(
        "--duration",
        type=float,
        default=None,
        metavar="SEC",
        help="Video mode: stop after this many seconds of input",
    )
    p.add_argument(
        "--fps",
        type=float,
        default=None,
        metavar="FPS",
        help="Animated export (image/generator -> video): output frame "
        "rate (default 30); frame i renders with _rf_time = --start + "
        "i / fps",
    )
    p.add_argument(
        "--batch-frames",
        type=int,
        default=1,
        metavar="K",
        help="Video mode: run K frames back to back before handing them "
        "to the writer (frames identical to K=1)",
    )
    p.add_argument(
        "--num-frames",
        type=int,
        default=2,
        help="Frames in flight for the live loop",
    )
    p.add_argument(
        "--frames",
        type=int,
        default=0,
        help="Stop after N frames (0 = run until quit); useful for benchmarks",
    )
    p.add_argument(
        "--timing",
        choices=["fused", "per-node"],
        default="fused",
        help="per-node disables fusion to time each kernel like the reference's GPU timestamps",
    )
    p.add_argument(
        "--preview",
        choices=["auto", "window", "kitty", "none"],
        default="auto",
    )
    p.add_argument(
        "--shard",
        type=int,
        default=0,
        help="Row-shard the graph across N devices (0 = single device)",
    )
    p.add_argument(
        "--pipeline",
        type=int,
        default=0,
        metavar="S",
        help="Stage graph layers across S devices (pipeline parallelism)",
    )
    p.add_argument(
        "--backend",
        choices=["auto", "cuda", "cpu"],
        default="auto",
        help="Where the program runs: auto = cuda (exits 1 without a CUDA "
        "device); cpu runs the kernels' plain PyTorch versions",
    )
    p.add_argument(
        "--debug-nans",
        action="store_true",
        help="Abort with a traceback naming the node when a frame's output "
        "(each node's output under --timing per-node) holds a NaN",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="Write a torch.profiler trace of the run (CPU and CUDA "
        "activities, and the program's rf.* ranges) to DIR as a Chrome "
        "trace (view with Perfetto)",
    )
    return p


_KERNEL_EXTS = (".comp", ".frag", ".glsl", ".py")


def _assign_positionals(args) -> Optional[str]:
    """Reference-style positionals: ``reforge <input-file> [output-file]``
    (main.rs:45-48), extended so a kernel file anywhere in the list selects
    single-shader mode.  Returns an error message or None."""
    args.shader = None
    rest = []
    for a in args.positionals:
        if a.lower().endswith(_KERNEL_EXTS):
            if args.shader is not None:
                return f"Multiple kernel files given: {args.shader!r} and {a!r}"
            args.shader = a
        else:
            rest.append(a)
    if len(rest) > 2:
        return f"Too many positional arguments: {rest!r}"
    if rest:
        if args.input_file:
            return "Input file given both positionally and with -i"
        args.input_file = rest[0]
    if len(rest) == 2:
        if args.output_file:
            return "Output file given both positionally and with -o"
        args.output_file = rest[1]
    return None


def _device(args) -> Optional[str]:
    """The device of ``--backend``; None (after a diagnostic) when it
    names the card and there is none: the CLI never falls back to the
    CPU."""
    if args.backend == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        print(f"Error: --backend {args.backend} runs on a CUDA device, and none is "
              f"available (pass --backend cpu to run on the CPU)", file=sys.stderr)
        return None
    return "cuda"


def main(argv: Optional[list[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    err = _assign_positionals(args)
    if err is not None:
        warnln(err)
        return 1

    if args.config and args.shader:
        warnln("Cannot specify both a config and shader file")
        return 1

    device = _device(args)
    if device is None:
        return 1

    headless = args.output_file is not None
    num_frames = 1 if headless else args.num_frames
    from .io import is_video_path

    # Single-image headless render: one frame per node with same-input
    # conv bundles, then exit; strip planning pays off only across frames
    # (the reference renders its headless frame right after per-node
    # shader compiles, src/main.rs:220-224).
    # Sharded and pipelined renders keep the frame path: their executors
    # take the frames.
    one_shot = (headless and not is_video_path(args.output_file) and not args.shard
                and not args.pipeline)

    # Batch mode: a glob or directory input processes every matched image,
    # in turn on the one device or shared out over --shard N devices.
    if args.input_file:
        inputs = _expand_inputs(args.input_file)
        if len(inputs) > 1:
            if not args.output_file:
                warnln("Batch input requires -o (an output directory or a "
                       "pattern containing {})")
                return 1
            return _run_batch(args, inputs, device)
        if len(inputs) == 1 and inputs[0] != args.input_file:
            # A glob/directory matching exactly one image: run it as the
            # single input rather than opening the pattern string.
            args.input_file = inputs[0]

    decoder = None
    if args.input_file:
        try:
            decoder = ImageFileDecoder(args.input_file)
        except ImageFileError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1

    if decoder is not None:
        width, height = utils.get_dim(decoder.width, decoder.height, args.width, args.height)
    else:
        width, height = utils.get_dim(800, 600, args.width, args.height)

    info = RenderInfo(
        width=width,
        height=height,
        device=device,
        num_frames=num_frames,
        config_path=args.config,
        shader_path=args.shader_path,
        fmt=args.shader_format,
        has_input_image=args.input_file is not None,
        shader_file_path=args.shader,
        timing=args.timing,
        # Live loop: rebuild on a background thread so the old program
        # keeps producing frames; headless runs build inline.
        async_compile=not headless,
        one_shot=one_shot,
        debug_nans=args.debug_nans,
        shard=args.shard,
        pipeline_stages=args.pipeline,
    )

    try:
        # Engine construction builds the CUDA kernels on first use (nvcc,
        # about a minute on a cold build directory): keep the user informed.
        engine = _with_compile_status(lambda: Engine(info))
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    video_out = headless and is_video_path(args.output_file)
    # Animated export: a video OUTPUT from a still image (or a
    # generator-only graph) renders the time-varying graph over
    # --duration seconds instead of transcoding input frames.
    animate = video_out and (decoder is None or not is_video_path(args.input_file))
    rgba = None
    if decoder is not None and (not video_out or animate):
        # Video transcode mode must not pre-consume the first frame.
        t0 = _time.perf_counter()
        try:
            rgba = decoder.decode(width, height)
        except ImageFileError as e:
            engine.close()
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if not one_shot:
            # One-shot renders upload inside render_one_shot.
            engine.load_input(rgba)
        print(f"File Decode and resize: {utils.get_elapsed_ms(t0):.2f}ms")

    profiler = _start_profiler(args.profile, device) if args.profile else None
    try:
        if headless:
            if animate:
                return _run_animate(engine, args, width, height)
            if video_out:
                return _run_video(engine, decoder, args, width, height)
            if one_shot:
                out_u8 = _with_compile_status(lambda: engine.render_one_shot(rgba))
            else:
                # A sharded or pipelined render: the frame path.
                out = _with_compile_status(engine.render_frame_blocking)
                out_u8 = engine.read_output(out)
            try:
                encode(args.output_file, out_u8)
            except ImageFileError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            return 0
        return _run_live_loop(engine, args)
    finally:
        engine.close()
        if profiler is not None:
            _stop_profiler(profiler, args.profile)


def _start_profiler(out_dir: str, device: str):
    """A started torch.profiler session (CPU activity, and CUDA on the
    card), or None after a warning."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(out_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    except (OSError, RuntimeError) as e:
        warnln(f"Cannot start profiler trace at {out_dir}: {e}")
        return None
    return prof


def _stop_profiler(prof, out_dir: str) -> None:
    path = os.path.join(out_dir, f"reforge_{os.getpid()}.pt.trace.json")
    try:
        prof.stop()
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}", file=sys.stderr)
    except (OSError, RuntimeError) as e:  # trace export failure must not eat the run
        warnln(f"Profiler trace export failed: {e}")


def _with_compile_status(fn):
    """Run ``fn()`` printing a status line to stderr if it takes > 2 s
    (the first build of the CUDA kernels does; silence reads as a hang).
    On a TTY the line updates in place; redirected stderr (logs, CI) gets
    plain lines at a lower cadence instead of control bytes."""
    import threading

    done = threading.Event()
    tty = sys.stderr.isatty()

    def ticker():
        if done.wait(2.0):
            return
        start = _time.perf_counter() - 2.0
        while True:
            elapsed = _time.perf_counter() - start
            if tty:
                sys.stderr.write(f"\r\x1b[2KCompiling graph... ({elapsed:.0f}s)")
            else:
                sys.stderr.write(f"Compiling graph... ({elapsed:.0f}s)\n")
            sys.stderr.flush()
            if done.wait(3.0 if tty else 15.0):
                break
        if tty:
            sys.stderr.write("\r\x1b[2K")
            sys.stderr.flush()

    th = threading.Thread(target=ticker, daemon=True)
    th.start()
    try:
        return fn()
    finally:
        done.set()
        th.join()


def _expand_inputs(path: str) -> list[str]:
    """Glob patterns and directories expand to sorted image lists."""
    import glob as _glob

    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff"))
        )
    if any(ch in path for ch in "*?["):
        return sorted(_glob.glob(path))
    return [path] if os.path.exists(path) else []


def _batch_output_path(pattern: str, input_path: str) -> str:
    stem = os.path.splitext(os.path.basename(input_path))[0]
    if "{}" in pattern:
        return pattern.replace("{}", stem)
    # Treat as a directory.
    os.makedirs(pattern, exist_ok=True)
    return os.path.join(pattern, stem + ".png")


def _run_batch(args, inputs: list[str], device: str) -> int:
    """Decode N images, run ``engine.program`` over them (the strip tier
    where the graph has one): in turn on the one device, or with ``--shard
    N`` as a BatchProgram sharing them out over N devices; encode N."""
    try:
        first = ImageFileDecoder(inputs[0])
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    width, height = utils.get_dim(first.width, first.height, args.width, args.height)

    info = RenderInfo(
        width=width,
        height=height,
        device=device,
        num_frames=1,
        config_path=args.config,
        shader_path=args.shader_path,
        fmt=args.shader_format,
        has_input_image=True,
        shader_file_path=args.shader,
        debug_nans=args.debug_nans,
    )
    try:
        engine = _with_compile_status(lambda: Engine(info))
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    try:
        t0 = _time.perf_counter()
        frames = []
        for path in inputs:
            try:
                dec = first if path == inputs[0] else ImageFileDecoder(path)
                frames.append(dec.decode(width, height))
            except ImageFileError as e:
                print(f"Error decoding {path}: {e}", file=sys.stderr)
                return 1
        print(f"Decoded {len(inputs)} images at {width}x{height} in "
              f"{utils.get_elapsed_ms(t0):.0f}ms", file=sys.stderr)

        rgba = []
        if args.shard:
            try:
                bp = BatchProgram(engine.program, make_batch_mesh(
                    args.shard, available_devices(device)))
            except ValueError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            planar, n = bp.pad_batch(torch.stack([engine.decode_to_planar(f) for f in frames]))
            outs = list(bp(bp.shard_input(planar), 0.0)[:n])
        else:
            outs = (engine.program(engine.decode_to_planar(f), 0.0) for f in frames)
        for out in outs:
            engine.check_nans(out)
            rgba.append(engine.read_output(out))
        for path, image in zip(inputs, rgba):
            try:
                encode(_batch_output_path(args.output_file, path), image)
            except ImageFileError as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
        print(f"Processed {len(inputs)} images in {utils.get_elapsed_ms(t0):.0f}ms total",
              file=sys.stderr)
        return 0
    finally:
        engine.close()


class _FrameWriter:
    """Background readback+encode: the main thread queues device frames
    while a daemon thread encodes them in order.  Readbacks run in a small
    thread pool ahead of the encoder, so they overlap the encoder and the
    next frames' launches.  The engine renders on the device's default
    stream, which a readback from a pool thread also runs on, so a
    ``.cpu()`` there waits for its frame and nothing else; a frame made on
    another stream would need an event recorded after it and waited on
    before the read (not a device synchronize).  After a failure the queue
    drains without writing; the first error surfaces via ``finish``."""

    def __init__(self, engine: Engine, enc, maxsize: int, fetch_workers: int = 4):
        import concurrent.futures as cf
        import queue
        import threading

        self._engine = engine
        self._enc = enc
        # Queue of fetch FUTURES (submitted at put time, so up to
        # maxsize + fetch_workers frames are in flight): the encoder
        # consumes them in submission order.
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._pool = cf.ThreadPoolExecutor(max_workers=fetch_workers)
        self._errors: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._errors:
                continue  # drain remaining items after a failure
            try:
                self._enc.write(item.result())
            except Exception as e:  # surfaced on the main thread by finish()
                self._errors.append(e)

    def put(self, frame) -> None:
        self._q.put(self._pool.submit(self._engine.read_output, frame))

    @property
    def failed(self) -> bool:
        return bool(self._errors)

    def finish(self):
        """Join the writer; returns the first write error, if any."""
        self._q.put(None)
        self._thread.join()
        self._pool.shutdown(wait=True)
        return self._errors[0] if self._errors else None


def _finish_video(writer: _FrameWriter, enc, output: str) -> int:
    """Join the writer and finalize the file; 0, or 1 after printing the
    first error."""
    err = writer.finish()
    if err is not None:
        print(f"\nError: {err}", file=sys.stderr)
        try:
            enc.close()
        except ImageFileError:
            pass
        return 1
    try:
        enc.close()
    except ImageFileError as e:
        print(f"\nError finalizing video {output}: {e}", file=sys.stderr)
        return 1
    return 0


def _run_animate(engine: Engine, args, width: int, height: int) -> int:
    """Render a time-varying graph over a still image (or a generator
    graph) into a video: ``-i photo.png -o out.mp4 --duration 5``.

    Frames are rendered in chunks of 8 by ``GraphProgram.render_sequence``
    (``_rf_time`` advances per frame), queued without waiting on the
    device; a writer thread overlaps readback+encode with the next chunk.
    ``--start`` sets the initial ``_rf_time``; ``--fps`` the output rate."""
    from .io import VideoEncoder

    dur = args.duration
    if not dur or dur <= 0:
        print("Error: animated video export (image/generator -> video) needs "
              "--duration SEC (and optionally --fps)", file=sys.stderr)
        return 1
    fps = float(args.fps or 30.0)
    total = max(1, round(dur * fps))
    if args.frames:
        total = min(total, args.frames)
    try:
        enc = VideoEncoder(args.output_file, width, height, fps)
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    writer = _FrameWriter(engine, enc, maxsize=16)  # device frames in flight
    x = engine._file_input()
    t_start = float(args.start or 0.0)
    dt = 1.0 / fps
    chunk = 8
    t0 = _time.perf_counter()
    done = 0
    while done < total and not writer.failed:
        k = min(chunk, total - done)
        frames = engine.program.render_sequence(x, t_start + done * dt, dt, k, stack=True)
        for i in range(k):
            engine.check_nans(frames[i])
            writer.put(frames[i])
        done += k
        rate = done / max(_time.perf_counter() - t0, 1e-9)
        sys.stderr.write(f"\rFrame {done}/{total}  ({rate:5.1f} fps)")
        sys.stderr.flush()
    if _finish_video(writer, enc, args.output_file):
        return 1
    elapsed = _time.perf_counter() - t0
    sys.stderr.write(
        f"\rRendered {done} frames in {elapsed:.1f}s "
        f"({done / max(elapsed, 1e-9):.1f} fps) -> {args.output_file}\n"
    )
    return 0


def _run_video(engine: Engine, decoder, args, width: int, height: int) -> int:
    """Stream every frame of a video through the graph into a video file.

    Decode, dispatch, and readback+encode run as a three-stage pipeline:
    the main thread decodes frame i+1 and queues its launches while the
    writer thread reads frame i back (through the fetch pool) and encodes
    it.  In-flight frames are bounded by the queue depth + the fetch pool
    + the frame being encoded (~8 here)."""
    from .io import VideoEncoder, VideoFrames

    if decoder is None:
        print("Error: video output requires an input file (-i)", file=sys.stderr)
        return 1
    try:
        frames = VideoFrames(decoder, width, height, start=args.start or 0.0,
                             duration=args.duration)
        fps = frames.fps
        enc = VideoEncoder(args.output_file, width, height, fps)
    except ImageFileError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    t0 = _time.perf_counter()
    count = 0
    writer = _FrameWriter(engine, enc, maxsize=3)
    # --batch-frames K: K forwards back to back, then all K to the writer;
    # each frame sees the time it has at K=1, so the frames are identical.
    kbatch = max(1, args.batch_frames or 1)
    pending: list = []
    pending_t0 = 0

    def _flush_batch():
        outs = [engine.program(x, (pending_t0 + i) / fps) for i, x in enumerate(pending)]
        for out in outs:
            engine.check_nans(out)
            writer.put(out)
        pending.clear()

    try:
        for rgba in frames:
            if writer.failed:
                break
            if kbatch > 1:
                if not pending:
                    pending_t0 = count
                pending.append(engine.decode_to_planar(rgba))
                if len(pending) == kbatch:
                    _flush_batch()
            else:
                engine.load_input(rgba)
                writer.put(engine.render_frame(t=count / fps))
            count += 1
            if args.frames and count >= args.frames:
                break
            if count % 25 == 0:
                rate = count / (_time.perf_counter() - t0)
                sys.stderr.write(f"\rFrame {count}  ({rate:5.1f} fps)")
                sys.stderr.flush()
        if pending and not writer.failed:
            _flush_batch()
    except ImageFileError as e:
        writer.finish()
        print(f"\nError: {e}", file=sys.stderr)
        try:
            enc.close()
        except ImageFileError:
            pass
        return 1
    if _finish_video(writer, enc, args.output_file):
        return 1
    elapsed = _time.perf_counter() - t0
    sys.stderr.write(
        f"\rProcessed {count} frames in {elapsed:.1f}s "
        f"({count / max(elapsed, 1e-9):.1f} fps) -> {args.output_file}\n"
    )
    return 0


def _run_live_loop(engine: Engine, args) -> int:
    from .window import NullPreview, create_preview

    preview = create_preview(args.preview, engine.info.width, engine.info.height)
    avg_ms = 0.0
    frame_timer = _time.perf_counter()
    frames_run = 0
    try:
        while True:
            if preview.poll_quit():
                break
            resized = preview.poll_resize()
            if resized is not None:
                engine.resize(*resized)
            if engine.trigger_reloads():
                sys.stderr.write(TERM_CLEAR)

            elapsed_ms = utils.get_elapsed_ms(frame_timer)
            avg_ms = utils.moving_avg(avg_ms, elapsed_ms)
            frame_timer = _time.perf_counter()
            sys.stderr.write(
                f"\rFrame: {elapsed_ms:5.2f}ms, Frame-Avg: {avg_ms:5.2f}ms, "
                f"GPU: {{{engine.gpu_times_str()}}}"
            )
            sys.stderr.flush()

            out = engine.render_frame()
            if not isinstance(preview, NullPreview):
                preview.show(engine.read_output_scaled(out, preview.target_px()))

            frames_run += 1
            if args.frames and frames_run >= args.frames:
                break
    except KeyboardInterrupt:
        pass
    finally:
        sys.stderr.write("\n")
        preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
