"""The benchmark of reforge_tpu_torch: one run of one cell.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>/``: ``config.json``, the graph, its
shader path, ``reference.py`` and ``work.py``), its traffic mix
(``traffic/<mix>.json``, read by ``drive.py``), each metric's reader
(``metrics/<metric>.py``) and the cell's limits (``limits/<cell>.json``).
A later cell, mix, configuration or metric is new files and entries.

A run: make the seeded uint8 input on the device, build the engine (the
``build`` span), upload the input, warm up, then measure ``seconds`` with
the program untraced (the end-to-end metrics, the host spans and the launch
counters); with ``--trace 1`` a traced window of ``TRACE_SECONDS`` follows.
Then the peak memory is read, the program is freed, and the sampled
answers are compared with the plain reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
TRACE_SECONDS = 2.0
# Top-level modules that may not be loaded in the process that reports.
FOREIGN = ("jax", "jaxlib", "flax", "reforge_tpu")


@dataclasses.dataclass
class Record:
    """What one run saw; the metric readers take their numbers from it."""

    loop: str
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    frame_s: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    trace: object = None
    work: dict | None = None
    peak: dict | None = None


# ---- finding things by name --------------------------------------------------


def manifest() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config_dir(name: str) -> Path:
    return ROOT / "configs" / name


def load_config(name: str) -> dict:
    return json.loads((config_dir(name) / "config.json").read_text())


def load_mix(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str) -> dict:
    return json.loads((ROOT / "limits" / f"{cell}.json").read_text())


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    return load_module(ROOT / "metrics" / f"{metric}.py", f"perfbench.metrics.{metric}")


def config_module(config: str, part: str):
    return load_module(config_dir(config) / f"{part}.py", f"perfbench.configs.{config}.{part}")


def reported(man: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced.  A metric with ``workloads`` is reported in
    those cells; one without, in every cell that reports what it moves."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


# ---- one run --------------------------------------------------------------------


def make_input(seed: int, height: int, width: int, device):
    """The seeded (H, W, 4) uint8 sRGB image, made on the device."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return torch.randint(0, 256, (height, width, 4), generator=gen, device=device,
                         dtype=torch.uint8)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: float | None = None, size: tuple[int, int] | None = None,
             mix_overrides: dict | None = None, fmt: str | None = None) -> dict:
    """One run of ``workload``; returns the result line (a dict).
    ``size`` (height, width), ``mix_overrides`` and ``fmt`` serve the tests
    and the control's readings; a benchmark run gives none of them."""
    import torch

    from perfbench import check, devtrace, drive

    t0 = time.perf_counter() if t0 is None else t0
    man = manifest()
    cell = find(man["workloads"], workload, "workload")
    cfg = load_config(cell["config"])
    if size is not None:
        cfg["height"], cfg["width"] = size
    mix = {**load_mix(cell["traffic"]), **(mix_overrides or {})}
    limits = load_limits(workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    u8 = make_input(seed, cfg["height"], cfg["width"], dev)
    from reforge_tpu_torch.engine import Engine, RenderInfo
    from reforge_tpu_torch.kernels import cuda_ops

    if cuda:
        cuda_ops.load_library()  # the kernels' build on a checkout's first run, else a load
    rec = Record(loop=mix["loop"])
    start = time.perf_counter()
    engine = Engine(RenderInfo(
        width=cfg["width"], height=cfg["height"], device=device,
        num_frames=mix["frames_in_flight"],
        config_path=str(config_dir(cell["config"]) / cfg["graph"]),
        shader_path=str(config_dir(cell["config"]) / cfg["shader_path"]),
        fmt=fmt or cfg["format"], has_input_image=True,
    ))
    rec.spans["build"] = [time.perf_counter() - start]
    engine.load_input(u8.cpu().numpy())
    loop = drive.make_loop(engine, mix, seed)
    loop.warm_up()
    rec.setup_s = time.perf_counter() - t0

    cuda_ops.reset_launches()
    rec.frames = loop.window(seconds)
    rec.launches = dict(cuda_ops.LAUNCHES)
    rec.window_s, rec.frame_s = loop.window_s, loop.frame_s
    rec.spans.update(loop.spans)
    answers = loop.answers()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if trace:
        rec.trace = devtrace.traced(loop, TRACE_SECONDS)
        rec.work = config_module(cell["config"], "work").least_work(cfg)
        rec.peak = json.loads((ROOT / "peaks.json").read_text()).get(
            torch.cuda.get_device_name(dev) if cuda else "")
    engine.close()
    del engine, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = config_module(cell["config"], "reference").frame(u8, cfg)
    values, failed = check.compare(answers, ref, mix.get("preview_px"), limits)
    del answers, ref

    metrics = {}
    for m in reported(man, workload, trace):
        value = reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {
        "correct": all(values[k] <= limits[k]["limit"] for k in limits),
        "attempted": rec.frames,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, cell["chips"], memory_peak, rec.trace),
    }
    if rec.trace is not None:
        line["breakdown"] = {"device_ops": rec.trace.device_ops(),
                             "idle_gaps": rec.trace.idle_gaps()}
    line["checks"] = {k: {"value": values[k], "limit": limits[k]["limit"]} for k in limits}
    return line


def device_info(dev, chips: int, memory_peak: int, trace) -> dict:
    import torch

    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
                "memory_peak_bytes": memory_peak, "power_limit_w": power_limit()}
    if trace is not None:
        info["busy_s"] = trace.busy_s
        info["window_s"] = trace.window_s
    return info


def power_limit() -> float | None:
    """The card's power limit in watts, from nvidia-smi (None without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FOREIGN)


# ---- the command ------------------------------------------------------------------


def main(argv: list[str], t0: float) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = find(manifest()["workloads"], args.workload, "workload")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 1
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    foreign = foreign_modules()
    if foreign:
        print(f"perfbench: JAX or the JAX package was loaded: {', '.join(foreign)}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0
