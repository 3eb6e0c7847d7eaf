"""Split ``graph_strip_mc``'s time at 3840x2160 by cutting parts out.

    python3 -m reforge_tpu_torch.mc_ablation [--tiles 16x64,32x32]
    python3 -m reforge_tpu_torch.mc_ablation --parent DIR/reforge_tpu_torch

Each variant is a copy of this package under ``build/mc_ablation/`` whose
``csrc/graph_strip_mc.cu`` carries one source edit.  A cut variant's
output is wrong by design; only its time means anything:

  full        the kernel as it is;
  load_only   return once the input block is in shared memory;
  no_conv     skip the conv stages;
  no_stencil  skip the stencil stages.

Each copy builds its own kernels and, in a process of its own, times the
demo (rgba32f and rgba16f), chain3, edges and neon edges with CUDA events
(20 launches after 3).  ``full`` runs first and last, so drift within the
call shows.  ``--tiles`` also times the full kernel with each tile
forced on every graph.

``--parent`` is an A/B run instead: the package of another checkout (an
unpacked parent commit, say) against this one, parent, this, this,
parent, each a copy with this file in it.  Needs a CUDA card and nvcc.
"""

import argparse
import json
import pathlib
import shutil
import subprocess
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent
OUT = PACKAGE.parent / "build" / "mc_ablation"
KERNEL = "csrc/graph_strip_mc.cu"
STAGE_LOOP = "  for (int s = 0; s < args.n_stages; ++s) {\n"
CONV = "    if (st.kind == MC_CONV) {\n"
# variant -> (anchor, replacement); each anchor occurs once in the kernel.
EDITS = {
    "full": None,
    "load_only": (STAGE_LOOP, "  if (args.n_stages > 0) return;\n" + STAGE_LOOP),
    "no_conv": (CONV, CONV + "      continue;\n"),
    "no_stencil": (CONV, "    if (st.kind == MC_STENCIL) continue;\n" + CONV),
}
GRAPHS = (("demo", lambda b: b.DEMO_CONFIG, "rgba32f"),
          ("demo", lambda b: b.DEMO_CONFIG, "rgba16f"),
          ("chain3", lambda b: b.CHAIN3_CONFIG, "rgba32f"),
          ("edges", lambda b: b.EDGES_CONFIG, "rgba32f"),
          ("neon_edges", lambda b: b.LIBRARY_GRAPHS["neon_edges"], "rgba32f"))


def _copy(variant: str, package: pathlib.Path = PACKAGE) -> pathlib.Path:
    root = OUT / variant
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(package, root / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(__file__, root / PACKAGE.name / "mc_ablation.py")
    edit = EDITS.get(variant)
    if edit is not None:
        path = root / PACKAGE.name / KERNEL
        src = path.read_text()
        if src.count(edit[0]) != 1:
            raise SystemExit(f"{variant}: anchor not found once in {KERNEL}; update EDITS")
        path.write_text(src.replace(edit[0], edit[1]))
    return root


def _time(label: str, tile: str) -> None:
    """Time each graph with the package in the working directory."""
    import numpy as np
    import torch

    from . import benchmarks
    from .kernels import cuda_ops

    if tile:
        cuda_ops.MC_TILES = (tuple(int(v) for v in tile.split("x")),)
        cuda_ops.MC_SMEM_SOFT = cuda_ops.MC_SMEM_LIMIT
    x = torch.from_numpy(np.random.default_rng(0).random((4, 2160, 3840), dtype=np.float32))
    x = x.cuda()
    row = {}
    for name, config, fmt in GRAPHS:
        prog = benchmarks.build_program(config(benchmarks), 3840, 2160, fmt)
        mc = prog._strip_plan[1]
        xin = x.to(prog.storage_dtype)
        for _ in range(3):
            cuda_ops.graph_strip_mc(xin, 0.5, mc)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            cuda_ops.graph_strip_mc(xin, 0.5, mc)
        end.record()
        torch.cuda.synchronize()
        row[f"{name} {fmt}"] = {"ms": start.elapsed_time(end) / 20, "tile": list(mc.tile()[:2])}
    # ptxas's lines for the kernel's f32 form for builtins (registers, stack)
    log = (cuda_ops.BUILD_DIR / "build.log").read_text().splitlines()
    at = [i for i, line in enumerate(log)
          if "graph_strip_mc_kernelIfEE" in line or "graph_strip_mc_kernelIfLb0E" in line][:1]
    ptxas = [line.split(":", 1)[-1].strip() for i in at for line in log[i + 1:i + 5]
             if "registers" in line or "stack frame" in line]
    print(json.dumps({"variant": label, "kernel_ms": row, "ptxas": ptxas}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", default="", help="comma-separated tiles to force, e.g. 16x64")
    ap.add_argument("--parent", default="", help="the package directory of another checkout: A/B")
    ap.add_argument("--time", nargs=2, metavar=("LABEL", "TILE"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time:
        _time(*args.time)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    if args.parent:
        runs = [("parent", ""), ("full", ""), ("full", ""), ("parent", "")]
        roots = {"parent": _copy("parent", pathlib.Path(args.parent).resolve()), "full": _copy("full")}
    else:
        runs = [(v, "") for v in EDITS] + [("full", t) for t in args.tiles.split(",") if t]
        runs.append(("full", ""))
        roots = {v: _copy(v) for v in EDITS}
    for variant, tile in runs:
        label = f"{variant} tile {tile}" if tile else variant
        proc = subprocess.run([sys.executable, "-m", f"{PACKAGE.name}.mc_ablation", "--time", label,
                               tile], cwd=roots[variant], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
