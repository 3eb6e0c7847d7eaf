"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--seconds 2]

In one process (set-up is paid once for the torch import and the
kernels), each seed runs the cell's timed path as a benchmark run does,
with a short window, and its compared numbers are printed as one JSON
line.  ``--control-seeds`` run the control: the same path with the
program's own lower-precision storage switched on (rgba16f: bfloat16
storage, f32 arithmetic), the step below the configuration's rgba32f.
The last line gives, for each number, the largest reading of the
program (the lower reading) and the smallest of the control (the upper).
Run on the card; it is not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench import harness  # noqa: E402

CONTROL_FORMAT = "rgba16f"


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(prog="perfbench/readings.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_seeds, default=[])
    parser.add_argument("--control-seeds", type=_seeds, default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    runs = [(s, None) for s in args.seeds] + [(s, CONTROL_FORMAT) for s in args.control_seeds]
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for seed, fmt in runs:
        start = time.perf_counter()
        line = harness.run_cell(args.workload, seed, args.seconds, False, fmt=fmt)
        values = {k: c["value"] for k, c in line["checks"].items()}
        side = upper if fmt else lower
        for k, v in values.items():
            side[k] = (min if fmt else max)(side.get(k, v), v)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": bool(fmt),
                          "correct": line["correct"], "values": values,
                          "attempted": line["attempted"],
                          "metrics": {k: m["value"] for k, m in line["metrics"].items()},
                          "seconds": time.perf_counter() - start}), flush=True)
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
