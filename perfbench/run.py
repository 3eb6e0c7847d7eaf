"""Run one cell of the benchmark of reforge_tpu_torch on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the last lines of standard error are the numbers compared,
each beside its limit.  Without enough CUDA devices it exits 1 and prints
no result.  See perfbench/README.md.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The checkout's root, in place of this folder: the program and perfbench
# import from there.
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
