"""The benchmark's own CPU tests: ``python -m pytest perfbench/tests`` from
the checkout's root.  The test marked ``cuda`` runs a short cell on the
card and skips without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
