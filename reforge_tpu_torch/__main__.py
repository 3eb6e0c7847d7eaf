"""`python -m reforge_tpu_torch` — the CLI entry point."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
