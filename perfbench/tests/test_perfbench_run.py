"""The command itself: it refuses to run without a card, keeps JAX and the
JAX package out of the process, and (on the card) runs a short cell."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
RUN = ["python3", "perfbench/run.py"]


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([*RUN, "--workload", "flagship_4k.seq", "--seed", "3",
                           "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


# A run of each mix on the CPU at a small size, then the modules it left.
RUN_ON_CPU = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
for cell in ("flagship_4k.live", "glsl_chain_4k.seq"):
    harness.run_cell(cell, 9, 0.1, False, device="cpu", size=(36, 64),
                     mix_overrides={{"warmup": 1, "hold": 1, "preview_px": 16}})
for m in harness.manifest()["end_to_end"] + harness.manifest()["per_layer"]:
    harness.reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""

# The references, the work counts and refmath alone.
REFERENCES = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
for c in harness.manifest()["configs"]:
    harness.config_module(c["name"], "reference")
    harness.config_module(c["name"], "work")
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {name.split(".")[0] for name in json.loads(proc.stdout.strip().splitlines()[-1])}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    tops = _modules(RUN_ON_CPU)
    assert "reforge_tpu_torch" in tops and "perfbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "reforge_tpu"}


def test_the_references_import_nothing_of_the_program():
    tops = _modules(REFERENCES)
    assert not tops & {"reforge_tpu_torch", "reforge_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([*RUN, "--workload", "flagship_4k.seq", "--seed", "2147483999",
                           "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"seq_fps", "setup_s"} <= set(line["metrics"])
