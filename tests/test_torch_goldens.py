"""The PyTorch port on the CPU against the repository's 100 golden PNGs
(``tests/goldens/``), each read with the port's own PNG decoder.

Each golden renders as the JAX package's golden tests render it, with
their configs, seeds, sizes and times (``tests/test_goldens.py:20-64``,
``:117-135``, ``:170-185``; ``tests/test_examples.py:57-71``), one case a
golden, within one u8 code.  ``mandelbrot.comp`` and the mandelzoom
example are held as a share of values: XLA:CPU contracts the reference's
escape-time loop into FMAs where the port rounds each operation, and an
ulp moves a pixel's escape iteration (ROADMAP Queue 3), so at most 1% of
their values may be off by more than one code.
"""

import pathlib

import numpy as np
import pytest
import torch

from reforge_tpu_torch import utils
from reforge_tpu_torch.config import parse, parse_file
from reforge_tpu_torch.graph import build_graph, make_program
from reforge_tpu_torch.io import decode_image_to_planar, encode_planar_to_image
from reforge_tpu_torch.io.png import decode_png
from reforge_tpu_torch.kernels import builtin_kernels
from reforge_tpu_torch.kernels.base import KernelContext
from reforge_tpu_torch.kernels.loader import load_kernel_file

from test_goldens import CONFIGS, GENERIC_PARAMS

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "goldens"
SHADER_DIR = REPO / "shaders"
GOLDENS = sorted(p.stem for p in GOLDEN_DIR.glob("*.png"))
# Escape-time renders, held as a share of values (the module docstring).
FMA_FLIPS = ("shader_mandelbrot", "example_mandelzoom")
FLIP_SHARE = 0.01
# A golden the JAX test's filter now skips (expose_apply.comp reads a
# storage buffer); here it renders with no buffer bound.
UNLISTED = ["shader_expose_apply"]


@pytest.fixture(autouse=True)
def _quiet():
    utils.print_warnings = False
    yield


def _seeded(seed, size):
    rgba = np.random.default_rng(seed).integers(0, 256, (size, size, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    return decode_image_to_planar(torch.from_numpy(rgba))


def _u8(planar):
    return encode_planar_to_image(planar).numpy()


def _render_program(config, t, seed, fmt="rgba32f"):
    program = make_program(build_graph(config), 64, 64, fmt, device="cpu")
    assert program is not None
    return _u8(program(_seeded(seed, 64), t))


def render(name):
    """The port's render of golden ``name`` (test_goldens.py's render,
    render_shader and render_builtin; test_examples.py's render_example)."""
    if name.startswith("shader_"):
        stem = name[len("shader_"):]
        path = next(p for p in (SHADER_DIR / f"{stem}.comp", SHADER_DIR / f"{stem}.frag")
                    if p.exists())
        spec = load_kernel_file(str(path))
        assert spec is not None, path
        ctx = KernelContext(width=64, height=64, time=0.5, device="cpu")
        params = spec.resolve_params({k: v for k, v in GENERIC_PARAMS.items() if k in spec.params})
        planar = _seeded(7, 64)
        return _u8(spec(ctx, {n: planar for n in spec.images_in}, params)["output_image"])
    if name.startswith("kernel_"):
        spec = builtin_kernels()[name[len("kernel_"):]]
        ctx = KernelContext(width=48, height=48, time=0.3, device="cpu")
        planar = _seeded(11, 48)
        out = spec(ctx, {n: planar for n in spec.images_in}, spec.resolve_params({}))
        return _u8(out[spec.images_out[0] if spec.images_out else "output_image"])
    if name.startswith("example_"):
        text = (REPO / "examples" / f"{name[len('example_'):]}.rf").read_text()
        return _render_program(parse_file(text, True, str(SHADER_DIR)), 0.5, 23)
    fmt = "rgba8" if name == "rgba8_quantized" else "rgba32f"
    return _render_program(parse(CONFIGS[name], expects_input=True), 0.0, 42, fmt)


def test_every_golden_has_a_render():
    """The goldens are the JAX tests' sets (its configs, every shipped
    image-to-image shader without storage buffers, every builtin without
    them, every example) and UNLISTED."""
    shaders = []
    for path in sorted([*SHADER_DIR.glob("*.comp"), *SHADER_DIR.glob("*.frag")]):
        spec = load_kernel_file(str(path))
        if spec is not None and not spec.ssbos_in and "output_image" in spec.images_out:
            shaders.append(f"shader_{path.stem}")
    kernels = [f"kernel_{n}" for n, s in builtin_kernels().items()
               if not s.ssbos_in and not s.ssbos_out]
    examples = [f"example_{p.stem}" for p in (REPO / "examples").glob("*.rf")]
    assert sorted([*CONFIGS, *shaders, *kernels, *examples, *UNLISTED]) == GOLDENS
    assert len(GOLDENS) == 100


@pytest.mark.parametrize("name", GOLDENS)
def test_golden(name):
    with open(GOLDEN_DIR / f"{name}.png", "rb") as f:
        want = decode_png(f.read(), name)
    got = render(name)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if name in FMA_FLIPS:
        share = float((diff > 1).mean())
        assert share <= FLIP_SHARE, f"{name}: {share:.4f} of the values off by more than 1"
    else:
        assert diff.max() <= 1, f"{name}: max diff {diff.max()}, {(diff > 1).sum()} values off"
