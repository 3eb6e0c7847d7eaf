"""Benchmark graph definitions and measurement helpers (the port of
``reforge_tpu/benchmarks.py``).

Graphs:
  * the flagship (single tier): a separable gaussian and an unsharp mask
    of the input, blended, tonemapped and vignetted;
  * the classic demo (examples/blur_sharpen_blend.rf), edges
    (examples/edges.rf) and chain3 (the reference's mc benchmark graph,
    BENCH.md:138): multi-stage graphs of the mc tier;
  * newsprint, watercolor and oil paint (examples/*.rf): per-node graphs
    through the bilateral kernel (stencil_reduce_mc), kuwahara's convs,
    a gather (halftone) and counter-based noise;
  * film look, old film, pop art, psychedelic and neon edges
    (examples/*.rf) and frost (a 4K frosted-glass backdrop, our own): the
    rest of the builtin library; frost's radius-160 box blur runs the 1-D
    kernels conv1d_h and conv1d_w, neon edges the mc tier;
  * two check graphs that put every channel-local builtin through the
    graph_strip kernel and every new mc point op through graph_strip_mc;
  * the reference's mc test graphs and a mix wired second input first:
    the mc tier's checks on small frames;
  * GLSL graphs over the shipped shaders (``shaders/``): glsl-blur
    (gaussian_h.comp -> gaussian_v.comp, one composed conv stage on the mc
    tier), glsl-blur-sharpen (plus sharpen.comp, a synthesized stencil
    stage), the reference's own glsl-chain and glsl-sharpen
    (benchmarks/glsl_graphs.py there; they end in tonemap.comp, a point
    shader, so the port runs them per node), and the 16 examples of
    ``examples/`` whose shaders touch only images.

Timings end in ``torch.cuda.synchronize()`` on a GPU: launches are
asynchronous, and the synchronize proves every frame finished.
"""

from __future__ import annotations

import time as _time
from pathlib import Path

import numpy as np
import torch

from .config import parse, parse_file
from .graph import GraphProgram, build_graph, make_program

FLAGSHIP_CONFIG = """
// 5-node flagship: blur + unsharp fan-in, blended, tonemapped, vignetted.
input -> soften -> mixer -> tone -> vig -> output
input -> crisp -> mixer:input_image2

soften: gaussian { sigma: 4.0 }
crisp:  unsharp  { sigma: 2.0, amount: 0.8 }
mixer:  mix      { factor: 0.5 }
tone:   tonemap  { exposure: 1.1 }
vig:    vignette { strength: 0.4 }
"""


# The classic reforge demo: blur one branch, sharpen the other, blend
# (examples/blur_sharpen_blend.rf).
DEMO_CONFIG = """
input -> soft -> mixdown -> output
input -> crisp -> mixdown:input_image2

soft:    gaussian { sigma: 8.0 }
crisp:   sharpen  { amount: 0.6 }
mixdown: blend    { factor: 0.5 }
"""

# Edge detection over a denoised image (examples/edges.rf).
EDGES_CONFIG = """
input -> smooth -> sobel -> output
smooth: median3 {}
sobel:  sobel { amount: 1.5 }
"""

# blur sigma 2 -> sobel -> tonemap (BENCH.md:138, benchmarks/mc_profile.py).
CHAIN3_CONFIG = """
input -> gs -> edge -> tone -> output
gs: gaussian { sigma: 2.0 }
edge: sobel {}
tone: tonemap {}
"""

# The stylized graphs (examples/newsprint.rf, watercolor.rf, oil_paint.rf):
# per node on every tier (halftone and noise gather or draw per pixel,
# bilateral and kuwahara have no strip form).
NEWSPRINT_CONFIG = """
// Stylized newsprint: edge-preserving smooth, punchy levels, rotated
// halftone screen.  Shows the bilateral filter (shifted-window
// formulation, halo-shardable) and the coordinate-driven halftone.
input -> smooth -> grade -> dots -> output

smooth: bilateral     { radius: 4, sigma_space: 2.5, sigma_range: 0.12 }
grade:  levels        { in_black: 0.08, in_white: 0.92, gamma: 1.1 }
dots:   halftone      { size: 6, angle: 15.0 }
"""

WATERCOLOR_CONFIG = """
// Watercolor: kuwahara flattens regions painterly, bilateral smooths
// while keeping edges, a touch of paper grain and soft vignette.
input -> paint -> smooth -> grade -> paper -> vig -> output

paint:  kuwahara  { radius: 4 }
smooth: bilateral { sigma_space: 2.5, sigma_range: 0.12 }
grade:  levels    { in_black: 0.04, in_white: 0.96, gamma: 1.08 }
paper:  noise     { amount: 0.02 }
vig:    vignette  { strength: 0.3, radius: 0.85 }
"""

OIL_PAINT_CONFIG = """
// Oil-paint look: Kuwahara regional-variance smoothing (per-lane
// dynamic array indexing in GLSL), then a gentle contrast lift.
input -> paint -> tone -> output

paint: kuwahara { radius: 4.0 }
tone:  tonemap  { exposure: 1.1 }
"""

STYLIZED_GRAPHS = {
    "newsprint": NEWSPRINT_CONFIG,
    "watercolor": WATERCOLOR_CONFIG,
    "oil_paint": OIL_PAINT_CONFIG,
}

# The rest of the builtin library (examples/film_look.rf, old_film.rf,
# pop_art.rf, psychedelic.rf, neon_edges.rf): per node on every tier but
# neon edges, which takes the mc tier (the reference runs it as segments,
# a tier the port does not have).
FILM_LOOK_CONFIG = """
// Filmic grade: tonemap, sepia-ish warmth, vignette, grain.
input -> tone -> warm -> vig -> grain -> output

tone:  tonemap     { exposure: 1.2 }
warm:  white_balance { temperature: 0.08 }
vig:   vignette    { strength: 0.45, radius: 0.7 }
grain: noise       { amount: 0.03, animate: true }
"""

OLD_FILM_CONFIG = """
// Old-film look: directional shake blur, sepia tone, vignette, grain,
// scanline flicker.  Exercises the round-3 kernels (motion_blur, sepia).
input -> shake -> tone -> vig -> grain -> lines -> output

shake: motion_blur { length: 6.0, angle: 85.0 }
tone:  sepia       { amount: 0.85 }
vig:   vignette    { strength: 0.55, radius: 0.6 }
grain: noise       { amount: 0.06, animate: true }
lines: scanlines   { period: 3, darkness: 0.12 }
"""

POP_ART_CONFIG = """
// Warhol-ish pop grade: hue spin + saturation push, posterized, with a
// zoom blur halo from the center.
input -> spin -> poster -> zoom -> output

spin:   hue_saturation { hue: 40.0, saturation: 1.6 }
poster: posterize      { levels: 5 }
zoom:   radial_blur    { strength: 0.08, samples: 10 }
"""

PSYCHEDELIC_CONFIG = """
// Animated demo: swirling waves with chromatic fringing, driven by _rf_time.
input -> wavy -> swirly -> fringe -> output

wavy:   wave  { amplitude: 10.0, frequency: 0.03, speed: 1.5 }
swirly: swirl { angle: 1.2, radius: 0.6 }
fringe: chromatic_aberration { shift: 4.0 }
"""

NEON_EDGES_CONFIG = """
// Neon edges: strong sobel outlines only (thresholded), hue-spun and
// bloomed over a darkened base.
input -> dark -> mixer -> output
input -> soft -> edge -> pick -> spin -> glow -> mixer:input_image2

dark: exposure       { stops: -1.4 }
soft: gaussian       { sigma: 1.2 }
edge: sobel          { }
pick: threshold      { value: 0.45 }
spin: hue_saturation { hue: 120.0, saturation: 1.8 }
glow: bloom          { threshold: 0.2, sigma: 2.5, intensity: 0.8 }
mixer: screen        { }
"""

# Not an example of the reference: our own frosted-glass backdrop, a 4K box
# blur of radius 160 (321 taps a pass) behind a UI.  No shared-memory tile
# of the fused conv kernels holds its window, so it runs conv1d_h then
# conv1d_w, as the reference runs box blurs of radius >= about 390 at 4K.
FROST_CONFIG = """
// Frosted glass: a wide box blur of the whole frame.
input -> frost -> output

frost: box_blur { radius: 160 }
"""

LIBRARY_GRAPHS = {
    "film_look": FILM_LOOK_CONFIG,
    "old_film": OLD_FILM_CONFIG,
    "pop_art": POP_ART_CONFIG,
    "psychedelic": PSYCHEDELIC_CONFIG,
    "neon_edges": NEON_EDGES_CONFIG,
    "frost": FROST_CONFIG,
}

# Every channel-local builtin in one single-tier plan (graph_strip): a box
# blur of the input, then each colour op; the two-input ones read the
# input or the blur as their second image.
CW_CHECK_CONFIG = """
input -> soft -> inv -> expo -> gam -> bc -> wb -> post -> dith -> lines -> lev -> plus -> mul -> scr -> ovl -> diff -> output
input -> plus:input_image2
soft -> mul:input_image2
input -> scr:input_image2
soft -> ovl:input_image2
input -> diff:input_image2

soft:  box_blur { radius: 3 }
inv:   invert {}
expo:  exposure { stops: 0.4 }
gam:   gamma { value: 1.8 }
bc:    brightness_contrast { brightness: 0.05, contrast: 1.2 }
wb:    white_balance { temperature: 0.08, tint: -0.03 }
post:  posterize { levels: 7 }
dith:  dither { levels: 4 }
lines: scanlines { period: 3, darkness: 0.2 }
lev:   levels { in_black: 0.05, in_white: 0.95, gamma: 1.2, out_black: 0.02, out_white: 0.97 }
plus:  add { scale: 0.3 }
mul:   multiply {}
scr:   screen {}
ovl:   overlay {}
diff:  difference {}
"""

# The same colour ops, sepia and hue_saturation as point stages of one mc
# plan (graph_strip_mc) after a box blur conv stage.
MC_CHECK_CONFIG = """
input -> soft -> hue -> sep -> inv -> expo -> gam -> bc -> wb -> post -> dith -> lines -> lev -> plus -> mul -> scr -> ovl -> diff -> output
input -> plus:input_image2
soft -> mul:input_image2
input -> scr:input_image2
soft -> ovl:input_image2
input -> diff:input_image2

soft:  box_blur { radius: 3 }
hue:   hue_saturation { hue: 40.0, saturation: 1.6, lightness: 0.02 }
sep:   sepia { amount: 0.7 }
inv:   invert {}
expo:  exposure { stops: 0.4 }
gam:   gamma { value: 1.8 }
bc:    brightness_contrast { brightness: 0.05, contrast: 1.2 }
wb:    white_balance { temperature: 0.08, tint: -0.03 }
post:  posterize { levels: 7 }
dith:  dither { levels: 4 }
lines: scanlines { period: 3, darkness: 0.2 }
lev:   levels { in_black: 0.05, in_white: 0.95, gamma: 1.2, out_black: 0.02, out_white: 0.97 }
plus:  add { scale: 0.3 }
mul:   multiply {}
scr:   screen {}
ovl:   overlay {}
diff:  difference {}
"""

# The reference's mc test graphs (tests/test_graph.py:434-471): one
# graph for each kind of stage and wiring the mc tier plans.
MC_TEST_GRAPHS = {
    "conv_stencil_point": (
        "input -> soft -> edges -> tone -> output\n"
        "soft: blur { sigma: 4.0 }\nedges: sobel { amount: 1.0 }\n"
        "tone: tonemap { exposure: 1.1 }"
    ),
    "conv_of_conv": "input -> a -> b -> output\na: blur { sigma: 3.0 }\nb: blur { sigma: 2.0 }",
    "bloom_pre_conv": (
        "input -> glow -> output\nglow: bloom { threshold: 0.4, sigma: 3.0, intensity: 0.8 }"
    ),
    "point_feeding_conv_fan": (
        "input -> th -> bl -> m -> output\ninput -> m:input_image2\n"
        "th: threshold { value: 0.4 }\nbl: blur { sigma: 2.0 }\nm: mix { factor: 0.6 }"
    ),
    "median_saturation": (
        "input -> med -> sat -> output\nmed: median3 {}\nsat: saturation { amount: 1.4 }"
    ),
    "sharpen_grayscale": (
        "input -> sh -> gray -> output\nsh: sharpen { amount: 0.7 }\ngray: grayscale {}"
    ),
    "coord_point_feeding_conv": (
        "input -> v -> b -> output\nv: vignette { strength: 0.5 }\nb: blur { sigma: 2.0 }"
    ),
    "emboss_unsharp_chain": (
        "input -> e -> u -> output\n"
        "e: emboss { amount: 0.9 }\nu: unsharp { sigma: 2.0, amount: 0.8 }"
    ),
}

# A mix whose second image is wired before its first (an asymmetric
# factor): the mc stage must still read input_image as the mix's base.
MIX_SECOND_FIRST_CONFIG = (
    "input -> sh -> m:input_image2\ninput -> bl -> m -> output\n"
    "sh: sharpen { amount: 0.7 }\nbl: blur { sigma: 2.0 }\nm: mix { factor: 0.6 }"
)


# The checkout's shipped shaders and example configs.
REPO_DIR = Path(__file__).resolve().parents[1]
SHADER_DIR = str(REPO_DIR / "shaders")
EXAMPLES_DIR = REPO_DIR / "examples"

GLSL_BLUR_CONFIG = (
    "input -> gh -> gv -> output\n"
    "gh: gaussian_h { sigma: 2.0 }\n"
    "gv: gaussian_v { sigma: 2.0 }\n"
)
GLSL_BLUR_SHARPEN_CONFIG = GLSL_BLUR_CONFIG.replace(
    "gv -> output", "gv -> sh -> output") + "sh: sharpen { amount: 0.7 }\n"
# The reference's GLSL benchmark graphs (benchmarks/glsl_graphs.py:43-58).
GLSL_CHAIN_CONFIG = (
    "input -> gh -> gv -> tm -> output\n"
    "gh: gaussian_h { sigma: 2.0 }\n"
    "gv: gaussian_v { sigma: 2.0 }\n"
    "tm: tonemap { exposure: 1.1 }\n"
)
GLSL_SHARPEN_CONFIG = (
    "input -> sh -> tm -> output\n"
    "sh: sharpen { amount: 0.7 }\n"
    "tm: tonemap { exposure: 1.1 }\n"
)
GLSL_GRAPHS = {
    "glsl_blur": GLSL_BLUR_CONFIG,
    "glsl_blur_sharpen": GLSL_BLUR_SHARPEN_CONFIG,
    "glsl_chain": GLSL_CHAIN_CONFIG,
    "glsl_sharpen": GLSL_SHARPEN_CONFIG,
}
# The examples that run a shader touching only images (examples/<name>.rf).
GLSL_EXAMPLES = (
    "bloom_glow", "film_look", "glass", "mandelzoom", "blur_sharpen_blend", "crt_tv", "edges",
    "neon_edges", "flow_smear", "raymarch", "old_film", "watercolor", "oil_paint", "psychedelic",
    "ink_drip", "light_trails",
)


def example_config(name: str) -> str:
    """The config text of ``examples/<name>.rf``."""
    return (EXAMPLES_DIR / f"{name}.rf").read_text()


def build_program(config: str, width: int, height: int, fmt: str = "rgba32f",
                  device="cuda", plan_strips: bool = True,
                  shader_path: str | None = None) -> GraphProgram:
    """A checked GraphProgram of ``config`` on ``device``: builtins only,
    or with kernel files from ``shader_path`` (SHADER_DIR: the shipped
    shaders) taking the names they define."""
    cfg = (parse(config, expects_input=True) if shader_path is None
           else parse_file(config, True, shader_path))
    graph = build_graph(cfg) if cfg is not None else None
    program = (
        make_program(graph, width, height, fmt, plan_strips=plan_strips, device=device)
        if graph is not None else None
    )
    if program is None:
        raise RuntimeError("the graph failed to build")
    return program


def build_flagship(width: int, height: int, fmt: str = "rgba32f", device="cuda",
                   plan_strips: bool = True) -> GraphProgram:
    return build_program(FLAGSHIP_CONFIG, width, height, fmt, device, plan_strips)


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def bench_program(program, file_input: torch.Tensor, frames: int = 60, warmup: int = 5) -> dict:
    """Steady-state frames/sec, one ``program(...)`` dispatch per frame."""
    for i in range(warmup):
        program(file_input, float(i) * 0.01)
    _sync(file_input)
    start = _time.perf_counter()
    for i in range(frames):
        program(file_input, 1.0 + i * 0.016)
    _sync(file_input)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def bench_program_sequenced(program, file_input: torch.Tensor, frames: int = 120,
                            chunk: int = 24, warmup_chunks: int = 2) -> dict:
    """Steady-state frames/sec through ``render_sequence`` in chunks of
    ``chunk`` frames (the multi-frame export path)."""
    frames = max(frames // chunk, 1) * chunk
    for i in range(warmup_chunks):
        program.render_sequence(file_input, float(i), 0.016, chunk)
    _sync(file_input)
    start = _time.perf_counter()
    for c in range(frames // chunk):
        program.render_sequence(file_input, 1.0 + c * chunk * 0.016, 0.016, chunk)
    _sync(file_input)
    elapsed = _time.perf_counter() - start
    return {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / elapsed,
        "ms_per_frame": elapsed / frames * 1000.0,
    }


def make_test_image(height: int, width: int, seed: int = 0, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((4, height, width), dtype=np.float32)).to(device)
