"""Benchmark graph definitions and helpers (the port of
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
    shader: an op-list stage of the mc tier), the 16 examples of
    ``examples/`` whose shaders touch only images, the three whose shaders
    use storage buffers and atomics, and a lut1d graph fed by the port's
    gamma_curve.comp;
  * the point-shader graphs (``point_graphs()``): glsl-chain, glsl-sharpen,
    blur_sharpen_blend and bloom_glow with the shipped shaders on the mc
    tier, and the port's nblur.comp (zeros out of bounds) before a builtin
    tonemap (the mc tier in zero mode) and before a builtin gaussian
    (mixed borders: segments).
"""

from __future__ import annotations

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
# pop_art.rf, psychedelic.rf, neon_edges.rf), as plan_steps gives them:
# film look, old film, pop art and psychedelic plan per node (the segments
# tier finds no range of their nodes that fuses); neon edges plans the mc
# tier, the whole graph in one graph_strip_mc, where the reference runs it
# as segments.
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

# Three convs of the input and a channel-local tail (a channel op among
# it): graph_strip at its compiled plan count (cuda_ops.MAX_PLANS).
PLAN_LIMIT_CONFIG = """
input -> a -> m -> m2 -> tone -> output
input -> b -> m:input_image2
input -> c -> m2:input_image2
a: gaussian { sigma: 1.0 }
b: unsharp { sigma: 2.0, amount: 0.5 }
c: box_blur { radius: 2 }
m: mix { factor: 0.5 }
m2: screen { }
tone: tonemap { exposure: 1.1 }
"""


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
# tonemap.comp's op list before sharpen.comp's stencil, whose tap lists
# (five terms) leave the taps an odd count: McProgram pads the positions
# after them, and with them the op list, to an even word of shared memory.
TONEMAP_SHARPEN_CONFIG = (
    "input -> tm -> sh -> output\n"
    "tm: tonemap { exposure: 1.1 }\n"
    "sh: sharpen { amount: 0.7 }\n"
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
# The examples whose shaders use storage buffers and atomics: histogram ->
# equalize (atomicAdd into 256 bins, a 256-round CDF loop), auto_expose
# (expose_meter's atomicMax and atomicAdd, expose_apply) and waveform_scope
# (waveform's imageAtomicAdd, scope_overlay).
BUFFER_EXAMPLES = ("equalize", "auto_expose", "waveform_scope")
# The port's own shaders: gamma_curve.comp writes the 256-entry Curve that
# the lut1d builtin reads (no shipped shader writes one).
PORT_SHADER_DIR = str(Path(__file__).resolve().parent / "shaders")
LUT1D_CONFIG = (
    "input -> lut -> output\n"
    "curve:Curve -> lut:Curve\n"
    "curve: gamma_curve { gamma: 0.6 }\n"
    "lut: lut1d {}\n"
)
# The port's nblur.comp (the reference's tests/test_graph.py ZERO_1D): a
# 1-D tap-sum that reads out of bounds as zero.  Before the builtin
# tonemap it plans the mc tier in zero mode; before the builtin gaussian
# (an edge conv) the borders mix, and it plans segments: nblur a zero-mode
# child, gs per node.
ZERO_BORDER_CONFIG = "input -> nblur -> tm -> output\ntm: tonemap {}\n"
MIXED_BORDER_CONFIG = "input -> nblur -> gs -> output\ngs: gaussian { sigma: 2.0 }\n"
# Point shaders with data-dependent loops and integer shifts after a
# blur, each an op list with loop regions or shift ops on the mc tier:
# mandelbrot.comp at examples/mandelzoom.rf's parameters (it ignores its
# input), the port's iterate.comp (loops whose trips follow the picture: a
# break, a function's loop with a valued return) and bits.comp (<<, >>,
# bitCount, findMSB, findLSB).
MANDELBROT_AFTER_BLUR_CONFIG = (
    "input -> gv -> mb -> output\n"
    "gv: gaussian_v { sigma: 2.0 }\n"
    "mb: mandelbrot { zoom: 1.0, center_x: -0.7435, center_y: 0.1314, max_iter: 128.0,"
    " speed: 0.35 }\n"
)
ITERATE_AFTER_BLUR_CONFIG = (
    "input -> gs -> it -> output\n"
    "gs: gaussian { sigma: 2.0 }\n"
    "it: iterate { a: 1.08, b: 0.01, lim: 1.5, x: 1.3, max_n: 24 }\n"
)
BITS_AFTER_BLUR_CONFIG = (
    "input -> gs -> bt -> output\n"
    "gs: gaussian { sigma: 2.0 }\n"
    "bt: bits { bits: 3, spin: 5 }\n"
)
LOOP_GRAPHS = ("mandelbrot_after_blur", "iterate_after_blur", "bits_after_blur")
# Point shaders at the last reach of the mc planner, each an op list on
# the mc tier: the port's hash.comp (film grain from a PCG hash of the
# coordinates and the frame time's bits: bit casts) after a blur,
# composite3.comp mixing a blur and a sharpen by a threshold's mask (one
# point stage of three images), the same by the input's own red channel
# (the third image the input block itself), and wide.comp after a blur
# (more than 128 float registers live and 128 float constants: the wide
# op word, its register files in device memory).
HASH_AFTER_BLUR_CONFIG = (
    "input -> gs -> hs -> output\n"
    "gs: gaussian { sigma: 2.0 }\n"
    "hs: hash { amount: 0.06 }\n"
)
COMPOSITE3_CONFIG = (
    "input -> a -> cmp:base_image\n"
    "input -> b -> cmp:overlay_image\n"
    "input -> m -> cmp:mask_image\n"
    "cmp -> output\n"
    "a: gaussian { sigma: 2.0 }\n"
    "b: sharpen { amount: 0.6 }\n"
    "m: threshold { value: 0.5 }\n"
    "cmp: composite3 { opacity: 1.0 }\n"
)
COMPOSITE3_RAW_MASK_CONFIG = COMPOSITE3_CONFIG.replace("input -> m -> cmp:mask_image",
                                                        "input -> cmp:mask_image").replace(
    "m: threshold { value: 0.5 }\n", "")
WIDE_AFTER_BLUR_CONFIG = (
    "input -> gs -> wd -> output\n"
    "gs: gaussian { sigma: 2.0 }\n"
    "wd: wide { taps: 80 }\n"
)
REACH_GRAPHS = ("hash_after_blur", "composite3", "composite3_raw_mask", "wide_after_blur")


def example_config(name: str) -> str:
    """The config text of ``examples/<name>.rf``."""
    return (EXAMPLES_DIR / f"{name}.rf").read_text()


def point_graphs() -> dict[str, tuple[str, str]]:
    """The graphs whose GLSL point shaders run as op-list stages of the mc
    tier (MC_GLSL), the two border graphs, the LOOP_GRAPHS (loops and
    shifts in an op list) and the REACH_GRAPHS (bit casts, three images,
    the wide op word): name -> (config, shader path).  Two are examples,
    read from the checkout when called."""
    return {
        "glsl_chain": (GLSL_CHAIN_CONFIG, SHADER_DIR),
        "glsl_sharpen": (GLSL_SHARPEN_CONFIG, SHADER_DIR),
        "tonemap_sharpen": (TONEMAP_SHARPEN_CONFIG, SHADER_DIR),
        "blur_sharpen_blend": (example_config("blur_sharpen_blend"), SHADER_DIR),
        "bloom_glow": (example_config("bloom_glow"), SHADER_DIR),
        "zero_border": (ZERO_BORDER_CONFIG, PORT_SHADER_DIR),
        "mixed_border": (MIXED_BORDER_CONFIG, PORT_SHADER_DIR),
        "mandelbrot_after_blur": (MANDELBROT_AFTER_BLUR_CONFIG, SHADER_DIR),
        "iterate_after_blur": (ITERATE_AFTER_BLUR_CONFIG, PORT_SHADER_DIR),
        "bits_after_blur": (BITS_AFTER_BLUR_CONFIG, PORT_SHADER_DIR),
        "hash_after_blur": (HASH_AFTER_BLUR_CONFIG, PORT_SHADER_DIR),
        "composite3": (COMPOSITE3_CONFIG, PORT_SHADER_DIR),
        "composite3_raw_mask": (COMPOSITE3_RAW_MASK_CONFIG, PORT_SHADER_DIR),
        "wide_after_blur": (WIDE_AFTER_BLUR_CONFIG, PORT_SHADER_DIR),
    }


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


def plan_steps(program: GraphProgram) -> list[tuple[str, list[str]]]:
    """A program's strip plan as (tier, node names) steps: one step for a
    whole-graph plan ("single" or "mc") or for per-node execution
    ("per-node"); for a segments plan, ("seg <child tier>", names) and
    ("node", [name]) in execution order."""
    plan = program._strip_plan
    names = [n.name for n in program.graph.ordered_nodes]
    if plan is None:
        return [("per-node", names)]
    if plan[0] != "segments":
        return [(plan[0], names)]
    return [(f"seg {step[1]._strip_plan[0]}", [n.name for n in step[4]]) if step[0] == "seg"
            else ("node", [step[1].name]) for step in plan[1]]


def build_flagship(width: int, height: int, fmt: str = "rgba32f", device="cuda",
                   plan_strips: bool = True) -> GraphProgram:
    return build_program(FLAGSHIP_CONFIG, width, height, fmt, device, plan_strips)


def make_test_image(height: int, width: int, seed: int = 0, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((4, height, width), dtype=np.float32)).to(device)
