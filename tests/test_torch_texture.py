"""GLSL ``texture()`` at the image's top and left edges, pinned: an
inherited reference fault that the port keeps bit for bit.

Both interpreters clamp the lower tap (``y0 = floor(v * H - 0.5)``) to 0
and then take the upper one from the clamped value (``y1 = y0 + 1``),
keeping the weight ``yf - floor(yf)``.  So a sample inside the first row's
(or column's) outer half texel blends row 0 with row 1, where
clamp-to-edge reads row 0.  A fix would move four goldens (ROADMAP), so
it must be a deliberate change of the contract; this test fails if either
package's behaviour moves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reforge_tpu.glsl import translate_shader as jtranslate
from reforge_tpu.kernels.base import KernelContext as JContext
from reforge_tpu_torch.glsl import translate_shader
from reforge_tpu_torch.kernels.base import KernelContext

H, W = 24, 40
# Each pixel samples a quarter texel above its column's first-row centre
# (r, b) and a quarter texel left of its row's first-column centre (g, a).
EDGE_SHADER = """#version 450
layout (local_size_x = 16, local_size_y = 16) in;
layout (binding = 0) uniform sampler2D input_image;
layout (binding = 1, rgba32f) uniform writeonly image2D output_image;
void main() {
    ivec2 pos = ivec2(gl_GlobalInvocationID.xy);
    vec2 size = vec2(imageSize(output_image));
    vec4 top = texture(input_image, vec2((float(pos.x) + 0.5) / size.x, 0.25 / size.y));
    vec4 left = texture(input_image, vec2(0.25 / size.x, (float(pos.y) + 0.5) / size.y));
    imageStore(output_image, pos, vec4(top.r, left.g, top.b, left.a));
}
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_texture_edge_half_texel_keeps_the_reference_fault(seed):
    """The port's values are bit-equal to the reference's, and both blend
    row 0 (column 0) with row 1 (column 1) at weight 0.75 where
    clamp-to-edge would read row 0 (column 0) alone."""
    img = np.random.default_rng(seed).random((4, H, W), dtype=np.float32)
    spec = translate_shader(EDGE_SHADER, "texture_edge")
    got = spec(KernelContext(width=W, height=H, time=0.0, device="cpu"),
               {"input_image": torch.from_numpy(img)}, spec.resolve_params({}))
    got = got["output_image"].numpy()
    jspec = jtranslate(EDGE_SHADER, "texture_edge")
    want = jspec(JContext(width=W, height=H, time=0.0), {"input_image": jnp.asarray(img)},
                 jspec.resolve_params({}))
    want = np.asarray(want["output_image"])
    np.testing.assert_array_equal(got, want)
    x = img.astype(np.float64)
    top_r = x[0, 0] + (x[0, 1] - x[0, 0]) * 0.75  # (W,): row 0 towards row 1
    top_b = x[2, 0] + (x[2, 1] - x[2, 0]) * 0.75
    left_g = x[1, :, 0] + (x[1, :, 1] - x[1, :, 0]) * 0.75  # (H,): column 0 towards 1
    left_a = x[3, :, 0] + (x[3, :, 1] - x[3, :, 0]) * 0.75
    for k, fault in ((0, top_r[None, :]), (2, top_b[None, :]), (1, left_g[:, None]),
                     (3, left_a[:, None])):
        np.testing.assert_allclose(got[k], np.broadcast_to(fault, (H, W)), atol=2e-6)
    # clamp-to-edge would read the first row and column alone
    assert np.abs(got[0] - img[0, 0][None, :]).max() > 0.1
    assert np.abs(got[1] - img[1, :, 0][:, None]).max() > 0.1
