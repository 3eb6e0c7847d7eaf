"""The PyTorch port's conv entry points, sRGB and storage rounding, held
against the JAX package on the CPU.

On the CPU every wrapper in ``reforge_tpu_torch.kernels.cuda_ops`` runs its
plain PyTorch version; the CUDA kernels themselves are held against those
plain versions on the card (tests/test_torch_cuda.py and ``chip_smoke.py``).
The JAX side runs as its own tests run it: the jnp path, and each Pallas
kernel in interpret mode.
"""


import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from reforge_tpu.io import srgb as jsrgb
from reforge_tpu.kernels import base as jbase
from reforge_tpu.kernels import ops as jops
from reforge_tpu.kernels import pallas_ops
from reforge_tpu_torch import utils as tutils
from reforge_tpu_torch.io import srgb as tsrgb
from reforge_tpu_torch.kernels import base as tbase
from reforge_tpu_torch.kernels import cuda_ops
from reforge_tpu_torch.kernels import ops as tops

# f32 bound: both sides sum the same taps in f32 in the same order; XLA-CPU
# may contract a multiply-add into an FMA where PyTorch rounds twice, one
# rounding per tap of values in [0, 1].
F32_ATOL = 2e-6
H, W = 48, 72
RADII = (1, 6, 12)


@pytest.fixture(autouse=True)
def _quiet():
    tutils.print_warnings = False
    yield


def _image(seed=0, shape=(4, H, W)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _taps(r):
    return jops.gaussian_weights(r / 3.0)  # radius ceil(3 sigma) = r


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _assert_within_bf16_ulp(got, want):
    """|got - want| <= one bf16 unit in the last place of the larger value."""
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    excess = np.abs(got - want) - ulp
    assert excess.max() <= 0, f"{(excess > 0).sum()} values differ by more than 1 bf16 ulp"


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("r", RADII)
def test_sep_conv_f32_matches_jnp(r):
    x = _image(r)
    w = _taps(r)
    want = np.asarray(jax.jit(lambda v: jops.sep_conv(v, w, w))(jnp.asarray(x)))
    got = tops.sep_conv(_torch(x), w, w)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("r", RADII)
def test_sep_conv_bf16_storage_matches_jnp(r):
    """rgba16f: the input is bf16-stored, compute is f32, the node output
    rounds to bf16 once.  The port reads bf16 (``sep_conv_fused_mxu``); the
    JAX CPU path computes the same conv in f32."""
    x = _bf16(_image(r))
    w = _taps(r)
    want = np.asarray(
        jax.jit(lambda v: jops.sep_conv(v, w, w, prefer_mxu=True))(jnp.asarray(x))
    )
    got = tops.sep_conv(_torch(x), w, w, prefer_mxu=True)
    _assert_within_bf16_ulp(_bf16(got.numpy()), _bf16(want))


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("r", RADII)
def test_sep_conv_fused_matches_pallas(r, mode):
    x = _image(10 + r)
    w = _taps(r)
    wa = np.roll(w, 1) if r > 1 else w  # asymmetric H taps: pins orientation
    want = pallas_ops.sep_conv_fused(jnp.asarray(x), wa, w, mode=mode, tile_h=16,
                                     interpret=True)
    got = cuda_ops.sep_conv_fused(_torch(x), wa, w, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["edge", "zero"])
@pytest.mark.parametrize("radii", [(6, 12), (1, 12)])
def test_sep_conv_fused_multi_matches_pallas(radii, mode):
    x = _image(20)
    plans = [(_taps(r), _taps(r)) for r in radii]
    want = pallas_ops.sep_conv_fused_multi(jnp.asarray(x), plans, mode=mode, tile_h=16,
                                           interpret=True)
    got = cuda_ops.sep_conv_fused_multi(_torch(x), plans, mode=mode)
    assert len(got) == len(plans)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("r", RADII)
def test_sep_conv_fused_mxu_matches_pallas(r):
    """The TPU kernel stores its H pass in bf16 and rounds its output to
    bf16; the port accumulates both passes in f32 and rounds once, at the
    node boundary.  Both stay within one bf16 ulp of the output."""
    x = _bf16(_image(30 + r))
    w = _taps(r)
    want = pallas_ops.sep_conv_fused_mxu(jnp.asarray(x, jnp.bfloat16), w, w, tile_h=16,
                                         interpret=True)
    got = cuda_ops.sep_conv_fused_mxu(_torch(x).to(torch.bfloat16), w, w)
    assert got.dtype == torch.float32
    _assert_within_bf16_ulp(_bf16(got.numpy()), np.asarray(want.astype(jnp.float32)))


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    cuda_ops.reset_launches()
    x = _torch(_image(1))
    w = _taps(6)
    cuda_ops.sep_conv_fused(x, w, w)
    cuda_ops.sep_conv_fused_multi(x, [(w, w), (w, w)])
    cuda_ops.sep_conv_fused_mxu(x.to(torch.bfloat16), w, w)
    assert set(cuda_ops.LAUNCHES.values()) == {0}
    with pytest.raises(TypeError):
        cuda_ops.sep_conv_fused(x.to(torch.bfloat16), w, w)
    with pytest.raises(ValueError):
        cuda_ops.sep_conv_fused(x[0], w, w)
    with pytest.raises(ValueError):
        cuda_ops.sep_conv_fused(x, w, w, mode="wrap")


def test_tile_choice_fits_shared_memory():
    for r in (1, 6, 12, 48, 96):
        th, tw, nbytes = cuda_ops.pick_tile(r, r, 2 * (2 * r + 1), extra_per_pixel=2)
        assert nbytes <= cuda_ops.SMEM_LIMIT
        assert ((th + 2 * r) * (tw + 2 * r) + th * (tw + 2 * r)) * 4 < nbytes
    with pytest.raises(ValueError):
        cuda_ops.pick_tile(400, 400, 10)


def test_srgb_round_trip_exact_for_all_codes():
    codes = np.zeros((1, 256, 4), np.uint8)
    codes[0, :, :] = np.arange(256, dtype=np.uint8)[:, None]
    planar = tsrgb.decode_image_to_planar(_torch(codes))
    back = tsrgb.encode_planar_to_image(planar).numpy()
    np.testing.assert_array_equal(back, codes)


def test_srgb_matches_jax_within_one_code():
    """torch.pow and jnp.power may differ by an ulp in the OETF, which can
    move a value across a rounding edge: at most one code."""
    u8 = np.random.default_rng(3).integers(0, 256, (H, W, 4), dtype=np.uint8)
    lin_t = tsrgb.decode_image_to_planar(_torch(u8))
    lin_j = np.asarray(jsrgb.decode_image_to_planar(jnp.asarray(u8)))
    np.testing.assert_allclose(lin_t.numpy(), lin_j, atol=1e-7, rtol=1e-6)
    x = _image(4) * 1.2 - 0.1
    enc_t = tsrgb.encode_planar_to_image(_torch(x)).numpy().astype(int)
    enc_j = np.asarray(jsrgb.encode_planar_to_image(jnp.asarray(x))).astype(int)
    assert np.abs(enc_t - enc_j).max() <= 1


def test_quantize_rgba8_bitwise():
    x = _image(5) * 1.4 - 0.2
    edges = (np.arange(256, dtype=np.float32) + 0.5) / 255.0  # round-half cases
    x[0, 0, : min(W, 256)] = edges[: min(W, 256)]
    got = tbase.quantize_rgba8(_torch(x)).numpy()
    want = np.asarray(jbase.quantize_rgba8(jnp.asarray(x)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_ops_helpers_match_jax():
    """Tap builders bit for bit (the port copies them); padding, luma,
    map_rgb, smoothstep and coordinate planes elementwise-exact."""
    for sigma in (0.3, 2.0, 4.0, 40.0):
        a, b = tops.gaussian_weights(sigma), jops.gaussian_weights(sigma)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert tops.gaussian_radius(40.0) == jops.gaussian_radius(40.0) == 96
    np.testing.assert_array_equal(tops.box_weights(3), jops.box_weights(3))
    x = _image(7, (4, 9, 13))
    np.testing.assert_array_equal(tops.pad_edge(_torch(x), 3, 5).numpy(),
                                  np.asarray(jops.pad_edge(jnp.asarray(x), 3, 5)))
    np.testing.assert_array_equal(tops.luma(_torch(x)).numpy(), np.asarray(jops.luma(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tops.map_rgb(_torch(x), lambda v: v * 2.0).numpy(),
        np.asarray(jops.map_rgb(jnp.asarray(x), lambda v: v * 2.0)))
    np.testing.assert_array_equal(
        tops.smoothstep(0.25, 0.75, _torch(x)).numpy(),
        np.asarray(jops.smoothstep(0.25, 0.75, jnp.asarray(x))))
    ctx = tbase.KernelContext(width=13, height=9, device="cpu")
    for got, want in zip(tops.grid_coords(ctx), jops.pixel_coords(9, 13)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
