"""The evaluation library's ops in vfisr_tpu_torch against vfisr_tpu:
``core/color.py`` (bgr_to_gray, rgb_to_bgr), ``core/resize.py::crop_16_9``,
``ops/conv.py::sobel``, ``ops/ssim.py`` (ms_ssim, ssim_global),
``ops/flow/farneback.py::flow_magnitude`` and ``ops/edges.py::canny``.

Inputs are made with numpy from a seed. Tolerances: channel swaps, crops,
and Canny on uint8-valued gray are equal element for element (Sobel and
the magnitude are exact in f32, so no threshold can flip); Sobel of uint8
values is exact too, and 1e-5 of the largest magnitude on float input
(another order of f32 sums); ms_ssim and ssim_global within 1e-5; the
flow magnitude within 1e-6 relative.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import game_frames, rel_err, smooth_frames
from vfisr_tpu_torch.core import color as tcolor, resize as tresize
from vfisr_tpu_torch.ops import conv as tconv, edges as tedges, ssim as tssim
from vfisr_tpu_torch.ops.flow import flow_magnitude

jcolor, jresize, jconv, jssim, jedges, jmorph, jfarn = (import_module(f"vfisr_tpu.{m}") for m in (
    "core.color", "core.resize", "ops.conv", "ops.ssim", "ops.edges", "ops.morphology",
    "ops.flow.farneback"))


def _gray_u8(n, h, w, seed=0):
    """[n,h,w] uint8-valued f32 gray of synthetic gameplay frames, with
    seeded noise so that edges of every direction and strength occur."""
    f = game_frames(n, h, w, step=5.0).astype(np.float32)
    f += np.random.default_rng(seed).normal(0, 12, f.shape)
    return np.round(np.clip(f.mean(-1), 0, 255)).astype(np.float32)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_color_swaps_match(dtype):
    x = smooth_frames(np.random.default_rng(0), 2, 9, 13)
    x = (x * 255).astype(np.uint8) if dtype == np.uint8 else x
    for name in ("bgr_to_gray", "rgb_to_bgr"):
        ref = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
        out = getattr(tcolor, name)(torch.from_numpy(x)).numpy()
        assert out.dtype == ref.dtype and np.array_equal(out, ref), name


@pytest.mark.parametrize("shape", [(2, 90, 200, 3), (1, 120, 160, 3), (100, 100, 1),
                                   (36, 64, 3), (3, 37, 70, 2)])
def test_crop_16_9_matches(shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    ref = np.asarray(jresize.crop_16_9(jnp.asarray(x)))
    out = tresize.crop_16_9(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and np.array_equal(out, ref)


@pytest.mark.parametrize("axis", ["x", "y"])
def test_sobel_matches(axis):
    u8 = _gray_u8(2, 40, 56)[..., None]
    fl = smooth_frames(np.random.default_rng(1), 2, 40, 56, c=2)
    for x, tol in ((u8, 0.0), (fl, 1e-5)):
        ref = np.asarray(jconv.sobel(jnp.asarray(x), axis))
        out = tconv.sobel(torch.from_numpy(x), axis).numpy()
        assert out.shape == ref.shape and rel_err(out, ref) <= tol
    with pytest.raises(ValueError):
        tconv.sobel(torch.from_numpy(u8), "z")


@pytest.mark.parametrize("shape,noise", [((120, 160), 8.0), ((2, 113, 151), 25.0),
                                         ((128, 128), 0.0)])
def test_ms_ssim_and_ssim_global_match(shape, noise):
    rng = np.random.default_rng(2)
    n = int(np.prod(shape[:-2]))
    x = (smooth_frames(rng, n, *shape[-2:], c=1)[..., 0] * 255).reshape(shape)
    y = np.clip(x + rng.normal(0, noise, shape), 0, 255).astype(np.float32)
    ref = np.asarray(jssim.ms_ssim(jnp.asarray(x), jnp.asarray(y)))
    out = tssim.ms_ssim(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= 1e-5
    ref_g = float(jssim.ssim_global(jnp.asarray(x), jnp.asarray(y)))
    out_g = float(tssim.ssim_global(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(out_g - ref_g) <= 1e-5 and 0.0 <= out_g <= 1.0


def test_ssim_global_clamps_to_zero():
    """Anti-correlated images: the formula goes negative, both clamp to 0."""
    x = smooth_frames(np.random.default_rng(3), 1, 32, 32, c=1)[0, ..., 0] * 255
    y = 255.0 - x
    assert float(jssim.ssim_global(jnp.asarray(x), jnp.asarray(y))) == 0.0
    assert float(tssim.ssim_global(torch.from_numpy(x), torch.from_numpy(y))) == 0.0


def test_flow_magnitude_matches():
    flow = np.random.default_rng(4).normal(0, 5, (2, 17, 23, 2)).astype(np.float32)
    ref = np.asarray(jfarn.flow_magnitude(jnp.asarray(flow)))
    out = flow_magnitude(torch.from_numpy(flow)).numpy()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


def _reference_iterations(gray, lo, hi):
    """The reference's hysteresis loop run step by step with its own ops:
    the body count of its while_loop."""
    edges = np.asarray(jedges.canny(jnp.asarray(gray), lo, hi)) > 0
    # strong pixels are the edges above hi; rerun the loop from them
    x = jnp.asarray(gray, jnp.float32)[..., None]
    gx, gy = jconv.sobel(x, "x")[..., 0], jconv.sobel(x, "y")[..., 0]
    mag = np.asarray(jnp.abs(gx) + jnp.abs(gy))
    cur = jnp.asarray(edges & (mag > hi))
    weak = jnp.asarray(edges)
    count = 0
    while True:
        new = (jmorph.dilate(cur.astype(jnp.float32), 3) > 0) & weak | cur
        count += 1
        if not bool(jnp.any(new != cur)):
            return count
        cur = new


@pytest.mark.parametrize("lo,hi", [(100, 200), (50, 150), (5, 20)])
def test_canny_bit_equal_on_uint8(lo, hi):
    g = _gray_u8(2, 72, 128, seed=lo)
    ref = np.asarray(jedges.canny(jnp.asarray(g), lo, hi))
    out, iters = tedges.canny_with_iterations(torch.from_numpy(g), lo, hi)
    assert out.dtype == torch.uint8 and np.array_equal(out.numpy(), ref)
    assert ref.any() and set(np.unique(ref)) <= {0, 255}
    # one frame [H, W], and the iteration count the reference's loop takes
    one = tedges.canny(torch.from_numpy(g[0]), lo, hi)
    assert np.array_equal(one.numpy(), ref[0])
    assert iters == max(_reference_iterations(g[i], lo, hi) for i in range(2))
