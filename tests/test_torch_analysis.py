"""The port's frame, resize and analysis ops held against vfisr_tpu's.

f32 on both sides; tolerances: 1e-5 for single-pass ops on [0,1] data,
scaled by the data's magnitude for [0,255] grays; Farneback flow 1e-4 px
(an iterative solve over four pyramid levels, sums taken in another
order); uint8 results equal.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smooth_frames
from vfisr_tpu_torch.core import color as tcolor, frames as tframes, resize as tresize
from vfisr_tpu_torch.ops import conv as tconv, morphology as tmorph, ssim as tssim
from vfisr_tpu_torch.ops.flow import farneback as tfarn

# vfisr_tpu's package __init__s re-export functions under the module names
jcolor, jframes, jresize, jconv, jmorph, jssim, jfarn = (import_module(f"vfisr_tpu.{m}") for m in (
    "core.color", "core.frames", "core.resize", "ops.conv", "ops.morphology", "ops.ssim",
    "ops.flow.farneback"))


def _err(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("method", ["nearest", "linear", "lanczos4"])
@pytest.mark.parametrize("size", [(45, 70), (96, 128), (13, 20)])
def test_resize_float_matches(method, size):
    x = smooth_frames(np.random.default_rng(0), 2, 36, 52)
    ref = jresize.resize(jnp.asarray(x), size, method)
    out = tresize.resize(torch.from_numpy(x), size, method)
    assert out.shape == ref.shape and _err(out, ref) <= 1e-5


def test_resize_uint8_matches():
    x = (smooth_frames(np.random.default_rng(1), 1, 40, 64) * 255).astype(np.uint8)
    ref = np.asarray(jresize.resize(jnp.asarray(x), (53, 85), "lanczos4"))
    out = tresize.resize(torch.from_numpy(x), (53, 85), "lanczos4")
    assert out.dtype == torch.uint8 and np.array_equal(out.numpy(), ref)


def test_frames_and_color_match():
    x = smooth_frames(np.random.default_rng(2), 2, 30, 45)
    xt = torch.from_numpy(x)
    for a, b in zip(tframes.pad_to_multiple(xt, 16), jframes.pad_to_multiple(jnp.asarray(x), 16)):
        if torch.is_tensor(a):
            assert _err(a, b) == 0.0
        else:
            assert a == b
    assert np.array_equal(tframes.to_uint8(xt * 1.2 - 0.1).numpy(),
                          np.asarray(jframes.to_uint8(jnp.asarray(x * 1.2 - 0.1))))
    assert _err(tcolor.rgb_to_gray(xt * 255.0), jcolor.rgb_to_gray(jnp.asarray(x * 255.0))) <= 1e-4
    u8 = (x * 255).astype(np.uint8)
    assert np.array_equal(tcolor.rgb_to_gray(torch.from_numpy(u8)).numpy(),
                          np.asarray(jcolor.rgb_to_gray(jnp.asarray(u8))))


@pytest.mark.parametrize("border", ["reflect", "replicate"])
def test_filters_match(border):
    g = smooth_frames(np.random.default_rng(3), 2, 34, 60, c=2) * 255.0
    k = jconv.gaussian_kernel1d(7, 1.5)
    assert np.array_equal(k, tconv.gaussian_kernel1d(7, 1.5))
    kr = np.arange(5, dtype=np.float32) - 2.0
    ref = jconv.sep_filter2d(jnp.asarray(g), kr, k, border=border)
    out = tconv.sep_filter2d(torch.from_numpy(g), kr, k, border=border)
    assert _err(out, ref) <= 1e-5 * 255
    assert _err(tconv.box_filter(torch.from_numpy(g), 15, border),
                jconv.box_filter(jnp.asarray(g), 15, border)) <= 1e-5 * 255
    assert _err(tconv.laplacian(torch.from_numpy(g)), jconv.laplacian(jnp.asarray(g))) <= 1e-5 * 255


def test_ssim_and_morphology_match():
    rng = np.random.default_rng(4)
    a = smooth_frames(rng, 3, 40, 64, c=1)[..., 0] * 255.0
    b = np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.float32)
    assert _err(tssim.ssim(torch.from_numpy(a), torch.from_numpy(b)),
                jssim.ssim(jnp.asarray(a), jnp.asarray(b))) <= 1e-5
    m = (rng.random((2, 30, 50)) > 0.6).astype(np.float32)
    for fn_t, fn_j in ((tmorph.morph_close, jmorph.morph_close), (tmorph.morph_open, jmorph.morph_open)):
        assert np.array_equal(fn_t(torch.from_numpy(m), 5).numpy(), np.asarray(fn_j(jnp.asarray(m), 5)))


def test_farneback_matches():
    """Exact warps on both sides (each package's CPU default), 270x480-like
    pyramid on a small frame: a textured pattern shifted by (2.5, -1.5) px."""
    yy, xx = np.mgrid[0:68, 0:120].astype(np.float32)

    def pattern(dx, dy):
        return (128 + 60 * np.sin((xx - dx) / 5.0) * np.cos((yy - dy) / 4.0)
                + 30 * np.sin((xx - dx + yy - dy) / 9.0)).astype(np.float32)

    f0 = np.stack([pattern(0, 0), pattern(1, 1)])
    f1 = np.stack([pattern(2.5, -1.5), pattern(0, 3)])
    ref = np.asarray(jfarn.farneback_flow(jnp.asarray(f0), jnp.asarray(f1), 0.5, 3, 15, 3, 5, 1.2))
    out = tfarn.farneback_flow(torch.from_numpy(f0), torch.from_numpy(f1), 0.5, 3, 15, 3, 5, 1.2)
    assert out.shape == ref.shape == (2, 68, 120, 2)
    assert np.abs(ref[0, 20:-20, 20:-20].mean(axis=(0, 1)) - (2.5, -1.5)).max() < 0.5
    assert _err(out, ref) <= 1e-4
