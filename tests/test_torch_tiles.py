"""The windowed warp at any output tile: vfisr_tpu_torch's plain twin with
``tile`` held against vfisr_tpu's ``warp_windowed(..., tile=...)`` in
interpret mode (``_torch_port.windowed_reference``).

The tile places each window (the tile-mean displacement) and the content
origin (PT, PL) the clip bounds hang on, so shapes here leave partial
tiles on both axes. Tolerances as tests/test_torch_warp.py's: 1e-5 in f32
(the same taps, weights and rounding steps), 2/255 in bf16 (bf16 windows
and horizontal sums); K2's derivatives 1e-4 of their scale (tests/
test_pallas_warp.py's own tolerance for this tile and radius). The CUDA
kernel for these tiles (csrc/warp_tiled.cu) is held against the twin on
the card by test_torch_kernels_cuda.py and chip_smoke.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, rel_err, smooth_flow, windowed_reference  # noqa: F401
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = {"f32": 1e-5, "bf16": 2.0 / 255.0}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (tile, (n, h, w, c), r, border, dtype): each tile in both window dtypes
# and both borders across the cases; every shape leaves partial tiles
K1_PARAMS = [
    ((8, 128), (1, 44, 300, 3), (2, 2), "replicate", "f32"),
    ((8, 128), (2, 20, 200, 3), (3, 4), "constant", "bf16"),
    ((16, 256), (1, 40, 300, 3), (3, 4), "replicate", "bf16"),
    ((16, 256), (1, 36, 270, 1), 8, "constant", "f32"),
    ((40, 256), (1, 90, 300, 3), (2, 2), "replicate", "f32"),
    ((40, 256), (2, 50, 260, 3), (3, 4), "replicate", "bf16"),
    ((8, 640), (1, 20, 700, 3), (3, 4), "constant", "bf16"),
    ((8, 640), (1, 12, 650, 3), (2, 4), "replicate", "f32"),
]


@pytest.fixture(scope="module")
def jax_warp():
    with windowed_reference(backend=False) as warp:
        yield warp


@pytest.mark.parametrize("tile,shape,r,border,dt", K1_PARAMS)
def test_tiled_plain_matches_pallas_interpret(jax_warp, tile, shape, r, border, dt):
    n, h, w, c = shape
    rng = np.random.default_rng(zlib.crc32(f"{tile}/{shape}/{border}/{dt}".encode()))
    img = rng.random(shape, np.float32)
    flow = smooth_flow(rng, n, h, w, 4.0, 0.5)
    t = np.linspace(0.4, 1.0, n).astype(np.float32)  # a t per image
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t), r=r,
                              tile=tile, border=border, interpret=True, compute_dtype=jdt))
    out = tw.warp_windowed(torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(t),
                           r=r, border=border, compute_dtype=tdt, tile=tile)
    assert out.dtype == torch.float32 and out.shape == img.shape
    err = np.abs(out.numpy() - ref.astype(np.float32)).max()
    assert err <= TOL[dt], err
    # the tile moves the windows: the default tile's warp differs here
    other = tw.warp_windowed(torch.from_numpy(img), torch.from_numpy(flow), torch.from_numpy(t),
                             r=r, border=border, compute_dtype=tdt)
    assert not torch.equal(other, out)


@pytest.mark.parametrize("border", ["replicate", "constant"])
def test_tiled_grad_modes_match_pallas_interpret(jax_warp, border):
    """K2's twin at tests/test_pallas_warp.py's tile (8, 128), r = 6, on its
    [1,32,64,3] shape and random flows."""
    rng = np.random.default_rng(7)
    img = rng.random((1, 32, 64, 3), np.float32)
    ct = rng.random((1, 32, 64, 3), np.float32)
    flow = ((rng.random((1, 32, 64, 2), np.float32) - 0.5) * 8).astype(np.float32)
    refs = {}
    for mode in ("grad_y", "grad_x"):
        refs[mode] = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), 1.0, r=6,
                                         tile=(8, 128), border=border, interpret=True,
                                         weight_mode=mode))
        out = tw.warp_windowed_plain(torch.from_numpy(img), torch.from_numpy(flow), 1.0, 6,
                                     border, weight_mode=mode, tile=(8, 128))
        assert np.abs(refs[mode]).max() > 0.1, mode
        assert rel_err(out.numpy(), refs[mode]) <= 1e-4, mode
    # the K2 wrapper on CPU tensors: the channel sums of ct times the modes
    gflow, cg = tw.warp_windowed_grad(torch.from_numpy(img), torch.from_numpy(flow), 1.0,
                                      torch.from_numpy(ct), 6, border, tile=(8, 128))
    want = np.stack([(ct * refs["grad_x"]).sum(-1), (ct * refs["grad_y"]).sum(-1)], -1)
    assert rel_err(cg.numpy(), want) <= 1e-4 and torch.equal(gflow, cg)


def test_default_tile_is_unchanged():
    """tile=(32, 256) is the kernels' TILE: the same origins and the same
    warp as a call without it, through the op's default (th, tw)."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((2, 40, 300, 3), np.float32))
    flow = torch.from_numpy(smooth_flow(rng, 2, 40, 300, 4.0))
    assert tw.TILE == (32, 256)
    a = tw.warp_windowed(img, flow, 0.5, (3, 4), compute_dtype=torch.bfloat16)
    b = tw.warp_windowed(img, flow, 0.5, (3, 4), compute_dtype=torch.bfloat16, tile=(32, 256))
    c = torch.ops.vfisr_tpu_torch.warp_windowed(img, flow, None, 0.5, 3, 4, "replicate",
                                                torch.bfloat16)
    assert torch.equal(a, b) and torch.equal(a, c)
    t = torch.full((2,), 0.5)
    assert torch.equal(tw.window_origins(flow, t, 3, 4, True),
                       tw.window_origins(flow, t, 3, 4, True, (32, 256)))


@pytest.mark.parametrize("tile,cells", [((40, 256), (5, 32)), ((8, 640), (1, 80)),
                                        ((16, 256), (1, 16)), ((24, 40), (3, 5))])
def test_window_origins_reduce_as_the_reference(tile, cells):
    """The tile mean: 2x2 halvings down to g (the largest power of two
    dividing th and tw), then a row-major sum of the (th/g, tw/g) cells
    times g*g/(th*tw), in f32, as the reference's reduce_window chain; its
    origins against one computed here in numpy in that order."""
    th, tw_ = tile
    g = th // cells[0]
    n, h, w = 1, 2 * th + 3, 2 * tw_ + 5
    rng = np.random.default_rng(11)
    flow = (rng.normal(0, 40.0, (n, h, w, 2))).astype(np.float32)
    pad = np.pad(flow, ((0, 0), (0, (-h) % th), (0, (-w) % tw_), (0, 0)), mode="edge")
    m = pad
    for _ in range(g.bit_length() - 1):
        m = (((m[:, 0::2, 0::2] + m[:, 0::2, 1::2]) + m[:, 1::2, 0::2]) + m[:, 1::2, 1::2]) \
            * np.float32(0.25)
    ky, kx = cells
    ty_n, tx_n = pad.shape[1] // th, pad.shape[2] // tw_
    blocks = m.reshape(n, ty_n, ky, tx_n, kx, 2)
    acc = blocks[:, :, 0, :, 0]
    for k in range(1, ky * kx):
        acc = acc + blocks[:, :, k // kx, :, k % kx]
    if ky * kx > 1:
        acc = acc * np.float32(g * g / (th * tw_))
    pt, pl = tw._content_origin(2, 3, tile)
    oy = pt + np.arange(ty_n)[None, :, None] * th + np.rint(acc[..., 1]).astype(np.int64) - 3
    ox = pl + np.arange(tx_n)[None, None, :] * tw_ + np.rint(acc[..., 0]).astype(np.int64) - 4
    oy = np.clip(oy, 0, pt + ty_n * th)
    ox = np.clip(ox, 0, pl + tx_n * tw_)
    got = tw.window_origins(torch.from_numpy(flow), torch.ones(n), 2, 3, False, tile)
    assert got.shape == (n, ty_n, tx_n, 2)
    np.testing.assert_array_equal(got[..., 0].numpy(), oy)
    np.testing.assert_array_equal(got[..., 1].numpy(), ox)


def test_tiled_kernel_refuses_cpu_launch():
    """warp_tiled.cu has no CPU mode: its launchers take CUDA tensors only
    (here they fail before any build), and a bad tile raises."""
    img = torch.zeros((1, 8, 8, 3))
    flow = torch.zeros((1, 8, 8, 2))
    with pytest.raises(ValueError, match="CUDA flow"):
        tw.kernel_origins(flow, 1.0, 2, torch.float32, (8, 128))
    with pytest.raises(ValueError, match="positive"):
        tw.warp_windowed(img, flow, 1.0, 2, tile=(0, 128))
