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
the card by test_torch_kernels_cuda.py and chip_smoke.py; its plan
(``tiled_plan``, the C plan's mirror) and the footprint each CTA copies
are held here.
"""

import importlib.util
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, rel_err, smooth_flow, windowed_reference  # noqa: F401
from vfisr_tpu_torch.ops.cuda import warp as tw
from vfisr_tpu_torch.utils.paths import REPO_ROOT

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


# ---- warp_tiled.cu's plan and footprints ------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("_chip_smoke_specs", REPO_ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# every case of chip_smoke.py's step 27 (tiled_case_specs, and its K2 cases
# at 8x128, r = 6 on 1080p), and test_torch_kernels_cuda.py's TILES at
# 270x700 in its two window dtypes: (name, shape, window dtype, r, tile)
PLAN_CASES = [(sp["name"], sp["shape"], sp["compute_dtype"], sp["r"], sp["tile"])
              for sp in _chip_smoke().tiled_case_specs()]
PLAN_CASES += [("k2_t8x128_r6_1080p", (1, 1080, 1920, 3), torch.float32, 6, (8, 128))]
PLAN_CASES += [(f"cuda_tiles_{th}x{tw_}_{dt}", (2, 270, 700, 3), cd, (3, 4), (th, tw_))
               for th, tw_ in ((8, 128), (16, 256), (40, 256), (40, 640), (104, 640), (104, 256),
                               (40, 1920), (8, 640), (40, 960), (104, 960))
               for dt, cd in (("f32", torch.float32), ("bf16", torch.bfloat16))]
SMEM_BLOCK = 227 * 1024  # the most shared memory one CTA can take on the H100


def _footprint_misses(plan: dict, shape, cd, r, tile, flow: np.ndarray, t: float) -> int:
    """Replays the twin's tap arithmetic (warp_windowed_plain's yi0, xi0
    and the +1 taps) in numpy for image 0 and counts the taps outside the
    footprint box of the CTA and slab that computes the pixel: content rows
    [oy + r0 - pt, + rows + nsh_y - 1), columns [ox + cb - pl, + cols +
    nsh_x - 1), r0 the slab's first tile row and cb the band's first tile
    column, as warp_tiled.cu copies them."""
    _, h, w, _ = shape
    th, tw_ = tile
    ry, rx = (r, r) if isinstance(r, int) else r
    bf16 = cd == torch.bfloat16
    pt, pl, nsh_y, nsh_x, (ylo, yhi, xlo, xhi) = tw._geometry(h, w, ry, rx, bf16, "replicate",
                                                                tile)
    org = tw.window_origins(torch.from_numpy(flow[None]), torch.tensor([t]), ry, rx, bf16,
                            tile)[0].numpy().astype(np.int64)
    ys, xs = np.arange(h), np.arange(w)
    oy = org[..., 0][ys // th][:, xs // tw_]
    ox = org[..., 1][ys // th][:, xs // tw_]
    rows, cols = (ys % th)[:, None], (xs % tw_)[None, :]
    f32 = np.float32
    sy = ((pt + ys)[:, None] + flow[..., 1].astype(np.float64) * t).astype(f32)
    sx = ((pl + xs)[None, :] + flow[..., 0].astype(np.float64) * t).astype(f32)
    ry_max, rx_max = f32(nsh_y - 1.001), f32(nsh_x - 1.001)
    ryr = (np.clip(sy, f32(ylo), f32(yhi)) - oy.astype(f32)) - rows.astype(f32)
    rxr = (np.clip(sx, f32(xlo), f32(xhi)) - ox.astype(f32)) - cols.astype(f32)
    yi0 = oy + rows + np.floor(np.clip(ryr, f32(0), ry_max)).astype(np.int64) - pt
    xi0 = ox + cols + np.floor(np.clip(rxr, f32(0), rx_max)).astype(np.int64) - pl
    # the pixel's CTA and slab
    seg_rows = plan["rows"] if plan["chunked"] else -(-min(th, h) // plan["segments"])
    rows_p = plan["rows"]
    ra = (rows // seg_rows) * seg_rows
    r0 = ra + ((rows - ra) // rows_p) * rows_p
    seg_n = np.minimum(seg_rows, np.minimum(th, h - (ys // th)[:, None] * th) - ra)
    rn = np.minimum(rows_p, seg_n - (r0 - ra))
    cb = (cols // plan["cols"]) * plan["cols"]
    cols_n = np.minimum(plan["cols"], np.minimum(tw_, w - (xs // tw_)[None, :] * tw_) - cb)
    top, left = oy + r0 - pt, ox + cb - pl
    miss_y = (yi0 < top) | (yi0 + 1 >= top + rn + nsh_y - 1)
    miss_x = (xi0 < left) | (xi0 + 1 >= left + cols_n + nsh_x - 1)
    return int((miss_y | miss_x).sum())


@pytest.mark.parametrize("name,shape,cd,r,tile", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_tiled_plan_and_footprint(name, shape, cd, r, tile):
    """tiled_plan (the C plan's mirror) at every step-27 and CUDA-test case:
    K1's and K2's shared memory under the H100's 227 KB per CTA and two or
    more CTAs per SM; the CTAs cover every pixel once; every tap of the
    twin lies in the footprint its CTA copies, under a smooth flow and
    under +-40 px flows far past the window (whose taps the residual clamp
    keeps inside it: the copy does not depend on the flow)."""
    n, h, w, c = shape
    th, tw_ = tile
    plans = [tw.tiled_plan(shape, torch.float32, r, cd, tile, grad) for grad in (False, True)]
    for pl in plans:
        assert pl is not None, name
        assert pl["smem"] <= SMEM_BLOCK and pl["ctas_per_sm"] >= 2, pl
        th_e, tw_e = min(th, h), min(tw_, w)
        assert pl["bands"] * pl["cols"] >= tw_e > (pl["bands"] - 1) * pl["cols"], pl
        assert pl["ctas"] == n * -(-h // th) * -(-w // tw_) * pl["bands"] * pl["segments"], pl
        assert pl["fused"] == int(pl["bands"] == 1 and pl["segments"] == 1), pl
        if pl["chunked"]:
            assert pl["chunks"] * pl["chunk"] >= c and pl["slabs"] == 1, pl
        else:
            seg_rows = -(-th_e // pl["segments"])
            assert pl["slabs"] * pl["rows"] >= seg_rows > (pl["slabs"] - 1) * pl["rows"], pl
            assert pl["chunk"] == c and pl["chunks"] == 1, pl
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    t = 0.75
    smooth = smooth_flow(rng, 1, h, w, 4.0, 0.5)[0]
    far = rng.uniform(-40.0, 40.0, (h, w, 2)).astype(np.float32)
    for pl in plans:
        for flow in (smooth, far):
            assert _footprint_misses(pl, shape, cd, r, tile, flow, t) == 0, (name, pl)
