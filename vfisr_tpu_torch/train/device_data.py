"""Synthetic training scenes made on the device (port of
``vfisr_tpu/train/device_data.py``: ``device_synthetic_batch`` for VFI and
``device_sr_batch`` for SR).

A scene is a textured background moving by a subpixel camera translation,
a soft-edged foreground disc with its own motion, optional high-frequency
structure (near-Nyquist checkers, thin grid lines, specular speckle) and an
optional static HUD box that must not move. It is rendered at positions 0,
t and 1: img0, gt and img1. Both layer moves are ``backward_warp`` calls
(radius 2, f32 windows), the windowed warp kernel on the GPU; their flows
are constant per sample, so the windowed warp equals the exact one.

The work is split in two so that the tests can feed the port the JAX
function's own random draws: ``draw_scene`` draws every random array from a
``torch.Generator`` (the coarse texture grids before their upsampling, the
per-sample scalars, the speckle field); ``render_scene`` is deterministic.

The SR scenes (``device_sr_batch``) are crisp and unwarped: a textured
canvas with six hard-edged flat-colour panels, near-Nyquist checkers gated
to patches, 1 px panel seams and speckle, at full contrast, which the
caller area-downsamples for the LR input. The same split:
``draw_sr_scene`` and ``render_sr_scene``.
"""

from __future__ import annotations

import numpy as np
import torch

from vfisr_tpu_torch.core.warp import backward_warp

HUD_BOX = (20, 56)  # the static HUD box, rows x columns


def _bg_grids(crop: int) -> tuple:
    """Coarse texture grid sizes: background (2*crop) coarse and fine,
    foreground (crop) coarse and fine, the detail gate's."""
    c = crop
    return (max(2 * c // 16, 2), max(2 * c // 4, 4), max(c // 12, 2), max(c // 3, 4),
            max(2 * c // 24, 2))


def draw_scene(gen: torch.Generator, batch: int, crop: int, detail: float = 0.35) -> dict:
    """Every random array of one batch of scenes, on ``gen``'s device, with
    the ranges of the JAX generator (device_data.py:50-141)."""
    n, c = batch, crop
    dev = gen.device

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def randint(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    bg0, bg1, fg0, fg1, gate = _bg_grids(c)
    d = dict(
        wmix=uniform((n, 1, 1, 1), 0.25, 0.75),
        tex_bg=(uniform((n, bg0, bg0, 3)), uniform((n, bg1, bg1, 3))),
        tex_fg=(uniform((n, fg0, fg0, 3)), uniform((n, fg1, fg1, 3))),
        ctr=uniform((n, 2, 1, 1), 0.3 * c, 0.7 * c),
        rad=uniform((n, 1, 1), c / 8, c / 3),
        t=uniform((n,), 0.1, 0.9),
        bgd=uniform((n, 2), -12.0, 12.0),
        fgd=uniform((n, 2), -20.0, 20.0),
        hud_u=uniform((n, 1, 1)),
        hx=uniform((n, 2, 1, 1), 4.0, max(5.0, c - 64.0)),
    )
    if detail > 0.0:
        d.update(per=randint((n, 1, 1), 2, 5), gate=uniform((n, gate, gate, 3)),
                 pitch=randint((n, 1, 1), 24, 96), speck=uniform((n, 2 * c, 2 * c)),
                 amp=uniform((n, 1, 1, 1), 0.5, 1.0), tone=uniform((n, 1, 1, 3), 0.2, 1.0))
    return d


def _cubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] weights of ``jax.image.resize(..., 'cubic')`` along one
    axis (jax/_src/image/scale.py::compute_weight_mat): Keys cubic with
    a = -0.5 at half-pixel centres, renormalised over the in-range taps.
    This is not ``core/resize.py``'s cv2 cubic (a = -0.75, replicate)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)  # antialias: widened only when shrinking
    sample = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_cubic(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N,h,w,C] -> [N,size,size,C], ``jax.image.resize`` 'cubic'."""
    wy, wx = (torch.from_numpy(_cubic_matrix(m, size)).to(x.device, torch.float32)
              for m in x.shape[1:3])
    return torch.einsum("nhwc,hy,wx->nyxc", x, wy, wx)


def render_scene(d: dict, crop: int, detail: float = 0.35) -> dict:
    """{img0, img1, gt [N,crop,crop,3], t [N]} in [0, 1] from ``draw_scene``'s
    draws (the JAX function's, device_data.py:52-147)."""
    c = crop
    n = d["t"].shape[0]
    dev = d["t"].device
    wmix = d["wmix"]
    canvas = wmix * resize_cubic(d["tex_bg"][0], 2 * c) + (1 - wmix) * resize_cubic(d["tex_bg"][1], 2 * c)
    fg = wmix * resize_cubic(d["tex_fg"][0], c) + (1 - wmix) * resize_cubic(d["tex_fg"][1], c)

    if detail > 0.0:
        cy = torch.arange(2 * c, device=dev, dtype=torch.float32)[None, :, None]
        cx = torch.arange(2 * c, device=dev, dtype=torch.float32)[None, None, :]
        per, pitch = d["per"], d["pitch"]
        checker = torch.remainder(torch.floor(cy / per) + torch.floor(cx / per), 2.0)
        gate = (resize_cubic(d["gate"], 2 * c)[..., 0] > 0.72).float()
        lines = ((torch.remainder(cy, pitch) < 2.0) | (torch.remainder(cx, pitch) < 2.0)).float()
        speck = (d["speck"] > 0.985).float()
        amp = detail * d["amp"]
        struct = torch.clamp(0.8 * checker * gate + 0.6 * lines + 1.5 * speck, 0.0, 1.0)[..., None]
        canvas = canvas * (1.0 - amp * struct) + d["tone"] * (amp * struct)

    yy = torch.arange(c, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(c, device=dev, dtype=torch.float32)[None, None, :]
    ctr = d["ctr"]
    dist = torch.sqrt((yy - ctr[:, 0]) ** 2 + (xx - ctr[:, 1]) ** 2)
    fmask = torch.sigmoid(d["rad"] - dist)[..., None]  # ~1px soft edge

    # three renders (pos 0, t, 1), one warp call each for background and
    # foreground
    t = d["t"]
    pos = torch.cat([torch.zeros_like(t), t, torch.ones_like(t)])
    canvas3 = canvas.repeat(3, 1, 1, 1)
    fg3 = torch.cat([fg, fmask], dim=-1).repeat(3, 1, 1, 1)
    bgd3 = d["bgd"].repeat(3, 1) * pos[:, None] + c / 2  # crop origin offset
    fgd3 = d["fgd"].repeat(3, 1) * pos[:, None]
    flow_bg = bgd3[:, None, None, :].expand(3 * n, 2 * c, 2 * c, 2)
    frames = backward_warp(canvas3, flow_bg, 1.0, border="replicate", radius=2)[:, :c, :c]
    # content moved BY +fgd is a backward flow of -fgd
    flow_fg = (-fgd3)[:, None, None, :].expand(3 * n, c, c, 2)
    fg_w = backward_warp(fg3, flow_fg, 1.0, border="constant", radius=2)
    m = torch.clamp(fg_w[..., 3:4], 0.0, 1.0)
    frames = frames * (1.0 - m) + fg_w[..., :3] * m

    # static HUD: a bright box with dark inner stripes, in all three frames
    hud_on = (d["hud_u"] < 0.5).float()
    hx = d["hx"]
    bh, bw = HUD_BOX
    in_box = ((yy >= hx[:, 0]) & (yy < hx[:, 0] + bh)
              & (xx >= hx[:, 1]) & (xx < hx[:, 1] + bw)).float() * hud_on
    stripe = ((torch.remainder(xx - hx[:, 1], 8.0) < 4.0)
              & (yy >= hx[:, 0] + 6) & (yy < hx[:, 0] + 14)).float()
    hud_val = torch.clamp(1.0 - 0.9 * stripe, 0.0, 1.0)[..., None]
    hmask = in_box[..., None].repeat(3, 1, 1, 1)
    hval = hud_val.repeat(3, 1, 1, 1)
    frames = torch.clamp(frames * (1.0 - hmask) + hval * hmask, 0.0, 1.0)
    return {"img0": frames[:n], "gt": frames[n:2 * n], "img1": frames[2 * n:], "t": t}


@torch.no_grad()
def device_synthetic_batch(gen: torch.Generator, batch: int = 32, crop: int = 192,
                           detail: float = 0.35) -> dict:
    """One batch of scenes on ``gen``'s device: {img0, img1, gt, t}."""
    return render_scene(draw_scene(gen, batch, crop, detail), crop, detail)


SR_BOXES = 6  # hard-edged panels per SR scene


def draw_sr_scene(gen: torch.Generator, batch: int, size: int) -> dict:
    """Every random array of one batch of SR scenes, on ``gen``'s device,
    with the ranges of the JAX generator (device_data.py:165-193)."""
    n, c = batch, size
    dev = gen.device

    def uniform(shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def randint(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    g0, g1, gate = max(c // 16, 2), max(c // 4, 4), max(c // 24, 2)
    return dict(wmix=uniform((n, 1, 1, 1), 0.25, 0.75),
                tex=(uniform((n, g0, g0, 3)), uniform((n, g1, g1, 3))),
                boxes=uniform((n, SR_BOXES, 4)), cols=uniform((n, SR_BOXES, 3), 0.1, 1.0),
                per=randint((n, 1, 1), 2, 5), gate=uniform((n, gate, gate, 3)),
                pitch=randint((n, 1, 1), 16, 64), speck=uniform((n, c, c)),
                tone=uniform((n, 1, 1, 3), 0.1, 1.0))


def render_sr_scene(d: dict, size: int, detail: float = 0.6) -> dict:
    """{"gt": [N,size,size,3]} in [0, 1] from ``draw_sr_scene``'s draws (the
    JAX function's, device_data.py:165-198)."""
    c = size
    dev = d["wmix"].device
    wmix = d["wmix"]
    canvas = wmix * resize_cubic(d["tex"][0], c) + (1 - wmix) * resize_cubic(d["tex"][1], c)
    cy = torch.arange(c, device=dev, dtype=torch.float32)[None, :, None]
    cx = torch.arange(c, device=dev, dtype=torch.float32)[None, None, :]
    boxes, cols = d["boxes"], d["cols"]
    for k in range(SR_BOXES):  # y0, x0, h, w as fractions of the size
        y0 = boxes[:, k, 0, None, None] * c * 0.8
        x0 = boxes[:, k, 1, None, None] * c * 0.8
        bh = 8.0 + boxes[:, k, 2, None, None] * c * 0.25
        bw = 8.0 + boxes[:, k, 3, None, None] * c * 0.25
        inb = ((cy >= y0) & (cy < y0 + bh) & (cx >= x0) & (cx < x0 + bw)).float()[..., None]
        canvas = canvas * (1 - 0.9 * inb) + cols[:, k, None, None] * 0.9 * inb
    per, pitch = d["per"], d["pitch"]
    checker = torch.remainder(torch.floor(cy / per) + torch.floor(cx / per), 2.0)
    gate = (resize_cubic(d["gate"], c)[..., 0] > 0.7).float()
    lines = ((torch.remainder(cy, pitch) < 1.0) | (torch.remainder(cx, pitch) < 1.0)).float()
    speck = (d["speck"] > 0.99).float()
    struct = torch.clamp(checker * gate + 0.7 * lines + 1.5 * speck, 0.0, 1.0)[..., None]
    canvas = canvas * (1.0 - detail * struct) + d["tone"] * (detail * struct)
    return {"gt": torch.clamp(canvas, 0.0, 1.0)}


@torch.no_grad()
def device_sr_batch(gen: torch.Generator, batch: int = 32, size: int = 192,
                    detail: float = 0.6) -> dict:
    """One batch of crisp HR scenes for SR training on ``gen``'s device:
    {"gt": [N,size,size,3]}."""
    return render_sr_scene(draw_sr_scene(gen, batch, size), size, detail)
