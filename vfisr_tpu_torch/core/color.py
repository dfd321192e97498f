"""Color conversion with OpenCV's Rec.601 coefficients (port of
``vfisr_tpu/core/color.py``)."""

from __future__ import annotations

import torch

_R, _G, _B = 0.299, 0.587, 0.114


def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> [..., H, W] gray. Float in -> float out
    (unclamped); integer in -> same integer type with OpenCV rounding."""
    xf = x.float()
    g = _R * xf[..., 0] + _G * xf[..., 1] + _B * xf[..., 2]
    if not x.is_floating_point():
        return torch.clamp(torch.floor(g + 0.5), 0, 255).to(x.dtype)
    return g.to(x.dtype)


# I420 (4:2:0 planar YUV), ITU-R BT.601 video range: the layout of a Y4M
# frame, and of the streaming pipeline's device-side readback

def rgb_to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 RGB (H and W even) -> [..., H*W*3/2] uint8 I420:
    the Y plane, then the U and V planes at half size on each axis, each
    chroma sample the mean of its 2x2 block. The constants and the order of
    operations are those of the reference's device-side packer
    (``vfisr_tpu/pipeline/streaming.py::_get_pack_i420``), in f32, rounded
    half to even and clipped."""
    h, w = rgb.shape[-3:-1]
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs an even frame size, got {w}x{h}")
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b
    lead = y.shape[:-2]

    def half(c):
        return c.reshape(*lead, h // 2, 2, w // 2, 2).mean(dim=(-3, -1)).flatten(-2)

    out = torch.cat([y.flatten(-2), half(u), half(v)], dim=-1)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# OpenCV's fixed-point I420 -> RGB (cv2.COLOR_YUV2RGB_I420): the BT.601
# coefficients scaled by 2**20 (ITUR_BT_601_* in its color_yuv code)
_SHIFT = 20
_CY, _CVR, _CVG, _CUG, _CUB = 1220542, 1673527, -852492, -409993, 2116026


def i420_size(h: int, w: int) -> int:
    """Bytes of one h x w I420 frame: the chroma planes round odd sides up."""
    return h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)


def i420_to_rgb(i420: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[..., i420_size(h, w)] uint8 I420 -> [..., h, w, 3] uint8 RGB, with
    OpenCV's integer arithmetic (each chroma sample covers its 2x2 block),
    so the result is cv2's bit for bit on any device."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    if i420.shape[-1] != i420_size(h, w):
        raise ValueError(f"{i420.shape[-1]} bytes are not one {w}x{h} I420 frame")
    lead = i420.shape[:-1]
    n, c = h * w, ch * cw
    y = i420[..., :n].reshape(*lead, h, w).to(torch.int32)

    def chroma(plane):
        up = plane.reshape(*lead, ch, cw).to(torch.int32)
        return up.repeat_interleave(2, -2).repeat_interleave(2, -1)[..., :h, :w] - 128

    u, v = chroma(i420[..., n:n + c]), chroma(i420[..., n + c:])
    yy = torch.clamp(y - 16, min=0) * _CY + (1 << (_SHIFT - 1))
    rgb = torch.stack([yy + _CVR * v, yy + _CVG * v + _CUG * u, yy + _CUB * u], dim=-1)
    return torch.clamp(rgb >> _SHIFT, 0, 255).to(torch.uint8)
