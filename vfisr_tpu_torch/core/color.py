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
