"""Canny edge detection (port of ``vfisr_tpu/ops/edges.py``).

cv2.Canny(gray, lo, hi) with aperture 3 and the L1 gradient norm
(|gx| + |gy|): non-maximum suppression with cv2's sector quantisation and
its asymmetric tie-break (``mag > n1 & mag >= n2``), no edges on the image
border, and hysteresis as a fixed point: strong edges grow through weak
ones by 3x3 dilation until nothing changes. Output is {0, 255} uint8.

On uint8-valued input, Sobel and the magnitude are exact in f32, so the
edges equal the reference's bit for bit. The hysteresis runs to its fixed
point, as the reference's ``while_loop`` does (its ``max_iters`` is never
read, so it has no counterpart here). Each check of "changed" is a host
read-back, so ``HYSTERESIS_BATCH`` dilations run between checks; the
iterations past the fixed point change nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vfisr_tpu_torch.ops.conv import sobel
from vfisr_tpu_torch.ops.morphology import dilate

# cv2 compares against tan(22.5 deg) and tan(67.5 deg)
_TG22 = 0.4142135623730950488016887242097
HYSTERESIS_BATCH = 16  # dilations per host check of the fixed point


def _hysteresis(strong: torch.Tensor, weak: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Grow strong through weak by 3x3 dilation to the fixed point. Returns
    the edges and the reference loop's iteration count (the dilations up to
    and including the first that changes nothing)."""
    cur = strong
    done = 0
    while True:
        changed = []
        for _ in range(HYSTERESIS_BATCH):
            new = (dilate(cur.to(torch.float32), 3) > 0) & weak | cur
            changed.append((new != cur).any())
            cur = new
        flags = torch.stack(changed).tolist()
        if not all(flags):
            return cur, done + flags.index(False) + 1
        done += HYSTERESIS_BATCH


def canny_with_iterations(gray: torch.Tensor, lo: float, hi: float) -> Tuple[torch.Tensor, int]:
    """``canny``, and the hysteresis's iteration count."""
    squeeze = gray.ndim == 2
    g = gray[None] if squeeze else gray
    x = g.to(torch.float32)[..., None]  # [N,H,W,1]
    gx = sobel(x, "x")[..., 0]
    gy = sobel(x, "y")[..., 0]
    ax, ay = torch.abs(gx), torch.abs(gy)
    mag = ax + ay

    horizontal = ay < ax * _TG22  # compare left/right
    vertical = ay > ax * (1.0 / _TG22)  # compare up/down
    same_sign = (gx * gy) >= 0  # the diagonal's direction

    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), dims=(-2, -1))

    m_l, m_r = shift(mag, 0, 1), shift(mag, 0, -1)
    m_u, m_d = shift(mag, 1, 0), shift(mag, -1, 0)
    m_ul, m_dr = shift(mag, 1, 1), shift(mag, -1, -1)
    m_ur, m_dl = shift(mag, 1, -1), shift(mag, -1, 1)
    n1 = torch.where(horizontal, m_l, torch.where(vertical, m_u, torch.where(same_sign, m_ul, m_ur)))
    n2 = torch.where(horizontal, m_r, torch.where(vertical, m_d, torch.where(same_sign, m_dr, m_dl)))
    is_max = (mag > n1) & (mag >= n2)

    interior = torch.zeros_like(is_max)
    interior[..., 1:-1, 1:-1] = True
    strong = is_max & (mag > hi) & interior
    weak = is_max & (mag > lo) & interior
    edges, iterations = _hysteresis(strong, weak)
    out = edges.to(torch.uint8) * 255
    return (out[0] if squeeze else out), iterations


def canny(gray: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """gray: [..., H, W] uint8 or float in [0, 255] -> {0, 255} uint8 edges."""
    return canny_with_iterations(gray, lo, hi)[0]
