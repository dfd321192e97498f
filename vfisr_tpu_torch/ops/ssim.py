"""Windowed SSIM (port of ``vfisr_tpu/ops/ssim.py::ssim``): skimage
``structural_similarity`` defaults — 7x7 uniform window, K1=0.01, K2=0.03,
unbiased covariance N/(N-1), mean over the valid (border-cropped) map."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _window(win_size: int, device: str) -> torch.Tensor:
    return torch.full((1, 1, win_size, win_size), 1.0 / (win_size * win_size),
                      dtype=torch.float32, device=device)


def ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 7,
         data_range: float = 255.0) -> torch.Tensor:
    """Mean SSIM over valid windows. x, y: [..., H, W] gray; returns [...]."""
    orig_batch = x.shape[:-2]
    h, w = x.shape[-2:]
    xf = x.reshape(-1, 1, h, w).float()
    yf = y.reshape(-1, 1, h, w).float()
    win = _window(win_size, str(x.device))

    def f(a):
        return F.conv2d(a, win)

    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1.0)
    ux, uy = f(xf), f(yf)
    uxx, uyy, uxy = f(xf * xf), f(yf * yf), f(xf * yf)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)
    return s.mean(dim=(1, 2, 3)).reshape(orig_batch)
