"""SSIM variants (port of ``vfisr_tpu/ops/ssim.py``), on [..., H, W] gray
in [0, 255]:

- ``ssim``: skimage ``structural_similarity`` defaults — 7x7 uniform
  window, K1=0.01, K2=0.03, unbiased covariance N/(N-1), mean over the
  valid (border-cropped) map;
- ``ms_ssim``: the same statistics at 5 dyadic scales (2x2 average pooling
  that drops an odd last row or column), contrast-structure at each scale
  and luminance at the coarsest, with Wang et al.'s weights;
- ``ssim_global``: one window over the whole image, clamped to [0, 1].

The box filters are f32 convolutions of values up to 255^2: the callers
that reach them on the GPU keep cuDNN's TF32 off (``QualityEvaluator``,
``FlagshipVFI.load``)."""

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


_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 7, data_range: float = 255.0,
            levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003). x, y: [..., H, W] gray; returns
    [...]. Each scale needs win_size rows and columns after its poolings."""
    weights = torch.tensor(_MS_WEIGHTS[:levels], dtype=torch.float32, device=x.device)
    weights = weights / weights.sum()
    orig_batch = x.shape[:-2]
    h, w = x.shape[-2:]
    a = x.reshape(-1, 1, h, w).float()
    b = y.reshape(-1, 1, h, w).float()
    win = _window(win_size, str(x.device))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1.0)

    def stats(aa, bb):
        def f(z):
            return F.conv2d(z, win)

        ux, uy = f(aa), f(bb)
        vx = cov_norm * (f(aa * aa) - ux * ux)
        vy = cov_norm * (f(bb * bb) - uy * uy)
        vxy = cov_norm * (f(aa * bb) - ux * uy)
        lum = (2 * ux * uy + c1) / (ux * ux + uy * uy + c1)
        cs = (2 * vxy + c2) / (vx + vy + c2)
        return lum.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))

    def pool(z):
        hh, ww = z.shape[-2] // 2, z.shape[-1] // 2
        return z[..., :hh * 2, :ww * 2].reshape(-1, 1, hh, 2, ww, 2).mean(dim=(3, 5))

    total = torch.ones(a.shape[0], dtype=torch.float32, device=x.device)
    for lvl in range(levels):
        lum, cs = stats(a, b)
        if lvl == levels - 1:
            total = total * torch.abs(lum * cs) ** weights[lvl]
        else:
            total = total * torch.abs(cs) ** weights[lvl]
            a, b = pool(a), pool(b)
    return total.reshape(orig_batch)


def ssim_global(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Global-statistics SSIM over all elements of x and y (one value),
    clamped to [0, 1]."""
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    xf, yf = x.float(), y.float()
    mu1, mu2 = xf.mean(), yf.mean()
    s1 = ((xf - mu1) ** 2).mean()
    s2 = ((yf - mu2) ** 2).mean()
    s12 = ((xf - mu1) * (yf - mu2)).mean()
    v = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 ** 2 + mu2 ** 2 + c1) * (s1 + s2 + c2))
    return torch.clamp(v, 0.0, 1.0)
