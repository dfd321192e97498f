"""Farneback dense optical flow (port of ``vfisr_tpu/ops/flow/farneback.py``).

OpenCV's recipe: Gaussian pyramid, polynomial expansion with the inverse
basis, matrix update with 5 px border damping, box-blurred 2x2 solve. The
bilinear fetch of the second frame's coefficients goes through
``backward_warp`` (the windowed kernel on the GPU, radius 8, f32), as the
reference's does on the TPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.ops.conv import box_filter, gaussian_blur, sep_filter2d


@functools.lru_cache(maxsize=16)
def _poly_exp_tables(n: int, sigma: float):
    """1-D kernels g, xg, xxg and the inverse-basis scalars ig11, ig03,
    ig33, ig55 (entries of Farneback's G^-1)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    xs, ys = np.meshgrid(x, x)
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xs), xs, ys, xs * xs, ys * ys, xs * ys],
                     axis=-1).reshape(-1, 6)
    inv = np.linalg.inv((basis * w.reshape(-1, 1)).T @ basis)
    return (g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32),
            float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5]))


def _poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """img [N,H,W] -> R [N,H,W,5] = (b_y, b_x, A_yy, A_xx, A_xy')."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_tables(n, sigma)
    f = img[..., None]

    def corr(kr, kc):
        return sep_filter2d(f, kr, kc, border="replicate")[..., 0]

    b1 = corr(g, g)
    b2 = corr(xg, g)
    b3 = corr(g, xg)
    b4 = corr(xxg, g)
    b5 = corr(g, xxg)
    b6 = corr(xg, xg)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=-1)


@functools.lru_cache(maxsize=16)
def _border_scale_map(h: int, w: int, device: str) -> torch.Tensor:
    """OpenCV's 5-pixel border damping weights for UpdateMatrices."""
    wts = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
    sy = np.ones(h, np.float32)
    sx = np.ones(w, np.float32)
    for i in range(min(5, h)):
        sy[i] *= wts[i]
        sy[h - 1 - i] *= wts[i]
    for i in range(min(5, w)):
        sx[i] *= wts[i]
        sx[w - 1 - i] *= wts[i]
    return torch.as_tensor(np.outer(sy, sx), device=device)[None]


def _update_matrices(R0: torch.Tensor, R1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """M [N,H,W,5] = (G11, G12, G22, h1, h2) from the coefficients and flow."""
    n, h, w, _ = R0.shape
    dx, dy = flow[..., 0], flow[..., 1]
    ys = torch.arange(h, device=R0.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=R0.device, dtype=torch.float32).view(1, 1, w)
    x1 = torch.floor(xs + dx).long()
    y1 = torch.floor(ys + dy).long()
    inb = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)

    # out-of-bounds pixels are overridden by `inb` below, so only in-bounds
    # samples need to be exact
    R1w = backward_warp(R1, flow, 1.0, border="replicate")

    r4 = torch.where(inb, (R0[..., 2] + R1w[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inb, (R0[..., 3] + R1w[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inb, (R0[..., 4] + R1w[..., 4]) * 0.25, R0[..., 4] * 0.5)
    r2 = (R0[..., 0] - torch.where(inb, R1w[..., 0], 0.0)) * 0.5
    r3 = (R0[..., 1] - torch.where(inb, R1w[..., 1], 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    scale = _border_scale_map(h, w, str(R0.device))
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-1)


def _solve_flow(M: torch.Tensor) -> torch.Tensor:
    g11, g12, g22, h1, h2 = M.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=-1)


def farneback_flow(f0: torch.Tensor, f1: torch.Tensor, pyr_scale: float = 0.5,
                   levels: int = 3, winsize: int = 15, iterations: int = 3,
                   poly_n: int = 5, poly_sigma: float = 1.2) -> torch.Tensor:
    """cv2.calcOpticalFlowFarneback analog.

    f0, f1: [N, H, W] (or [H, W]) gray in [0, 255]. Returns flow
    [N, H, W, 2] (u=dx, v=dy), float32.
    """
    squeeze = f0.ndim == 2
    if squeeze:
        f0, f1 = f0[None], f1[None]
    f0, f1 = f0.float(), f1.float()
    n, h, w = f0.shape

    # OpenCV clamps the pyramid so the smallest level stays usable
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if min(h, w) * scale < 16:
            break
        k += 1
    levels = k

    flow = None
    for k in range(levels, -1, -1):
        scale = pyr_scale ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)

        def prep(img):
            blurred = gaussian_blur(img[..., None], smooth_sz, sigma)[..., 0]
            if (lh, lw) != (h, w):
                blurred = resize(blurred[..., None], (lh, lw), "linear")[..., 0]
            return blurred

        I0, I1 = prep(f0), prep(f1)
        if flow is None:
            flow = torch.zeros((n, lh, lw, 2), dtype=torch.float32, device=f0.device)
        else:
            flow = resize(flow, (lh, lw), "linear") * (1.0 / pyr_scale)

        R0 = _poly_exp(I0, poly_n, poly_sigma)
        R1 = _poly_exp(I1, poly_n, poly_sigma)
        M = _update_matrices(R0, R1, flow)
        for i in range(iterations):
            flow = _solve_flow(box_filter(M, winsize, border="replicate"))
            if i < iterations - 1:
                M = _update_matrices(R0, R1, flow)
    return flow[0] if squeeze else flow
