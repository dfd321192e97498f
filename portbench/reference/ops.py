"""Plain PyTorch image operations of the reference, in float32.

Frozen copies of the semantics the measured program states for colour,
resizing, filtering, morphology, SSIM, frame padding and Farneback flow
(OpenCV's recipes). Nothing here imports the program. Tensors are NHWC
([N, H, W, C]) or [N, H, W] gray, float32. ``prec`` is a
``reference.precision.Precision``: the control lowers every convolution
through it; the reference passes ``FULL``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import FULL, Precision
from portbench.reference.warp import windowed_warp

HUD_RES = (180, 320)  # the HUD ring's gray frames


# ---- colour and frames ----

def rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] float RGB -> [...] gray, Rec.601 (OpenCV's weights)."""
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8: floor(x*255 + 0.5), clipped."""
    return torch.clamp(torch.floor(x.float() * 255.0 + 0.5), 0.0, 255.0).to(torch.uint8)


def rgb_to_i420(rgb: torch.Tensor) -> torch.Tensor:
    """[F, H, W, 3] uint8 RGB -> [F, 3H/2, W] uint8 I420, BT.601 video range:
    Y, then U and V as the mean of each 2x2 block, rounded half to even."""
    f, h, w, _ = rgb.shape
    x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + 0.257 * r + 0.504 * g + 0.098 * b
    u = 128.0 - 0.148 * r - 0.291 * g + 0.439 * b
    v = 128.0 + 0.439 * r - 0.368 * g - 0.071 * b

    def half(c):
        return c.reshape(f, h // 2, 2, w // 2, 2).mean(dim=(-3, -1)).flatten(-2)

    out = torch.cat([y.flatten(-2), half(u), half(v)], dim=-1)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).reshape(f, h * 3 // 2, w)


def pad_to_multiple(x: torch.Tensor, multiple: int = 32) -> torch.Tensor:
    """Reflect-pad (edge not repeated) the bottom and right of NHWC x to
    multiples of ``multiple``."""
    h, w = x.shape[-3], x.shape[-2]

    def idx(size, after):
        i = torch.arange(0, size + after, device=x.device)
        if size == 1:
            return torch.zeros_like(i)
        period = 2 * (size - 1)
        m = torch.remainder(i, period)
        return torch.where(m < size, m, period - m)

    ph, pw = (-h) % multiple, (-w) % multiple
    if ph == 0 and pw == 0:
        return x
    return x.index_select(-3, idx(h, ph)).index_select(-2, idx(w, pw))


# ---- resizing (tap tables, each output the weighted sum of its taps) ----

def _lanczos4(d: np.ndarray) -> np.ndarray:
    w = np.sinc(d) * np.sinc(d / 4.0)
    w[np.abs(d) >= 4.0] = 0.0
    return w


def tap_table(in_size: int, out_size: int, method: str):
    """(idx [out, k], w [out, k] float32) of one axis."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    if method == "nearest":
        idx = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        return idx[:, None], np.ones((out_size, 1), np.float32)
    if method == "area" and scale > 1.0:
        k = int(np.ceil(scale)) + 1
        idx = np.zeros((out_size, k), np.int64)
        w = np.zeros((out_size, k), np.float64)
        for i in range(out_size):
            lo, hi = i * scale, (i + 1) * scale
            first = int(np.floor(lo))
            for j in range(k):
                p = first + j
                cov = min(hi, p + 1) - max(lo, p)
                idx[i, j] = min(max(p, 0), in_size - 1)
                w[i, j] = cov if (p < in_size and cov > 0) else 0.0
            w[i] /= w[i].sum()
        return idx, w.astype(np.float32)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    if method in ("linear", "area"):
        offs = np.array([0, 1])
        d = frac[:, None] - offs[None, :]
        w = np.where(np.abs(d) < 1.0, 1.0 - np.abs(d), 0.0)
    elif method == "lanczos4":
        offs = np.arange(-3, 5)
        w = _lanczos4(frac[:, None] - offs[None, :])
        w = w / w.sum(axis=1, keepdims=True)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    idx = np.clip(base[:, None] + offs[None, :], 0, in_size - 1)
    return idx, w.astype(np.float32)


def _resize_axis(x: torch.Tensor, out_size: int, method: str, axis: int) -> torch.Tensor:
    idx, w = tap_table(x.shape[axis], out_size, method)
    idx = torch.as_tensor(idx.T.copy(), device=x.device)
    w = torch.as_tensor(w.T.copy(), device=x.device)
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = None
    for k in range(idx.shape[0]):
        term = x.index_select(axis, idx[k]) * w[k].view(shape)
        acc = term if acc is None else acc + term
    return acc


def resize(x: torch.Tensor, size, method: str = "lanczos4") -> torch.Tensor:
    """[..., H, W, C] float -> [..., out_h, out_w, C]: rows, then columns."""
    h_axis, w_axis = x.ndim - 3, x.ndim - 2
    y = x.float()
    if y.shape[h_axis] != size[0]:
        y = _resize_axis(y, size[0], method, h_axis)
    if y.shape[w_axis] != size[1]:
        y = _resize_axis(y, size[1], method, w_axis)
    return y


# ---- filtering, morphology, SSIM ----

def _depthwise(x: torch.Tensor, kernel: np.ndarray, border: str, prec: Precision) -> torch.Tensor:
    """x NCHW; 'SAME' correlation with a (kh, kw) kernel per channel."""
    kernel = np.ascontiguousarray(kernel, np.float32)
    kh, kw = kernel.shape
    xp = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2), mode=border) if kh > 1 or kw > 1 else x
    wt = torch.from_numpy(kernel).to(x.device)[None, None].expand(x.shape[1], 1, kh, kw)
    return prec.conv2d(xp, wt.contiguous(), None, groups=x.shape[1])


def sep_filter2d(x: torch.Tensor, krow, kcol, border: str = "reflect",
                 prec: Precision = FULL) -> torch.Tensor:
    """NHWC separable correlation: kcol along H, then krow along W."""
    out = _depthwise(x.permute(0, 3, 1, 2), np.asarray(kcol).reshape(-1, 1), border, prec)
    out = _depthwise(out, np.asarray(krow).reshape(1, -1), border, prec)
    return out.permute(0, 2, 3, 1)


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def laplacian(g: torch.Tensor, prec: Precision = FULL) -> torch.Tensor:
    """[N,H,W] -> [N,H,W], kernel [[0,1,0],[1,-4,1],[0,1,0]], reflect-101."""
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    return _depthwise(g[:, None], k, "reflect", prec)[:, 0]


def _max_window(x: torch.Tensor, k: int) -> torch.Tensor:
    shape = x.shape
    return F.max_pool2d(x.reshape(-1, 1, *shape[-2:]), k, stride=1, padding=k // 2).reshape(shape)


def morph_close(x, k=5):
    return -_max_window(-_max_window(x, k), k)


def morph_open(x, k=5):
    return _max_window(-_max_window(-x, k), k)


def ssim(x: torch.Tensor, y: torch.Tensor, prec: Precision = FULL, win: int = 7) -> torch.Tensor:
    """Mean SSIM over valid 7x7 uniform windows (skimage's defaults):
    [N,H,W] gray in [0, 255] -> [N]."""
    h, w = x.shape[-2:]
    xf, yf = x.reshape(-1, 1, h, w), y.reshape(-1, 1, h, w)
    wt = torch.full((1, 1, win, win), 1.0 / (win * win), device=x.device)

    def f(a):
        return prec.conv2d(a, wt, None)

    cov = win * win / (win * win - 1.0)
    ux, uy = f(xf), f(yf)
    uxx, uyy, uxy = f(xf * xf), f(yf * yf), f(xf * yf)
    vx, vy, vxy = cov * (uxx - ux * ux), cov * (uyy - uy * uy), cov * (uxy - ux * uy)
    c1, c2 = (0.01 * 255.0) ** 2, (0.03 * 255.0) ** 2
    s = ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


# ---- Farneback flow (OpenCV's recipe) ----

def _poly_tables(n: int, sigma: float):
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    xs, ys = np.meshgrid(x, x)
    basis = np.stack([np.ones_like(xs), xs, ys, xs * xs, ys * ys, xs * ys], -1).reshape(-1, 6)
    inv = np.linalg.inv((basis * np.outer(g, g).reshape(-1, 1)).T @ basis)
    return (g.astype(np.float32), (x * g).astype(np.float32), (x * x * g).astype(np.float32),
            float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5]))


def _poly_exp(img: torch.Tensor, prec: Precision) -> torch.Tensor:
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_tables(5, 1.2)
    f = img[..., None]

    def corr(kr, kc):
        return sep_filter2d(f, kr, kc, "replicate", prec)[..., 0]

    b1, b2, b3 = corr(g, g), corr(xg, g), corr(g, xg)
    b4, b5, b6 = corr(xxg, g), corr(g, xxg), corr(xg, xg)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], dim=-1)


def _border_scale(h: int, w: int, device) -> torch.Tensor:
    wts = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)
    sy, sx = np.ones(h, np.float32), np.ones(w, np.float32)
    for i in range(min(5, h)):
        sy[i] *= wts[i]
        sy[h - 1 - i] *= wts[i]
    for i in range(min(5, w)):
        sx[i] *= wts[i]
        sx[w - 1 - i] *= wts[i]
    return torch.as_tensor(np.outer(sy, sx), device=device)[None]


def _update_matrices(R0, R1, flow):
    n, h, w, _ = R0.shape
    dx, dy = flow[..., 0], flow[..., 1]
    ys = torch.arange(h, device=R0.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=R0.device, dtype=torch.float32).view(1, 1, w)
    x1, y1 = torch.floor(xs + dx).long(), torch.floor(ys + dy).long()
    inb = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    R1w = windowed_warp(R1, flow, 1.0, 8, "replicate", torch.float32)
    r4 = torch.where(inb, (R0[..., 2] + R1w[..., 2]) * 0.5, R0[..., 2])
    r5 = torch.where(inb, (R0[..., 3] + R1w[..., 3]) * 0.5, R0[..., 3])
    r6 = torch.where(inb, (R0[..., 4] + R1w[..., 4]) * 0.25, R0[..., 4] * 0.5)
    r2 = (R0[..., 0] - torch.where(inb, R1w[..., 0], 0.0)) * 0.5
    r3 = (R0[..., 1] - torch.where(inb, R1w[..., 1], 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    scale = _border_scale(h, w, R0.device)
    r2, r3, r4, r5, r6 = (v * scale for v in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=-1)


def _solve(M):
    g11, g12, g22, h1, h2 = M.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=-1)


def farneback(f0: torch.Tensor, f1: torch.Tensor, prec: Precision = FULL) -> torch.Tensor:
    """cv2.calcOpticalFlowFarneback(pyr_scale 0.5, levels 3, winsize 15,
    iterations 3, poly_n 5, poly_sigma 1.2) of [N,H,W] grays in [0, 255]
    -> [N,H,W,2] (dx, dy)."""
    n, h, w = f0.shape
    levels, scale = 0, 1.0
    while levels < 3:
        scale *= 0.5
        if min(h, w) * scale < 16:
            break
        levels += 1
    box = np.full((15,), 1.0 / 15, np.float32)
    flow = None
    for k in range(levels, -1, -1):
        scale = 0.5 ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        sigma = (1.0 / scale - 1.0) * 0.5
        ks = max(int(round(sigma * 5)) | 1, 3)
        gk = gaussian_kernel1d(ks, sigma)

        def prep(img):
            b = sep_filter2d(img[..., None], gk, gk, "reflect", prec)
            return (resize(b, (lh, lw), "linear") if (lh, lw) != (h, w) else b)[..., 0]

        I0, I1 = prep(f0), prep(f1)
        if flow is None:
            flow = torch.zeros((n, lh, lw, 2), dtype=torch.float32, device=f0.device)
        else:
            flow = resize(flow, (lh, lw), "linear") * 2.0
        R0, R1 = _poly_exp(I0, prec), _poly_exp(I1, prec)
        M = _update_matrices(R0, R1, flow)
        for i in range(3):
            flow = _solve(sep_filter2d(M, box, box, "replicate", prec))
            if i < 2:
                M = _update_matrices(R0, R1, flow)
    return flow
