"""Separable resampling with OpenCV-compatible taps (port of
``vfisr_tpu/core/resize.py``).

The tap tables are a copy of the reference's (that module imports JAX):
half-pixel coordinate map ``src = (dst + 0.5) * in/out - 0.5``, Lanczos4 as
8 normalised ``sinc(d) * sinc(d/4)`` taps, cubic as OpenCV's 4 taps with
A = -0.75, nearest as ``floor(dst*in/out)``, area as each output pixel's
fractional footprint when downscaling (and bilinear when upscaling, as
OpenCV's INTER_AREA is), indices clamped into range. Each axis is applied as gathers of the tap rows
weighted in f32 — the same formulation as the reference's CPU tap path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_METHODS = ("nearest", "linear", "cubic", "lanczos4", "area")


def _kernel_cubic(d: np.ndarray) -> np.ndarray:
    # OpenCV interpolateCubic: A = -0.75
    A = -0.75
    ad = np.abs(d)
    return np.where(
        ad <= 1.0,
        ((A + 2.0) * ad - (A + 3.0)) * ad * ad + 1.0,
        np.where(ad < 2.0, ((A * ad - 5.0 * A) * ad + 8.0 * A) * ad - 4.0 * A, 0.0),
    )


def _kernel_lanczos4(d: np.ndarray) -> np.ndarray:
    w = np.sinc(d) * np.sinc(d / 4.0)
    w[np.abs(d) >= 4.0] = 0.0
    return w


def _tap_table(in_size: int, out_size: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """(idx [out, k] int64, w [out, k] float32) for one axis."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    if method == "nearest":
        idx = np.clip(np.floor(dst * scale).astype(np.int64), 0, in_size - 1)
        return idx[:, None], np.ones((out_size, 1), np.float32)
    if method == "area" and scale > 1.0:
        # downscale: the exact fractional coverage of each output pixel's
        # footprint, normalised (OpenCV's INTER_AREA decimation)
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
    if method in ("linear", "area"):  # INTER_AREA upscales about bilinearly
        offs = np.array([0, 1])
        d = frac[:, None] - offs[None, :]
        w = np.where(np.abs(d) < 1.0, 1.0 - np.abs(d), 0.0)
    elif method == "cubic":
        offs = np.array([-1, 0, 1, 2])
        w = _kernel_cubic(frac[:, None] - offs[None, :])
    elif method == "lanczos4":
        offs = np.array([-3, -2, -1, 0, 1, 2, 3, 4])
        d = frac[:, None] - offs[None, :]
        w = _kernel_lanczos4(d)
        w = w / w.sum(axis=1, keepdims=True)
    else:
        raise ValueError(f"unknown resize method {method!r}; pick from {_METHODS}")
    idx = np.clip(base[:, None] + offs[None, :], 0, in_size - 1)
    return idx, w.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _taps_on(in_size: int, out_size: int, method: str, device: str):
    idx, w = _tap_table(in_size, out_size, method)
    return (torch.as_tensor(idx.T.copy(), device=device),
            torch.as_tensor(w.T.copy(), device=device))


def _apply_axis(x: torch.Tensor, in_size: int, out_size: int, method: str,
                axis: int) -> torch.Tensor:
    """out[..., o, ...] = sum_k w[o, k] * x[..., idx[o, k], ...] in f32."""
    idx, w = _taps_on(in_size, out_size, method, str(x.device))
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = None
    for k in range(idx.shape[0]):
        term = x.index_select(axis, idx[k]) * w[k].view(shape)
        acc = term if acc is None else acc + term
    return acc


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "lanczos4") -> torch.Tensor:
    """Resize [..., H, W, C] to ``size`` = (out_h, out_w).

    method: nearest, linear, cubic, lanczos4 or area. uint8 in -> uint8 out (OpenCV
    saturate rounding); float in -> float out of the same dtype.
    """
    out_h, out_w = size
    h_axis, w_axis = x.ndim - 3, x.ndim - 2
    in_h, in_w = x.shape[h_axis], x.shape[w_axis]
    y = x.float()
    if in_h != out_h:
        y = _apply_axis(y, in_h, out_h, method, h_axis)
    if in_w != out_w:
        y = _apply_axis(y, in_w, out_w, method, w_axis)
    if not x.is_floating_point():
        return torch.clamp(torch.floor(y + 0.5), 0, 255).to(x.dtype)
    return y.to(x.dtype)


def scale_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    """Reference size math: ``int(h*scale), int(w*scale)``."""
    return int(h * scale), int(w * scale)


def crop_16_9(x: torch.Tensor) -> torch.Tensor:
    """Centre-crop [..., H, W, C] to 16:9: the width to int(H*16/9) where
    that fits, else the height to int(W*9/16) (a view)."""
    h, w = x.shape[-3], x.shape[-2]
    target_w = int(h * 16 / 9)
    if target_w <= w:
        x0 = (w - target_w) // 2
        return x[..., x0:x0 + target_w, :]
    target_h = int(w * 9 / 16)
    y0 = (h - target_h) // 2
    return x[..., y0:y0 + target_h, :, :]
