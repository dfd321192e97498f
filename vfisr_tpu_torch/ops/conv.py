"""Separable/depthwise 2-D filtering with OpenCV-compatible kernels (port of
``vfisr_tpu/ops/conv.py``).

Functions take [N, H, W, C] float tensors (batched NHWC) and correlate
each channel with its own copy of the kernel: an explicit border pad, then
a VALID depthwise ``conv2d`` in f32. The callers keep cuDNN's TF32 off
(``FlagshipVFI.load``), so these stay full f32 on the GPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel parity (sigma <= 0 takes cv2's automatic
    sigma 0.3*((ksize-1)*0.5 - 1) + 0.8)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_BORDERS = ("reflect", "replicate", "constant")


@functools.lru_cache(maxsize=128)
def _weight(kernel: bytes, shape: tuple, channels: int, device: str) -> torch.Tensor:
    k = torch.from_numpy(np.frombuffer(kernel, np.float32).reshape(shape).copy())
    return k.to(device)[None, None].expand(channels, 1, *shape).contiguous()


def _depthwise(x: torch.Tensor, kernel: np.ndarray, border: str) -> torch.Tensor:
    """x NCHW; 'SAME' correlation with a (kh, kw) kernel (BORDER_REFLECT_101
    for 'reflect', as cv2's default)."""
    kernel = np.ascontiguousarray(kernel, np.float32)
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    if border not in _BORDERS:
        raise ValueError(f"unknown border mode {border!r}")
    xp = F.pad(x, (pw, pw, ph, ph), mode=border) if (ph or pw) else x
    w = _weight(kernel.tobytes(), kernel.shape, x.shape[1], str(x.device))
    return F.conv2d(xp, w.to(x.dtype), groups=x.shape[1])


def filter2d(x: torch.Tensor, kernel: np.ndarray, border: str = "reflect") -> torch.Tensor:
    """Dense 2-D correlation (cv2.filter2D semantics, no kernel flip)."""
    return _depthwise(x.permute(0, 3, 1, 2), np.asarray(kernel), border).permute(0, 2, 3, 1)


def sep_filter2d(x: torch.Tensor, krow: np.ndarray, kcol: np.ndarray,
                 border: str = "reflect") -> torch.Tensor:
    """Separable correlation: kcol along H, then krow along W."""
    out = _depthwise(x.permute(0, 3, 1, 2), np.asarray(kcol).reshape(-1, 1), border)
    out = _depthwise(out, np.asarray(krow).reshape(1, -1), border)
    return out.permute(0, 2, 3, 1)


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """cv2.GaussianBlur analog with an explicit aperture."""
    k = gaussian_kernel1d(ksize, sigma)
    return sep_filter2d(x, k, k)


def box_filter(x: torch.Tensor, ksize: int, border: str = "reflect") -> torch.Tensor:
    """cv2.blur analog (normalised box)."""
    k = np.full((ksize,), 1.0 / ksize, np.float32)
    return sep_filter2d(x, k, k, border=border)


_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL_DIFF = np.array([-1.0, 0.0, 1.0], np.float32)


def sobel(x: torch.Tensor, axis: str) -> torch.Tensor:
    """cv2.Sobel 3x3: axis 'x' -> d/dx, 'y' -> d/dy."""
    if axis == "x":
        return sep_filter2d(x, _SOBEL_DIFF, _SOBEL_SMOOTH)
    if axis == "y":
        return sep_filter2d(x, _SOBEL_SMOOTH, _SOBEL_DIFF)
    raise ValueError("axis must be 'x' or 'y'")


_LAPLACIAN_K1 = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)


def laplacian(x: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian(ksize=1): kernel [[0,1,0],[1,-4,1],[0,1,0]]."""
    return filter2d(x, _LAPLACIAN_K1)
