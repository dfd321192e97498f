"""Frame layout/dtype conventions (port of ``vfisr_tpu/core/frames.py``).

Batched NHWC float tensors in [0, 1] on the device; uint8 HWC RGB at the
host boundary.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def to_float(frame, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> float [0, 1], any leading dims; a numpy array goes
    to a CPU tensor."""
    return torch.as_tensor(frame).to(dtype) / 255.0


def to_device(x, device="cuda") -> torch.Tensor:
    """A numpy array (any strides) or a tensor -> a tensor on ``device``;
    float64 narrows to float32, as ``jnp.asarray`` narrows it in the JAX
    package (64-bit mode off)."""
    if torch.is_tensor(x):
        t = x
    else:
        arr = np.ascontiguousarray(x)
        t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device)


def to_uint8(frame: torch.Tensor) -> torch.Tensor:
    """float [0, 1] -> uint8 [0, 255]: ``floor(x*255 + 0.5)`` clipped
    (round half up, OpenCV ``saturate_cast`` behaviour)."""
    x = frame.float() * 255.0
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def to_batched(frame, device="cuda") -> torch.Tensor:
    """HWC uint8 (numpy or tensor) -> 1HWC float32 [0, 1] on ``device``."""
    arr = torch.as_tensor(np.asarray(frame) if not torch.is_tensor(frame) else frame,
                          device=device)
    if arr.ndim == 2:
        arr = arr[..., None]
    return (arr.float() / 255.0)[None]


def from_batched(x: torch.Tensor) -> np.ndarray:
    """1HWC/NHWC float [0, 1] -> HWC uint8 numpy (the first frame of a batch)."""
    if x.ndim == 4:
        x = x[0]
    return to_uint8(x).cpu().numpy()


@functools.lru_cache(maxsize=64)
def _reflect_index(size: int, before: int, after: int, device) -> torch.Tensor:
    """Source indices of an axis of ``size`` reflect-padded by (before,
    after), the edge not repeated, reflecting again past the far edge as
    numpy's and jnp.pad's 'reflect' do for pads wider than the axis. Kept
    per shape and device: a stream pads every frame alike."""
    i = torch.arange(-before, size + after, device=device)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    m = torch.remainder(i, period)
    return torch.where(m < size, m, period - m)


def pad_reflect(x: torch.Tensor, top: int, bottom: int, left: int, right: int) -> torch.Tensor:
    """Reflect-pad the H and W axes of NHWC (or HWC) x, as
    ``jnp.pad(mode="reflect")`` does at any width (``F.pad`` refuses a pad
    as wide as the axis)."""
    h, w = x.shape[-3], x.shape[-2]
    x = x.index_select(-3, _reflect_index(h, top, bottom, x.device))
    return x.index_select(-2, _reflect_index(w, left, right, x.device))


def pad_to_multiple(x: torch.Tensor, multiple: int = 32
                    ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Reflect-pad NHWC (or HWC) so H, W are multiples of ``multiple``,
    bottom/right only. Returns (padded, (left, right, top, bottom))."""
    h, w = x.shape[-3], x.shape[-2]
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h == 0 and pad_w == 0:
        return x, (0, 0, 0, 0)
    # 'reflect' excludes the edge and reflects again past the far edge, as
    # jnp.pad's does at a pad as wide as the side
    return pad_reflect(x, 0, pad_h, 0, pad_w), (0, pad_w, 0, pad_h)


def unpad(x: torch.Tensor, original_h: int, original_w: int) -> torch.Tensor:
    """Crop NHWC/HWC back to the original spatial size."""
    return x[..., :original_h, :original_w, :]


def get_default_timestamps(num_frames: int) -> List[float]:
    """Evenly spaced timestamps in (0, 1): ``[(i+1)/(n+1)]``."""
    return [(i + 1) / (num_frames + 1) for i in range(num_frames)]
