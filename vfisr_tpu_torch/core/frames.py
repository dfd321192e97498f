"""Frame layout/dtype conventions (port of ``vfisr_tpu/core/frames.py``).

Batched NHWC float tensors in [0, 1] on the device; uint8 HWC RGB at the
host boundary.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def to_float(frame, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [0, 255] -> float [0, 1], any leading dims; a numpy array goes
    to a CPU tensor."""
    return torch.as_tensor(frame).to(dtype) / 255.0


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


def pad_to_multiple(x: torch.Tensor, multiple: int = 32
                    ) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """Reflect-pad NHWC (or HWC) so H, W are multiples of ``multiple``,
    bottom/right only. Returns (padded, (left, right, top, bottom))."""
    h, w = x.shape[-3], x.shape[-2]
    pad_h = (multiple - h % multiple) % multiple
    pad_w = (multiple - w % multiple) % multiple
    if pad_h == 0 and pad_w == 0:
        return x, (0, 0, 0, 0)
    squeeze = x.ndim == 3
    x4 = x[None] if squeeze else x
    # 'reflect' excludes the edge, as numpy's and jnp.pad's 'reflect' do
    padded = F.pad(x4.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h), mode="reflect")
    padded = padded.permute(0, 2, 3, 1)
    return (padded[0] if squeeze else padded), (0, pad_w, 0, pad_h)


def unpad(x: torch.Tensor, original_h: int, original_w: int) -> torch.Tensor:
    """Crop NHWC/HWC back to the original spatial size."""
    return x[..., :original_h, :original_w, :]


def get_default_timestamps(num_frames: int) -> List[float]:
    """Evenly spaced timestamps in (0, 1): ``[(i+1)/(n+1)]``."""
    return [(i + 1) / (num_frames + 1) for i in range(num_frames)]
