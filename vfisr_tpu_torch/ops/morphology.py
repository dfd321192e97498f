"""Morphology with all-ones square elements (port of
``vfisr_tpu/ops/morphology.py``, the parts the flagship uses).

'SAME' windows whose padding never wins: dilation pads with -inf (max
pooling's implicit padding), erosion with +inf. Inputs are [..., H, W].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _max_window(x: torch.Tensor, ksize: int) -> torch.Tensor:
    shape = x.shape
    x4 = x.reshape(-1, 1, *shape[-2:])
    return F.max_pool2d(x4, ksize, stride=1, padding=ksize // 2).reshape(shape)


def dilate(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """cv2.dilate with a ksize x ksize all-ones element."""
    return _max_window(x.float(), ksize).to(x.dtype)


def erode(x: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    """cv2.erode (non-shrinking border)."""
    return (-_max_window(-x.float(), ksize)).to(x.dtype)


def morph_close(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Dilate then erode (cv2.MORPH_CLOSE)."""
    return erode(dilate(x, ksize), ksize)


def morph_open(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """Erode then dilate (cv2.MORPH_OPEN)."""
    return dilate(erode(x, ksize), ksize)
