"""Model contract (port of the parts of ``vfisr_tpu/models/base.py`` the
flagship uses): ``ModelInfo``, ``InferenceResult`` and ``device_peak_mb``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch


@dataclass
class ModelInfo:
    """Model metadata."""

    name: str
    type: str  # 'traditional', 'sota', 'novel'
    supports_vfi: bool
    supports_sr: bool
    supports_joint: bool
    parameters: Optional[int] = None
    requires_gpu: bool = True
    description: str = ""


@dataclass
class InferenceResult:
    """Result of one model call."""

    frames: List[np.ndarray]  # (H, W, C) uint8 RGB
    inference_time_ms: float
    vram_peak_mb: float
    model_used: str = ""
    extra_info: dict = field(default_factory=dict)


def device_peak_mb(device=None) -> float:
    """Peak CUDA memory allocated by this process, in MB
    (``torch.cuda.max_memory_allocated``); 0.0 without a GPU."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e6
