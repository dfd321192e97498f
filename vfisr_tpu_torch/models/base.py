"""Model contract (port of ``vfisr_tpu/models/base.py``): ``ModelInfo``,
``InferenceResult``, the peak-memory helpers, and ``BaseModel`` with its
``JointModel`` and ``TwoStageModel`` kinds.

Subclasses implement batched device cores (``interpolate_batch`` /
``upscale_batch`` over NHWC float tensors in [0, 1] with a tuple of
timestamps); the per-frame numpy API (``interpolate``, ``upscale``,
``process_pair``) adapts at the host boundary, as in the reference.
Entry points default to ``device="cuda"``.
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.frames import from_batched, get_default_timestamps, to_batched
from vfisr_tpu_torch.core.resize import resize, scale_size


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


def reset_peak() -> None:
    """Start a new peak for ``device_peak_mb`` (harnesses call it at the
    start of each model's run, so one model's peak does not carry into the
    next one's)."""
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()


def device_peak_mb(device=None) -> float:
    """Peak CUDA memory allocated by this process on ``device`` (the current
    one when None), in MB (``torch.cuda.max_memory_allocated``); 0.0 without
    a GPU or for a CPU device."""
    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 1e6


def upscale_frame(frame: np.ndarray, scale: float, method: str, device) -> np.ndarray:
    """One HWC uint8 frame resized by ``scale`` as uint8 (OpenCV saturate
    rounding), the reference models' ``upscale``."""
    h, w = frame.shape[:2]
    return resize(torch.as_tensor(np.asarray(frame), device=device), scale_size(h, w, scale),
                  method).cpu().numpy()


class BaseModel(ABC):
    """Abstract base of every model."""

    def __init__(self, device: str = "cuda"):
        self.device = torch.device(device)
        self._loaded = False

    @property
    @abstractmethod
    def info(self) -> ModelInfo:
        """Model information."""

    @abstractmethod
    def load(self) -> None:
        """Load or initialise the weights; called once before inference."""

    def interpolate(self, frame0: np.ndarray, frame1: np.ndarray, num_frames: int = 3,
                    timestamps: Optional[List[float]] = None) -> List[np.ndarray]:
        """Two uint8 HWC RGB frames -> the intermediate frames, over the
        batched core."""
        if timestamps is None:
            timestamps = self.get_default_timestamps(num_frames)
        out = self.interpolate_batch(to_batched(frame0, self.device),
                                     to_batched(frame1, self.device), tuple(timestamps))
        return [from_batched(out[:, i]) for i in range(out.shape[1])]

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        """One uint8 HWC RGB frame upscaled by ``scale``."""
        return from_batched(self.upscale_batch(to_batched(frame, self.device), scale))

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                          timestamps: Tuple[float, ...]) -> torch.Tensor:
        """[N,H,W,3] float pair -> [N,T,H,W,3] float. Subclasses override."""
        raise NotImplementedError

    def upscale_batch(self, x: torch.Tensor, scale: float) -> torch.Tensor:
        """[N,H,W,3] float -> [N,H',W',3] float. Subclasses override."""
        raise NotImplementedError

    def process_pair(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                     target_scale: float = 1.333) -> InferenceResult:
        """Interpolate, then upscale every frame, timed: [up(frame0),
        up(mid_1..n), up(frame1)]."""
        if not self._loaded:
            raise RuntimeError(f"Model {self.info.name} not loaded. Call load() first.")
        start = time.perf_counter()
        interpolated = self.interpolate(frame0, frame1, num_intermediate)
        upscaled = [self.upscale(f, target_scale) for f in [frame0, *interpolated, frame1]]
        return InferenceResult(frames=upscaled,
                               inference_time_ms=(time.perf_counter() - start) * 1000,
                               vram_peak_mb=device_peak_mb(self.device), model_used=self.info.name)

    def ensure_loaded(self) -> None:
        if not self._loaded:
            self.load()
            self._loaded = True

    def get_default_timestamps(self, num_frames: int) -> List[float]:
        return get_default_timestamps(num_frames)


class JointModel(BaseModel):
    """Base of joint VFI+SR models (one pass gives every frame at the target
    scale)."""

    @abstractmethod
    def joint_process(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                      target_scale: float = 1.333) -> List[np.ndarray]:
        """All frames at the target scale."""

    def process_pair(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                     target_scale: float = 1.333) -> InferenceResult:
        if not self._loaded:
            raise RuntimeError(f"Model {self.info.name} not loaded. Call load() first.")
        start = time.perf_counter()
        frames = self.joint_process(frame0, frame1, num_intermediate, target_scale)
        return InferenceResult(frames=frames,
                               inference_time_ms=(time.perf_counter() - start) * 1000,
                               vram_peak_mb=device_peak_mb(self.device), model_used=self.info.name)


class TwoStageModel(BaseModel):
    """A VFI model followed by an SR model."""

    def __init__(self, vfi_model: BaseModel, sr_model: BaseModel, device: str = "cuda"):
        super().__init__(device)
        self.vfi_model = vfi_model
        self.sr_model = sr_model

    @property
    def info(self) -> ModelInfo:
        vfi, sr = self.vfi_model.info, self.sr_model.info
        return ModelInfo(
            name=f"{vfi.name}+{sr.name}",
            type="sota" if "sota" in (vfi.type, sr.type) else vfi.type,
            supports_vfi=True, supports_sr=True, supports_joint=False,
            parameters=(vfi.parameters or 0) + (sr.parameters or 0),
            requires_gpu=vfi.requires_gpu or sr.requires_gpu,
            description=f"Two-stage: {vfi.name} VFI + {sr.name} SR")

    def load(self) -> None:
        self.vfi_model.ensure_loaded()
        self.sr_model.ensure_loaded()
        self._loaded = True

    def interpolate(self, frame0, frame1, num_frames=3, timestamps=None):
        return self.vfi_model.interpolate(frame0, frame1, num_frames, timestamps)

    def upscale(self, frame, scale: float = 1.333):
        return self.sr_model.upscale(frame, scale)

    def process_pair(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                     target_scale: float = 1.333) -> InferenceResult:
        if not self._loaded:
            raise RuntimeError(f"Model {self.info.name} not loaded. Call load() first.")
        start = time.perf_counter()
        interpolated = self.interpolate(frame0, frame1, num_intermediate)
        t_vfi = (time.perf_counter() - start) * 1000
        t_sr0 = time.perf_counter()
        upscaled = [self.upscale(f, target_scale) for f in [frame0, *interpolated, frame1]]
        end = time.perf_counter()
        return InferenceResult(frames=upscaled, inference_time_ms=(end - start) * 1000,
                               vram_peak_mb=device_peak_mb(self.device), model_used=self.info.name,
                               extra_info={"vfi_time_ms": t_vfi,
                                           "sr_time_ms": (end - t_sr0) * 1000})
