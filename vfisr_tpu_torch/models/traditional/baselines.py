"""Traditional (non-learned) baselines (port of
``vfisr_tpu/models/traditional/baselines.py``).

- Bicubic and Lanczos: a linear crossfade ``(1-t)*f0 + t*f1`` for VFI,
  floored to the 1/255 grid (the reference blends in float and truncates to
  uint8), and OpenCV-parity cubic or Lanczos4 resize for SR.
- OpticalFlowVFI: Farneback flow both ways (0.5/3/15/3/5/1.2), each frame
  warped by its flow scaled by t or 1-t with the reflect border, blended by
  distance and floored to the 1/255 grid; Lanczos4 SR.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.core.warp import flow_warp
from vfisr_tpu_torch.models.base import BaseModel, ModelInfo, upscale_frame
from vfisr_tpu_torch.ops.flow import farneback_flow


def _crossfade_batch(x0: torch.Tensor, x1: torch.Tensor,
                     timestamps: Tuple[float, ...]) -> torch.Tensor:
    """[N,H,W,3] pair -> [N,T,H,W,3] linear blends on the 1/255 grid."""
    ts = torch.tensor(timestamps, dtype=x0.dtype, device=x0.device).reshape(1, -1, 1, 1, 1)
    blend = x0[:, None] * (1.0 - ts) + x1[:, None] * ts
    return torch.floor(blend * 255.0) / 255.0


def _flow_vfi_batch(x0: torch.Tensor, x1: torch.Tensor,
                    timestamps: Tuple[float, ...]) -> torch.Tensor:
    """Bidirectional-Farneback VFI: [N,H,W,3] pair -> [N,T,H,W,3]."""
    g0, g1 = rgb_to_gray(x0 * 255.0), rgb_to_gray(x1 * 255.0)
    flow_fwd = farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2)
    flow_bwd = farneback_flow(g1, g0, 0.5, 3, 15, 3, 5, 1.2)
    outs = []
    for t in timestamps:
        warped0 = flow_warp(x0, flow_fwd, t, border="reflect")
        warped1 = flow_warp(x1, flow_bwd, 1.0 - t, border="reflect")
        outs.append(torch.floor((warped0 * (1.0 - t) + warped1 * t) * 255.0) / 255.0)
    return torch.stack(outs, dim=1)


class _Traditional(BaseModel):
    """No weights: SR by ``SR_METHOD`` (uint8 frames resized as uint8)."""

    SR_METHOD = "lanczos4"

    def load(self) -> None:
        """Sets cuDNN and matmul TF32 off: the f32 resize and Farneback
        convs keep the reference's f32 semantics."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self._loaded = True

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), self.SR_METHOD)

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        return upscale_frame(frame, scale, self.SR_METHOD, self.device)


class BicubicBaseline(_Traditional):
    """Crossfade VFI + bicubic SR."""

    SR_METHOD = "cubic"
    NAME = "Bicubic"
    DESC = "Bicubic interpolation - simplest baseline"

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(name=self.NAME, type="traditional", supports_vfi=False, supports_sr=True,
                         supports_joint=False, parameters=0, requires_gpu=False,
                         description=self.DESC)

    def interpolate_batch(self, x0, x1, timestamps):
        return _crossfade_batch(x0, x1, tuple(timestamps))


class LanczosBaseline(BicubicBaseline):
    """Crossfade VFI + Lanczos4 SR."""

    SR_METHOD = "lanczos4"
    NAME = "Lanczos"
    DESC = "Lanczos interpolation - higher quality traditional SR"


class OpticalFlowVFI(_Traditional):
    """Farneback optical-flow VFI + Lanczos4 SR."""

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(name="OpticalFlow_Farneback", type="traditional", supports_vfi=True,
                         supports_sr=True, supports_joint=False, parameters=0,
                         requires_gpu=False, description="Farneback optical flow - traditional VFI")

    def interpolate_batch(self, x0, x1, timestamps):
        return _flow_vfi_batch(x0, x1, tuple(timestamps))


def get_traditional_models() -> dict:
    """name -> class."""
    return {"bicubic": BicubicBaseline, "lanczos": LanczosBaseline,
            "optical_flow": OpticalFlowVFI}
