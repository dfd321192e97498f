"""SPAN, the Swift Parameter-free Attention Network for SR (port of
``vfisr_tpu/models/sota/span.py``), in its inference (re-parameterized)
form: six SPAB blocks of three 3x3 convs with SiLU and the parameter-free
attention ``sigmoid(out3) - 0.5``, a 1x1 aggregation over (first feature,
final feature, block 1's first conv, block 5's), and a 3x3 upsampler
conv followed by depth-to-space. 48 features, x2 and x4
(weights/span_x2.npz, weights/span_x4.npz).

The depth-to-space is the reference's: the upsampler's 3*r*r output
channels read as (r, r, 3), row offset, column offset, colour
(``span.py:78-82``, NHWC). ``F.pixel_shuffle`` reads NCHW channels as
(3, r, r), so ``depth_to_space`` here reshapes and permutes explicitly.

On the GPU every conv runs f32 (``load`` turns TF32 off) with cuDNN's
plan, but ``conv_cat``, which goes through ``models/base.py::planned_conv``:
cuDNN's plan was measured to lose at 1080p and to win at the trainer's
shapes (batch 16, crop 192; PERF.md §5), and a shape never measured runs
without it.

``SPANModel`` follows the reference's contract: the fixed x2 or x4 net,
then Lanczos4 to the exact target size, clipped to [0, 1]; interpolation
is the baselines' crossfade. ``create_rife_span`` and
``create_vfimamba_span`` are the two-stage models of the registry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfisr_tpu_torch.core.frames import from_batched, to_batched
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.models.base import BaseModel, ModelInfo, TwoStageModel, planned_conv


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """NCHW [N, r*r*C, H, W] -> NHWC [N, r*H, r*W, C], the channel axis read
    as (r, r, C) as the reference's NHWC reshape reads it."""
    n, rrc, h, w = x.shape
    c = rrc // (r * r)
    return x.reshape(n, r, r, c, h, w).permute(0, 4, 1, 5, 2, 3).reshape(n, h * r, w * r, c)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1)


class SPAB(nn.Module):
    """Swift parameter-free attention block; NCHW. Returns (out, out1)."""

    def __init__(self, c: int):
        super().__init__()
        self.c1, self.c2, self.c3 = _conv3(c, c), _conv3(c, c), _conv3(c, c)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out1 = self.c1(x)
        out3 = self.c3(F.silu(self.c2(F.silu(out1))))
        return (out3 + x) * (torch.sigmoid(out3) - 0.5), out1


class SPANNet(nn.Module):
    """NHWC [N,H,W,3] -> NHWC [N, r*H, r*W, 3]."""

    def __init__(self, feature_channels: int = 48, upscale: int = 2):
        super().__init__()
        c = feature_channels
        self.upscale = upscale
        self.conv_1 = _conv3(3, c)
        for i in range(1, 7):
            setattr(self, f"block_{i}", SPAB(c))
        self.conv_2 = _conv3(c, c)
        self.conv_cat = nn.Conv2d(4 * c, c, 1)
        self.upsampler = _conv3(c, 3 * upscale ** 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv_1(x.permute(0, 3, 1, 2))
        h, b1 = self.block_1(feat)
        h, _ = self.block_2(h)
        h, _ = self.block_3(h)
        h, _ = self.block_4(h)
        h, b5 = self.block_5(h)
        final = self.conv_2(self.block_6(h)[0])
        agg = planned_conv(self.conv_cat, torch.cat([feat, final, b1, b5], dim=1))
        return depth_to_space(self.upsampler(agg), self.upscale)


class SPANModel(BaseModel):
    """SPAN SR model: the x2 or x4 net, then Lanczos4 to the target size."""

    def __init__(self, scale: int = 2, device: str = "cuda", seed: int = 0):
        super().__init__(device)
        self.scale = scale
        self.seed = seed
        self.module: Optional[SPANNet] = None

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(name=f"SPAN_x{self.scale}", type="sota", supports_vfi=False,
                         supports_sr=True, supports_joint=False,
                         parameters=self._param_count(), requires_gpu=True,
                         description="Swift Parameter-free Attention Network for SR")

    def _param_count(self) -> int:
        if self.module is None:
            return 400_000  # the reference's nominal count before load
        return int(sum(p.numel() for p in self.module.parameters()))

    def load(self, weights_path: Optional[str] = None) -> None:
        """Build the net (seeded init) and load ``weights_path``, or
        ``weights/span_x<scale>.npz`` when it exists and no path is given;
        strict: every parameter checked against the file. Sets cuDNN and
        matmul TF32 off."""
        from vfisr_tpu_torch.utils.checkpoint import load_into
        from vfisr_tpu_torch.utils.paths import default_weights

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if weights_path is None:
            weights_path = default_weights(f"span_x{self.scale}")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = SPANNet(upscale=self.scale)
        if weights_path:
            load_into(module, weights_path)
        self.module = module.to(self.device).eval().requires_grad_(False)
        self._loaded = True

    def trainable(self) -> SPANNet:
        """The loaded module in training mode, every parameter requiring a
        gradient (``load`` leaves it frozen for inference)."""
        if self.module is None:
            raise RuntimeError("load() the model before training it")
        return self.module.train().requires_grad_(True)

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                          timestamps: Tuple[float, ...]) -> torch.Tensor:
        """SPAN does not interpolate: the linear crossfade."""
        from vfisr_tpu_torch.models.traditional.baselines import _crossfade_batch

        return _crossfade_batch(x0, x1, tuple(timestamps))

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        """[N,H,W,3] -> [N,H',W',3]: the net, Lanczos4 to ``scale_size``
        where the net's size differs, clipped to [0, 1]."""
        h, w = x.shape[-3:-1]
        with torch.no_grad():
            up = self.module(x)
        target = scale_size(h, w, scale)
        if tuple(up.shape[-3:-1]) != target:
            up = resize(up, target, "lanczos4")
        return torch.clamp(up, 0.0, 1.0)

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        self.ensure_loaded()
        return from_batched(self.upscale_batch(to_batched(frame, self.device), scale))


def create_rife_span(device: str = "cuda") -> TwoStageModel:
    """RIFE VFI, then SPAN x2 SR."""
    from vfisr_tpu_torch.models.sota.rife import RIFEModel

    return TwoStageModel(RIFEModel(device=device), SPANModel(device=device), device=device)


def create_vfimamba_span(device: str = "cuda") -> TwoStageModel:
    """VFIMamba VFI, then SPAN x2 SR."""
    from vfisr_tpu_torch.models.sota.vfimamba import VFIMambaModel

    return TwoStageModel(VFIMambaModel(device=device), SPANModel(device=device), device=device)
