"""SAFA-style joint VFI+SR (port of ``vfisr_tpu/models/sota/safa.py``).

One pass takes a frame pair and a timestep to the intermediate frame at 2x
resolution: a shared stride-4 encoder (``Conv_0..2``, 176 channels) on both
frames; two flow-head stages at 1/4 resolution, each warping both frames'
features by the current bidirectional flow and adding a conv head's
residual to the flow and the fusion mask; full-resolution frame warps and
their mask blend; the features warped once more, a decoder of 8 residual
blocks at 1/4, upsampled to full resolution, joined with the blend and both
warped frames, and a pixel-shuffle head whose x2 residual is added to the
bilinearly upsampled blend. ``SAFAModel`` resamples to the exact target
scale with Lanczos4, and above ``tile_px_budget`` input pixels runs the
forward on overlapping tiles blended under a linear seam ramp (a 1080p pair
is 12 tiles of 360x480 with a 48 px border).

Warps: all eight of a forward go through ``core/warp.py::backward_warp``
with the replicate border, radius 8 and f32 windows, the TPU's semantics:
on the GPU the windowed CUDA kernel (K1; the 176-channel feature warps take
its channel groups), on the CPU the exact warp, as the reference does off
the TPU. The feature flows are clamped to +-``feat_warp_clamp`` first, with
``jnp.clip``'s gradient (half at a flow on the bound, as
``torch.maximum``/``minimum`` give it; ``torch.clamp`` gives all of it).
Inference runs under ``torch.no_grad()``. Training (``SAFAModel.trainable``,
``python -m vfisr_tpu_torch.train --model safa``) differentiates the feature
warps as the reference does: the flow gradient from K2 (in channel groups
at 176 channels), the features' gradient from the dense shifted adjoint
(``img_grad='shifted:R'``, R = ceil(feat_warp_clamp)).

Convolutions run f32 (``load`` turns TF32 off). Which leave cuDNN is
decided per input shape, by ``models/base.py::planned_conv``, from the
timings of each conv shape forward and backward with cuDNN and without on
an H100 80GB HBM3 at 700 W (chip_smoke.py's conv lines; PERF.md §5): the
176-channel convs at 1/4 resolution (``Conv_2``, the flow stages'
``_a``/``_b``, the decoder) and ``dec_c`` go through it. On 1080p tiles
(batch 3, 114x144 at 1/4) all of them run without cuDNN: its heuristic
plans took 24-361 ms and 17-34 GB of workspace per conv there, where
PyTorch's own convolution takes 1-2 ms. At the trainer's shapes (batch 16,
crop 192: 48x48 at 1/4) cuDNN's plans win at the 176->176 convs, so only
``flow*_a``, ``dec_a`` and ``dec_c`` leave it; a shape never measured
leaves it too. Every backward runs with cuDNN, which won at every training
shape. The encoder's strided convs and the 5- and 12-channel heads keep
cuDNN.

Flax conventions kept: ``nn.Conv(padding=1)`` pads symmetrically, also at
stride 2; every ``jax.image.resize(..., "bilinear")`` here is an upsampling
and equals ``F.interpolate(bilinear, align_corners=False)``; the pixel
shuffle reads channels as (2, 2, 3) (``span.depth_to_space``); module names
mirror the Flax tree, so ``utils.checkpoint.params_from_jax`` loads
weights/safa.npz as it is.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfisr_tpu_torch.core.frames import (from_batched, pad_reflect, pad_to_multiple, to_batched,
                                         unpad)
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.models.base import JointModel, ModelInfo, planned_conv, upscale_frame
from vfisr_tpu_torch.models.sota.span import depth_to_space
from vfisr_tpu_torch.models.sota.vfimamba import _nchw, _nhwc, _upsample


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class SAFANet(nn.Module):
    """(img0, img1 NHWC [N,H,W,3] in [0, 1], timestep [N]) -> the frame at
    that timestep at 2x resolution, NHWC [N, 2H, 2W, 3]."""

    def __init__(self, c: int = 176, num_dec_blocks: int = 8, feat_warp_clamp: float = 8.0):
        super().__init__()
        self.c, self.num_dec_blocks = c, num_dec_blocks
        self.feat_warp_clamp = float(feat_warp_clamp)
        conv = nn.Conv2d
        self.Conv_0 = conv(3, c // 2, 3, stride=2, padding=1)
        self.Conv_1 = conv(c // 2, c, 3, stride=2, padding=1)
        self.Conv_2 = conv(c, c, 3, padding=1)
        for i in range(2):
            setattr(self, f"flow{i}_a", conv(2 * c + 6, c, 3, padding=1))
            setattr(self, f"flow{i}_b", conv(c, c, 3, padding=1))
            setattr(self, f"flow{i}_head", conv(c, 5, 3, padding=1))
        self.dec_a = conv(2 * c + 1, c, 3, padding=1)
        for i in range(num_dec_blocks):
            setattr(self, f"dec_b{i}", conv(c, c, 3, padding=1))
        self.dec_c = conv(c + 9, c, 3, padding=1)
        self.ps_head = conv(c, 12, 3, padding=1)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW frame -> NHWC features at 1/4 (contiguous: the warps read
        them as they are)."""
        f = planned_conv(self.Conv_2, _lrelu(self.Conv_1(_lrelu(self.Conv_0(x)))))
        return _nhwc(f).contiguous()

    def _feat_warp(self, f: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """NHWC features by an NCHW 2-channel flow clipped to the feature
        clamp (as ``jnp.clip``, gradient included) -> NCHW view."""
        bound = flow.new_tensor(self.feat_warp_clamp)
        fl = _nhwc(torch.minimum(torch.maximum(flow, -bound), bound)).contiguous()
        return _nchw(backward_warp(f, fl, 1.0, border="replicate",
                                   img_grad=f"shifted:{math.ceil(self.feat_warp_clamp)}"))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = img0.shape
        f0, f1 = self.encode(_nchw(img0)), self.encode(_nchw(img1))
        h4, w4 = f0.shape[1:3]
        t_map4 = timestep.to(img0.dtype).reshape(-1, 1, 1, 1).expand(n, 1, h4, w4)

        flow = img0.new_zeros((n, 4, h4, w4))
        mask = img0.new_zeros((n, 1, h4, w4))
        for i in range(2):
            inp = torch.cat([self._feat_warp(f0, flow[:, 0:2]), self._feat_warp(f1, flow[:, 2:4]),
                             t_map4, mask, flow], dim=1)
            hdd = _lrelu(planned_conv(getattr(self, f"flow{i}_a"), inp))
            hdd = _lrelu(planned_conv(getattr(self, f"flow{i}_b"), hdd)) + hdd
            out = getattr(self, f"flow{i}_head")(hdd)
            flow = flow + out[:, :4]
            mask = mask + out[:, 4:5]

        flow_full = _upsample(flow, (h, w)) * 4.0
        mask_full = _nhwc(torch.sigmoid(_upsample(mask, (h, w))))
        warped0 = backward_warp(img0, _nhwc(flow_full[:, 0:2]).contiguous(), 1.0,
                                border="replicate")
        warped1 = backward_warp(img1, _nhwc(flow_full[:, 2:4]).contiguous(), 1.0,
                                border="replicate")
        fused = warped0 * mask_full + warped1 * (1.0 - mask_full)

        agg = torch.cat([self._feat_warp(f0, flow[:, 0:2]), self._feat_warp(f1, flow[:, 2:4]),
                         t_map4], dim=1)
        d = _lrelu(planned_conv(self.dec_a, agg))
        for i in range(self.num_dec_blocks):
            d = _lrelu(planned_conv(getattr(self, f"dec_b{i}"), d)) + d
        d = torch.cat([_upsample(d, (h, w)), _nchw(fused), _nchw(warped0), _nchw(warped1)], dim=1)
        d = _lrelu(planned_conv(self.dec_c, d))
        out = depth_to_space(self.ps_head(d), 2)
        base = _nhwc(_upsample(_nchw(fused), (2 * h, 2 * w)))
        return torch.clamp(base + out, 0.0, 1.0)


def _ramp(size2x: int, ov: int, device) -> torch.Tensor:
    """The seam ramp of a tile's 2x output along one axis: 1/(2ov) up to 1
    over 2ov px at each end, 1 inside."""
    e = 2 * ov
    up = torch.linspace(1.0 / e, 1.0, e, device=device)
    return torch.cat([up, torch.ones(size2x - 2 * e, device=device), up.flip(0)])


class SAFAModel(JointModel):
    """Joint VFI+SR in one pass, spatially tiled above ``tile_px_budget``
    input pixels (the decoder carries 176-channel full-resolution
    features)."""

    TILE_HW = (360, 480)
    OVERLAP = 48  # >= the decoder's receptive field + 4 * feat_warp_clamp

    def __init__(self, device: str = "cuda", seed: int = 0, feat_warp_clamp: float = 8.0,
                 tile_px_budget: int = 700_000):
        super().__init__(device)
        self.seed = seed
        self.feat_warp_clamp = feat_warp_clamp
        self.tile_px_budget = int(tile_px_budget)
        self.module: Optional[SAFANet] = None

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(name="SAFA", type="sota", supports_vfi=True, supports_sr=True,
                         supports_joint=True, parameters=self._param_count(), requires_gpu=True,
                         description="Scale-adaptive joint VFI+SR (single-pass space-time "
                                     "upscaling)")

    def _param_count(self) -> int:
        if self.module is None:
            return 5_500_000  # the reference's nominal count before load
        return int(sum(p.numel() for p in self.module.parameters()))

    def load(self, weights_path: Optional[str] = None) -> None:
        """Build the net (seeded init) and load ``weights_path``, or
        weights/safa.npz when it exists and no path is given; strict:
        every parameter checked against the file. Sets cuDNN and matmul
        TF32 off."""
        from vfisr_tpu_torch.utils.checkpoint import load_into
        from vfisr_tpu_torch.utils.paths import default_weights

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if weights_path is None:
            weights_path = default_weights("safa")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = SAFANet(feat_warp_clamp=self.feat_warp_clamp)
        if weights_path:
            load_into(module, weights_path)
        self.module = module.to(self.device).eval().requires_grad_(False)
        self._loaded = True

    def trainable(self) -> SAFANet:
        """The loaded module in training mode, every parameter requiring a
        gradient (``load`` leaves it frozen for inference)."""
        if self.module is None:
            raise RuntimeError("load() the model before training it")
        return self.module.train().requires_grad_(True)

    def net(self, x0: torch.Tensor, x1: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
        """One net call: [M,H,W,3] pairs and ts [M] -> [M, 2H, 2W, 3]."""
        with torch.no_grad():
            return self.module(x0, x1, ts)

    def _joint_2x_tiled(self, x0: torch.Tensor, x1: torch.Tensor, ts: torch.Tensor,
                        tile_hw: Tuple[int, int] = TILE_HW, overlap: int = OVERLAP
                        ) -> torch.Tensor:
        """[N,H,W,3] pair and ts [N*T] (pair-major) -> [N*T, 2H, 2W, 3]: the
        pair reflect-padded (as jnp.pad does), cut into tiles of tile_hw
        with ``overlap`` px of context on each side, each tile's 2x output
        accumulated under the seam ramp and the sum normalised."""
        n, h, w, _ = x0.shape
        t = ts.shape[0] // n
        th, tw = tile_hw
        ov = overlap
        gy, gx = -(-h // th), -(-w // tw)
        ph, pw = gy * th, gx * tw
        xp0 = pad_reflect(x0, ov, ph - h + ov, ov, pw - w + ov)
        xp1 = pad_reflect(x1, ov, ph - h + ov, ov, pw - w + ov)
        wt = (_ramp(2 * (th + 2 * ov), ov, x0.device)[:, None]
              * _ramp(2 * (tw + 2 * ov), ov, x0.device)[None, :])[None, :, :, None]
        accum = x0.new_zeros((n * t, 2 * (ph + 2 * ov), 2 * (pw + 2 * ov), 3), dtype=torch.float32)
        wsum = x0.new_zeros((1, accum.shape[1], accum.shape[2], 1), dtype=torch.float32)
        for iy in range(gy):
            for ix in range(gx):
                y0, xc = iy * th, ix * tw
                a = xp0[:, y0:y0 + th + 2 * ov, xc:xc + tw + 2 * ov]
                b = xp1[:, y0:y0 + th + 2 * ov, xc:xc + tw + 2 * ov]
                o = self.net(a.repeat_interleave(t, 0), b.repeat_interleave(t, 0), ts)
                rows = slice(2 * y0, 2 * y0 + o.shape[1])
                cols = slice(2 * xc, 2 * xc + o.shape[2])
                accum[:, rows, cols] += o * wt
                wsum[:, rows, cols] += wt
        out = accum / torch.clamp(wsum, min=1e-8)
        return out[:, 2 * ov:2 * ov + 2 * h, 2 * ov:2 * ov + 2 * w]

    def joint_batch(self, x0: torch.Tensor, x1: torch.Tensor, timestamps: Tuple[float, ...],
                    scale: float) -> torch.Tensor:
        """[N,H,W,3] pair -> [N,T,H',W',3] at the target scale, in one pass
        (tiled above ``tile_px_budget`` input pixels)."""
        n, h, w, _ = x0.shape
        t = len(timestamps)
        ts = torch.tensor(tuple(timestamps), dtype=x0.dtype, device=x0.device).repeat(n)
        if h * w > self.tile_px_budget:
            out2x = self._joint_2x_tiled(x0, x1, ts)
        else:
            x0p, _ = pad_to_multiple(x0, 16)
            x1p, _ = pad_to_multiple(x1, 16)
            out2x = unpad(self.net(x0p.repeat_interleave(t, 0), x1p.repeat_interleave(t, 0),
                                       ts), 2 * h, 2 * w)
        target = scale_size(h, w, scale)
        if tuple(out2x.shape[-3:-1]) != target:
            out2x = resize(out2x, target, "lanczos4")
        return out2x.reshape(n, t, *target, 3)

    def joint_process(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                      target_scale: float = 1.333) -> List[np.ndarray]:
        """Every frame of the pair (endpoints and intermediates) at the
        target scale, uint8."""
        self.ensure_loaded()
        ts = [0.0] + self.get_default_timestamps(num_intermediate) + [1.0]
        out = self.joint_batch(to_batched(frame0, self.device), to_batched(frame1, self.device),
                               tuple(ts), target_scale)
        return [from_batched(out[:, i]) for i in range(out.shape[1])]

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                          timestamps: Tuple[float, ...]) -> torch.Tensor:
        """VFI alone: the joint pass at scale 1.0."""
        return self.joint_batch(x0, x1, tuple(timestamps), 1.0)

    def interpolate(self, frame0: np.ndarray, frame1: np.ndarray, num_frames: int = 3,
                    timestamps=None) -> List[np.ndarray]:
        self.ensure_loaded()
        return super().interpolate(frame0, frame1, num_frames, timestamps)

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        return upscale_frame(frame, scale, "lanczos4", self.device)

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), "lanczos4")
