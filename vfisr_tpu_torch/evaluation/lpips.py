"""LPIPS with the AlexNet backbone (port of ``vfisr_tpu/evaluation/lpips.py``).

The LPIPS-v0.1 graph: AlexNet features at 5 taps (post-ReLU of conv1..conv5;
3x3 max pools with stride 2 and no padding after the first two), each
normalised to unit length over channels, squared differences weighted by
a non-negative linear head per tap, spatial means summed over the taps.

Weights, in the JAX package's layout (HWIO convs, ``lin{i}_w`` heads), so a
file it wrote loads here: the official weights from ``weights_path`` (which
must exist when given) or ``weights/lpips_alex.npz`` where that file exists
(mode ``official_weights``; ``load_official=False`` skips that file), else
the AlexNet drawn from a numpy seed (He init, ``_init_params``) with uniform
heads (``random_features``), or with the calibrated heads of
``weights/lpips_heads.npz`` (``calibrated_heads``).

On the GPU the five convs run in f32 with TF32 off (``LPIPS.__init__``
turns cuDNN's and matmul's TF32 off) through ``models/base.py::planned_conv``,
which takes cuDNN only at the shapes where its plan was measured to win.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.models.base import planned_conv
from vfisr_tpu_torch.utils.paths import REPO_ROOT

# (out_ch, kernel, stride, pad)
_ALEX_CFG = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
# LPIPS' ScalingLayer (input in [-1, 1])
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

DEFAULT_WEIGHTS_PATH = str(REPO_ROOT / "weights" / "lpips_alex.npz")
HEADS_PATH = str(REPO_ROOT / "weights" / "lpips_heads.npz")


def _init_params(seed: int = 0) -> dict:
    """Deterministic He-init AlexNet and uniform heads (random-features
    mode), drawn as the JAX package draws them."""
    rng = np.random.default_rng(seed)
    params = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX_CFG):
        fan_in = in_ch * k * k
        params[f"conv{i}_w"] = (
            rng.normal(0, np.sqrt(2.0 / fan_in), (k, k, in_ch, out_ch))
        ).astype(np.float32)
        params[f"conv{i}_b"] = np.zeros((out_ch,), np.float32)
        params[f"lin{i}_w"] = np.full((out_ch,), 1.0 / out_ch, np.float32)
        in_ch = out_ch
    return params


@functools.lru_cache(maxsize=32)
def _bilinear_weights(in_size: int, out_size: int, device: str) -> torch.Tensor:
    """[out, in] weights of ``jax.image.resize(..., "bilinear")`` along one
    axis: half-pixel centres, the triangle kernel widened by in/out when
    downsampling (antialiasing), each column normalised, in f32 as JAX
    computes them."""
    inv = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= in_size - 0.5))[None, :], w, 0)
    return torch.as_tensor(np.ascontiguousarray(w.T, np.float32), device=device)


def image_resize(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "bilinear")``: every axis whose size
    changes, antialiased where it shrinks."""
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in != n_out:
            w = _bilinear_weights(n_in, n_out, str(x.device))
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [1])), -1, d)
    return x


class _AlexFeatures(nn.Module):
    """AlexNet's five convs, NCHW, from HWIO parameters."""

    def __init__(self, params: dict):
        super().__init__()
        convs, in_ch = [], 3
        for i, (out_ch, k, stride, pad) in enumerate(_ALEX_CFG):
            conv = nn.Conv2d(in_ch, out_ch, k, stride, pad)
            with torch.no_grad():
                conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
                    np.transpose(np.asarray(params[f"conv{i}_w"], np.float32), (3, 2, 0, 1)))))
                conv.bias.copy_(torch.from_numpy(np.asarray(params[f"conv{i}_b"], np.float32)))
            convs.append(conv)
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)

    def forward(self, h: torch.Tensor) -> list:
        feats = []
        for i, conv in enumerate(self.convs):
            h = F.relu(planned_conv(conv, h))
            feats.append(h)
            if i in (0, 1):
                h = F.max_pool2d(h, 3, 2)
        return feats


class LPIPS:
    """Callable LPIPS distance. Frames: uint8 HWC RGB or [N,H,W,3] float
    [0,1] (numpy or tensors); the network lives on ``device``."""

    def __init__(self, weights_path: Optional[str] = None, seed: int = 0,
                 load_calibrated: bool = True, device: str = "cuda", load_official: bool = True):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = device
        if weights_path is not None and not os.path.exists(weights_path):
            raise FileNotFoundError(f"LPIPS weights {weights_path} not found")
        path = weights_path or DEFAULT_WEIGHTS_PATH
        if os.path.exists(path) and (load_official or weights_path is not None):
            data = np.load(path)
            self.params = {k: data[k] for k in data.files}
            self.mode = "official_weights"
        else:
            self.params = _init_params(seed)
            self.mode = "random_features"
            # the calibration (evaluation/lpips_calibrate.py) passes
            # load_official=False and load_calibrated=False: it fits heads
            # to the random features, and its baselines must not pick up
            # the heads it ships
            if load_calibrated and os.path.exists(HEADS_PATH):
                heads = np.load(HEADS_PATH)
                for k in heads.files:
                    if k.startswith("lin"):
                        self.params[k] = heads[k]
                self.mode = "calibrated_heads"
        self.net = _AlexFeatures(self.params).to(device).eval()
        self._lin = [torch.as_tensor(np.asarray(self.params[f"lin{i}_w"], np.float32),
                                     device=device).view(1, -1, 1, 1) for i in range(len(_ALEX_CFG))]
        self._shift = torch.as_tensor(_SHIFT, device=device).view(1, 3, 1, 1)
        self._scale = torch.as_tensor(_SCALE, device=device).view(1, 3, 1, 1)

    # ---- computation graph ----
    @torch.no_grad()
    def _features(self, x: torch.Tensor) -> list:
        """x: [N,H,W,3] in [-1,1] -> the 5 post-ReLU feature maps, NCHW."""
        return self.net((x.permute(0, 3, 1, 2) - self._shift) / self._scale)

    def _tap_maps(self, a: torch.Tensor, b: torch.Tensor) -> list:
        """Per tap, [N,h,w]: the head-weighted squared difference of the
        unit-normalised features of a and b (one pass over both)."""
        feats = self._features(torch.cat([a, b]))
        n = a.shape[0]
        maps = []
        for f, lin in zip(feats, self._lin):
            unit = f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            maps.append(torch.sum((unit[:n] - unit[n:]) ** 2 * lin, dim=1))
        return maps

    def _distance(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """[N]: the taps' spatial means, summed."""
        return sum(m.mean(dim=(1, 2)) for m in self._tap_maps(a, b))

    def _distance_map(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Spatial LPIPS map [N, h, w] at the first tap's size (each tap's
        map resized bilinearly to it and summed)."""
        maps = self._tap_maps(a, b)
        target = maps[0].shape
        return sum(image_resize(m, target) for m in maps)

    def flow_weighted(self, pred, gt, flow_mag) -> np.ndarray:
        """FloLPIPS-style distance: the spatial LPIPS map weighted by the
        normalised motion magnitude (Danier et al. 2022). flow_mag: [H, W]
        or [N, H, W]."""
        dmap = self._distance_map(self._prep(pred), self._prep(gt))
        m = to_device(flow_mag, self.device).float()
        if m.ndim == 2:
            m = m[None]
        m = image_resize(m, dmap.shape)
        wsum = torch.sum(m, dim=(1, 2), keepdim=True) + 1e-8
        return torch.sum(dmap * m / wsum, dim=(1, 2)).cpu().numpy()

    # ---- public API ----
    def __call__(self, pred, gt) -> np.ndarray:
        """LPIPS distance per batch element (HWC uint8 or NHWC float)."""
        return self._distance(self._prep(pred), self._prep(gt)).cpu().numpy()

    def _prep(self, x) -> torch.Tensor:
        arr = to_device(x, self.device)
        if arr.ndim == 3:
            arr = arr[None]
        if arr.is_floating_point():
            return arr.float() * 2.0 - 1.0
        return arr.float() / 127.5 - 1.0


@functools.lru_cache(maxsize=2)
def default_lpips(device: str = "cuda") -> LPIPS:
    """One ``LPIPS()`` per device, made at first use."""
    return LPIPS(device=device)
