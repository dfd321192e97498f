"""RIFE-style IFNet (port of ``vfisr_tpu/models/sota/rife.py``).

Coarse-to-fine pyramid of IFBlocks at scales (8, 4, 2, 1); each block
refines a bidirectional flow (F_t->0, F_t->1) and a fusion mask from the
warped inputs and the timestep map; the output is
sigmoid(mask)*warp(I0) + (1-sigmoid(mask))*warp(I1). Warps go through
``backward_warp`` with the replicate border: the windowed CUDA kernel on the
GPU, with the radii and window dtype of the config.

Public functions take and return NHWC tensors; inside, the network runs in
NCHW. Module names mirror Flax's (``block0.Conv_0``), so
``utils.checkpoint.params_from_jax`` loads ``weights/rife.npz`` directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfisr_tpu_torch.core.frames import from_batched, pad_to_multiple, to_batched, unpad
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.models.base import BaseModel, ModelInfo, upscale_frame


@dataclass(frozen=True)
class RIFEConfig:
    scales: Tuple[int, ...] = (8, 4, 2, 1)
    channels: Tuple[int, ...] = (256, 160, 112, 80)
    num_convs: int = 8
    # the residual head on the fused frame (``RefineNet``); off in every
    # shipped checkpoint
    refine: bool = False
    # warp block inputs at each level's own resolution, never finer than
    # min_warp_scale; the final fusion warps run at full resolution
    warp_at_level: bool = True
    min_warp_scale: int = 2
    # windowed-warp residual radii (ry, rx) of the level and final warps
    level_warp_radius: Tuple[int, int] = (2, 4)
    final_warp_radius: Tuple[int, int] = (4, 6)
    dtype: torch.dtype = torch.float32
    warp_dtype: torch.dtype = torch.bfloat16


def _up2_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact 2x bilinear upsample along one axis (half-pixel, edge-clamped):
    out[2k] = 0.25*in[k-1] + 0.75*in[k], out[2k+1] = 0.75*in[k] + 0.25*in[k+1]."""
    n = x.shape[axis]
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1)
    xp = torch.cat([first, x, last], dim=axis)
    lo = xp.narrow(axis, 0, n)
    mid = xp.narrow(axis, 1, n)
    hi = xp.narrow(axis, 2, n)
    even = 0.25 * lo + 0.75 * mid
    odd = 0.75 * mid + 0.25 * hi
    y = torch.stack([even, odd], dim=axis + 1)
    return y.reshape(*x.shape[:axis], 2 * n, *x.shape[axis + 1:])


def _resize_bilinear(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with jax.image.resize semantics (half-pixel;
    antialiased when downsampling)."""
    h, w = x.shape[-2:]
    if tuple(hw) == (h, w):
        return x
    if tuple(hw) == (2 * h, 2 * w):
        return _up2_axis(_up2_axis(x, x.ndim - 2), x.ndim - 1)
    return F.interpolate(x.float(), size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True).to(x.dtype)


def _halve(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pool, the pyramid downsample."""
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) * 0.25


def _build_pyramid(x: torch.Tensor, max_down: int) -> dict:
    pyr = {1: x}
    s = 1
    while s < max_down:
        pyr[s * 2] = _halve(pyr[s])
        s *= 2
    return pyr


def _lrelu(x):
    return F.leaky_relu(x, negative_slope=0.2)


def _warp_nchw(img: torch.Tensor, flow: torch.Tensor, radius, warp_dtype) -> torch.Tensor:
    """backward_warp on NCHW tensors (the warp takes NHWC)."""
    out = backward_warp(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), 1.0,
                        border="replicate", radius=radius, compute_dtype=warp_dtype)
    return out.permute(0, 3, 1, 2)


class IFBlock(nn.Module):
    """One pyramid level: stride-4 encoder, residual conv trunk, upsampling
    head. Returns [N, 5, H, W]: flow delta (4) + mask delta (1)."""

    def __init__(self, in_ch: int, c: int, num_convs: int = 8):
        super().__init__()
        self.num_convs = num_convs
        self.add_module("Conv_0", nn.Conv2d(in_ch, c // 2, 3, stride=2, padding=1))
        self.add_module("Conv_1", nn.Conv2d(c // 2, c, 3, stride=2, padding=1))
        for j in range(num_convs):
            self.add_module(f"Conv_{2 + j}", nn.Conv2d(c, c, 3, padding=1))
        # Flax ConvTranspose(5, (4,4), strides=2, padding=1): output 2H-2
        self.ConvTranspose_0 = nn.ConvTranspose2d(c, 5, 4, stride=2, padding=2)
        nn.init.zeros_(self.ConvTranspose_0.weight)
        nn.init.zeros_(self.ConvTranspose_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _lrelu(self.Conv_0(x))
        h = _lrelu(self.Conv_1(h))
        feat = h
        for j in range(self.num_convs):
            feat = _lrelu(getattr(self, f"Conv_{2 + j}")(feat)) + feat
        out = self.ConvTranspose_0(feat)
        return _resize_bilinear(out, x.shape[-2:])


class RefineNet(nn.Module):
    """Residual head sharpening the fused frame, at half resolution: a 2x2
    mean-pool entry (the sum in the input's dtype, then the scale, as the
    reference's ``reduce_window``), two 3x3 convs, and a zero-init 4x4
    stride-2 transpose conv back to full resolution. Returns
    tanh(out) / 16, [N, 3, H, W]; a fresh head adds zero."""

    def __init__(self, in_ch: int = 11, c: int = 40):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, c, 3, padding=1)
        self.Conv_1 = nn.Conv2d(c, c, 3, padding=1)
        # Flax ConvTranspose(3, (4,4), strides=2, padding="SAME") pads the
        # dilated input (2, 2): torch padding 1, output 2H
        self.ConvTranspose_0 = nn.ConvTranspose2d(c, 3, 4, stride=2, padding=1)
        nn.init.zeros_(self.ConvTranspose_0.weight)
        nn.init.zeros_(self.ConvTranspose_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
        xh = _halve(x[..., :h, :w])
        out = self.ConvTranspose_0(_lrelu(self.Conv_1(_lrelu(self.Conv_0(xh)))))
        return torch.tanh(out) * (1.0 / 16.0)


class IFNet(nn.Module):
    """Coarse-to-fine intermediate flow network."""

    def __init__(self, config: RIFEConfig = RIFEConfig()):
        super().__init__()
        self.config = config
        for i, c in enumerate(config.channels):
            self.add_module(f"block{i}", IFBlock(12, c, config.num_convs))
        if config.refine:
            self.refine = RefineNet()

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, timestep,
                scales: Optional[Tuple[int, ...]] = None):
        """img0/img1: [N,H,W,3] in [0,1]; timestep: [N] or scalar; scales:
        the pyramid's per-level scales in place of the config's (one per
        block, the same parameters: ``RIFEModel.scales_for``).

        Returns (merged [N,H,W,3], flow [N,H,W,4], mask [N,H,W,1]).
        """
        cfg = self.config
        scales = tuple(scales or cfg.scales)
        if len(scales) != len(cfg.scales):
            raise ValueError(f"{len(scales)} pyramid scales for {len(cfg.scales)} blocks")
        n, h, w, _ = img0.shape
        out_dtype = img0.dtype
        x0 = img0.to(cfg.dtype).permute(0, 3, 1, 2)
        x1 = img1.to(cfg.dtype).permute(0, 3, 1, 2)
        t_scalar = torch.as_tensor(timestep, dtype=cfg.dtype, device=img0.device).reshape(-1, 1, 1, 1)

        ws_list = [max(s, cfg.min_warp_scale) if cfg.warp_at_level else 1 for s in scales]
        pyr0 = _build_pyramid(x0, max(ws_list))
        pyr1 = _build_pyramid(x1, max(ws_list))

        flow = mask = None
        for i, scale in enumerate(scales):
            ws = ws_list[i]
            sh, sw = max(h // ws, 1), max(w // ws, 1)
            img0_s, img1_s = pyr0[ws], pyr1[ws]
            t_map = t_scalar.expand(n, 1, sh, sw)
            if flow is None:
                flow = torch.zeros((n, 4, sh, sw), dtype=x0.dtype, device=x0.device)
                mask = torch.zeros((n, 1, sh, sw), dtype=x0.dtype, device=x0.device)
                warped0, warped1 = img0_s, img1_s
            else:
                rescale = sh / flow.shape[2]
                flow = _resize_bilinear(flow, (sh, sw)) * rescale
                mask = _resize_bilinear(mask, (sh, sw))
                # both sides in one warp call
                warped = _warp_nchw(torch.cat([img0_s, img1_s], 0),
                                    torch.cat([flow[:, 0:2], flow[:, 2:4]], 0),
                                    cfg.level_warp_radius, cfg.warp_dtype)
                warped0, warped1 = warped[:n], warped[n:]
            inp = torch.cat([warped0, warped1, t_map, mask, flow], dim=1)
            block_down = max(scale // ws, 1)
            if block_down > 1:
                inp = _resize_bilinear(inp, (max(sh // block_down, 1), max(sw // block_down, 1)))
            out = getattr(self, f"block{i}")(inp)
            out = _resize_bilinear(out, (sh, sw))
            flow = flow + out[:, :4] * block_down
            mask = mask + out[:, 4:5]

        # final full-resolution fusion warps (both sides in one call)
        rescale = h / flow.shape[2]
        flow = _resize_bilinear(flow, (h, w)) * rescale
        mask = _resize_bilinear(mask, (h, w))
        warped = _warp_nchw(torch.cat([x0, x1], 0),
                            torch.cat([flow[:, 0:2], flow[:, 2:4]], 0),
                            cfg.final_warp_radius, cfg.warp_dtype)
        warped0, warped1 = warped[:n], warped[n:]
        m = torch.sigmoid(mask)
        merged = warped0 * m + warped1 * (1.0 - m)
        if cfg.refine:
            t_map = t_scalar.expand(n, 1, h, w)
            merged = merged + self.refine(torch.cat([merged, warped0, warped1, m, t_map], dim=1))
        merged = torch.clamp(merged, 0.0, 1.0)

        def nhwc(v):
            return v.to(out_dtype).permute(0, 2, 3, 1)

        return nhwc(merged), nhwc(flow), nhwc(mask)


def shared_flow_apply(module: IFNet, x0: torch.Tensor, x1: torch.Tensor,
                      timestamps: Tuple[float, ...]) -> torch.Tensor:
    """Deployment fast path: one trunk pass, all timesteps from its flow.

    The trunk runs once at the anchor timestep a (the one closest to 0.5);
    other timesteps rescale the flow linearly, F_t->0 = F_a->0*(t/a) and
    F_t->1 = F_a->1*((1-t)/(1-a)), and pay only the final fusion warp, with
    the mask shifted to m_t = clip(sigmoid(mask) + (a - t), 0, 1).

    x0/x1: [P,H,W,3] (padded); returns [P*T,H,W,3] pair-major (pair i's
    timestep j at index i*T+j).
    """
    cfg = module.config
    p, h, w, _ = x0.shape
    ts = tuple(float(t) for t in timestamps)
    anchor_idx = min(range(len(ts)), key=lambda i: abs(ts[i] - 0.5))
    a = ts[anchor_idx]

    def full(t):
        return torch.full((p,), t, dtype=x0.dtype, device=x0.device)

    if a <= 1e-3 or a >= 1.0 - 1e-3:
        # anchor at an endpoint: the rescale would divide by ~0, so run the
        # trunk per timestep
        outs = [module(x0, x1, full(t))[0] for t in ts]
        return torch.stack(outs, dim=1).reshape(p * len(ts), h, w, 3)
    merged_a, flow, mask = module(x0, x1, full(a))
    others = [t for i, t in enumerate(ts) if i != anchor_idx]
    if not others:
        return merged_a
    m = torch.sigmoid(mask.to(cfg.dtype))

    # one warp call for every (timestep, side): batch 2*len(others)*P
    imgs, flows = [], []
    for t in others:
        imgs.append(x0.to(cfg.dtype))
        flows.append(flow[..., 0:2] * (t / a))
        imgs.append(x1.to(cfg.dtype))
        flows.append(flow[..., 2:4] * ((1.0 - t) / (1.0 - a)))
    warped = backward_warp(torch.cat(imgs, 0), torch.cat(flows, 0).to(cfg.dtype), 1.0,
                           border="replicate", radius=cfg.final_warp_radius,
                           compute_dtype=cfg.warp_dtype)
    outs = {a: merged_a}
    for k, t in enumerate(others):
        w0 = warped[2 * k * p:(2 * k + 1) * p]
        w1 = warped[(2 * k + 1) * p:(2 * k + 2) * p]
        m_t = torch.clamp(m + (a - t), 0.0, 1.0)
        outs[t] = torch.clamp(w0 * m_t + w1 * (1.0 - m_t), 0.0, 1.0).to(x0.dtype)
    return torch.stack([outs[t] for t in ts], dim=1).reshape(p * len(ts), h, w, 3)


class RIFEModel(BaseModel):
    """RIFE VFI model: the IFNet with its weights on a device. VFI runs every
    timestep in one IFNet call (timesteps folded into the batch); SR is
    Lanczos4, as in the reference."""

    CONFIG = RIFEConfig()
    NAME = "RIFE"
    WEIGHTS = "rife"  # weights/<WEIGHTS>.npz
    PAD_MULTIPLE = 32

    def __init__(self, device: str = "cuda", seed: int = 0,
                 config: Optional[RIFEConfig] = None, uhd_mode: bool = False):
        super().__init__(device)
        self.uhd_mode = uhd_mode  # the pyramid one level coarser when no scale is given
        self.seed = seed
        if config is not None:
            self.CONFIG = config
        self.module: Optional[IFNet] = None

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(name=self.NAME, type="sota", supports_vfi=True, supports_sr=False,
                         supports_joint=False, parameters=self.param_count(), requires_gpu=True,
                         description="RIFE-style IFNet: real-time intermediate flow estimation")

    def param_count(self) -> Optional[int]:
        if self.module is None:
            return None
        return int(sum(p.numel() for p in self.module.parameters()))

    def load(self, weights_path: Optional[str] = None) -> None:
        """Build the IFNet (seeded init) and load ``weights_path``, or
        ``weights/<WEIGHTS>.npz`` when it exists and no path is given. The
        module is left in inference mode, without gradients. Sets cuDNN and
        matmul TF32 off: an f32 config keeps the reference's f32 convs."""
        from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax
        from vfisr_tpu_torch.utils.paths import default_weights

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        auto = weights_path is None
        if auto:
            weights_path = default_weights(self.WEIGHTS)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = IFNet(self.CONFIG)
        if weights_path:
            try:
                module.load_state_dict(params_from_jax(load_npz(weights_path)))
            except RuntimeError:
                # an auto-found checkpoint of another architecture keeps the
                # fresh init; an explicit path stays strict
                if not auto:
                    raise
                import warnings

                warnings.warn(f"{weights_path} does not match the current architecture; "
                              "using fresh init", stacklevel=2)
        self.module = module.to(device=self.device, dtype=self.CONFIG.dtype).eval()
        self.module.requires_grad_(False)
        self._loaded = True

    def trainable(self) -> IFNet:
        """The loaded module in training mode, every parameter requiring a
        gradient (``load`` leaves it frozen for inference)."""
        if self.module is None:
            raise RuntimeError("load() the model before training it")
        return self.module.train().requires_grad_(True)

    def scales_for(self, scale: float) -> Tuple[int, ...]:
        """The pyramid at native scale ``scale``: each level's scale /
        scale, rounded, at least 1 (JAX ``rife.py::_apply_for_scale``).
        Below 1 the flow runs at coarser resolutions with the same
        parameters (the reference's ``scale`` knob: 0.5 one level coarser,
        0.25 two)."""
        if not scale or scale == 1.0:
            return tuple(self.CONFIG.scales)
        return tuple(max(int(round(s / float(scale))), 1) for s in self.CONFIG.scales)

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                          timestamps: Tuple[float, ...], scale: float = 1.0) -> torch.Tensor:
        """[N,H,W,3] pair -> [N,T,H,W,3]: one IFNet call on the N*T batch
        (pair-major), its pyramid at native ``scale`` (``scales_for``),
        padded to a multiple of max(32, the coarsest level's scale)."""
        scales = self.scales_for(scale)
        pad = max(self.PAD_MULTIPLE, max(scales))
        n, h, w, _ = x0.shape
        t = len(timestamps)
        x0p, _ = pad_to_multiple(x0, pad)
        x1p, _ = pad_to_multiple(x1, pad)
        ts = torch.tensor(timestamps, dtype=x0.dtype, device=x0.device).repeat(n)
        with torch.no_grad():
            merged = self.module(x0p.repeat_interleave(t, 0), x1p.repeat_interleave(t, 0), ts,
                                 scales=scales)[0]
        return unpad(merged, h, w).reshape(n, t, h, w, 3)

    def interpolate(self, frame0: np.ndarray, frame1: np.ndarray, num_frames: int = 3,
                    timestamps=None, scale: Optional[float] = None) -> List[np.ndarray]:
        """The base adapter with the reference's per-call ``scale``, in
        native pyramid units (1.0 = the trained pyramid). An explicit scale
        wins; without one, ``uhd_mode`` runs the pyramid one level coarser
        (0.5), as the reference does for >= 4K inputs."""
        if timestamps is None:
            timestamps = self.get_default_timestamps(num_frames)
        if scale is None:
            scale = 0.5 if self.uhd_mode else 1.0
        out = self.interpolate_batch(to_batched(frame0, self.device),
                                     to_batched(frame1, self.device), tuple(timestamps),
                                     scale=scale)
        return [from_batched(out[:, i]) for i in range(out.shape[1])]

    def interpolate_recursive(self, frame0: np.ndarray, frame1: np.ndarray,
                              factor: int = 2) -> List[np.ndarray]:
        """2^n frame multiplication by recursive midpoints: the frames
        strictly between frame0 and frame1 (JAX ``rife.py:525``)."""
        self.ensure_loaded()
        if factor < 2:
            return []
        frames = [frame0, frame1]
        while len(frames) - 1 < factor:
            new_frames = [frames[0]]
            for i in range(len(frames) - 1):
                mid = self.interpolate(frames[i], frames[i + 1], num_frames=1)[0]
                new_frames += [mid, frames[i + 1]]
            frames = new_frames
        return frames[1:-1]

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), "lanczos4")

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        return upscale_frame(frame, scale, "lanczos4", self.device)


class RIFELiteModel(RIFEModel):
    """The lite config (JAX ``rife.py:358,543-547``): three levels, ~4.5M
    parameters, weights/rife_lite.npz."""

    CONFIG = RIFEConfig(scales=(4, 2, 1), channels=(176, 112, 80), num_convs=8)
    NAME = "RIFE-Lite"
    WEIGHTS = "rife_lite"


def get_rife_model(lite: bool = False, device: str = "cuda") -> RIFEModel:
    """A loaded RIFE (or RIFE-Lite) model (JAX ``rife.py:550``)."""
    model = RIFELiteModel(device) if lite else RIFEModel(device)
    model.load()
    return model
