"""VFIMamba-style state-space VFI model (port of
``vfisr_tpu/models/sota/vfimamba.py``).

A stride-8 conv encoder per frame; a trunk of bidirectional Mamba (S6)
blocks over the two frames' tokens interleaved along the scan axis, with
layers alternating horizontal scans (rows are the batch) and vertical
scans (columns are the batch); a decoder to bidirectional flow and a fusion
mask at 1/8 resolution; a coarse-to-fine refinement pyramid (1/4, 1/2)
whose levels warp the area-downscaled frames by the current flow and add a
zero-init residual; full-resolution warps, the mask blend, and a residual
refinement. Warps go through ``backward_warp`` (replicate border, radius 8,
f32 windows): the windowed CUDA kernel on the GPU.

The selective scan. The reference forms ``a = exp(dt A)`` and
``b = dt u B`` as whole [rows, L, Di, S] tensors and runs
``lax.associative_scan`` over L. At 1080p with 3 timesteps one horizontal
block's ``a`` alone is [408, 480, 512, 16] f32, 6.4 GB, and a forward has 24
such calls. ``selective_scan`` here is a plain PyTorch loop over L instead,
in chunks of ``SCAN_CHUNK`` steps: per chunk it forms ``a`` and ``b`` for
those steps only, runs the recurrence one step at a time
(``h = a_t h + b_t``, one ``addcmul`` launch per step, state [rows, Di, S])
and forms ``y = h . C`` for the chunk with one batched matmul. It is the
same function as the reference's scan followed by ``sum(h * C)``, with
f32 sums taken in another order.

Flax defaults kept: ``nn.gelu`` is the tanh approximation, ``LayerNorm``
has eps 1e-6, ``nn.Conv(padding=1)`` pads symmetrically, the causal
depthwise conv pads k-1 on the left, and ``jax.image.resize(...,
"bilinear")`` (every resize here is an upsampling) equals
``F.interpolate(mode="bilinear", align_corners=False)``. Module names
mirror the Flax tree (``Conv_0``..``Conv_6``, ``block<i>``, ``t_embed``,
``refine_lvl<l>_c<k>``), so ``utils.checkpoint.params_from_jax`` loads
``weights/vfimamba.npz`` directly.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfisr_tpu_torch.core.frames import pad_to_multiple, unpad
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.models.base import BaseModel, ModelInfo, upscale_frame

SCAN_CHUNK = 32  # steps of L per chunk of the selective scan


@dataclass(frozen=True)
class MambaConfig:
    d_model: int = 256
    d_state: int = 16
    expand: int = 2
    dt_rank: int = 16
    layers: int = 12
    conv_k: int = 4
    # coarse-to-fine flow refinement below the 1/8 trunk (levels at 1/4 and
    # 1/2 for 2); zero-init, so a v1 checkpoint stays output-identical
    refine_levels: int = 2


def selective_scan(dt: torch.Tensor, A: torch.Tensor, u: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor) -> torch.Tensor:
    """y_t = h_t . C_t with h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t, h_{-1} = 0.

    dt, u: [R, L, Di]; A: [Di, S]; B, C: [R, L, S] -> y [R, L, Di]. A loop
    over L in chunks of SCAN_CHUNK steps (module docstring): memory
    [R, SCAN_CHUNK, Di, S] for each of a, b and the chunk's states, never
    [R, L, Di, S].
    """
    r, length, di = u.shape
    du = dt * u
    y = torch.empty_like(u)
    h = torch.zeros((r, di, A.shape[1]), dtype=u.dtype, device=u.device)
    for c0 in range(0, length, SCAN_CHUNK):
        c1 = min(length, c0 + SCAN_CHUNK)
        a = torch.exp(dt[:, c0:c1, :, None] * A)
        b = du[:, c0:c1, :, None] * B[:, c0:c1, None, :]
        hs = torch.empty_like(a)
        for j in range(c1 - c0):
            h = torch.addcmul(b[:, j], a[:, j], h, out=hs[:, j])
        y[:, c0:c1] = torch.matmul(hs, C[:, c0:c1, :, None])[..., 0]
    return y


class S6(nn.Module):
    """Selective state-space layer (Mamba S6), one scan direction."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        self.cfg = cfg
        di = cfg.d_model * cfg.expand
        self.in_proj = nn.Linear(cfg.d_model, 2 * di)
        # depthwise causal conv along the sequence, conv1d layout (Di, 1, k)
        self.conv_w = nn.Parameter(torch.randn(di, 1, cfg.conv_k) / cfg.conv_k ** 0.5)
        self.x_proj = nn.Linear(di, cfg.dt_rank + 2 * cfg.d_state)
        self.dt_proj = nn.Linear(cfg.dt_rank, di)
        self.A_log = nn.Parameter(
            torch.log(torch.arange(1, cfg.d_state + 1, dtype=torch.float32)).repeat(di, 1))
        self.D = nn.Parameter(torch.ones(di))
        self.out_proj = nn.Linear(di, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, L, d_model] -> [B, L, d_model]."""
        cfg = self.cfg
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        xs = F.pad(xs.transpose(1, 2), (cfg.conv_k - 1, 0))
        xs = F.silu(F.conv1d(xs, self.conv_w, groups=xs.shape[1]).transpose(1, 2))
        dt_raw, B, C = self.x_proj(xs).split([cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt_raw))
        A = -torch.exp(self.A_log)
        y = selective_scan(dt, A, xs, B, C) + self.D * xs
        return self.out_proj(y * F.silu(z))


class BiMambaBlock(nn.Module):
    """Bidirectional S6 + MLP with pre-norm residuals."""

    def __init__(self, cfg: MambaConfig):
        super().__init__()
        d = cfg.d_model
        self.LayerNorm_0 = nn.LayerNorm(d, eps=1e-6)
        self.s6_fwd = S6(cfg)
        self.s6_bwd = S6(cfg)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=1e-6)
        self.Dense_0 = nn.Linear(d, 2 * d)
        self.Dense_1 = nn.Linear(2 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(x)
        x = x + self.s6_fwd(h) + self.s6_bwd(h.flip(1)).flip(1)
        h = self.LayerNorm_1(x)
        return x + self.Dense_1(F.gelu(self.Dense_0(h), approximate="tanh"))


def _conv(cin: int, cout: int, stride: int = 1, zero: bool = False) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, 3, stride=stride, padding=1)
    if zero:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    return conv


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear resize, half-pixel, no antialiasing: jax.image.resize
    'bilinear' for an upsampling."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=False)


@contextlib.contextmanager
def _without_cudnn():
    """PyTorch's own convolution (im2col and a GEMM) instead of cuDNN's.
    For the decoder's 512->128 conv at 1/8 resolution, f32 with TF32 off
    and a batch of 3 (one 1080p pair, 3 timesteps), cuDNN's heuristics pick
    an algorithm that takes 345 ms and a 35.5 GB workspace on an H100 80GB
    HBM3 at 700 W, where PyTorch's takes 3.8 ms and 0.65 GB (chip_smoke.py's
    "decoder conv" lines; PERF.md)."""
    enabled = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = enabled


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """NHWC img, NCHW flow (2 channels) -> NHWC warp, replicate border."""
    return backward_warp(img, _nhwc(flow).contiguous(), 1.0, border="replicate")


class VFIMambaNet(nn.Module):
    """Two-frame interpolation network with a cross-scan Mamba trunk."""

    def __init__(self, cfg: MambaConfig = MambaConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.Conv_0, self.Conv_1, self.Conv_2 = _conv(3, 64, 2), _conv(64, 128, 2), _conv(128, d, 2)
        self.t_embed = nn.Linear(1, d)
        for i in range(cfg.layers):
            self.add_module(f"block{i}", BiMambaBlock(cfg))
        self.Conv_3, self.Conv_4 = _conv(2 * d, 128), _conv(128, 5, zero=True)
        for lvl in range(cfg.refine_levels):
            self.add_module(f"refine_lvl{lvl}_c0", _conv(18, 48))
            self.add_module(f"refine_lvl{lvl}_c1", _conv(48, 48))
            self.add_module(f"refine_lvl{lvl}_c2", _conv(48, 5, zero=True))
        self.Conv_5, self.Conv_6 = _conv(9, 32), _conv(32, 3, zero=True)

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.Conv_2(F.silu(self.Conv_1(F.silu(self.Conv_0(_nchw(x)))))))

    def _trunk(self, f0: torch.Tensor, f1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """[N,h8,w8,D] features of both frames -> [N,D2,h8,w8] merged."""
        n, h8, w8, d = f0.shape
        x = torch.stack([f0, f1], dim=-2) + self.t_embed(t)[:, None, None, None, :]
        for i in range(self.cfg.layers):
            block = getattr(self, f"block{i}")
            if i % 2 == 0:  # horizontal: rows are the batch, frames interleaved along W
                x = block(x.reshape(n * h8, w8 * 2, d)).reshape(n, h8, w8, 2, d)
            else:  # vertical: columns are the batch, frames interleaved along H
                xt = x.transpose(1, 2).reshape(n * w8, h8 * 2, d)
                x = block(xt).reshape(n, w8, h8, 2, d).transpose(1, 2)
        return _nchw(x.reshape(n, h8, w8, 2 * d))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, timestep):
        """img0/img1: [N,H,W,3] in [0,1]; timestep: [N] or a scalar.

        Returns (merged [N,H,W,3], flow [N,H,W,4], mask [N,H,W,1])."""
        cfg = self.cfg
        n, h, w, _ = img0.shape
        t = torch.as_tensor(timestep, dtype=img0.dtype, device=img0.device).reshape(-1, 1)
        feat = self._trunk(self._encode(img0), self._encode(img1), t)
        with _without_cudnn():
            feat = self.Conv_3(feat)
        out = self.Conv_4(F.silu(feat))  # flow (4) + mask (1) at 1/8

        if cfg.refine_levels == 0:
            out = _upsample(out, (h, w))
            flow, mask = out[:, :4] * 8.0, torch.sigmoid(out[:, 4:5])
        else:
            # flow stays in full-res pixels; each level warps level-res
            # frames by it and adds a zero-init residual
            flow, mlogit = out[:, :4] * 8.0, out[:, 4:5]
            t_map = t.reshape(-1, 1, 1, 1)
            for lvl in range(cfg.refine_levels):
                s = 8 // (2 ** (lvl + 1))
                hs, ws = h // s, w // s
                flow, mlogit = _upsample(flow, (hs, ws)), _upsample(mlogit, (hs, ws))
                i0, i1 = resize(img0, (hs, ws), "area"), resize(img1, (hs, ws), "area")
                w0 = _warp(i0, flow[:, 0:2] / float(s))
                w1 = _warp(i1, flow[:, 2:4] / float(s))
                inp = torch.cat([_nchw(i0), _nchw(i1), _nchw(w0), _nchw(w1), flow / 8.0, mlogit,
                                 t_map.expand(n, 1, hs, ws)], dim=1)
                d = F.silu(getattr(self, f"refine_lvl{lvl}_c0")(inp))
                d = F.silu(getattr(self, f"refine_lvl{lvl}_c1")(d))
                d = getattr(self, f"refine_lvl{lvl}_c2")(d)
                flow = flow + d[:, :4] * float(s)
                mlogit = mlogit + d[:, 4:5]
            flow = _upsample(flow, (h, w))
            mask = torch.sigmoid(_upsample(mlogit, (h, w)))
        warped0 = _warp(img0, flow[:, 0:2])
        warped1 = _warp(img1, flow[:, 2:4])
        m = _nhwc(mask)
        merged = warped0 * m + warped1 * (1.0 - m)
        res = self.Conv_6(F.silu(self.Conv_5(_nchw(torch.cat([merged, warped0, warped1], -1)))))
        out = torch.clamp(merged + _nhwc(torch.tanh(res)) * (1.0 / 16.0), 0.0, 1.0)
        return out, _nhwc(flow), m


_FULL = MambaConfig()
_SMALL = MambaConfig(d_model=192, dt_rank=12, layers=10)

#: Largest pixel area the trunk processes natively (the reference's cap,
#: sized for a 15.75 GB TPU; kept for parity). Above it, inputs are
#: area-downscaled for the net and the midpoints Lanczos-upscaled back.
MAX_INTERNAL_AREA = 1920 * 1080


class VFIMambaModel(BaseModel):
    """VFIMamba VFI model: ``VFIMambaNet`` with its weights on a device."""

    def __init__(self, variant: str = "full", device: str = "cuda", seed: int = 0,
                 max_internal_area: Optional[int] = MAX_INTERNAL_AREA):
        super().__init__(device)
        self.variant = variant
        self.cfg = _FULL if variant == "full" else _SMALL
        self.seed = seed
        self.module: Optional[VFIMambaNet] = None
        self.max_internal_area = max_internal_area

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(
            name="VFIMamba" if self.variant == "full" else "VFIMamba-S", type="sota",
            supports_vfi=True, supports_sr=False, supports_joint=False,
            parameters=self._param_count(), requires_gpu=True,
            description="State-space (Mamba S6) video frame interpolation")

    def _param_count(self) -> int:
        if self.module is None:
            return 17_000_000 if self.variant == "full" else 8_000_000
        return int(sum(p.numel() for p in self.module.parameters()))

    def load(self, weights_path: Optional[str] = None) -> None:
        """Build the net (seeded init) and load ``weights_path``, or
        ``weights/vfimamba[_s].npz`` when it exists and no path is given,
        with ``partial`` semantics: stages missing from the file (a v1
        checkpoint's refinement pyramid) keep their zero init. Sets cuDNN
        and matmul TF32 off: the net runs in f32."""
        import warnings

        from vfisr_tpu_torch.utils.checkpoint import load_params, params_from_jax, params_to_jax
        from vfisr_tpu_torch.utils.paths import default_weights

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if weights_path is None:
            name = f"vfimamba{'_s' if self.variant != 'full' else ''}"
            weights_path = default_weights(name)
            if weights_path is None:
                warnings.warn(f"weights/{name}.npz not found: VFIMamba[{self.variant}] runs with "
                              "fresh-init parameters (about a linear blend)", stacklevel=2)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            module = VFIMambaNet(self.cfg)
        if weights_path:
            flat = load_params(weights_path, params_to_jax(module.state_dict()), partial=True)
            module.load_state_dict(params_from_jax(flat))
        self.module = module.to(self.device).eval().requires_grad_(False)
        self._loaded = True

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor, timestamps) -> torch.Tensor:
        """[N,H,W,3] pair -> [N,T,H,W,3]: one net call on the N*T batch
        (pair-major), padded to a multiple of 32."""
        n, h, w, _ = x0.shape
        t = len(timestamps)
        cap = self.max_internal_area
        if cap and h * w > cap:
            # run the trunk at a reduced internal size; the sizes are floored
            # (the reference rounds, so an input a sliver over the cap
            # rounds back over it and recurses without end)
            s = (cap / float(h * w)) ** 0.5
            ih, iw = int(h * s), int(w * s)
            out = self.interpolate_batch(resize(x0, (ih, iw), "area"),
                                         resize(x1, (ih, iw), "area"), timestamps)
            up = resize(out.reshape(n * t, ih, iw, 3), (h, w), "lanczos4")
            return torch.clamp(up, 0.0, 1.0).reshape(n, t, h, w, 3)
        x0p, _ = pad_to_multiple(x0, 32)
        x1p, _ = pad_to_multiple(x1, 32)
        ts = torch.tensor(timestamps, dtype=x0.dtype, device=x0.device).repeat(n)
        with torch.no_grad():
            merged = self.module(x0p.repeat_interleave(t, 0), x1p.repeat_interleave(t, 0), ts)[0]
        return unpad(merged, h, w).reshape(n, t, h, w, 3)

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), "lanczos4")

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        return upscale_frame(frame, scale, "lanczos4", self.device)
