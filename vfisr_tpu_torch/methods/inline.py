"""The experiments' inline methods (port of ``vfisr_tpu/methods/inline.py``):
UAFI (UI-aware interpolation), MCAR (motion-complexity adaptive routing),
UGHI (uncertainty-guided hybrid), linear blend, frame duplication, edge
enhance and the plain flow warp.

Each method takes uint8 HWC frames (numpy) and a ``device`` ("cuda" by
default), runs as torch ops there, and returns uint8 frames, rounded half up
and clipped as the reference's adapters do. Flows come from the port's
Farneback (``ops/flow``), whose coefficient fetch is the windowed warp (K1)
on the GPU; the methods' own image warps are the exact bilinear gather
(``core/warp.py::flow_warp``, zero border), as the reference's are.

Known reference behaviour kept: MCAR's complexity, 0.5*min(mean/20, 1) +
0.3*min(std/15, 1) + 0.2*2*edge_density capped at 1, seldom reaches the 0.7
RIFE threshold, so its RIFE tier almost never fires. The formula is the
reference's; the thresholds are arguments.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.warp import flow_warp, remap_bilinear
from vfisr_tpu_torch.ops.conv import gaussian_blur
from vfisr_tpu_torch.ops.edges import canny
from vfisr_tpu_torch.ops.flow import farneback_flow, flow_magnitude
from vfisr_tpu_torch.ops.morphology import morph_close, morph_open

# Farneback's parameters: the flow methods' and the fast ones (motion,
# complexity)
FLOW_PARAMS = (0.5, 3, 15, 3, 5, 1.2)
FAST_FLOW_PARAMS = (0.5, 1, 15, 1, 5, 1.1)


def _as_batch_f32(frame, device) -> torch.Tensor:
    x = to_device(frame, device).float()
    return x[None] if x.ndim == 3 else x


def _to_u8(x: torch.Tensor) -> np.ndarray:
    out = torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8).cpu().numpy()
    return out[0] if out.shape[0] == 1 else out


# ---------------------------------------------------------------- simple ----


def linear_blend(prev: np.ndarray, curr: np.ndarray, t: float, device: str = "cuda") -> np.ndarray:
    """prev*(1-t) + curr*t (cv2.addWeighted)."""
    return _to_u8(_as_batch_f32(prev, device) * (1 - t) + _as_batch_f32(curr, device) * t)


def frame_dup(prev: np.ndarray, curr: np.ndarray, t: float) -> np.ndarray:
    """The worst-case baseline: the previous frame again (no device work)."""
    return prev.copy()


def edge_enhance_core(x: torch.Tensor, strength: float) -> torch.Tensor:
    """Unsharp mask of NHWC float x in [0, 255]: x*s + blur*(1-s), clipped,
    the blur a Gaussian of sigma 2."""
    blur = gaussian_blur(x, 0, 2.0)
    return torch.clamp(x * strength + blur * (1 - strength), 0, 255)


def edge_enhance(img: np.ndarray, strength: float = 1.3, device: str = "cuda") -> np.ndarray:
    """Unsharp mask of a uint8 frame; strength <= 0 returns it unchanged."""
    if strength <= 0:
        return img
    return _to_u8(edge_enhance_core(_as_batch_f32(img, device), strength) - 0.5 + 0.5)


def calc_motion(prev_gray: np.ndarray, curr_gray: np.ndarray, device: str = "cuda") -> float:
    """Mean flow magnitude of two gray frames, Farneback's fast parameters."""
    flow = farneback_flow(to_device(prev_gray, device).float(),
                          to_device(curr_gray, device).float(), *FAST_FLOW_PARAMS)
    return float(torch.mean(flow_magnitude(flow)))


# ---------------------------------------------------------------- flow VFI --


def _flow_interp_core(x0: torch.Tensor, x1: torch.Tensor, t: float) -> torch.Tensor:
    flow = farneback_flow(rgb_to_gray(x0), rgb_to_gray(x1), *FLOW_PARAMS)
    warped = flow_warp(x0, flow, t)
    return torch.clamp(warped * (1 - t) + x1 * t, 0, 255)


def flow_interpolate(prev: np.ndarray, curr: np.ndarray, t: float,
                     device: str = "cuda") -> np.ndarray:
    """Single-direction flow warp of prev by t*flow, blended with curr."""
    return _to_u8(_flow_interp_core(_as_batch_f32(prev, device), _as_batch_f32(curr, device),
                                    float(t)))


# ---------------------------------------------------------------- UAFI ------


def _ui_mask_core(x0: torch.Tensor, x1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """UI = high reconstruction error at low motion, closed then opened (5x5)."""
    warped = flow_warp(x0, flow, 0.5)
    recon_error = torch.mean(torch.abs(warped - x1), dim=-1)
    ui = (recon_error > 30) & (flow_magnitude(flow) < 2)
    return morph_open(morph_close(ui.to(torch.uint8), 5), 5)


def detect_ui_mask(frame_0: np.ndarray, frame_1: np.ndarray, flow: np.ndarray,
                   device: str = "cuda") -> np.ndarray:
    """[H, W] uint8 UI mask of a pair and its flow."""
    ui = _ui_mask_core(_as_batch_f32(frame_0, device), _as_batch_f32(frame_1, device),
                       to_device(flow, device).float()[None])
    return ui[0].cpu().numpy()


def _uafi_core(x0: torch.Tensor, x1: torch.Tensor, t: float) -> torch.Tensor:
    flow = farneback_flow(rgb_to_gray(x0), rgb_to_gray(x1), *FLOW_PARAMS)
    ui = _ui_mask_core(x0, x1, flow)
    blended = flow_warp(x0, flow, t) * (1 - t) + x1 * t
    ui_source = x0 if t < 0.5 else x1
    return torch.clamp(torch.where((ui > 0)[..., None], ui_source, blended), 0, 255)


def ui_aware_interpolate(prev: np.ndarray, curr: np.ndarray, t: float,
                         device: str = "cuda") -> np.ndarray:
    """UAFI: flow blend, UI pixels from prev (t < 0.5) or curr."""
    return _to_u8(_uafi_core(_as_batch_f32(prev, device), _as_batch_f32(curr, device), float(t)))


# ---------------------------------------------------------------- MCAR ------


def complexity_core(g0: torch.Tensor, g1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """([N] complexity in [0, 1], [N,H,W,2] fast flow) of gray batches."""
    flow = farneback_flow(g0, g1, *FAST_FLOW_PARAMS)
    mag = flow_magnitude(flow)
    mean_motion = torch.clamp(torch.mean(mag, dim=(-2, -1)) / 20.0, max=1.0)
    motion_var = torch.clamp(torch.std(mag, dim=(-2, -1), correction=0) / 15.0, max=1.0)
    edge_density = torch.mean((canny(g1, 100, 200) > 0).float(), dim=(-2, -1)) * 2.0
    complexity = torch.clamp(0.5 * mean_motion + 0.3 * motion_var + 0.2 * edge_density, max=1.0)
    return complexity, flow


def estimate_motion_complexity(prev_gray: np.ndarray, curr_gray: np.ndarray,
                               device: str = "cuda") -> Tuple[float, np.ndarray]:
    """(complexity score in [0, 1], [H,W,2] flow) of two gray frames."""
    c, flow = complexity_core(to_device(prev_gray, device).float()[None],
                              to_device(curr_gray, device).float()[None])
    return float(c[0]), flow[0].cpu().numpy()


def mcar_interpolate_cached(prev: np.ndarray, curr: np.ndarray, t: float, complexity: float,
                            flow: np.ndarray, rife_model=None, threshold_low: float = 0.3,
                            threshold_high: float = 0.7,
                            device: str = "cuda") -> Tuple[np.ndarray, str]:
    """Three tiers with a precomputed flow: blend below threshold_low, flow
    warp below threshold_high (or without a RIFE model), RIFE above.
    Returns (frame, tier)."""
    if complexity < threshold_low:
        return linear_blend(prev, curr, t, device), "linear"
    if complexity < threshold_high or rife_model is None:
        warped = flow_warp(_as_batch_f32(prev, device), to_device(flow, device).float()[None], t)
        out = warped * (1 - t) + _as_batch_f32(curr, device) * t
        return _to_u8(torch.clamp(out, 0, 255)), "flow"
    return rife_model.interpolate(prev, curr, num_frames=1, timestamps=[t])[0], "rife"


# ---------------------------------------------------------------- UGHI ------


def _uncertainty_core(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor) -> torch.Tensor:
    """[N,H,W] uncertainty: the forward-backward flow inconsistency / 10,
    at least half the forward motion / 50, each clipped to [0, 1]."""
    n, h, w, _ = flow_fwd.shape
    ys = torch.arange(h, dtype=torch.float32, device=flow_fwd.device).view(1, h, 1).expand(n, h, w)
    xs = torch.arange(w, dtype=torch.float32, device=flow_fwd.device).view(1, 1, w).expand(n, h, w)
    bwd_warped = remap_bilinear(flow_bwd, xs + flow_fwd[..., 0], ys + flow_fwd[..., 1])
    err = torch.sqrt((flow_fwd[..., 0] + bwd_warped[..., 0]) ** 2
                     + (flow_fwd[..., 1] + bwd_warped[..., 1]) ** 2)
    motion_unc = torch.clamp(flow_magnitude(flow_fwd) / 50.0, 0, 1)
    return torch.maximum(torch.clamp(err / 10.0, 0, 1), motion_unc * 0.5)


def estimate_uncertainty(prev, curr, flow_fwd: np.ndarray, flow_bwd: np.ndarray,
                         device: str = "cuda") -> np.ndarray:
    """[H, W] per-pixel uncertainty from flow consistency (prev and curr are
    not read, as in the reference)."""
    return _uncertainty_core(to_device(flow_fwd, device).float()[None],
                             to_device(flow_bwd, device).float()[None])[0].cpu().numpy()


def _ughi_core(x0: torch.Tensor, x1: torch.Tensor, t: float):
    g0, g1 = rgb_to_gray(x0), rgb_to_gray(x1)
    flow_fwd = farneback_flow(g0, g1, *FLOW_PARAMS)
    flow_bwd = farneback_flow(g1, g0, *FLOW_PARAMS)
    unc = _uncertainty_core(flow_fwd, flow_bwd)
    base = flow_warp(x0, flow_fwd, t) * (1 - t) + flow_warp(x1, flow_bwd, -(1 - t)) * t
    simple = x0 * (1 - t) + x1 * t
    u3 = unc[..., None]
    return torch.clamp(base * (1 - u3) + simple * u3, 0, 255), torch.mean(unc, dim=(-2, -1))


def ughi_interpolate(prev: np.ndarray, curr: np.ndarray, t: float,
                     device: str = "cuda") -> Tuple[np.ndarray, float]:
    """UGHI: the bidirectional flow blend, leaning to the plain blend where
    the flows disagree. Returns (frame, mean uncertainty)."""
    out, u = _ughi_core(_as_batch_f32(prev, device), _as_batch_f32(curr, device), float(t))
    return _to_u8(out), float(u[0])
