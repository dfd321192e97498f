"""The flagship fused AdaptiveVFI step (port of
``vfisr_tpu/pipeline/flagship.py``).

Per frame pair, all on the device: router analysis on a 480x270 gray pair
(Farneback motion, SSIM scene-cut gate confirmed by a flow-compensated
warp, Laplacian particle score, HUD temporal-variance ring with
morphology), RIFE in its deploy config (shared-flow timesteps, or one IFNet
pass per timestep with ``shared_flow=False``), the
branchless scene-cut and HUD composites, and Lanczos4 SR to the output size
as uint8.

Precision: ``FlagshipVFI.load`` sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False, so the f32 analysis
(Farneback, SSIM, filters) runs in full f32 as the JAX reference does; the
IFNet runs in bf16 by its config.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Tuple

import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import pad_to_multiple, to_batched, to_uint8, unpad
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.models.base import BaseModel, InferenceResult, ModelInfo, device_peak_mb
from vfisr_tpu_torch.models.novel.adaptive_pipeline import (_HUD_RES, _push_history as push_history,
                                                            scene_cut_signals)
from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig, RIFEModel, shared_flow_apply
from vfisr_tpu_torch.ops.conv import laplacian
from vfisr_tpu_torch.ops.flow import farneback_flow
from vfisr_tpu_torch.ops.morphology import morph_close, morph_open


@dataclass(frozen=True)
class FlagshipConfig:
    """Deployment dials for the fused adaptive step."""

    out_hw: Tuple[int, int] = (1440, 2560)
    timestamps: Tuple[float, ...] = (0.25, 0.5, 0.75)
    analysis_hw: Tuple[int, int] = (270, 480)
    scene_ssim_threshold: float = 0.65
    # flow-compensated scene-cut confirmation; 1.0 = SSIM-only gate.
    # FlagshipVFI.load takes the calibrated value from router_gate.json.
    scene_warp_ssim_threshold: float = 1.0
    particle_threshold: float = 0.4
    hud_var_threshold: float = 10.0
    hud_coverage_threshold: float = 0.01
    # composite only HUD pixels where |g0-g1| <= eps at full res (0 = off)
    hud_agree_eps: float = 3.0
    motion_threshold_high: float = 25.0  # route-to-VFIMamba signal
    sr_filter: str = "lanczos4"
    # one IFNet trunk pass at the anchor timestep, the others from its
    # rescaled flow (``shared_flow_apply``); False runs the IFNet per
    # timestep, all of them in one call
    shared_flow: bool = True


def analyze_small(f0, f1, history, history_count, cfg: FlagshipConfig) -> dict:
    """Router signals from a downscaled gray pair. f0/f1: [N,H,W,3] in [0,1];
    history: [N,K,180,320] HUD gray ring; history_count: [N] valid entries."""
    n, h, w, _ = f0.shape
    ah, aw = cfg.analysis_hw
    flow_scale = h / ah
    g0 = rgb_to_gray(resize(f0, (ah, aw), "linear") * 255.0)
    g1 = rgb_to_gray(resize(f1, (ah, aw), "linear") * 255.0)

    flow = farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2)
    is_scene, ssim_score, warped_ssim = scene_cut_signals(
        g0, g1, flow, cfg.scene_ssim_threshold, cfg.scene_warp_ssim_threshold)

    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2) * flow_scale
    motion_mean = mag.mean(dim=(1, 2))
    motion_max = mag.amax(dim=(1, 2))
    motion_std = mag.std(dim=(1, 2), correction=0)

    flow_score = torch.clamp(motion_std / 20.0, max=1.0)
    lap = laplacian(g0[..., None])[..., 0]
    freq_score = torch.clamp(lap.var(dim=(1, 2), correction=0) / 500.0, max=1.0)
    particle_score = torch.sqrt(flow_score * freq_score)
    has_particles = particle_score > cfg.particle_threshold

    var = history[:, -5:].var(dim=1, correction=0)
    hud_small = (var < cfg.hud_var_threshold).float()
    hud_small = torch.where((history_count >= 5)[:, None, None], hud_small, 0.0)
    hud_small = morph_open(morph_close(hud_small, 5), 5)
    hud_mask_small = hud_small > 0.5
    hud_coverage = hud_mask_small.float().mean(dim=(1, 2))

    return {
        "ssim": ssim_score,
        "warped_ssim": warped_ssim,
        "is_scene_change": is_scene,
        "motion_mean": motion_mean,
        "motion_max": motion_max,
        "motion_std": motion_std,
        "particle_score": particle_score,
        "has_particles": has_particles,
        "hud_mask_small": hud_mask_small,
        "hud_coverage": hud_coverage,
        "route_vfimamba": (has_particles | (motion_max > cfg.motion_threshold_high)) & ~is_scene,
    }


def init_history(n: int, device="cuda"):
    return (torch.zeros((n, 10, *_HUD_RES), dtype=torch.float32, device=device),
            torch.zeros((n,), dtype=torch.int32, device=device))


def make_flagship_step(module: IFNet, cfg: FlagshipConfig = FlagshipConfig()):
    """Build the fused step: (x0, x1, hist, hcnt) -> (up_u8, mids, hist, hcnt, sig).

    x0/x1: [P,H,W,3] float32 in [0,1] (P frame pairs). up_u8:
    [(1+T)*P, OH, OW, 3] uint8, the x0 frames then the T midpoints,
    upscaled; mids: [T*P,H,W,3] composited midpoints.
    """
    ts_tuple = cfg.timestamps
    t_count = len(ts_tuple)
    oh, ow = cfg.out_hw

    @torch.no_grad()
    def step(x0, x1, hist, hcnt):
        p, h, w, _ = x0.shape
        hist, hcnt = push_history(hist, hcnt, x0)
        sig = analyze_small(x0, x1, hist, hcnt, cfg)

        x0p, _ = pad_to_multiple(x0, 32)
        x1p, _ = pad_to_multiple(x1, 32)
        if cfg.shared_flow:
            # one IFNet trunk pass, every timestep from its flow
            merged = shared_flow_apply(module, x0p, x1p, ts_tuple)
        else:
            # each pair repeated T times, the timestamps tiled pair-major
            ts = torch.tensor(ts_tuple, dtype=x0.dtype, device=x0.device).repeat(p)
            merged = module(x0p.repeat_interleave(t_count, 0), x1p.repeat_interleave(t_count, 0),
                            ts)[0]
        mids = unpad(merged, h, w)  # [P*T,H,W,3]

        # branchless scene-cut repeat of x0
        scene = sig["is_scene_change"].repeat_interleave(t_count)
        x0_rep = x0.repeat_interleave(t_count, 0)
        mids = torch.where(scene[:, None, None, None], x0_rep, mids)

        # branchless HUD composite: source x0 for t<0.5 else x1, where the
        # coverage passes its threshold
        hud_full = resize(sig["hud_mask_small"][..., None].float(), (h, w), "nearest")[..., 0] > 0.5
        if cfg.hud_agree_eps > 0:
            g0f = rgb_to_gray(x0 * 255.0)
            g1f = rgb_to_gray(x1 * 255.0)
            hud_full = hud_full & (torch.abs(g0f - g1f) <= cfg.hud_agree_eps)
        apply_hud = sig["hud_coverage"] > cfg.hud_coverage_threshold
        hud_rep = (hud_full & apply_hud[:, None, None]).repeat_interleave(t_count, 0)
        src = torch.stack([x0 if t < 0.5 else x1 for t in ts_tuple], dim=1).reshape(p * t_count, h, w, 3)
        mids = torch.where(hud_rep[..., None], src, mids)

        frames = torch.cat([x0, mids], dim=0)
        up = to_uint8(resize(frames, (oh, ow), cfg.sr_filter))
        return up, mids, hist, hcnt, sig

    return step


class FlagshipVFI(BaseModel):
    """The fused deployment pipeline: RIFE deploy config (bf16, warp radii
    level (2,2) and final (3,4), bf16 warp windows, shared-flow timesteps)
    + router analysis + scene/HUD composite + SR, with the HUD history
    carried across calls."""

    def __init__(self, device: str = "cuda", config: FlagshipConfig = None):
        super().__init__(device)
        self.base_config = config or FlagshipConfig()
        self._rife = None
        self._module = None
        self._steps = {}  # (in_hw, out_hw) -> step
        self._hist = None
        self._hist_n = None

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(
            name="FlagshipAdaptiveVFI", type="novel", supports_vfi=True, supports_sr=True,
            supports_joint=True, parameters=self._rife.param_count() if self._rife else None,
            requires_gpu=True,
            description="Fused AdaptiveVFI deployment path: analysis + RIFE shared-flow + "
                        "scene/HUD composite + SR")

    def load(self, weights_path=None, gate_path=None) -> None:
        """Load the RIFE deploy config (``weights/rife.npz`` by default) and
        the calibrated scene gate (``weights/router_gate.json``). Sets cuDNN
        and matmul TF32 off (see the module docstring)."""
        from vfisr_tpu_torch.utils.router_gate import scene_warp_threshold

        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        warp_thr = scene_warp_threshold(gate_path)
        if warp_thr is not None and self.base_config.scene_warp_ssim_threshold == 1.0:
            self.base_config = dataclasses.replace(
                self.base_config, scene_warp_ssim_threshold=float(warp_thr))
            self._steps.clear()
        deploy = RIFEConfig(dtype=torch.bfloat16, level_warp_radius=(2, 2),
                            final_warp_radius=(3, 4))
        self._rife = RIFEModel(device=self.device, config=deploy)
        self._rife.load(weights_path)
        self._module = self._rife.module
        self._loaded = True

    def _step_for(self, in_hw, out_hw):
        key = (in_hw, out_hw)
        if key not in self._steps:
            cfg = dataclasses.replace(self.base_config, out_hw=out_hw)
            self._steps[key] = make_flagship_step(self._module, cfg)
        return self._steps[key]

    def _history_for(self, n):
        if self._hist is None or self._hist_n != n:
            self._hist = init_history(n, self.device)
            self._hist_n = n
        return self._hist

    def reset_history(self):
        self._hist = None

    def _set_timestamps(self, ts):
        if ts != self.base_config.timestamps:
            self.base_config = dataclasses.replace(self.base_config, timestamps=ts)
            self._steps.clear()

    def process_pair(self, frame0, frame1, num_intermediate: int = 3,
                     target_scale: float = 1.333) -> InferenceResult:
        """Endpoints + intermediates at the target scale (HWC uint8 in,
        HWC uint8 numpy frames out)."""
        self.ensure_loaded()
        if num_intermediate != len(self.base_config.timestamps):
            self._set_timestamps(tuple((i + 1) / (num_intermediate + 1)
                                       for i in range(num_intermediate)))
        t0 = time.perf_counter()
        x0 = to_batched(frame0, self.device)
        x1 = to_batched(frame1, self.device)
        h, w = x0.shape[1:3]
        out_hw = scale_size(h, w, target_scale)
        hist, hcnt = self._history_for(1)
        up, _, hist, hcnt, sig = self._step_for((h, w), out_hw)(x0, x1, hist, hcnt)
        self._hist = (hist, hcnt)
        last = to_uint8(resize(x1, out_hw, "lanczos4"))[0]
        frames = [f.cpu().numpy() for f in up] + [last.cpu().numpy()]
        return InferenceResult(
            frames=frames,
            inference_time_ms=(time.perf_counter() - t0) * 1000,
            vram_peak_mb=device_peak_mb(self.device),
            model_used=self.info.name,
            extra_info={
                "is_scene_change": bool(sig["is_scene_change"][0]),
                "motion_mean": float(sig["motion_mean"][0]),
                "hud_coverage": float(sig["hud_coverage"][0]),
                "route_vfimamba": bool(sig["route_vfimamba"][0]),
            },
        )

    def fused_stream_step(self, prev_u8, curr_u8, scale: float, timestamps) -> torch.Tensor:
        """One fused step per pair for streaming: returns [(1+T), oh, ow, 3]
        uint8 device frames (the prev endpoint + T composited midpoints,
        upscaled), asynchronously; the HUD history carries across calls."""
        self.ensure_loaded()
        self._set_timestamps(tuple(timestamps))
        x0 = torch.as_tensor(prev_u8, device=self.device).float()[None] / 255.0
        x1 = torch.as_tensor(curr_u8, device=self.device).float()[None] / 255.0
        h, w = x0.shape[1:3]
        hist, hcnt = self._history_for(1)
        up, _, hist, hcnt, _ = self._step_for((h, w), scale_size(h, w, scale))(x0, x1, hist, hcnt)
        self._hist = (hist, hcnt)
        return up

    def interpolate_batch(self, x0, x1, timestamps) -> torch.Tensor:
        """Bare shared-flow RIFE mids [N,T,H,W,3] (no scene-cut hold or HUD
        composite)."""
        self.ensure_loaded()
        n, h, w, _ = x0.shape
        x0p, _ = pad_to_multiple(x0, 32)
        x1p, _ = pad_to_multiple(x1, 32)
        with torch.no_grad():
            merged = shared_flow_apply(self._module, x0p, x1p, tuple(timestamps))
        return unpad(merged, h, w).reshape(n, len(timestamps), h, w, 3)

    def upscale_batch(self, x, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), "lanczos4")
