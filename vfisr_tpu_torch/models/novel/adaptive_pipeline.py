"""The adaptive content-aware VFI+SR pipeline, the project's router (port of
``vfisr_tpu/models/novel/adaptive_pipeline.py``).

Easy pairs go to RIFE, hard pairs to VFIMamba, scene cuts repeat the first
frame, and HUD pixels are copied from a source frame. Thresholds as the
reference: motion low/high 5/25 px; scene cut when SSIM of the 0.25x grays
< 0.65 and, calibrated, the flow-compensated SSIM < the gate's threshold;
particle score sqrt(min(sigma_flow/20, 1) * min(LaplacianVar/500, 1)) > 0.4;
HUD where the temporal variance of the last 5 of 10 320x180 grays is < 10,
refined by pair agreement (|g0 - g1| <= 3) when quality-aware, composited
when it covers > 1% (source f0 for t < 0.5, else f1).

Routing. Quality-aware (the default), the expert of each pair is the
measured winner at its motion (``utils.router_gate.bin_winner`` over the
calibrated native-regime bins of ``weights/router_gate.json``); otherwise
particles or motion_max > 25 px send a pair to VFIMamba.

``AdaptiveRouter.analyze_device`` computes every signal for a batch of
pairs on the device (full-res Farneback, the SSIM scene gate, the Laplacian
particle score, the HUD ring and mask) and advances the HUD history.
``AdaptivePipeline.interpolate_batch`` has two route modes: 'hosted' (the
default) reads the masks back once and runs each expert on the contiguous
runs of pairs routed to it; 'masked' runs both experts on the whole batch
and selects per pair on the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_batched
from vfisr_tpu_torch.core.resize import resize, scale_size
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.models.base import BaseModel, InferenceResult, ModelInfo, device_peak_mb
from vfisr_tpu_torch.ops.conv import laplacian
from vfisr_tpu_torch.ops.flow import farneback_flow
from vfisr_tpu_torch.ops.morphology import morph_close, morph_open
from vfisr_tpu_torch.ops.ssim import ssim as ssim_windowed

_HUD_RES = (180, 320)  # the reference's 320x180 HUD analysis frames


@dataclass
class ContentAnalysis:
    """Analysis of a frame pair."""

    motion_mean: float
    motion_max: float
    motion_std: float
    has_particles: bool
    is_scene_change: bool
    hud_coverage: float
    recommended_model: str
    confidence: float


@dataclass
class RoutingStats:
    """Routing decision counters."""

    total: int = 0
    rife_count: int = 0
    vfimamba_count: int = 0
    scene_change_count: int = 0

    def add(self, model: str):
        self.total += 1
        if model == "rife":
            self.rife_count += 1
        elif model == "vfimamba":
            self.vfimamba_count += 1
        elif model == "scene_change":
            self.scene_change_count += 1

    def to_dict(self) -> dict:
        if self.total == 0:
            return {"total": 0}
        return {
            "total": self.total,
            "rife": self.rife_count,
            "rife_pct": self.rife_count / self.total * 100,
            "vfimamba": self.vfimamba_count,
            "vfimamba_pct": self.vfimamba_count / self.total * 100,
            "scene_change": self.scene_change_count,
            "scene_change_pct": self.scene_change_count / self.total * 100,
        }


def scene_cut_signals(s0: torch.Tensor, s1: torch.Tensor, flow_small: torch.Tensor,
                      scene_thr: float, scene_warp_thr: float):
    """Scene cut = SSIM of the small grays below ``scene_thr`` AND SSIM after
    warping s1 back by the measured flow below ``scene_warp_thr`` (real
    motion re-aligns under the warp; a cut does not).

    s0/s1: [N,h,w] small grays; flow_small: [N,h,w,2] in small-res px.
    Returns (is_scene [N] bool, ssim [N], warped_ssim [N]).
    """
    ssim_score = ssim_windowed(s0, s1)
    warped = backward_warp(s1[..., None], flow_small, 1.0, border="replicate")[..., 0]
    warped_ssim = ssim_windowed(s0, warped)
    is_scene = (ssim_score < scene_thr) & (warped_ssim < scene_warp_thr)
    return is_scene, ssim_score, warped_ssim


def _analyze_core(f0: torch.Tensor, f1: torch.Tensor, history: torch.Tensor,
                  history_count: torch.Tensor, scene_thr: float, scene_warp_thr: float,
                  particle_thr: float, hud_var_thr: float, hud_agree_eps: float = 0.0) -> dict:
    """Router signals of a batch of pairs. f0/f1: [N,H,W,3] float [0,1];
    history: [N,K,180,320] ring of past grays (newest appended by the
    caller); history_count: [N] valid entries. Returns per-pair signals and
    the full-res HUD mask."""
    n, h, w, _ = f0.shape
    g0 = rgb_to_gray(f0 * 255.0)
    g1 = rgb_to_gray(f1 * 255.0)

    # motion: full-res Farneback
    flow = farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2)
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    motion_mean = mag.mean(dim=(1, 2))
    motion_max = mag.amax(dim=(1, 2))
    motion_std = mag.std(dim=(1, 2), correction=0)

    # scene cut: SSIM of the 0.25x grays, confirmed by the flow-compensated SSIM
    sh, sw = max(h // 4, 7), max(w // 4, 7)
    s0 = resize(g0[..., None], (sh, sw), "linear")[..., 0]
    s1 = resize(g1[..., None], (sh, sw), "linear")[..., 0]
    flow_small = resize(flow, (sh, sw), "linear") * torch.tensor(
        [sw / w, sh / h], dtype=flow.dtype, device=flow.device)
    is_scene, ssim_score, warped_ssim = scene_cut_signals(s0, s1, flow_small, scene_thr,
                                                          scene_warp_thr)

    # particles
    flow_score = torch.clamp(motion_std / 20.0, max=1.0)
    lap = laplacian(g0[..., None])[..., 0]
    freq_score = torch.clamp(lap.var(dim=(1, 2), correction=0) / 500.0, max=1.0)
    particle_score = torch.sqrt(flow_score * freq_score)

    # HUD: temporal variance over the last 5 history frames
    var = history[:, -5:].var(dim=1, correction=0)
    hud_small = (var < hud_var_thr).float()
    hud_small = torch.where((history_count >= 5)[:, None, None], hud_small, 0.0)
    hud_full = resize(hud_small[..., None], (h, w), "nearest")[..., 0]
    hud_mask = morph_open(morph_close(hud_full, 5), 5) > 0.5
    if hud_agree_eps > 0:
        # copy a source pixel only where the endpoints already agree: the
        # low-res variance test alone takes slow smooth motion for HUD
        hud_mask = hud_mask & (torch.abs(g0 - g1) <= hud_agree_eps)

    return {
        "ssim": ssim_score,
        "warped_ssim": warped_ssim,
        "is_scene_change": is_scene,
        "motion_mean": motion_mean,
        "motion_max": motion_max,
        "motion_std": motion_std,
        "particle_score": particle_score,
        "has_particles": particle_score > particle_thr,
        "hud_mask": hud_mask,
        "hud_coverage": hud_mask.float().mean(dim=(1, 2)),
    }


def _push_history(history: torch.Tensor, count: torch.Tensor, frame: torch.Tensor):
    """Append the 320x180 gray of ``frame`` to the HUD ring (shift left)."""
    g = rgb_to_gray(frame * 255.0)
    small = resize(g[..., None], _HUD_RES, "linear")[..., 0]
    return (torch.cat([history[:, 1:], small[:, None]], dim=1),
            torch.clamp(count + 1, max=history.shape[1]))


class AdaptiveRouter:
    """Content analyser and routing rule. The HUD history is a device ring
    buffer [N, K, 180, 320]."""

    def __init__(
        self,
        motion_threshold_low: float = 5.0,
        motion_threshold_high: float = 25.0,
        scene_change_threshold: float = 0.65,
        scene_warp_ssim_threshold: Optional[float] = None,
        particle_threshold: float = 0.4,
        hud_variance_threshold: float = 10.0,
        hud_history_frames: int = 10,
        quality_aware: bool = True,
        device: str = "cuda",
        gate_path: Optional[str] = None,
    ):
        self.motion_threshold_low = motion_threshold_low
        self.motion_threshold_high = motion_threshold_high
        self.scene_change_threshold = scene_change_threshold
        self.gate_path = gate_path  # None: weights/router_gate.json
        # flow-compensated scene-cut confirmation: the calibrated threshold
        # when quality-aware, else 1.0 (the reference's SSIM-only gate)
        if scene_warp_ssim_threshold is None and quality_aware:
            from vfisr_tpu_torch.utils.router_gate import scene_warp_threshold

            scene_warp_ssim_threshold = scene_warp_threshold(gate_path)
        self.scene_warp_ssim_threshold = (
            1.0 if scene_warp_ssim_threshold is None else float(scene_warp_ssim_threshold))
        self.quality_aware = quality_aware
        self.particle_threshold = particle_threshold
        self.hud_variance_threshold = hud_variance_threshold
        self.hud_agree_eps = 3.0 if quality_aware else 0.0
        self.hud_history_frames = hud_history_frames
        self.device = torch.device(device)
        self._history = None
        self._history_count = None
        self.hud_mask: Optional[np.ndarray] = None

    def reset_history(self):
        self._history = None
        self._history_count = None

    def _ensure_history(self, n: int, device: torch.device):
        if self._history is None or self._history.shape[0] != n or self._history.device != device:
            self._history = torch.zeros((n, self.hud_history_frames, *_HUD_RES),
                                        dtype=torch.float32, device=device)
            self._history_count = torch.zeros((n,), dtype=torch.int32, device=device)

    def analyze_device(self, x0: torch.Tensor, x1: torch.Tensor) -> dict:
        """Batched analysis on x0's device; advances the HUD history with x0."""
        self._ensure_history(x0.shape[0], x0.device)
        self._history, self._history_count = _push_history(self._history, self._history_count, x0)
        return _analyze_core(x0, x1, self._history, self._history_count,
                             self.scene_change_threshold, self.scene_warp_ssim_threshold,
                             self.particle_threshold, self.hud_variance_threshold,
                             self.hud_agree_eps)

    def _bin_winner_native(self, motion_mean: float) -> Optional[str]:
        """The measured-best expert at this motion (native regime), or None
        when not quality-aware or uncalibrated."""
        if not self.quality_aware:
            return None
        from vfisr_tpu_torch.utils.router_gate import bin_winner

        return bin_winner("native", motion_mean, path=self.gate_path)

    def routing_masks(self, sig: dict) -> dict:
        """Per-pair route: particles or motion_max > high -> vfimamba; when
        the per-motion-bin calibration exists, the measured winner at each
        pair's motion_mean instead (one readback of motion_mean)."""
        scene = sig["is_scene_change"]
        use_mamba = sig["has_particles"] | (sig["motion_max"] > self.motion_threshold_high)
        if self.quality_aware:
            winners = [self._bin_winner_native(float(m)) for m in sig["motion_mean"].tolist()]
            if any(w is not None for w in winners):
                use_mamba = torch.tensor([w == "vfimamba" for w in winners], device=scene.device)
        return {"scene": scene, "vfimamba": use_mamba & ~scene, "rife": ~use_mamba & ~scene}

    # ---- per-pair numpy API ----
    def analyze(self, frame0: np.ndarray, frame1: np.ndarray) -> ContentAnalysis:
        sig = {k: v.cpu() for k, v in self.analyze_device(to_batched(frame0, self.device),
                                                          to_batched(frame1, self.device)).items()}
        self.hud_mask = sig["hud_mask"][0].numpy()
        ssim_score = float(sig["ssim"][0])
        if bool(sig["is_scene_change"][0]):
            return ContentAnalysis(motion_mean=0, motion_max=0, motion_std=0, has_particles=False,
                                   is_scene_change=True, hud_coverage=0,
                                   recommended_model="scene_change", confidence=1.0 - ssim_score)
        motion_mean = float(sig["motion_mean"][0])
        motion_max = float(sig["motion_max"][0])
        particle_score = float(sig["particle_score"][0])
        has_particles = bool(sig["has_particles"][0])
        winner = self._bin_winner_native(motion_mean)
        use_mamba = (winner == "vfimamba" if winner is not None
                     else has_particles or motion_max > self.motion_threshold_high)
        if use_mamba:
            recommended, confidence = "vfimamba", min(particle_score + motion_max / 50.0, 1.0)
        elif motion_mean < self.motion_threshold_low:
            recommended, confidence = "rife", 1.0 - motion_mean / self.motion_threshold_low
        else:
            recommended, confidence = "rife", 0.7
        return ContentAnalysis(motion_mean=motion_mean, motion_max=motion_max,
                               motion_std=float(sig["motion_std"][0]), has_particles=has_particles,
                               is_scene_change=False, hud_coverage=float(sig["hud_coverage"][0]),
                               recommended_model=recommended, confidence=confidence)

    def compute_motion(self, frame0, frame1):
        """(mean, max, std, magnitude map) of the Farneback flow of two HWC
        frames in [0, 255]."""
        g0 = rgb_to_gray(torch.as_tensor(np.asarray(frame0), device=self.device).float())
        g1 = rgb_to_gray(torch.as_tensor(np.asarray(frame1), device=self.device).float())
        flow = farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2)
        mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2).cpu().numpy()
        return float(mag.mean()), float(mag.max()), float(mag.std()), mag

    def detect_scene_change(self, frame0, frame1):
        """(cut?, SSIM) of the 0.25x grays alone (the reference's test)."""
        g0 = rgb_to_gray(torch.as_tensor(np.asarray(frame0), device=self.device))
        g1 = rgb_to_gray(torch.as_tensor(np.asarray(frame1), device=self.device))
        h, w = g0.shape[-2:]
        s0 = resize(g0[..., None].float(), (h // 4, w // 4), "linear")[..., 0]
        s1 = resize(g1[..., None].float(), (h // 4, w // 4), "linear")[..., 0]
        score = float(ssim_windowed(s0, s1))
        return score < self.scene_change_threshold, score


def _composite_outputs(rife_out: torch.Tensor, mamba_out: torch.Tensor, x0: torch.Tensor,
                       x1: torch.Tensor, masks_scene: torch.Tensor, masks_mamba: torch.Tensor,
                       hud_mask: torch.Tensor, hud_coverage: torch.Tensor,
                       timestamps: Tuple[float, ...]) -> torch.Tensor:
    """Branchless select: expert choice, scene-cut repeat of x0, and HUD
    compositing (source x0 for t < 0.5, else x1). Outputs [N,T,H,W,3]."""
    sel = torch.where(masks_mamba[:, None, None, None, None], mamba_out, rife_out)
    sel = torch.where(masks_scene[:, None, None, None, None], x0[:, None].expand_as(sel), sel)
    hud = ((hud_coverage > 0.01)[:, None, None] & hud_mask)[..., None]
    return torch.stack([torch.where(hud, x0 if t < 0.5 else x1, sel[:, i])
                        for i, t in enumerate(timestamps)], dim=1)


class AdaptivePipeline(BaseModel):
    """Adaptive VFI+SR: the router, RIFE, VFIMamba and Lanczos4 SR.

    ``rife_weights``, ``vfimamba_weights`` and ``gate_path`` name the files
    to load; each left None is looked up under ``weights/``. An explicit
    checkpoint path is strict: a missing or mismatched file raises, where an
    automatic lookup falls back as the reference does (RIFE to fresh init,
    VFIMamba to RIFE for every pair, with a warning).
    """

    def __init__(
        self,
        device: str = "cuda",
        motion_threshold_low: float = 5.0,
        motion_threshold_high: float = 25.0,
        enable_vfimamba: bool = True,
        sr_model_name: str = "lanczos",
        route_mode: str = "hosted",  # 'hosted' | 'masked'
        quality_aware: bool = True,
        rife_weights: Optional[str] = None,
        vfimamba_weights: Optional[str] = None,
        gate_path: Optional[str] = None,
    ):
        super().__init__(device)
        if route_mode not in ("hosted", "masked"):
            raise ValueError(f"route_mode must be 'hosted' or 'masked'; got {route_mode!r}")
        self.enable_vfimamba = enable_vfimamba
        self.quality_aware = quality_aware
        self.sr_model_name = sr_model_name
        self.route_mode = route_mode
        self.rife_weights = rife_weights
        self.vfimamba_weights = vfimamba_weights
        self.gate_path = gate_path
        self.router = AdaptiveRouter(motion_threshold_low=motion_threshold_low,
                                     motion_threshold_high=motion_threshold_high,
                                     quality_aware=quality_aware, device=device,
                                     gate_path=gate_path)
        self.stats = RoutingStats()
        self._rife = None
        self._vfimamba = None

    @property
    def info(self) -> ModelInfo:
        return ModelInfo(
            name="AdaptivePipeline", type="novel", supports_vfi=True, supports_sr=True,
            supports_joint=False, parameters=27_700_000, requires_gpu=True,
            description=("Novel adaptive routing: fast RIFE for easy content, "
                         "quality VFIMamba for hard content"))

    def load(self) -> None:
        """Load RIFE (f32 config) and, unless the calibration rules it out,
        VFIMamba. Sets cuDNN and matmul TF32 off: both experts run f32."""
        from vfisr_tpu_torch.models.sota.rife import RIFEModel
        from vfisr_tpu_torch.models.sota.vfimamba import VFIMambaModel
        from vfisr_tpu_torch.utils.paths import default_weights
        from vfisr_tpu_torch.utils.router_gate import expert_bins, heavy_expert_allowed

        if self.sr_model_name == "span":
            raise NotImplementedError("SPAN SR is not ported yet (ROADMAP queue 1, item 7)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self._rife = RIFEModel(device=self.device)
        self._rife.load(self.rife_weights)
        if self.enable_vfimamba and self.quality_aware:
            bins = expert_bins("native", self.gate_path)
            if bins is not None:
                # keep the heavy expert iff it measurably wins some motion bin
                if not any(b.get("vfimamba") is not None and b.get("rife") is not None
                           and float(b["vfimamba"]) > float(b["rife"]) for b in bins):
                    print("AdaptivePipeline: calibrated native-regime bins show vfimamba below "
                          "rife in every motion bin (router_gate.json): heavy expert disabled")
                    self.enable_vfimamba = False
            elif not heavy_expert_allowed("vfimamba", "rife", self.gate_path):
                print("AdaptivePipeline: calibration shows vfimamba below rife on held-out "
                      "scenes (router_gate.json): hard pairs fall back to RIFE")
                self.enable_vfimamba = False
        if self.enable_vfimamba:
            explicit = self.vfimamba_weights is not None
            try:
                # the hardest pairs never go to a fresh-init net: the full
                # variant when its checkpoint exists, else the trained S one
                variant = "full" if explicit or default_weights("vfimamba") else (
                    "s" if default_weights("vfimamba_s") else "full")
                self._vfimamba = VFIMambaModel(variant=variant, device=self.device)
                self._vfimamba.load(self.vfimamba_weights)
            except Exception as e:  # degrade as the reference does, unless asked for a file
                if explicit:
                    raise
                print(f"Warning: Could not load VFIMamba: {e}")
                print("Will use RIFE for all frames")
                self.enable_vfimamba = False
        self._loaded = True

    def _count(self, scene: np.ndarray, mamba: np.ndarray) -> None:
        for s, m in zip(scene, mamba):
            self.stats.add("scene_change" if s else "vfimamba" if m else "rife")

    def interpolate_batch(self, x0: torch.Tensor, x1: torch.Tensor,
                          timestamps: Tuple[float, ...]) -> torch.Tensor:
        """[N,H,W,3] pairs -> [N,T,H,W,3] routed, scene-held, HUD-composited."""
        timestamps = tuple(timestamps)
        sig = self.router.analyze_device(x0, x1)
        masks = self.router.routing_masks(sig)
        n = x0.shape[0]
        if self.route_mode == "masked" and self.enable_vfimamba:
            rife_out = self._rife.interpolate_batch(x0, x1, timestamps)
            mamba_out = self._vfimamba.interpolate_batch(x0, x1, timestamps)
            self._count(*torch.stack([masks["scene"], masks["vfimamba"]]).cpu().numpy())
            return _composite_outputs(rife_out, mamba_out, x0, x1, masks["scene"],
                                      masks["vfimamba"], sig["hud_mask"], sig["hud_coverage"],
                                      timestamps)
        # hosted: one mask readback, then each expert on the contiguous runs
        # of pairs routed to it; scene-cut rows skip the experts and are
        # replaced by the composite
        scene_np, mamba_np = torch.stack([masks["scene"], masks["vfimamba"]]).cpu().numpy()
        if not self.enable_vfimamba:
            mamba_np = np.zeros(n, bool)
        routes = np.where(scene_np, 0, np.where(mamba_np, 2, 1))
        t = len(timestamps)
        h, w = x0.shape[1:3]
        chunks, start = [], 0
        for i in range(1, n + 1):
            if i < n and routes[i] == routes[start]:
                continue
            a, b = x0[start:i], x1[start:i]
            if routes[start] == 1:
                chunks.append(self._rife.interpolate_batch(a, b, timestamps))
            elif routes[start] == 2:
                chunks.append(self._vfimamba.interpolate_batch(a, b, timestamps))
            else:
                chunks.append(x0.new_zeros((i - start, t, h, w, 3)))
            start = i
        out = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
        self._count(scene_np, mamba_np)
        return _composite_outputs(out, out, x0, x1, masks["scene"],
                                  torch.zeros_like(masks["scene"]), sig["hud_mask"],
                                  sig["hud_coverage"], timestamps)

    def interpolate(self, frame0: np.ndarray, frame1: np.ndarray, num_frames: int = 3,
                    timestamps: Optional[List[float]] = None) -> List[np.ndarray]:
        self.ensure_loaded()
        return super().interpolate(frame0, frame1, num_frames, timestamps)

    def upscale_batch(self, x: torch.Tensor, scale: float = 1.333) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        return resize(x, scale_size(h, w, scale), "lanczos4")

    def upscale(self, frame: np.ndarray, scale: float = 1.333) -> np.ndarray:
        self.ensure_loaded()
        return super().upscale(frame, scale)

    def process_pair(self, frame0: np.ndarray, frame1: np.ndarray, num_intermediate: int = 3,
                     target_scale: float = 1.333) -> InferenceResult:
        """The whole pipeline for one pair of HWC uint8 frames, with the
        analysis (run once) in ``extra_info``."""
        self.ensure_loaded()
        start = time.perf_counter()
        analysis = self.router.analyze(frame0, frame1)
        if analysis.is_scene_change:
            self.stats.add("scene_change")
            interpolated = [frame0.copy() for _ in range(num_intermediate)]
        else:
            timestamps = self.get_default_timestamps(num_intermediate)
            if analysis.recommended_model == "vfimamba" and self.enable_vfimamba:
                self.stats.add("vfimamba")
                interpolated = self._vfimamba.interpolate(frame0, frame1, num_intermediate)
            else:
                self.stats.add("rife")
                interpolated = self._rife.interpolate(frame0, frame1, num_intermediate)
            if analysis.hud_coverage > 0.01 and self.router.hud_mask is not None:
                hud = self.router.hud_mask
                for i, t in enumerate(timestamps):
                    interpolated[i][hud] = (frame0 if t < 0.5 else frame1)[hud]
        upscaled = [self.upscale(f, target_scale) for f in [frame0, *interpolated, frame1]]
        return InferenceResult(
            frames=upscaled,
            inference_time_ms=(time.perf_counter() - start) * 1000,
            vram_peak_mb=device_peak_mb(self.device),
            model_used=self.info.name,
            extra_info={
                "analysis": {
                    "motion_mean": analysis.motion_mean,
                    "motion_max": analysis.motion_max,
                    "has_particles": analysis.has_particles,
                    "is_scene_change": analysis.is_scene_change,
                    "hud_coverage": analysis.hud_coverage,
                    "recommended_model": analysis.recommended_model,
                },
                "routing_stats": self.stats.to_dict(),
            },
        )

    def get_stats(self) -> dict:
        return self.stats.to_dict()

    def reset_stats(self) -> None:
        self.stats = RoutingStats()
