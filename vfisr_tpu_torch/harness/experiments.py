"""The named-experiment sweep (port of ``vfisr_tpu/harness/experiments.py``).

- the LIGHT and HEAVY experiment tables and the quality-level matrix;
- ``run_experiment``, the per-frame loop: each keyframe degraded to
  960x540 (area), upscaled per method (Lanczos4 or cubic), optionally edge
  enhanced, three VFI frames per pair written to the video; every step one
  frame at a time on ``device``, its result uint8 on the host, as the
  reference's cv2 calls leave it;
- the metrics: keyframes against the reference frames, the t = 0.5 VFI
  frame against the ground-truth midpoint, LPIPS on every 10th VFI frame,
  overall = 0.25 * keyframe + 0.75 * VFI;
- ``run_experiment_sweep``: experiments x intervals with a results JSON
  saved after every experiment, resume and replace, and a two-stage
  SIGINT/SIGTERM shutdown. With ``device_batched`` (the default) every
  experiment runs through ``harness/device_sweep.py`` and a failure there
  is that experiment's failure: there is no fall back to the per-frame
  loop.

Videos are written as Y4M (``<name>_i<interval>.y4m``): the port's writer
needs no codec library, and the card's machine has none.
"""

from __future__ import annotations

import json
import signal
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.core.warp import remap_bilinear
from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter
from vfisr_tpu_torch.evaluation.metrics import calc_psnr, calc_ssim, safe_round
from vfisr_tpu_torch.methods.inline import (
    calc_motion,
    edge_enhance,
    estimate_motion_complexity,
    linear_blend,
    mcar_interpolate_cached,
    ughi_interpolate,
    ui_aware_interpolate,
)
from vfisr_tpu_torch.ops.flow import farneback_flow

INPUT_W, INPUT_H = 960, 540
DURATION = 5.0

QUALITY_LEVELS = {
    "high": {"fps": 120, "resolution": (3840, 2160), "label": "4K@120"},
    "medium": {"fps": 90, "resolution": (2560, 1440), "label": "1440p@90"},
    "low": {"fps": 60, "resolution": (1920, 1080), "label": "1080p@60"},
}
DEFAULT_QUALITY = "medium"

LIGHT_EXPERIMENTS = [
    {"name": "control", "vfi": "none", "sr": "lanczos", "edge": 0, "motion_thresh": 0, "description": "Reference (no degradation)"},
    {"name": "degraded", "vfi": "frame_dup", "sr": "bicubic", "edge": 0, "motion_thresh": 0, "description": "Worst case baseline"},
    {"name": "lanczos_blend", "vfi": "linear_blend", "sr": "lanczos", "edge": 0, "motion_thresh": 0, "description": "Simple interpolation"},
    {"name": "lanczos_blend_edge", "vfi": "linear_blend", "sr": "lanczos", "edge": 1.3, "motion_thresh": 0, "description": "Blend + edge enhance"},
    {"name": "lanczos_blend_sharp", "vfi": "linear_blend", "sr": "lanczos", "edge": 1.5, "motion_thresh": 0, "description": "Blend + strong sharpen"},
    {"name": "optical_flow_basic", "vfi": "optical_flow", "sr": "lanczos", "edge": 0, "description": "Optical flow VFI"},
    {"name": "optical_flow_edge", "vfi": "optical_flow", "sr": "lanczos", "edge": 1.3, "description": "Optical flow + edge"},
    {"name": "optical_flow_sharp", "vfi": "optical_flow", "sr": "lanczos", "edge": 1.5, "description": "Optical flow + strong sharpen"},
    {"name": "bicubic_blend", "vfi": "linear_blend", "sr": "bicubic", "edge": 0, "description": "Bicubic SR + blend"},
    {"name": "bicubic_blend_edge", "vfi": "linear_blend", "sr": "bicubic", "edge": 1.3, "description": "Bicubic + edge"},
    {"name": "uafi_default", "vfi": "ui_aware", "sr": "lanczos", "edge": 1.3, "description": "UI-Aware Frame Interpolation"},
    {"name": "ughi_default", "vfi": "ughi", "sr": "lanczos", "edge": 1.3, "description": "Uncertainty-Guided Hybrid"},
]

HEAVY_EXPERIMENTS = [
    {"name": "rife_fast", "vfi": "rife", "sr": "lanczos", "edge": 1.3, "rife_scale": 0.25, "description": "RIFE fast (scale 0.25)"},
    {"name": "rife_default", "vfi": "rife", "sr": "lanczos", "edge": 1.3, "rife_scale": 0.5, "description": "RIFE default"},
    {"name": "adaptive_conservative", "vfi": "adaptive", "sr": "lanczos", "edge": 1.3, "motion_thresh": 5.0, "description": "Adaptive (conservative)"},
    {"name": "adaptive_default", "vfi": "adaptive", "sr": "lanczos", "edge": 1.3, "motion_thresh": 3.0, "description": "Adaptive (default)"},
    # the quality-priority tier: its blend route is also bounded by the
    # measured blend-vs-RIFE crossover (weights/router_gate.json), and its
    # neural pairs take the calibrated per-motion-bin expert
    {"name": "adaptive_aggressive", "vfi": "adaptive", "sr": "lanczos", "edge": 1.3, "motion_thresh": 1.5, "quality_aware": True, "description": "Adaptive (aggressive)"},
    {"name": "mcar_default", "vfi": "mcar", "sr": "lanczos", "edge": 1.3, "mcar_low": 0.25, "mcar_high": 0.6, "description": "Motion-Complexity Adaptive Routing"},
    {"name": "mcar_aggressive", "vfi": "mcar", "sr": "lanczos", "edge": 1.3, "mcar_low": 0.15, "mcar_high": 0.4, "description": "MCAR (more RIFE usage)"},
]

EXPERIMENTS = LIGHT_EXPERIMENTS + HEAVY_EXPERIMENTS

CORE_LIGHT = [e for e in LIGHT_EXPERIMENTS if e["name"] in
              ("control", "degraded", "lanczos_blend_edge", "optical_flow_edge")]
CORE_HEAVY = [e for e in HEAVY_EXPERIMENTS if e["name"] in ("rife_default", "adaptive_default")]


def generate_quality_experiments(base_experiments, quality_levels=None):
    """Experiments x quality levels: each experiment at each level's fps and
    resolution, named ``<name>_<label>``."""
    if quality_levels is None:
        quality_levels = list(QUALITY_LEVELS)
    out = []
    for quality in quality_levels:
        q = QUALITY_LEVELS[quality]
        for exp in base_experiments:
            e = exp.copy()
            e["quality_level"] = quality
            e["quality_fps"] = q["fps"]
            e["quality_resolution"] = q["resolution"]
            e["name"] = f"{exp['name']}_{q['label']}"
            e["description"] = f"{exp.get('description', '')} @ {q['label']}"
            out.append(e)
    return out


def _device_key(device) -> torch.device:
    """device with its index: "cuda" and a tensor's "cuda:0" compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class _RIFESingleton:
    """One RIFE (``get_model("rife", load=True)``: weights/rife.npz) per
    process, on the device it was asked for last."""

    _instance = None

    @classmethod
    def get(cls, device="cuda"):
        dev = _device_key(device)
        if cls._instance is None or _device_key(cls._instance.device) != dev:
            from vfisr_tpu_torch.models.registry import get_model

            cls._instance = get_model("rife", device=dev, load=True)
            print("[RIFE] Model loaded")
        return cls._instance


def _rife_native_scale(rife_scale: float) -> float:
    """The reference's rife_scale (Practical-RIFE units: 0.5 the default at
    1080p, 0.25 the fast mode) in the native model's pyramid units: the
    trained full pyramid is the default operating point, so 0.5 -> 1.0 and
    0.25 -> 0.5 (one level coarser)."""
    return min(float(rife_scale) * 2.0, 1.0)


def _rife_interpolate(prev: np.ndarray, curr: np.ndarray, t: float, scale: float = 0.5,
                      device: str = "cuda") -> np.ndarray:
    """One RIFE frame at t, the pyramid at the reference's rife_scale."""
    m = _RIFESingleton.get(device)
    return m.interpolate(prev, curr, num_frames=1, timestamps=[t],
                         scale=_rife_native_scale(scale))[0]


class _VFIMambaSingleton:
    """One VFIMamba (``get_model("vfimamba", load=True)``), the
    quality-aware tier's heavy expert, per process."""

    _instance = None

    @classmethod
    def get(cls, device="cuda"):
        dev = _device_key(device)
        if cls._instance is None or _device_key(cls._instance.device) != dev:
            from vfisr_tpu_torch.models.registry import get_model

            cls._instance = get_model("vfimamba", device=dev, load=True)
            print("[VFIMamba] Model loaded")
        return cls._instance

    @classmethod
    def release(cls):
        """Drop the instance and its device memory."""
        cls._instance = None


def _vfimamba_interpolate(prev: np.ndarray, curr: np.ndarray, t: float,
                          device: str = "cuda") -> np.ndarray:
    return _VFIMambaSingleton.get(device).interpolate(prev, curr, num_frames=1, timestamps=[t])[0]


def route_neural_expert(motion: float, quality_aware: bool):
    """The neural expert of a sweep pair above the blend gate: (name,
    rife_scale override). Quality-aware tiers take the winner of the pair's
    motion bin in weights/router_gate.json's 'sweep' regime among rife@0.5,
    rife@0.25 ('rife_fast') and vfimamba; otherwise, or uncalibrated,
    ('rife', None) keeps the experiment's rife_scale."""
    if quality_aware:
        from vfisr_tpu_torch.utils.router_gate import bin_winner

        w = bin_winner("sweep", motion, experts=("rife", "rife_fast", "vfimamba"))
        if w == "rife_fast":
            return "rife", 0.25
        if w == "vfimamba":
            return "vfimamba", None
        if w == "rife":
            return "rife", 0.5
    return "rife", None


def _resize_u8(frame, size_wh, method: str, device) -> np.ndarray:
    """cv2.resize of a uint8 frame (dsize (w, h)) on device, back as uint8."""
    w, h = size_wh
    return resize(to_device(frame, device), (h, w), method).cpu().numpy()


def _gray_u8(frame: np.ndarray, device) -> np.ndarray:
    """cv2.cvtColor(frame, COLOR_RGB2GRAY) on device."""
    return rgb_to_gray(to_device(frame, device)).cpu().numpy()


def _flow_half_res(prev_gray, curr_gray, out_w: int, out_h: int,
                   device: str = "cuda") -> torch.Tensor:
    """Farneback on the gray frames resized to half (bilinear, uint8), the
    flow resized back to (out_h, out_w) (bilinear) and doubled: [H, W, 2]
    f32 on device."""
    g = resize(to_device(np.stack([prev_gray, curr_gray]), device)[..., None],
               (out_h // 2, out_w // 2), "linear")[..., 0].float()
    fl = farneback_flow(g[:1], g[1:])
    return resize(fl, (out_h, out_w), "linear")[0] * 2


def generate_reference(video_path: str, start_s: float, duration: float = 5.0,
                       output_resolution=(1920, 1080), extract_midpoints: bool = True,
                       device: str = "cuda"):
    """Keyframes and midpoints of a raw video (legacy mode): each frame
    cropped to 16:9 and resized to output_resolution (Lanczos4), on device
    as the interval extraction does it (a Y4M frame's I420 -> RGB there
    too); even frames are keyframes, odd ones midpoints. Read through the
    port's ``VideoReader`` (Y4M without OpenCV). Returns (keyframes,
    midpoints) as lists of HWC uint8 RGB."""
    from vfisr_tpu_torch.data.extract_intervals import fit_frame

    probe = VideoReader(video_path)
    fps = float(probe.fps) or 30.0
    probe.close()
    keyframes, midpoints = [], []
    with VideoReader(video_path, start_frame=int(start_s * fps)) as reader:
        for idx in range(int(duration * fps)):
            frame = reader.read_to(device)
            if frame is None:
                break
            frame = fit_frame(frame, output_resolution).cpu().numpy()
            if idx % 2 == 0:
                keyframes.append(frame)
            elif extract_midpoints:
                midpoints.append(frame)
    return keyframes, midpoints


class GracefulShutdown:
    """Two-stage SIGINT/SIGTERM handler: the first signal asks the sweep to
    stop after the current experiment, the second exits. ``restore`` puts
    the handlers it replaced back."""

    def __init__(self):
        self.requested = False
        self._previous = None

    def install(self):
        if self._previous is not None:
            return

        def handler(signum, frame):
            if self.requested:
                print("\nForce exit.")
                raise SystemExit(130)
            print("\nShutdown requested — finishing current experiment "
                  "(press again to force quit)...")
            self.requested = True

        self._previous = {s: signal.signal(s, handler) for s in (signal.SIGINT, signal.SIGTERM)}

    def restore(self):
        if self._previous is not None:
            for s, h in self._previous.items():
                signal.signal(s, h)
            self._previous = None


def run_experiment(
    source_keyframes: List[np.ndarray],
    gt_midpoints: Optional[List[np.ndarray]],
    experiment: dict,
    ref_frames: Optional[List[np.ndarray]] = None,
    output_path: Optional[str] = None,
    out_fps: Optional[float] = None,
    lpips_fn=None,
    lpips_mode: Optional[str] = None,
    verbose: bool = True,
    device: str = "cuda",
) -> dict:
    """One experiment over an interval, a frame at a time.

    source_keyframes: full-resolution RGB keyframes (the 30 fps stream);
    gt_midpoints: RGB midpoints for the VFI metrics; ref_frames: reference
    keyframes for the SR metrics (source_keyframes by default). Every
    resize, gray conversion, method and metric runs on ``device``.
    """
    name = experiment["name"]
    vfi_method = experiment.get("vfi", "linear_blend")
    sr_method = experiment.get("sr", "lanczos")
    edge_strength = experiment.get("edge", 0)
    motion_thresh = experiment.get("motion_thresh", 3.0)
    quality_aware = bool(experiment.get("quality_aware", False))
    blend_thresh = motion_thresh
    if quality_aware:
        from vfisr_tpu_torch.utils.router_gate import blend_crossover_px

        crossover = blend_crossover_px()
        if crossover is not None:
            blend_thresh = min(motion_thresh, crossover)
    rife_scale = experiment.get("rife_scale", 0.5)
    mcar_low = experiment.get("mcar_low", 0.3)
    mcar_high = experiment.get("mcar_high", 0.7)
    exp_fps = experiment.get("quality_fps", QUALITY_LEVELS[DEFAULT_QUALITY]["fps"])
    exp_out_w, exp_out_h = experiment.get(
        "quality_resolution", QUALITY_LEVELS[DEFAULT_QUALITY]["resolution"])
    quality_level = experiment.get("quality_level", "default")

    is_control = name == "control" or name.startswith("control_")
    interp = "cubic" if sr_method == "bicubic" else "lanczos4"
    if ref_frames is None:
        ref_frames = source_keyframes

    writer = VideoWriter(output_path, exp_out_w, exp_out_h, out_fps or exp_fps) if output_path else None

    LPIPS_SAMPLE_RATE = 10
    cnt = 0
    psnr_sum = ssim_sum = 0.0
    metric_cnt = 0
    vfi_psnr_sum = vfi_ssim_sum = 0.0
    vfi_metric_cnt = 0
    vfi_lpips_sum = 0.0
    vfi_lpips_cnt = 0
    rife_frame_count = 0
    vfimamba_frame_count = 0
    total_interp_frames = 0
    midpoint_idx = 0
    prev = prev_gray = None
    t0 = time.time()

    def emit(frame):
        nonlocal cnt
        if writer:
            writer.write(frame)
        cnt += 1

    def eval_vfi(vfi_frame):
        nonlocal vfi_psnr_sum, vfi_ssim_sum, vfi_metric_cnt, vfi_lpips_sum, vfi_lpips_cnt
        if gt_midpoints and midpoint_idx < len(gt_midpoints):
            gt = gt_midpoints[midpoint_idx]
            if gt.shape[:2] != vfi_frame.shape[:2]:
                gt = _resize_u8(gt, (vfi_frame.shape[1], vfi_frame.shape[0]), "lanczos4", device)
            vfi_psnr_sum += calc_psnr(vfi_frame, gt, device)
            vfi_ssim_sum += calc_ssim(_gray_u8(vfi_frame, device), _gray_u8(gt, device), device)
            vfi_metric_cnt += 1
            if vfi_metric_cnt % LPIPS_SAMPLE_RATE == 0 and lpips_fn is not None:
                val = lpips_fn(vfi_frame, gt)
                if val is not None:
                    vfi_lpips_sum += float(val)
                    vfi_lpips_cnt += 1

    for ref_idx, src in enumerate(source_keyframes):
        if is_control:
            out = _resize_u8(src, (exp_out_w, exp_out_h), "lanczos4", device)
            out_for_metrics = out
        else:
            degraded = _resize_u8(src, (INPUT_W, INPUT_H), "area", device)
            out = _resize_u8(degraded, (exp_out_w, exp_out_h), interp, device)
            out_for_metrics = out
            if edge_strength > 0:
                out = edge_enhance(out, edge_strength, device)

        needs_gray = vfi_method in ("optical_flow", "adaptive", "mcar")
        curr_gray = _gray_u8(out, device) if needs_gray else None

        if prev is not None:
            if vfi_method == "frame_dup":
                for i in range(1, 4):
                    emit(prev)
                    if i == 2:
                        eval_vfi(prev)
            elif vfi_method == "adaptive" and prev_gray is not None:
                motion = calc_motion(_resize_u8(prev_gray[..., None], (480, 270), "linear", device)[..., 0],
                                     _resize_u8(curr_gray[..., None], (480, 270), "linear", device)[..., 0],
                                     device)
                total_interp_frames += 3
                use_rife_here = motion > blend_thresh
                expert, scale_override = "rife", None
                if use_rife_here:
                    expert, scale_override = route_neural_expert(motion, quality_aware)
                    rife_frame_count += 3
                    if expert == "vfimamba":
                        vfimamba_frame_count += 3
                for i in range(1, 4):
                    t = i / 4
                    if not use_rife_here:
                        mid = linear_blend(prev, out, t, device)
                    elif expert == "vfimamba":
                        mid = _vfimamba_interpolate(prev, out, t, device)
                    else:
                        mid = _rife_interpolate(
                            prev, out, t,
                            scale_override if scale_override is not None else rife_scale, device)
                    emit(mid)
                    if i == 2:
                        eval_vfi(mid)
            elif vfi_method == "rife":
                for i in range(1, 4):
                    mid = _rife_interpolate(prev, out, i / 4, rife_scale, device)
                    emit(mid)
                    if i == 2:
                        eval_vfi(mid)
            elif vfi_method == "optical_flow":
                fl = _flow_half_res(prev_gray, curr_gray, exp_out_w, exp_out_h, device)
                h, w = prev.shape[:2]
                y = torch.arange(h, dtype=torch.float32, device=fl.device)[:, None].expand(h, w)
                x = torch.arange(w, dtype=torch.float32, device=fl.device)[None, :].expand(h, w)
                prev_f = to_device(prev, device).float()[None]
                out_f = to_device(out, device).float()
                for i in range(1, 4):
                    t = i / 4
                    wr = remap_bilinear(prev_f, (x + fl[..., 0] * t)[None], (y + fl[..., 1] * t)[None])[0]
                    # clip then truncate to uint8, as the reference's astype does
                    blended = torch.clamp(wr * (1 - t) + out_f * t, 0, 255).to(torch.uint8).cpu().numpy()
                    emit(blended)
                    if i == 2:
                        eval_vfi(blended)
            elif vfi_method == "ui_aware":
                for i in range(1, 4):
                    mid = ui_aware_interpolate(prev, out, i / 4, device)
                    emit(mid)
                    if i == 2:
                        eval_vfi(mid)
            elif vfi_method == "ughi":
                for i in range(1, 4):
                    mid, _ = ughi_interpolate(prev, out, i / 4, device)
                    emit(mid)
                    if i == 2:
                        eval_vfi(mid)
            elif vfi_method == "mcar":
                complexity, flow = estimate_motion_complexity(_gray_u8(prev, device),
                                                              _gray_u8(out, device), device)
                total_interp_frames += 3
                rife_model = _RIFESingleton.get(device) if complexity >= mcar_high else None
                for i in range(1, 4):
                    mid, tier = mcar_interpolate_cached(prev, out, i / 4, complexity, flow,
                                                        rife_model, mcar_low, mcar_high, device)
                    if tier == "rife":
                        rife_frame_count += 1
                    emit(mid)
                    if i == 2:
                        eval_vfi(mid)
            elif is_control or vfi_method == "none":
                for _ in range(1, 4):
                    emit(prev)
            else:  # linear_blend
                for i in range(1, 4):
                    blended = linear_blend(prev, out, i / 4, device)
                    emit(blended)
                    if i == 2:
                        eval_vfi(blended)
            midpoint_idx += 1

        emit(out)

        if ref_frames and ref_idx < len(ref_frames):
            ref = ref_frames[ref_idx]
            if ref.shape[:2] != out_for_metrics.shape[:2]:
                ref = _resize_u8(ref, (out_for_metrics.shape[1], out_for_metrics.shape[0]),
                                 "lanczos4", device)
            psnr_sum += calc_psnr(out_for_metrics, ref, device)
            ssim_sum += calc_ssim(_gray_u8(out_for_metrics, device), _gray_u8(ref, device), device)
            metric_cnt += 1

        prev, prev_gray = out.copy(), curr_gray

    if writer:
        writer.close()
    elapsed = time.time() - t0

    avg_kf_psnr = psnr_sum / metric_cnt if metric_cnt else 0
    avg_kf_ssim = ssim_sum / metric_cnt if metric_cnt else 0
    avg_vfi_psnr = vfi_psnr_sum / vfi_metric_cnt if vfi_metric_cnt else 0
    avg_vfi_ssim = vfi_ssim_sum / vfi_metric_cnt if vfi_metric_cnt else 0
    avg_vfi_lpips = vfi_lpips_sum / vfi_lpips_cnt if vfi_lpips_cnt else None

    if metric_cnt and vfi_metric_cnt:
        overall_psnr = 0.25 * avg_kf_psnr + 0.75 * avg_vfi_psnr
        overall_ssim = 0.25 * avg_kf_ssim + 0.75 * avg_vfi_ssim
    elif metric_cnt:
        overall_psnr, overall_ssim = avg_kf_psnr, avg_kf_ssim
    else:
        overall_psnr = overall_ssim = 0

    use_rife = vfi_method == "rife"
    use_adaptive = vfi_method == "adaptive"
    use_mcar = vfi_method == "mcar"
    rife_pct = (rife_frame_count / total_interp_frames * 100) if total_interp_frames else 0

    return {
        "name": name,
        "config": experiment,
        "frames": cnt,
        "time_s": round(elapsed, 2),
        "fps_achieved": round(cnt / elapsed, 1) if elapsed > 0 else 0,
        "keyframe_psnr_db": safe_round(avg_kf_psnr, 2),
        "keyframe_ssim": round(avg_kf_ssim, 4),
        "vfi_psnr_db": safe_round(avg_vfi_psnr, 2),
        "vfi_ssim": round(avg_vfi_ssim, 4),
        "vfi_lpips": round(avg_vfi_lpips, 4) if avg_vfi_lpips is not None else None,
        # which LPIPS this is ('calibrated_heads', 'official_weights' or
        # 'random_features'; evaluation/lpips.py)
        "lpips_mode": lpips_mode if avg_vfi_lpips is not None else None,
        "overall_psnr_db": safe_round(overall_psnr, 2),
        "overall_ssim": round(overall_ssim, 4),
        "psnr_db": safe_round(overall_psnr, 2),
        "ssim": round(overall_ssim, 4),
        "keyframes_evaluated": metric_cnt,
        "vfi_frames_evaluated": vfi_metric_cnt,
        "lpips_frames_sampled": vfi_lpips_cnt,
        "rife_frames_pct": round(rife_pct, 1) if (use_adaptive or use_mcar)
        else (100.0 if use_rife else 0),
        "vfimamba_frames_pct": (
            round(vfimamba_frame_count / total_interp_frames * 100, 1)
            if use_adaptive and total_interp_frames else None),
        "realtime_x": round((cnt / exp_fps) / elapsed, 2) if elapsed > 0 else 0,
        "used_rife": use_rife or use_adaptive or use_mcar,
        "output_video": str(output_path) if output_path else None,
        "quality_level": quality_level,
        "target_fps": exp_fps,
        "target_resolution": f"{exp_out_w}x{exp_out_h}",
        "vfi_method": vfi_method,
        "sr_method": sr_method,
        "edge_strength": edge_strength,
        "quality_aware": quality_aware,
        "blend_thresh_effective": round(blend_thresh, 3) if use_adaptive else None,
    }


# the clip of result rows written before rows carried a clip_id
LEGACY_CLIP_ID = "synth_001"


class ExperimentCheckpoint:
    """Crash-safe results store: the JSON is rewritten (through a temporary
    file) after every appended row."""

    def __init__(self, path):
        self.path = Path(path)
        self.data = {"experiments": [], "created": time.strftime("%Y-%m-%d %H:%M:%S")}
        if self.path.exists():
            with open(self.path) as f:
                self.data = json.load(f)

    def completed_keys(self) -> set:
        """(clip_id, name, interval) of every row; rows without a clip_id
        are LEGACY_CLIP_ID's (a wildcard would let one clip's row shadow
        another clip's experiment)."""
        return {
            (e.get("clip_id") or LEGACY_CLIP_ID, e["name"], e.get("interval_idx", 0))
            for e in self.data.get("experiments", [])
        }

    def append(self, result: dict):
        self.data["experiments"].append(result)
        self.save()

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=2)
        tmp.replace(self.path)


def drop_rows(rows: List[dict], names: List[str], intervals: List[int],
              clip_id: Optional[str] = None) -> List[dict]:
    """rows without those matching (name in names) x (interval in
    intervals), of clip_id's rows only unless it is None (legacy rows
    belong to LEGACY_CLIP_ID)."""
    sel = {(n, i) for n in names for i in intervals}

    def _match(r: dict) -> bool:
        if (r["name"], r.get("interval_idx", 0)) not in sel:
            return False
        return clip_id is None or (r.get("clip_id") or LEGACY_CLIP_ID) == clip_id

    return [r for r in rows if not _match(r)]


def run_experiment_sweep(
    clip_id: str,
    intervals: List[int],
    experiments: List[dict],
    data_dir: str = "data",
    output_dir: str = "outputs",
    resume: bool = False,
    replace: bool = False,
    write_videos: bool = False,
    max_frames: Optional[int] = None,
    use_lpips: bool = True,
    device_batched: bool = True,
    device: str = "cuda",
) -> dict:
    """Experiments x intervals, with the results JSON saved after each, on
    ``device`` (TF32 off). device_batched: every experiment through
    ``device_sweep.run_experiment_batched`` (the interval uploaded once);
    otherwise through the per-frame ``run_experiment``. A failing experiment
    is logged as FAILED and the sweep goes on. Returns the results store."""
    from vfisr_tpu_torch.data.extract_intervals import load_interval

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    checkpoint = ExperimentCheckpoint(out_dir / "experiment_results.json")
    if replace:
        # re-run exactly the selected (experiment, interval) rows in place
        checkpoint.data["experiments"] = drop_rows(
            checkpoint.data["experiments"], [e["name"] for e in experiments], intervals,
            clip_id=clip_id)
        checkpoint.save()
        done = checkpoint.completed_keys()
    elif not resume:
        checkpoint.data = {"experiments": [], "created": time.strftime("%Y-%m-%d %H:%M:%S")}
        done = set()
    else:
        done = checkpoint.completed_keys()

    lpips_fn = lpips_mode = None
    if use_lpips:
        from vfisr_tpu_torch.evaluation.lpips import default_lpips

        lp = default_lpips(device)
        lpips_fn = lambda a, b: float(lp(a, b)[0])  # noqa: E731
        lpips_mode = lp.mode

    shutdown = GracefulShutdown()
    shutdown.install()
    try:
        with open(out_dir / "experiment_log.txt", "a") as log_file:
            for interval_idx in intervals:
                if shutdown.requested:
                    break
                keyframes, midpoints, meta = load_interval(clip_id, interval_idx, data_dir,
                                                           max_frames=max_frames)
                device_interval = None
                if device_batched:
                    from vfisr_tpu_torch.harness.device_sweep import DeviceInterval

                    device_interval = DeviceInterval(keyframes, midpoints, device=device)
                for experiment in experiments:
                    if shutdown.requested:
                        break
                    if (clip_id, experiment["name"], interval_idx) in done:
                        print(f"  [skip] {experiment['name']} interval {interval_idx} (done)")
                        continue
                    print(f"  Running {experiment['name']} on interval {interval_idx}...")
                    video_path = (str(out_dir / "videos" / f"{experiment['name']}_i{interval_idx}.y4m")
                                  if write_videos else None)
                    try:
                        if device_interval is not None:
                            from vfisr_tpu_torch.harness.device_sweep import run_experiment_batched

                            result = run_experiment_batched(
                                device_interval, experiment, output_path=video_path,
                                lpips_fn=lpips_fn, lpips_mode=lpips_mode)
                        else:
                            result = run_experiment(
                                keyframes, midpoints, experiment, output_path=video_path,
                                lpips_fn=lpips_fn, lpips_mode=lpips_mode, device=device)
                        result["interval_idx"] = interval_idx
                        result["clip_id"] = clip_id
                        result["interval_difficulty"] = meta.get("difficulty")
                        checkpoint.append(result)
                        log_file.write(f"[{experiment['name']}] i{interval_idx}: "
                                       f"KF {result['keyframe_psnr_db']} dB | "
                                       f"VFI {result['vfi_psnr_db']} dB | {result['time_s']}s\n")
                        log_file.flush()
                        print(f"    KF_PSNR: {result['keyframe_psnr_db']} | "
                              f"VFI_PSNR: {result['vfi_psnr_db']} | {result['time_s']}s")
                    except Exception as e:  # the sweep goes on; the row is the log's FAILED line
                        traceback.print_exc()
                        print(f"    FAILED: {e}")
                        log_file.write(f"[{experiment['name']}] i{interval_idx} FAILED: {e}\n")
                        log_file.flush()
    finally:
        shutdown.restore()
    return checkpoint.data


def summarize(results: dict) -> str:
    """Console summary by experiment, best VFI PSNR first."""
    by_name: Dict[str, list] = {}
    for e in results.get("experiments", []):
        by_name.setdefault(e["name"], []).append(e)
    lines = [f"{'Experiment':<28}{'VFI PSNR':>10}{'VFI SSIM':>10}{'KF PSNR':>9}{'time s':>8}"]
    lines.append("-" * 65)

    def _key(rows):
        vals = [r["vfi_psnr_db"] for r in rows if isinstance(r["vfi_psnr_db"], (int, float))]
        return -(np.mean(vals) if vals else -1)

    for name, rows in sorted(by_name.items(), key=lambda kv: _key(kv[1])):
        vfi = [r["vfi_psnr_db"] for r in rows if isinstance(r["vfi_psnr_db"], (int, float))]
        ssim = [r["vfi_ssim"] for r in rows]
        kf = [r["keyframe_psnr_db"] for r in rows if isinstance(r["keyframe_psnr_db"], (int, float))]
        t = [r["time_s"] for r in rows]
        lines.append(
            f"{name:<28}"
            f"{np.mean(vfi) if vfi else float('nan'):>10.2f}"
            f"{np.mean(ssim):>10.4f}"
            f"{np.mean(kf) if kf else float('nan'):>9.2f}"
            f"{np.mean(t):>8.1f}"
        )
    return "\n".join(lines)
