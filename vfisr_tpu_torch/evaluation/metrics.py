"""Quality, temporal and gaming metrics for VFI+SR evaluation (port of
``vfisr_tpu/evaluation/metrics.py``).

The same dataclasses, free functions, ``QualityEvaluator`` and
``run_comprehensive_benchmark``, numpy frames in and floats or numpy out.
What the reference computes with JAX (resizes, gray conversion, SSIM,
Farneback flow, remap, Canny, morphology, LPIPS) runs here with torch on
``device``, "cuda" by default, and so does PSNR's float64 MSE (numpy on
the host took 61.5 of the 84.0 ms of a 1080p ``evaluate_pair`` in
chip_smoke.py on the machine of an NVIDIA H100 80GB HBM3 at 700 W). The
rest of what it computes with numpy on the host (the flows' statistics,
the flicker, the UI ghosting and edge wobble means, the means over
frames) stays numpy, so each per-frame float is read back as in the
reference. No function falls back
to the CPU: pass ``device="cpu"`` to run there.

On the GPU, Farneback's warps are the windowed kernel (K1, as in the
reference on the TPU); on the CPU they are the exact warp, as the JAX
package's are off the TPU.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.core.warp import remap_bilinear
from vfisr_tpu_torch.ops.conv import laplacian
from vfisr_tpu_torch.ops.edges import canny
from vfisr_tpu_torch.ops.flow import farneback_flow
from vfisr_tpu_torch.ops.morphology import dilate, morph_close
from vfisr_tpu_torch.ops.ssim import ms_ssim
from vfisr_tpu_torch.ops.ssim import ssim as ssim_windowed
from vfisr_tpu_torch.ops.ssim import ssim_global


class MotionDifficulty(Enum):
    """Motion difficulty levels for stratified reporting."""

    STATIC = "static"  # < 1 px mean flow
    EASY = "easy"  # 1-5 px
    MEDIUM = "medium"  # 5-15 px
    HARD = "hard"  # 15-30 px
    EXTREME = "extreme"  # > 30 px


@dataclass
class TemporalMetrics:
    tof_smoothness: float
    flicker_score: float
    flow_consistency: float
    motion_variance: float

    def to_dict(self) -> dict:
        return {
            "tof_smoothness": self.tof_smoothness,
            "flicker_score": self.flicker_score,
            "flow_consistency": self.flow_consistency,
            "motion_variance": self.motion_variance,
        }


@dataclass
class StratifiedMetrics:
    by_difficulty: Dict[str, Dict[str, float]] = field(default_factory=dict)
    frame_counts: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {"by_difficulty": self.by_difficulty, "frame_counts": self.frame_counts}


@dataclass
class GamingMetrics:
    ui_ghosting_score: float
    edge_wobble_score: float

    def to_dict(self) -> dict:
        return {
            "ui_ghosting_score": self.ui_ghosting_score,
            "edge_wobble_score": self.edge_wobble_score,
        }


@dataclass
class QualityResults:
    psnr: float
    ssim: float
    lpips: float
    ms_ssim: Optional[float] = None
    flolpips: Optional[float] = None
    psnr_per_frame: Optional[List[float]] = None
    lpips_per_frame: Optional[List[float]] = None

    def to_dict(self) -> dict:
        return {
            "psnr": self.psnr,
            "ssim": self.ssim,
            "lpips": self.lpips,
            "ms_ssim": self.ms_ssim,
            "flolpips": self.flolpips,
        }


# =============================================================================
# Simple per-pair metrics
# =============================================================================


def _match_size(pred: np.ndarray, gt: np.ndarray, device: str) -> np.ndarray:
    """pred resized to gt's size ("linear"; a uint8 pred stays uint8, with
    OpenCV's rounding) where the shapes differ."""
    if pred.shape != gt.shape:
        pred = resize(to_device(pred, device), gt.shape[:2], "linear").cpu().numpy()
    return pred


def _gray(frame, device: str) -> torch.Tensor:
    """[H,W,3] RGB (a uint8 frame keeps OpenCV's rounded uint8 gray) or
    [H,W] gray -> f32 [H,W] on device."""
    x = to_device(frame, device)
    if x.ndim == 3:
        x = rgb_to_gray(x)
    return x.float()


def _to_gray(frame: np.ndarray, device: str = "cuda") -> np.ndarray:
    """Gray float32 numpy. The reference converts with the array's RGB order
    (its source used cv2.COLOR_BGR2GRAY on RGB arrays)."""
    return _gray(frame, device).cpu().numpy()


def compute_psnr_simple(pred: np.ndarray, gt: np.ndarray, device: str = "cuda") -> float:
    """10*log10(255^2/MSE), the MSE in float64 on device as the reference's
    numpy takes it on the host; inf for identical frames."""
    pred = _match_size(pred, gt, device)
    d = to_device(pred, device).double() - to_device(gt, device).double()
    mse = float(torch.mean(d * d))
    if mse == 0:
        return float("inf")
    return float(10 * np.log10(255.0**2 / mse))


def compute_ssim_simple(pred: np.ndarray, gt: np.ndarray, device: str = "cuda") -> float:
    """Windowed grayscale SSIM with skimage's default parameters."""
    pred = _match_size(pred, gt, device)
    return float(ssim_windowed(_gray(pred, device), _gray(gt, device)))


def calc_psnr(img1: np.ndarray, img2: np.ndarray, device: str = "cuda") -> float:
    """The experiments' PSNR: ``compute_psnr_simple`` (uncapped)."""
    return compute_psnr_simple(img1, img2, device)


def calc_ssim(img1: np.ndarray, img2: np.ndarray, device: str = "cuda") -> float:
    """Global-statistics SSIM, clamped to [0, 1]."""
    return float(ssim_global(to_device(img1, device), to_device(img2, device)))


def safe_round(value, decimals: int = 2):
    """inf/NaN-safe rounding for JSON."""
    if value is None:
        return None
    if math.isinf(value):
        return "inf" if value > 0 else "-inf"
    if math.isnan(value):
        return None
    return round(value, decimals)


# =============================================================================
# Optical flow + difficulty
# =============================================================================


def compute_optical_flow(frame1: np.ndarray, frame2: np.ndarray,
                         device: str = "cuda") -> np.ndarray:
    """Farneback flow [H,W,2] at full resolution with the reference's
    parameters (0.5, 3, 15, 3, 5, 1.2)."""
    flow = farneback_flow(_gray(frame1, device), _gray(frame2, device), pyr_scale=0.5,
                          levels=3, winsize=15, iterations=3, poly_n=5, poly_sigma=1.2)
    return flow.cpu().numpy()


def classify_motion_difficulty(flow: np.ndarray) -> MotionDifficulty:
    """Thresholds 1/5/15/30 px of mean flow magnitude."""
    mean_motion = float(np.mean(np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)))
    if mean_motion < 1:
        return MotionDifficulty.STATIC
    if mean_motion < 5:
        return MotionDifficulty.EASY
    if mean_motion < 15:
        return MotionDifficulty.MEDIUM
    if mean_motion < 30:
        return MotionDifficulty.HARD
    return MotionDifficulty.EXTREME


# =============================================================================
# Temporal consistency
# =============================================================================


def compute_tof_smoothness(flows: List[np.ndarray]) -> float:
    """Mean |delta flow| between consecutive flows."""
    if len(flows) < 2:
        return 0.0
    diffs = []
    for i in range(len(flows) - 1):
        d = flows[i + 1] - flows[i]
        diffs.append(float(np.mean(np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2))))
    return float(np.mean(diffs))


def compute_flicker_score(frames: List[np.ndarray], device: str = "cuda") -> float:
    """Mean |f(t+1) - 2f(t) + f(t-1)| of the luminance."""
    if len(frames) < 3:
        return 0.0
    lum = [_to_gray(f, device).astype(float) for f in frames]
    scores = [
        float(np.mean(np.abs(lum[i + 1] - 2 * lum[i] + lum[i - 1])))
        for i in range(1, len(lum) - 1)
    ]
    return float(np.mean(scores))


def compute_flow_consistency(flows_fwd: List[np.ndarray], flows_bwd: List[np.ndarray],
                             device: str = "cuda") -> float:
    """Mean ||fwd + bwd(p + fwd)||, bwd sampled bilinearly (zeros outside)."""
    if not flows_fwd or not flows_bwd:
        return 0.0
    errors = []
    for fwd, bwd in zip(flows_fwd, flows_bwd):
        h, w = fwd.shape[:2]
        f = to_device(fwd, device).float()
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        bwd_warped = remap_bilinear(to_device(bwd, device).float()[None], (xs + f[..., 0])[None],
                                    (ys + f[..., 1])[None])[0].cpu().numpy()
        err = np.sqrt((fwd[..., 0] + bwd_warped[..., 0]) ** 2
                      + (fwd[..., 1] + bwd_warped[..., 1]) ** 2)
        errors.append(float(np.mean(err)))
    return float(np.mean(errors))


def compute_temporal_metrics(frames: List[np.ndarray], device: str = "cuda") -> TemporalMetrics:
    """All temporal metrics of a frame sequence (two flows per pair)."""
    if len(frames) < 3:
        return TemporalMetrics(0.0, 0.0, 0.0, 0.0)
    flows_fwd, flows_bwd, mags = [], [], []
    for i in range(len(frames) - 1):
        fwd = compute_optical_flow(frames[i], frames[i + 1], device)
        bwd = compute_optical_flow(frames[i + 1], frames[i], device)
        flows_fwd.append(fwd)
        flows_bwd.append(bwd)
        mags.append(float(np.mean(np.sqrt(fwd[..., 0] ** 2 + fwd[..., 1] ** 2))))
    return TemporalMetrics(
        tof_smoothness=compute_tof_smoothness(flows_fwd),
        flicker_score=compute_flicker_score(frames, device),
        flow_consistency=compute_flow_consistency(flows_fwd, flows_bwd, device),
        motion_variance=float(np.var(mags)) if mags else 0.0,
    )


# =============================================================================
# Gaming-specific
# =============================================================================


def _ui_score_map(gray: torch.Tensor) -> torch.Tensor:
    """Edges x 0.4 + flat Laplacian x 0.3 + nearness to the border x 0.3,
    thresholded at 0.5 and closed with a 5x5 element. gray: [H, W] f32."""
    h, w = gray.shape[-2:]
    edges = canny(gray, 100, 200) > 0
    flat = torch.abs(laplacian(gray[None, ..., None])[0, ..., 0]) < 5
    ys = torch.arange(h, dtype=torch.float32, device=gray.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=gray.device)[None, :].expand(h, w)
    edge_weight = (torch.minimum(torch.minimum(ys, h - ys), torch.minimum(xs, w - xs))
                   / min(h, w) * 4.0)
    edge_weight = torch.clamp(1.0 - edge_weight, 0.0, 1.0)
    score = edges.float() * 0.4 + flat.float() * 0.3 + edge_weight * 0.3
    return morph_close((score > 0.5).to(torch.uint8), 5)


def detect_ui_regions(frame: np.ndarray, device: str = "cuda") -> np.ndarray:
    """Binary HUD/UI mask [H, W] uint8."""
    return _ui_score_map(_gray(frame, device)).cpu().numpy()


def compute_ui_ghosting_score(pred_frames: List[np.ndarray], gt_frames: List[np.ndarray],
                              device: str = "cuda") -> float:
    """Mean |pred - gt| inside the ground truth's UI mask (frames whose mask
    has fewer than 100 pixels are skipped)."""
    if len(pred_frames) != len(gt_frames):
        return 0.0
    scores = []
    for pred, gt in zip(pred_frames, gt_frames):
        ui_mask = detect_ui_regions(gt, device)
        if np.sum(ui_mask) < 100:
            continue
        pred = _match_size(pred, gt, device)
        error = np.abs(pred.astype(float) - gt.astype(float))
        if error.ndim == 3:
            error = np.mean(error, axis=2)
        ui_error = error * ui_mask
        scores.append(float(np.mean(ui_error[ui_mask > 0])))
    return float(np.mean(scores)) if scores else 0.0


def compute_edge_wobble_score(frames: List[np.ndarray], device: str = "cuda") -> float:
    """Share of edges present now but absent from the dilated previous and
    next frames' edges together."""
    if len(frames) < 3:
        return 0.0
    edge_maps = [canny(_gray(f, device), 50, 150).cpu().numpy().astype(float) / 255.0
                 for f in frames]
    scores = []
    for i in range(1, len(edge_maps) - 1):
        prev_d = dilate(to_device(edge_maps[i - 1], device), 3).cpu().numpy()
        next_d = dilate(to_device(edge_maps[i + 1], device), 3).cpu().numpy()
        wobbly = edge_maps[i] * (1 - prev_d * next_d)
        scores.append(float(np.mean(wobbly)))
    return float(np.mean(scores)) if scores else 0.0


def compute_gaming_metrics(pred_frames: List[np.ndarray], gt_frames: List[np.ndarray],
                           device: str = "cuda") -> GamingMetrics:
    return GamingMetrics(
        ui_ghosting_score=compute_ui_ghosting_score(pred_frames, gt_frames, device),
        edge_wobble_score=compute_edge_wobble_score(pred_frames, device),
    )


# =============================================================================
# Stratified metrics
# =============================================================================


def compute_stratified_metrics(pred_frames: List[np.ndarray], gt_frames: List[np.ndarray],
                               device: str = "cuda") -> StratifiedMetrics:
    """PSNR and SSIM per motion difficulty of the ground truth's pairs."""
    if len(pred_frames) != len(gt_frames) or len(pred_frames) < 2:
        return StratifiedMetrics()
    buckets = {d.value: {"psnr": [], "ssim": []} for d in MotionDifficulty}
    counts = {d.value: 0 for d in MotionDifficulty}
    for i in range(len(gt_frames) - 1):
        flow = compute_optical_flow(gt_frames[i], gt_frames[i + 1], device)
        difficulty = classify_motion_difficulty(flow)
        pred = _match_size(pred_frames[i], gt_frames[i], device)
        buckets[difficulty.value]["psnr"].append(compute_psnr_simple(pred, gt_frames[i], device))
        buckets[difficulty.value]["ssim"].append(compute_ssim_simple(pred, gt_frames[i], device))
        counts[difficulty.value] += 1
    by_difficulty = {
        d.value: {
            "psnr": float(np.mean(buckets[d.value]["psnr"])),
            "ssim": float(np.mean(buckets[d.value]["ssim"])),
        }
        for d in MotionDifficulty
        if counts[d.value] > 0
    }
    return StratifiedMetrics(
        by_difficulty=by_difficulty,
        frame_counts={k: v for k, v in counts.items() if v > 0},
    )


# =============================================================================
# QualityEvaluator
# =============================================================================


class QualityEvaluator:
    """Generated frames against ground truth: PSNR, SSIM, MS-SSIM and LPIPS
    per pair, FloLPIPS and LPIPS between consecutive frames over a sequence.
    LPIPS is ``evaluation/lpips.py``'s AlexNet graph (its weights' mode in
    ``lpips_mode``). Turns cuDNN's and matmul's TF32 off: the SSIM box
    filters of values up to 255^2 and the AlexNet run in f32."""

    def __init__(self, device: str = "cuda"):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.device = device
        self._lpips = None

    def _ensure_initialized(self):
        if self._lpips is None:
            from vfisr_tpu_torch.evaluation.lpips import default_lpips

            self._lpips = default_lpips(self.device)

    @property
    def lpips_mode(self) -> str:
        self._ensure_initialized()
        return self._lpips.mode

    def evaluate_pair(self, pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
        """psnr, ssim, lpips, and ms_ssim where the short side allows its 5
        scales (>= 112 px)."""
        self._ensure_initialized()
        pred = _match_size(pred, gt, self.device)
        results = {
            "psnr": compute_psnr_simple(pred, gt, self.device),
            "ssim": compute_ssim_simple(pred, gt, self.device),
            "lpips": float(self._lpips(pred, gt)[0]),
        }
        pg, gg = _gray(pred, self.device), _gray(gt, self.device)
        if min(pg.shape[-2:]) >= 7 * 2**4:
            results["ms_ssim"] = float(ms_ssim(pg, gg))
        return results

    def evaluate_flolpips(self, pred_frames: List[np.ndarray],
                          gt_frames: List[np.ndarray]) -> Optional[float]:
        """FloLPIPS over a sequence: LPIPS maps weighted by the ground truth's
        motion magnitude, averaged over its pairs."""
        self._ensure_initialized()
        if len(pred_frames) < 2 or len(pred_frames) != len(gt_frames):
            return None
        vals = []
        for i in range(len(gt_frames) - 1):
            flow = compute_optical_flow(gt_frames[i], gt_frames[i + 1], self.device)
            mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
            vals.append(float(self._lpips.flow_weighted(pred_frames[i], gt_frames[i], mag)[0]))
        return float(np.mean(vals))

    def evaluate(self, pred_frames: List[np.ndarray],
                 gt_frames: List[np.ndarray]) -> QualityResults:
        self._ensure_initialized()
        if len(pred_frames) != len(gt_frames):
            raise ValueError(
                f"Number of predicted frames ({len(pred_frames)}) "
                f"doesn't match ground truth ({len(gt_frames)})"
            )
        psnr_values, ssim_values, lpips_values, ms_values = [], [], [], []
        for pred, gt in zip(pred_frames, gt_frames):
            m = self.evaluate_pair(pred, gt)
            psnr_values.append(m["psnr"])
            ssim_values.append(m["ssim"])
            lpips_values.append(m["lpips"])
            if "ms_ssim" in m:
                ms_values.append(m["ms_ssim"])
        return QualityResults(
            psnr=float(np.mean(psnr_values)),
            ssim=float(np.mean(ssim_values)),
            lpips=float(np.mean(lpips_values)),
            ms_ssim=float(np.mean(ms_values)) if ms_values else None,
            psnr_per_frame=psnr_values,
            lpips_per_frame=lpips_values,
        )

    def evaluate_temporal_consistency(self, frames: List[np.ndarray]) -> Dict[str, float]:
        """LPIPS between consecutive frames."""
        self._ensure_initialized()
        if len(frames) < 2:
            return {"temporal_lpips_mean": 0, "temporal_lpips_std": 0}
        diffs = [
            float(self._lpips(frames[i], frames[i + 1])[0])
            for i in range(len(frames) - 1)
        ]
        return {
            "temporal_lpips_mean": float(np.mean(diffs)),
            "temporal_lpips_std": float(np.std(diffs)),
            "temporal_lpips_max": float(np.max(diffs)),
            "temporal_lpips_min": float(np.min(diffs)),
        }


# =============================================================================
# Comprehensive benchmark
# =============================================================================


@dataclass
class ComprehensiveBenchmarkResults:
    psnr: float
    ssim: float
    temporal: TemporalMetrics
    gaming: GamingMetrics
    stratified: StratifiedMetrics
    total_frames: int

    def to_dict(self) -> dict:
        return {
            "reconstruction": {"psnr": self.psnr, "ssim": self.ssim},
            "temporal": self.temporal.to_dict(),
            "gaming": self.gaming.to_dict(),
            "stratified": self.stratified.to_dict(),
            "total_frames": self.total_frames,
        }

    def summary_table(self) -> str:
        lines = [
            "=" * 60,
            "COMPREHENSIVE VFI BENCHMARK RESULTS",
            "=" * 60,
            "",
            "## Reconstruction Accuracy",
            f"  PSNR: {self.psnr:.2f} dB",
            f"  SSIM: {self.ssim:.4f}",
            "",
            "## Temporal Consistency (lower is better)",
            f"  tOF Smoothness: {self.temporal.tof_smoothness:.4f}",
            f"  Flicker Score: {self.temporal.flicker_score:.4f}",
            f"  Flow Consistency: {self.temporal.flow_consistency:.4f}",
            "",
            "## Gaming-Specific (lower is better)",
            f"  UI Ghosting: {self.gaming.ui_ghosting_score:.2f}",
            f"  Edge Wobble: {self.gaming.edge_wobble_score:.4f}",
            "",
            "## By Motion Difficulty",
        ]
        for diff, m in self.stratified.by_difficulty.items():
            count = self.stratified.frame_counts.get(diff, 0)
            lines.append(
                f"  {diff.upper()}: PSNR={m['psnr']:.2f}dB, "
                f"SSIM={m['ssim']:.4f} (n={count})"
            )
        lines += ["", f"Total Frames: {self.total_frames}", "=" * 60]
        return "\n".join(lines)


def run_comprehensive_benchmark(pred_frames: List[np.ndarray], gt_frames: List[np.ndarray],
                                verbose: bool = True,
                                device: str = "cuda") -> ComprehensiveBenchmarkResults:
    """The complete evaluation: reconstruction, temporal, gaming and
    stratified metrics over the first min(len) frames of each list."""
    if verbose:
        print("Running comprehensive VFI benchmark...")
    n_frames = min(len(pred_frames), len(gt_frames))
    pred_frames = pred_frames[:n_frames]
    gt_frames = gt_frames[:n_frames]

    if verbose:
        print("  Computing reconstruction metrics...")
    psnr_values, ssim_values = [], []
    for pred, gt in zip(pred_frames, gt_frames):
        pred = _match_size(pred, gt, device)
        psnr_values.append(compute_psnr_simple(pred, gt, device))
        ssim_values.append(compute_ssim_simple(pred, gt, device))

    if verbose:
        print("  Computing temporal consistency metrics...")
    temporal = compute_temporal_metrics(pred_frames, device)
    if verbose:
        print("  Computing gaming-specific metrics...")
    gaming = compute_gaming_metrics(pred_frames, gt_frames, device)
    if verbose:
        print("  Computing stratified metrics...")
    stratified = compute_stratified_metrics(pred_frames, gt_frames, device)

    results = ComprehensiveBenchmarkResults(
        psnr=float(np.mean(psnr_values)),
        ssim=float(np.mean(ssim_values)),
        temporal=temporal,
        gaming=gaming,
        stratified=stratified,
        total_frames=n_frames,
    )
    if verbose:
        print(results.summary_table())
    return results
