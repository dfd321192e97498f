"""Cached intervals (port of ``vfisr_tpu/data/extract_intervals.py``'s
``classify_difficulty``, ``crop16_9``, ``compute_motion_stats`` and
``load_interval``).

An interval lives at ``<data_dir>/clips/<clip_id>/intervals/interval_%04d/``:
``keyframes/kf_%04d.png`` (the even frames), ``midpoints/gt_%04d.png`` (the
odd frames) and ``meta.json``. The frames are read with ``data/png.py``, so
no OpenCV is needed. ``compute_motion_stats`` runs its gray conversion,
half-size resize and Farneback flow on the device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import bgr_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data.png import read_png
from vfisr_tpu_torch.ops.flow import farneback_flow

DIFFICULTY_THRESHOLDS = {"STATIC": 1, "EASY": 5, "MEDIUM": 15, "HARD": 30, "EXTREME": float("inf")}


def classify_difficulty(mean_flow: float) -> str:
    """Difficulty class of a pair's mean flow magnitude (px)."""
    for name, bound in DIFFICULTY_THRESHOLDS.items():
        if mean_flow < bound:
            return name
    return "EXTREME"


def crop16_9(frame: np.ndarray) -> np.ndarray:
    """Centre crop of an HWC frame to 16:9 (width first, as the reference)."""
    h, w = frame.shape[:2]
    target_w = int(h * 16 / 9)
    if target_w <= w:
        x0 = (w - target_w) // 2
        return frame[:, x0:x0 + target_w]
    target_h = int(w * 9 / 16)
    y0 = (h - target_h) // 2
    return frame[y0:y0 + target_h]


def compute_motion_stats(frame1_bgr: np.ndarray, frame2_bgr: np.ndarray,
                         device: str = "cuda") -> dict:
    """Farneback at half resolution (bilinear), magnitudes scaled back x2:
    mean, max, std and median over the frame."""
    gray = bgr_to_gray(to_device(np.stack([frame1_bgr, frame2_bgr]), device))
    h, w = gray.shape[-2:]
    small = resize(gray[..., None], (h // 2, w // 2), "linear")[..., 0].float()
    flow = farneback_flow(small[:1], small[1:])[0]
    mag = (torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2) * 2).cpu().numpy()
    return {
        "mean_flow": float(np.mean(mag)),
        "max_flow": float(np.max(mag)),
        "std_flow": float(np.std(mag)),
        "median_flow": float(np.median(mag)),
    }


def load_interval(clip_id: str, interval, data_dir="data", max_frames: Optional[int] = None):
    """Load a cached interval: (keyframes, midpoints, meta), the frames as
    lists of HWC uint8 RGB, at most ``max_frames`` of each."""
    if isinstance(interval, int):
        interval = f"interval_{interval:04d}"
    interval_dir = Path(data_dir) / "clips" / clip_id / "intervals" / interval
    if not interval_dir.exists():
        raise FileNotFoundError(f"interval not found: {interval_dir}")
    with open(interval_dir / "meta.json") as f:
        meta = json.load(f)

    def load_dir(subdir):
        paths = sorted((interval_dir / subdir).glob("*.png"))
        return [read_png(p) for p in paths[:max_frames or None]]

    return load_dir("keyframes"), load_dir("midpoints"), meta
