"""Interval extraction (port of ``vfisr_tpu/data/extract_intervals.py``):
``IntervalExtractor``, ``classify_difficulty``, ``crop16_9``,
``compute_motion_stats`` and ``load_interval``.

An interval lives at ``<data_dir>/clips/<clip_id>/intervals/interval_%04d/``:
``keyframes/kf_%04d.png`` (the even frames), ``midpoints/gt_%04d.png`` (the
odd frames), ``motion/{complexity,flow_stats}.json`` and ``meta.json``;
``<data_dir>/clips/<clip_id>/difficulty_index.json`` maps each interval to
its difficulty. Frames are read and written with ``data/png.py``, so no
OpenCV is needed.

Each source frame goes to the device (a Y4M frame as its I420 bytes,
turned into RGB there), is cropped to 16:9 and resized with Lanczos4 there,
and comes back once for its PNG. Each pair of consecutive keyframes gets
one Farneback flow at half size on the device (``compute_motion_stats``).

Two choices differ from the reference's and say so where they are made:
a second ``extract_intervals`` call on a clip keeps the intervals of the
first in ``clip_meta.json`` and ``difficulty_index.json`` (the reference
replaces them with the new ones only), and the frames are RGB throughout
(the reference's cv2 frames are BGR; the PNGs hold RGB in both).
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.color import bgr_to_gray, rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import crop_16_9, resize
from vfisr_tpu_torch.data.png import read_png, write_png
from vfisr_tpu_torch.data.registry import ClipRegistry
from vfisr_tpu_torch.data.video_io import VideoReader
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


def fit_frame(frame: torch.Tensor, resolution: Tuple[int, int]) -> torch.Tensor:
    """A [H, W, 3] uint8 frame cropped to 16:9 and, where its size is not
    resolution = (width, height), resized to it with Lanczos4, on the
    frame's device."""
    frame = crop_16_9(frame)
    w, h = resolution
    if tuple(frame.shape[:2]) != (h, w):
        frame = resize(frame, (h, w), "lanczos4")
    return frame


def motion_stats(gray: torch.Tensor) -> dict:
    """[2, H, W] uint8 gray frames -> Farneback at half size (bilinear),
    magnitudes scaled back x2: mean, max, std and median over the frame."""
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


def compute_motion_stats(frame1_bgr: np.ndarray, frame2_bgr: np.ndarray,
                         device: str = "cuda") -> dict:
    """``motion_stats`` of two HWC uint8 BGR frames (the reference's
    argument order of channels: its gray weights are BGR2GRAY's)."""
    return motion_stats(bgr_to_gray(to_device(np.stack([frame1_bgr, frame2_bgr]), device)))


def interval_starts(video_duration: float, count: int = 10, duration: float = 10.0,
                    start: Optional[float] = None, auto_difficulty: bool = False) -> Tuple[list, list]:
    """The reference's placement: (every start in seconds, the starts whose
    interval lies inside the video). An explicit start gives one interval;
    auto_difficulty spreads count over linspace(0.1, 0.9) of the room; else
    count starts evenly over [0, duration_s - duration] (one in its middle
    where count is 1). The bound is the reference's float test
    ``s + duration <= video_duration``."""
    if start is not None:
        starts = [start]
    elif auto_difficulty:
        positions = np.linspace(0.1, 0.9, count)
        starts = [p * (video_duration - duration) for p in positions]
    else:
        max_start = video_duration - duration
        starts = [max_start / 2] if count == 1 else np.linspace(0, max_start, count).tolist()
    return starts, [s for s in starts if s >= 0 and s + duration <= video_duration]


def interval_frames(start_s: float, duration_s: float, fps: float,
                    total_frames: int) -> Tuple[int, int]:
    """(first source frame, end frame) of an interval: ``int(start_s * fps)``
    and ``min(int((start_s + duration_s) * fps), total_frames)``. fps is the
    video's unrounded rate (cv2's CAP_PROP_FPS in the reference), not the
    registry's rounded one: at 59.94 fps the two floor differently."""
    start_frame = int(start_s * fps)
    return start_frame, min(int((start_s + duration_s) * fps), total_frames)


class IntervalExtractor:
    """Cuts a registered clip into intervals of keyframes, midpoints and
    motion statistics. Device work (I420 -> RGB, Lanczos4, Farneback) runs
    on ``device``, ``cuda`` unless the caller asks for ``cpu``."""

    def __init__(self, data_dir: str | Path = "data", device: str = "cuda"):
        # Farneback's filters are f32 convolutions: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.registry = ClipRegistry(data_dir)
        self.device = device

    def extract_single_interval(
        self,
        video_path: str,
        clip_id: str,
        interval_id: str,
        start_s: float,
        duration_s: float,
        output_resolution: Tuple[int, int] = (1920, 1080),
        verbose: bool = True,
    ) -> dict:
        clip_dir = self.registry.clips_dir / clip_id
        interval_dir = clip_dir / "intervals" / interval_id
        keyframes_dir = interval_dir / "keyframes"
        midpoints_dir = interval_dir / "midpoints"
        motion_dir = interval_dir / "motion"
        for d in (keyframes_dir, midpoints_dir, motion_dir):
            d.mkdir(parents=True, exist_ok=True)

        with VideoReader(video_path) as probe:
            fps, total_frames = float(probe.fps), probe.frame_count
        start_frame, end_frame = interval_frames(start_s, duration_s, fps, total_frames)

        keyframes: List[str] = []
        midpoints: List[str] = []
        motion_data: List[dict] = []
        difficulty_counts = {k: 0 for k in DIFFICULTY_THRESHOLDS}
        prev_gray = None
        frame_idx = 0

        if verbose:
            print(f"  Extracting {interval_id}: {start_s:.1f}s - {start_s + duration_s:.1f}s")

        # the reference reads while the capture's position is before
        # end_frame: end_frame - start_frame frames, fewer at the file's end
        with VideoReader(video_path, start_frame) as reader:
            for _ in range(max(end_frame - start_frame, 0)):
                frame = reader.read_to(self.device)
                if frame is None:
                    break
                frame = fit_frame(frame, output_resolution)
                if frame_idx % 2 == 0:
                    kf_path = keyframes_dir / f"kf_{len(keyframes):04d}.png"
                    write_png(kf_path, frame.cpu().numpy())
                    keyframes.append(kf_path.name)
                    # the reference's motion stats take cv2's BGR frames with
                    # BGR2GRAY's weights: the RGB frame's gray is the same
                    gray = rgb_to_gray(frame)
                    if prev_gray is not None:
                        stats = motion_stats(torch.stack([prev_gray, gray]))
                        motion_data.append({"pair_idx": len(keyframes) - 2, **stats})
                        difficulty_counts[classify_difficulty(stats["mean_flow"])] += 1
                    prev_gray = gray
                else:
                    gt_path = midpoints_dir / f"gt_{len(midpoints):04d}.png"
                    write_png(gt_path, frame.cpu().numpy())
                    midpoints.append(gt_path.name)
                frame_idx += 1
                if verbose and frame_idx % 100 == 0:
                    print(f"    Processed {frame_idx} frames...")

        if motion_data:
            all_mean = [m["mean_flow"] for m in motion_data]
            all_max = [m["max_flow"] for m in motion_data]
            n = len(motion_data)
            aggregate = {
                "mean_flow": float(np.mean(all_mean)),
                "max_flow": float(np.max(all_max)),
                "variance": float(np.var(all_mean)),
                **{
                    f"{k.lower()}_pct": round(100 * difficulty_counts[k] / n, 1)
                    for k in ("STATIC", "EASY", "MEDIUM", "HARD", "EXTREME")
                },
            }
            overall = classify_difficulty(aggregate["mean_flow"])
        else:
            aggregate = {}
            overall = "UNKNOWN"

        with open(motion_dir / "complexity.json", "w") as f:
            json.dump(motion_data, f, indent=2)
        with open(motion_dir / "flow_stats.json", "w") as f:
            json.dump(aggregate, f, indent=2)

        meta = {
            "interval_id": interval_id,
            "clip_id": clip_id,
            "start_s": start_s,
            "end_s": start_s + duration_s,
            "start_frame": start_frame,
            "end_frame": start_frame + frame_idx,
            "keyframe_count": len(keyframes),
            "midpoint_count": len(midpoints),
            "resolution": f"{output_resolution[0]}x{output_resolution[1]}",
            "difficulty": overall,
            "motion_stats": aggregate,
            "extracted": datetime.now().isoformat(),
        }
        with open(interval_dir / "meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        if verbose:
            print(f"    Done: {len(keyframes)} keyframes, {len(midpoints)} midpoints, "
                  f"difficulty={overall}")
        return meta

    def extract_intervals(
        self,
        clip_id: str,
        count: int = 10,
        duration: float = 10.0,
        start: Optional[float] = None,
        auto_difficulty: bool = False,
        output_resolution: Tuple[int, int] = (1920, 1080),
        verbose: bool = True,
    ) -> List[dict]:
        """Extract the intervals that ``interval_starts`` places, numbered
        after those already on disk; update the registry entry,
        ``clip_meta.json`` and ``difficulty_index.json``."""
        clip_info = self.registry.get_clip(clip_id)
        if clip_info is None:
            raise ValueError(f"Clip {clip_id!r} not found. Register it first.")
        video_path = clip_info.get("source_path") or clip_info.get("source")
        starts, valid_starts = interval_starts(clip_info["duration_s"], count, duration, start,
                                               auto_difficulty)
        if verbose and len(valid_starts) < len(starts):
            print(f"Warning: {len(starts) - len(valid_starts)} intervals skipped (out of bounds)")

        clip_dir = self.registry.clips_dir / clip_id
        intervals_dir = clip_dir / "intervals"
        existing = list(intervals_dir.glob("interval_*")) if intervals_dir.exists() else []
        next_idx = len(existing)

        results = []
        for i, start_s in enumerate(valid_starts):
            interval_id = f"interval_{next_idx + i:04d}"
            results.append(
                self.extract_single_interval(
                    video_path, clip_id, interval_id, start_s, duration,
                    output_resolution, verbose,
                )
            )

        self.registry.update_clip(
            clip_id,
            intervals_count=next_idx + len(results),
            last_processed=datetime.now().isoformat(),
        )
        # the reference sets both indexes to this call's intervals alone; a
        # second call would drop the first call's intervals from them, while
        # intervals_count counts all. Here both keep every interval.
        clip_meta_path = clip_dir / "clip_meta.json"
        if clip_meta_path.exists():
            with open(clip_meta_path) as f:
                clip_meta = json.load(f)
            ids = clip_meta.get("intervals", []) + [r["interval_id"] for r in results]
            clip_meta["intervals"] = list(dict.fromkeys(ids))
            clip_meta["intervals_count"] = next_idx + len(results)
            clip_meta["last_processed"] = datetime.now().isoformat()
            with open(clip_meta_path, "w") as f:
                json.dump(clip_meta, f, indent=2)

        index_path = clip_dir / "difficulty_index.json"
        difficulty_index = json.loads(index_path.read_text()) if index_path.exists() else {}
        for r in results:
            difficulty_index[r["interval_id"]] = {
                "difficulty": r["difficulty"],
                "mean_flow": r["motion_stats"].get("mean_flow", 0),
                "start_s": r["start_s"],
                "end_s": r["end_s"],
            }
        with open(index_path, "w") as f:
            json.dump(difficulty_index, f, indent=2)
        return results


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
