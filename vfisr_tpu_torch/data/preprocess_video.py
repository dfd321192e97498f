"""Triplet dataset preprocessing (port of ``vfisr_tpu/data/preprocess_video.py``).

Per source clip: analyze (probe) -> validate (the source is at least the
target's height and fps: ground truth is never upsampled) -> one pass over
the frames that keeps a source frame for the input (e.g. 1080p at 30 fps)
and for the ground truth (e.g. 1440p at 120 fps) where it crosses that
stream's timestamp grid -> PNG frames -> the triplet index:

    gt_start = round(i * scale); gt_end = round((i + 1) * scale)
    intermediates = (gt_start, gt_end) exclusive
    temporal_positions = (idx - gt_start) / (gt_end - gt_start)

Output: ``<output_dir>/<clip>/{input_1080p30/frames/frame_*.png,
ground_truth/frames/frame_*.png, metadata.json, triplets.json}``.

Each frame goes to the device once (a Y4M frame as its I420 bytes), is
cropped to 16:9 and resized with Lanczos4 there where its size differs from
the stream's, and comes back for its PNG (``data/png.py``). The timestamp
grid uses the probe's fps, rounded to 2 decimals as the reference's is.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from datetime import datetime
from pathlib import Path
from typing import List, Optional, Tuple

from vfisr_tpu_torch.data.extract_intervals import fit_frame
from vfisr_tpu_torch.data.png import write_png
from vfisr_tpu_torch.data.video_io import VideoMeta, VideoReader, probe_video


@dataclass
class VideoMetadata:
    """A processed clip's ``metadata.json``."""

    clip_name: str
    source_path: str
    source_width: int
    source_height: int
    source_fps: float
    input_width: int
    input_height: int
    input_fps: float
    target_width: int
    target_height: int
    target_fps: float
    temporal_scale: float
    spatial_scale: float
    num_input_frames: int
    num_gt_frames: int
    num_triplets: int
    processed_at: str

    def to_dict(self):
        return asdict(self)


class VideoPreprocessor:
    """Source clips into input / ground-truth frame triplets. Device work
    (I420 -> RGB, Lanczos4) runs on ``device``, ``cuda`` unless the caller
    asks for ``cpu``."""

    def __init__(
        self,
        input_resolution: Tuple[int, int] = (1920, 1080),
        input_fps: float = 30.0,
        target_resolution: Tuple[int, int] = (2560, 1440),
        target_fps: float = 120.0,
        output_dir: str | Path = "data/processed",
        device: str = "cuda",
    ):
        self.input_resolution = input_resolution
        self.input_fps = input_fps
        self.target_resolution = target_resolution
        self.target_fps = target_fps
        self.output_dir = Path(output_dir)
        self.device = device

    def analyze(self, video_path: str) -> VideoMeta:
        return probe_video(video_path)

    def validate(self, meta: VideoMeta) -> List[str]:
        problems = []
        if meta.height < self.target_resolution[1]:
            problems.append(
                f"source height {meta.height} < target {self.target_resolution[1]} "
                "(GT would be upsampled)"
            )
        if meta.fps < self.target_fps:
            problems.append(
                f"source fps {meta.fps} < target {self.target_fps} (cannot create GT)"
            )
        return problems

    def process(self, video_path: str, clip_name: Optional[str] = None, max_frames: int = 0) -> dict:
        """Write the clip's frames, ``metadata.json`` and ``triplets.json``;
        max_frames > 0 stops after that many input frames."""
        video_path = str(video_path)
        clip_name = clip_name or Path(video_path).stem
        meta = self.analyze(video_path)
        problems = self.validate(meta)
        if problems:
            raise ValueError("; ".join(problems))

        clip_dir = self.output_dir / clip_name
        input_frames_dir = clip_dir / "input_1080p30" / "frames"
        gt_frames_dir = clip_dir / "ground_truth" / "frames"
        input_frames_dir.mkdir(parents=True, exist_ok=True)
        gt_frames_dir.mkdir(parents=True, exist_ok=True)

        # frame-accurate decimation: keep source frame k where it crosses the
        # stream's timestamp grid (the reference's stand-in for ffmpeg's fps
        # filter)
        src_fps = meta.fps
        n_in = n_gt = 0
        next_in_t = next_gt_t = 0.0
        frame_idx = 0
        with VideoReader(video_path) as reader:
            while True:
                frame = reader.read_to(self.device)
                if frame is None:
                    break
                t = frame_idx / src_fps
                if t >= next_gt_t - 1e-9:
                    gt = fit_frame(frame, self.target_resolution)
                    write_png(gt_frames_dir / f"frame_{n_gt:05d}.png", gt.cpu().numpy())
                    n_gt += 1
                    next_gt_t = n_gt / self.target_fps
                if t >= next_in_t - 1e-9:
                    inp = fit_frame(frame, self.input_resolution)
                    write_png(input_frames_dir / f"frame_{n_in:05d}.png", inp.cpu().numpy())
                    n_in += 1
                    next_in_t = n_in / self.input_fps
                frame_idx += 1
                if max_frames and n_in >= max_frames:
                    break

        dirs = {"input_frames": input_frames_dir, "gt_frames": gt_frames_dir}
        triplets = self.create_triplet_index(dirs)
        metadata = VideoMetadata(
            clip_name=clip_name,
            source_path=str(Path(video_path).resolve()),
            source_width=meta.width,
            source_height=meta.height,
            source_fps=meta.fps,
            input_width=self.input_resolution[0],
            input_height=self.input_resolution[1],
            input_fps=self.input_fps,
            target_width=self.target_resolution[0],
            target_height=self.target_resolution[1],
            target_fps=self.target_fps,
            temporal_scale=self.target_fps / self.input_fps,
            spatial_scale=self.target_resolution[1] / self.input_resolution[1],
            num_input_frames=n_in,
            num_gt_frames=n_gt,
            num_triplets=len(triplets),
            processed_at=datetime.now().isoformat(),
        )
        with open(clip_dir / "metadata.json", "w") as f:
            json.dump(metadata.to_dict(), f, indent=2)
        with open(clip_dir / "triplets.json", "w") as f:
            json.dump(triplets, f, indent=2)
        return {"metadata": metadata.to_dict(), "triplets": len(triplets), "dir": str(clip_dir)}

    def create_triplet_index(self, dirs: dict) -> List[dict]:
        """Triplets of consecutive input frames and the ground-truth frames
        between them (the reference's index math)."""
        input_frames = sorted(Path(dirs["input_frames"]).glob("frame_*.png"))
        gt_frames = sorted(Path(dirs["gt_frames"]).glob("frame_*.png"))
        if not input_frames:
            raise ValueError("No input frames found")
        if not gt_frames:
            raise ValueError("No ground truth frames found")

        temporal_scale = self.target_fps / self.input_fps
        triplets = []
        for i in range(len(input_frames) - 1):
            gt_start = int(round(i * temporal_scale))
            gt_end = int(round((i + 1) * temporal_scale))
            gt_intermediate_indices = list(range(gt_start + 1, gt_end))
            if not gt_intermediate_indices:
                continue
            if gt_end >= len(gt_frames):
                continue
            temporal_positions = [
                (idx - gt_start) / (gt_end - gt_start) for idx in gt_intermediate_indices
            ]
            triplets.append(
                {
                    "triplet_id": len(triplets),
                    "input_frame_0": input_frames[i].name,
                    "input_frame_1": input_frames[i + 1].name,
                    "input_idx_0": i,
                    "input_idx_1": i + 1,
                    "gt_frame_start": gt_frames[gt_start].name,
                    "gt_frame_end": gt_frames[gt_end].name,
                    "gt_start_idx": gt_start,
                    "gt_end_idx": gt_end,
                    "gt_intermediate": [
                        gt_frames[idx].name
                        for idx in gt_intermediate_indices
                        if idx < len(gt_frames)
                    ],
                    "gt_intermediate_indices": [
                        idx for idx in gt_intermediate_indices if idx < len(gt_frames)
                    ],
                    "temporal_positions": temporal_positions,
                    "num_intermediate": len(gt_intermediate_indices),
                }
            )
        return triplets


def load_clip_data(clip_dir: str | Path) -> Tuple[dict, List[dict]]:
    """(metadata, triplets) of a processed clip. ``harness/triplet.py`` has
    its own ``load_clip_data``, which returns a dict with the frame
    directories as well."""
    clip_dir = Path(clip_dir)
    with open(clip_dir / "metadata.json") as f:
        metadata = json.load(f)
    with open(clip_dir / "triplets.json") as f:
        triplets = json.load(f)
    return metadata, triplets
