"""Clip registry (port of ``vfisr_tpu/data/registry.py``).

On disk: ``<data_dir>/clips_registry.json`` with a ``clips`` list, and
``<data_dir>/clips/<id>/{clip_meta.json, intervals/}``. A source must be at
least 1080 px high and 60 fps (the probe's fps, rounded to 2 decimals), so
that ground-truth midpoints exist. The probe is ``data/video_io.py``'s:
Y4M without OpenCV, other containers through cv2 where it is installed
(its ``codec`` is ``"y4m C420..."`` for a Y4M file, ``"unknown"`` otherwise).
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

from vfisr_tpu_torch.data.video_io import probe_video

DEFAULT_DATA_DIR = Path("data")


class ClipRegistry:
    def __init__(self, data_dir: str | Path = DEFAULT_DATA_DIR):
        self.data_dir = Path(data_dir)
        self.clips_dir = self.data_dir / "clips"
        self.registry_file = self.data_dir / "clips_registry.json"

    def load(self) -> dict:
        if self.registry_file.exists():
            with open(self.registry_file) as f:
                return json.load(f)
        return {"clips": [], "version": "1.0"}

    def save(self, registry: dict):
        self.clips_dir.mkdir(parents=True, exist_ok=True)
        with open(self.registry_file, "w") as f:
            json.dump(registry, f, indent=2)

    def get_clip(self, clip_id: str) -> Optional[dict]:
        for clip in self.load()["clips"]:
            if clip["clip_id"] == clip_id:
                return clip
        return None

    def register(self, video_path: str | Path, clip_id: str, force: bool = False) -> dict:
        """Validate a source clip and add (or, with force, replace) its entry."""
        video_path = Path(video_path)
        if not video_path.exists():
            raise FileNotFoundError(f"video not found: {video_path}")

        info = probe_video(str(video_path))
        if info.height < 1080:
            raise ValueError(f"source must be >=1080p, got {info.width}x{info.height}")
        if info.fps < 60:
            raise ValueError(f"source must be >=60fps for GT midpoints, got {info.fps}")

        registry = self.load()
        existing = [c for c in registry["clips"] if c["clip_id"] == clip_id]
        if existing and not force:
            raise ValueError(f"clip_id {clip_id!r} already registered (use force=True)")
        registry["clips"] = [c for c in registry["clips"] if c["clip_id"] != clip_id]

        entry = {
            "clip_id": clip_id,
            "source_path": str(video_path.resolve()),
            "registered_at": datetime.now(timezone.utc).isoformat(),
            "width": info.width,
            "height": info.height,
            "fps": info.fps,
            "duration_s": info.duration_s,
            "frame_count": info.frame_count,
            "codec": info.codec,
            "intervals": [],
        }
        registry["clips"].append(entry)
        self.save(registry)

        clip_dir = self.clips_dir / clip_id
        (clip_dir / "intervals").mkdir(parents=True, exist_ok=True)
        with open(clip_dir / "clip_meta.json", "w") as f:
            json.dump(entry, f, indent=2)
        return entry

    def update_clip(self, clip_id: str, **fields):
        registry = self.load()
        for clip in registry["clips"]:
            if clip["clip_id"] == clip_id:
                clip.update(fields)
        self.save(registry)

    def list_clips(self) -> list:
        return self.load()["clips"]
