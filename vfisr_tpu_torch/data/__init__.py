"""Video I/O and the dataset pipeline (port of ``vfisr_tpu/data/``): clip
registry -> interval extraction -> triplet preprocessing.

On disk, as the reference has it:
- ``<data_dir>/clips_registry.json`` and each clip's ``clip_meta.json``
  (``registry.py``);
- per interval ``keyframes/kf_*.png`` (even frames), ``midpoints/gt_*.png``
  (odd frames), ``motion/{complexity,flow_stats}.json`` and ``meta.json``,
  and per clip ``difficulty_index.json`` (``extract_intervals.py``);
- per processed clip ``{input_1080p30/frames, ground_truth/frames,
  metadata.json, triplets.json}`` (``preprocess_video.py``).

Frames are PNG (``png.py``) and videos Y4M without OpenCV (``video_io.py``).
"""

from vfisr_tpu_torch.data.extract_intervals import IntervalExtractor
from vfisr_tpu_torch.data.preprocess_video import VideoPreprocessor
from vfisr_tpu_torch.data.registry import ClipRegistry
from vfisr_tpu_torch.data.video_io import VideoMeta, VideoReader, VideoWriter, probe_video

__all__ = ["ClipRegistry", "IntervalExtractor", "VideoMeta", "VideoPreprocessor",
           "VideoReader", "VideoWriter", "probe_video"]
