"""Video I/O (port of ``vfisr_tpu/data/``'s ``video_io.py``: probe, reader,
writer)."""

from vfisr_tpu_torch.data.video_io import VideoMeta, VideoReader, VideoWriter, probe_video

__all__ = ["VideoMeta", "VideoReader", "VideoWriter", "probe_video"]
