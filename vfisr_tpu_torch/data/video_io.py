"""Video probe, reader and writer (port of ``vfisr_tpu/data/video_io.py``'s
``VideoMeta``, ``probe_video``, ``VideoReader`` and ``VideoWriter``).

The container read and written with numpy and torch alone is Y4M
(YUV4MPEG2) with 4:2:0 chroma: a one-line text header, then each frame as
``FRAME`` and its raw I420 planes. The reference reaches every container
through ffmpeg or cv2; this one needs neither, so the streaming pipeline
runs where they are missing. Colours are ITU-R BT.601 video range
(``core/color.py``): the reader turns I420 into RGB with cv2's
``COLOR_YUV2RGB_I420`` arithmetic, the writer RGB into I420 with the
formula of the streaming pipeline's ``pack_i420``, and
``VideoWriter.write_i420`` writes I420 frames as they are.

Other containers (mp4, mkv, ...) go through OpenCV, imported when such a
file is opened. The container is chosen by the file's signature on read
(the ``YUV4MPEG2 `` magic) and by the ``.y4m`` suffix on write; without
cv2, any other container raises an error that says to convert to Y4M.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import i420_size, i420_to_rgb, rgb_to_i420

Y4M_MAGIC = b"YUV4MPEG2 "
FRAME_HEADER = b"FRAME\n"
# the 4:2:0 chroma tags: the samples' siting differs, their layout does not
C420 = ("420jpeg", "420mpeg2", "420paldv", "420")
_MAX_LINE = 1024


@dataclass
class VideoMeta:
    width: int
    height: int
    fps: float
    frame_count: int
    duration_s: float
    codec: str = "unknown"

    def to_dict(self) -> dict:
        return {
            "width": self.width,
            "height": self.height,
            "fps": self.fps,
            "frame_count": self.frame_count,
            "duration_s": self.duration_s,
            "codec": self.codec,
        }


def is_y4m(path) -> bool:
    """Whether the file at path starts with the YUV4MPEG2 signature."""
    with open(path, "rb") as f:
        return f.read(len(Y4M_MAGIC)) == Y4M_MAGIC


def _cv2(path):
    """OpenCV, for a container other than Y4M."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"{path}: not a Y4M file, and without OpenCV (cv2) only Y4M "
                           "(YUV4MPEG2, 4:2:0) is read and written; convert the video to "
                           "Y4M, e.g. ffmpeg -i in.mp4 -pix_fmt yuv420p in.y4m") from None
    return cv2


@dataclass(frozen=True)
class Y4MHeader:
    """A Y4M stream header: frame size, exact frame rate, chroma tag."""

    width: int
    height: int
    fps: Fraction
    chroma: str = "420jpeg"

    @property
    def frame_bytes(self) -> int:
        return i420_size(self.height, self.width)

    @classmethod
    def parse(cls, line: bytes, path: str = "") -> "Y4MHeader":
        """The header line (without its newline). Raises ValueError for a
        missing signature or size, interlaced frames, or chroma other than
        4:2:0."""
        if not line.startswith(Y4M_MAGIC):
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        width = height = 0
        fps, chroma = Fraction(30), "420jpeg"
        for tok in line[len(Y4M_MAGIC):].decode("ascii").split():
            key, val = tok[0], tok[1:]
            if key == "W":
                width = int(val)
            elif key == "H":
                height = int(val)
            elif key == "F":
                num, den = val.split(":")
                fps = Fraction(int(num), int(den))
            elif key == "I" and val not in ("p", "?"):
                raise ValueError(f"{path}: interlaced Y4M (I{val}); only progressive is read")
            elif key == "C":
                chroma = val
        if width <= 0 or height <= 0:
            raise ValueError(f"{path}: Y4M header without a frame size: {line!r}")
        if chroma not in C420:
            raise ValueError(f"{path}: Y4M chroma C{chroma}; only 4:2:0 "
                             f"({', '.join('C' + c for c in C420)}) is read")
        return cls(width, height, fps, chroma)

    def line(self) -> bytes:
        return (f"YUV4MPEG2 W{self.width} H{self.height} F{self.fps.numerator}:"
                f"{self.fps.denominator} Ip A1:1 C{self.chroma}\n").encode("ascii")


def _read_line(f, path: str, what: str) -> bytes:
    """One header line without its newline; b"" at the end of the file."""
    line = f.readline(_MAX_LINE)
    if line and not line.endswith(b"\n"):
        raise ValueError(f"{path}: {what} is cut short or longer than {_MAX_LINE} bytes")
    return line[:-1]


def _y4m_layout(path: str):
    """(header, bytes of the header line, frame count from the file size)."""
    with open(path, "rb") as f:
        hdr = Y4MHeader.parse(_read_line(f, path, "the stream header"), path)
        start = f.tell()
        size = os.fstat(f.fileno()).st_size
    count, rest = divmod(size - start, len(FRAME_HEADER) + hdr.frame_bytes)
    if rest:
        raise ValueError(f"{path}: {rest} bytes past the last whole frame: a truncated file, "
                         "or frame headers with parameters (not read here)")
    return hdr, start, count


def probe_video(path: str) -> VideoMeta:
    """Size, frame rate (rounded to 2 decimals, as the reference's probe
    does) and frame count. A Y4M file's count comes from its size."""
    path = str(path)
    if is_y4m(path):
        hdr, _, count = _y4m_layout(path)
        fps = float(hdr.fps)
        return VideoMeta(width=hdr.width, height=hdr.height, fps=round(fps, 2),
                         frame_count=count, duration_s=count / fps, codec="y4m C" + hdr.chroma)
    cv2 = _cv2(path)
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video: {path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    meta = VideoMeta(width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                     height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), fps=round(fps, 2),
                     frame_count=count, duration_s=count / fps if fps else 0.0)
    cap.release()
    return meta


class VideoReader:
    """Sequential RGB frame reader with seek-by-frame. For Y4M, ``header``
    holds the stream header (None for other containers), ``fps`` is its
    exact Fraction (30000:1001 stays exact), ``read_i420`` gives a frame's
    bytes as stored, and a frame cut short by the end of the file raises
    ValueError."""

    def __init__(self, path: str, start_frame: int = 0):
        self.path = str(path)
        self._f = self._cap = None
        if is_y4m(self.path):
            self.header, start, self._count = _y4m_layout(self.path)
            self._f = open(self.path, "rb")
            self._f.seek(start + start_frame * (len(FRAME_HEADER) + self.header.frame_bytes))
        else:
            self.header = None
            self._cv = _cv2(self.path)
            self._cap = self._cv.VideoCapture(self.path)
            if not self._cap.isOpened():
                raise RuntimeError(f"cannot open video: {path}")
            if start_frame:
                self._cap.set(self._cv.CAP_PROP_POS_FRAMES, start_frame)

    @property
    def fps(self):
        if self._f is not None:
            return self.header.fps
        return self._cap.get(self._cv.CAP_PROP_FPS) or 30.0

    @property
    def frame_count(self) -> int:
        if self._f is not None:
            return self._count
        return int(self._cap.get(self._cv.CAP_PROP_FRAME_COUNT))

    def read_i420(self) -> Optional[np.ndarray]:
        """Next Y4M frame's I420 bytes as stored (flat uint8: Y, U, V), or
        None at the end."""
        line = _read_line(self._f, self.path, "a frame header")
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError(f"{self.path}: expected a frame header, read {line[:16]!r}")
        buf = np.empty(self.header.frame_bytes, np.uint8)
        got = self._f.readinto(memoryview(buf))
        if got != buf.size:
            raise ValueError(f"{self.path}: truncated frame: {got} of {buf.size} bytes")
        return buf

    def read(self) -> Optional[np.ndarray]:
        """Next frame as HWC uint8 RGB, or None at EOF."""
        if self._f is None:
            ok, frame = self._cap.read()
            return self._cv.cvtColor(frame, self._cv.COLOR_BGR2RGB) if ok else None
        buf = self.read_i420()
        if buf is None:
            return None
        return i420_to_rgb(torch.from_numpy(buf), self.header.height, self.header.width).numpy()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def close(self):
        if self._f is not None:
            self._f.close()
        if self._cap is not None:
            self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class VideoWriter:
    """Streaming frame writer: Y4M (C420jpeg, progressive) for a ``.y4m``
    path, else OpenCV's mp4v. ``fps`` is anything ``Fraction`` takes (a
    number, a Fraction, "30000/1001"), to the nearest fraction with a
    denominator up to 1001 (29.97 is 2997:100; NTSC's rate is
    "30000/1001")."""

    def __init__(self, path: str, width: int, height: int, fps):
        self.path = str(path)
        self.size = (width, height)
        self.fps = Fraction(fps).limit_denominator(1001)
        self._f = self._writer = None
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        if self.path.lower().endswith(".y4m"):
            if width % 2 or height % 2:
                raise ValueError(f"{path}: a 4:2:0 Y4M frame needs an even size, got "
                                 f"{width}x{height}")
            self.header = Y4MHeader(width, height, self.fps)
            self._f = open(self.path, "wb")
            self._f.write(self.header.line())
        else:
            self._cv = _cv2(self.path)
            self._writer = self._cv.VideoWriter(self.path, self._cv.VideoWriter_fourcc(*"mp4v"),
                                                float(self.fps), self.size)
            if not self._writer.isOpened():
                raise RuntimeError(f"cannot open VideoWriter for {path}")

    def _check(self, frame: np.ndarray, what: str) -> None:
        w, h = self.size
        if frame.dtype != np.uint8 or frame.shape != (h, w, 3):
            raise ValueError(f"{self.path}: a {what} frame must be uint8 {(h, w, 3)}, got "
                             f"{frame.dtype} {frame.shape}")

    def write(self, frame_rgb: np.ndarray):
        """Write one HWC uint8 RGB frame (streams immediately)."""
        self._check(frame_rgb, "RGB")
        if self._f is None:
            self._writer.write(self._cv.cvtColor(frame_rgb, self._cv.COLOR_RGB2BGR))
            return
        self.write_i420(rgb_to_i420(torch.from_numpy(frame_rgb)).numpy())

    def write_bgr(self, frame_bgr: np.ndarray):
        """Write one HWC uint8 BGR frame."""
        self._check(frame_bgr, "BGR")
        if self._f is None:
            self._writer.write(frame_bgr)
            return
        self.write(np.ascontiguousarray(frame_bgr[..., ::-1]))

    def write_i420(self, planes: np.ndarray):
        """Write one I420 frame: uint8 Y, U and V planes in order, packed
        [3H/2, W] as ``pack_i420`` gives them, or flat. To Y4M they go as
        they are."""
        w, h = self.size
        if planes.dtype != np.uint8 or planes.size != i420_size(h, w):
            raise ValueError(f"{self.path}: an I420 frame must hold {i420_size(h, w)} uint8, "
                             f"got {planes.dtype} {planes.shape}")
        if self._f is None:
            self._writer.write(self._cv.cvtColor(planes.reshape(h * 3 // 2, w),
                                                 self._cv.COLOR_YUV2BGR_I420))
            return
        self._f.write(FRAME_HEADER)
        self._f.write(np.ascontiguousarray(planes).data)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
