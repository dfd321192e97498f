"""The port's video I/O (``vfisr_tpu_torch/data/video_io.py``): Y4M read and
written with numpy and torch alone, other containers through cv2.

Tolerances: I420 planes round-trip bit-exact; the reader's RGB within 2
LSB of ``cv2.cvtColor(COLOR_YUV2RGB_I420)`` on smooth frames (the bound the
repo holds cv2 comparisons to; it uses cv2's integer arithmetic, and 0 LSB
was measured here); an mp4 read back through cv2 within 12 LSB of what was
written (mp4v is lossy; this only shows the cv2 branch is wired up).
"""

import sys
from fractions import Fraction

import cv2
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smooth_frames
from vfisr_tpu_torch.core.color import i420_to_rgb
from vfisr_tpu_torch.data.video_io import (C420, VideoReader, VideoWriter, Y4MHeader, is_y4m,
                                           probe_video)


def _smooth_rgb(seed, n, h, w):
    x = smooth_frames(np.random.default_rng(seed), n, h, w, cell=8)
    return np.floor(x * 255.0 + 0.5).astype(np.uint8)


def _write_y4m(path, header: bytes, frames):
    with open(path, "wb") as f:
        f.write(header + b"\n")
        for fr in frames:
            f.write(b"FRAME\n" + fr.tobytes())


def test_y4m_round_trip_is_bit_exact(tmp_path):
    h, w = 48, 64
    planes = np.random.default_rng(0).integers(0, 256, (5, h * 3 // 2, w), np.uint8)
    path = tmp_path / "rt.y4m"
    with VideoWriter(str(path), w, h, "30000/1001") as wr:
        for p in planes[:3]:
            wr.write_i420(p)  # packed [3H/2, W]
        for p in planes[3:]:
            wr.write_i420(p.reshape(-1))  # flat
    assert path.read_bytes().startswith(b"YUV4MPEG2 W64 H48 F30000:1001 Ip A1:1 C420jpeg\n")
    with VideoReader(str(path)) as rd:
        assert rd.fps == Fraction(30000, 1001) and rd.frame_count == 5
        got = [rd.read_i420() for _ in range(6)]
    assert got[-1] is None
    for g, p in zip(got, planes):
        assert np.array_equal(g, p.reshape(-1))
    with VideoReader(str(path), start_frame=3) as rd:
        assert np.array_equal(rd.read_i420(), planes[3].reshape(-1))


@pytest.mark.parametrize("tag", [b""] + [b" C" + c.encode() for c in C420])
def test_header_parsing(tmp_path, tag):
    h, w = 6, 8
    frames = np.random.default_rng(1).integers(0, 256, (3, h * w * 3 // 2), np.uint8)
    path = tmp_path / "h.y4m"
    _write_y4m(path, b"YUV4MPEG2 W8 H6 F30000:1001 Ip A1:1 XYSCSS=420JPEG" + tag, frames)
    assert is_y4m(path)
    meta = probe_video(str(path))
    assert (meta.width, meta.height, meta.frame_count) == (8, 6, 3)
    assert meta.fps == 29.97 and meta.duration_s == pytest.approx(3 * 1001 / 30000)
    with VideoReader(str(path)) as rd:
        assert rd.header.fps == Fraction(30000, 1001)
        assert rd.header.chroma == (tag[2:].decode() or "420jpeg")
        assert np.array_equal(rd.read_i420(), frames[0])


@pytest.mark.parametrize("header,what", [
    (b"YUV4MPEG2 W8 H6 F30:1 C444", "chroma"),
    (b"YUV4MPEG2 W8 H6 F30:1 C420p10", "chroma"),
    (b"YUV4MPEG2 W8 H6 F30:1 It C420jpeg", "interlaced"),
    (b"YUV4MPEG2 W8 F30:1", "size"),
])
def test_header_refused(tmp_path, header, what):
    path = tmp_path / "bad.y4m"
    _write_y4m(path, header, [np.zeros(72, np.uint8)])
    with pytest.raises(ValueError, match=what):
        probe_video(str(path))
    with pytest.raises(ValueError, match=what):
        VideoReader(str(path))
    assert Y4MHeader.parse(b"YUV4MPEG2 W8 H6 F25:1").fps == 25


def test_frame_count_from_size_and_truncation(tmp_path):
    h, w = 6, 8
    frames = np.random.default_rng(2).integers(0, 256, (4, h * w * 3 // 2), np.uint8)
    path = tmp_path / "t.y4m"
    _write_y4m(path, b"YUV4MPEG2 W8 H6 F30:1 C420", frames)
    assert probe_video(str(path)).frame_count == 4
    path.write_bytes(path.read_bytes()[:-5])  # the last frame cut short
    with pytest.raises(ValueError, match="truncated"):
        probe_video(str(path))
    with pytest.raises(ValueError, match="truncated"):
        VideoReader(str(path))


def test_reader_rgb_matches_cv2(tmp_path):
    h, w = 64, 96
    rgb = _smooth_rgb(3, 3, h, w)
    planes = [cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in rgb]
    path = tmp_path / "c.y4m"
    with VideoWriter(str(path), w, h, 30) as wr:
        for p in planes:
            wr.write_i420(p)
    with VideoReader(str(path)) as rd:
        got = list(rd)
    assert len(got) == 3
    for g, p in zip(got, planes):
        ref = cv2.cvtColor(p, cv2.COLOR_YUV2RGB_I420)
        assert g.dtype == np.uint8 and g.shape == (h, w, 3)
        assert np.abs(g.astype(int) - ref.astype(int)).max() <= 2


def test_write_bgr_and_write_agree(tmp_path):
    rgb = _smooth_rgb(6, 2, 32, 48)
    for name, write in (("rgb", lambda wr, f: wr.write(f)),
                        ("bgr", lambda wr, f: wr.write_bgr(np.ascontiguousarray(f[..., ::-1])))):
        with VideoWriter(str(tmp_path / f"{name}.y4m"), 48, 32, 29.97) as wr:
            for f in rgb:
                write(wr, f)
    data = (tmp_path / "rgb.y4m").read_bytes()
    assert data == (tmp_path / "bgr.y4m").read_bytes() and b" F2997:100 " in data


def test_odd_size_chroma_covers_its_block():
    """An odd side's last chroma sample covers its one row or column: the
    frame is the crop of the even frame with that row and column
    repeated."""
    h, w = 7, 5
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (h, w), np.uint8)
    u, v = (rng.integers(0, 256, (4, 3), np.uint8) for _ in range(2))
    got = i420_to_rgb(torch.from_numpy(np.concatenate([y.ravel(), u.ravel(), v.ravel()])), h, w)
    even = np.concatenate([np.pad(y, ((0, 1), (0, 1)), mode="edge").ravel(), u.ravel(), v.ravel()])
    ref = cv2.cvtColor(even.reshape(12, 6), cv2.COLOR_YUV2RGB_I420)[:h, :w]
    assert np.array_equal(got.numpy(), ref)


def test_other_containers_go_through_cv2(tmp_path):
    h, w = 64, 96
    rgb = _smooth_rgb(5, 3, h, w)
    path = tmp_path / "v.mp4"
    with VideoWriter(str(path), w, h, 30) as wr:
        for f in rgb:
            wr.write(f)
    assert not is_y4m(path)
    meta = probe_video(str(path))
    assert (meta.width, meta.height, meta.fps, meta.frame_count) == (w, h, 30.0, 3)
    with VideoReader(str(path)) as rd:
        got = list(rd)
    assert len(got) == 3 and np.abs(got[1].astype(int) - rgb[1].astype(int)).mean() <= 12


def test_mp4_without_cv2_names_y4m(tmp_path, monkeypatch):
    path = tmp_path / "v.mp4"
    with VideoWriter(str(path), 32, 32, 30) as wr:
        wr.write(np.zeros((32, 32, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for call in (lambda: VideoReader(str(path)), lambda: probe_video(str(path)),
                 lambda: VideoWriter(str(tmp_path / "o.mp4"), 32, 32, 30)):
        with pytest.raises(RuntimeError, match="Y4M"):
            call()
    # Y4M needs no cv2
    with VideoWriter(str(tmp_path / "o.y4m"), 32, 32, 30) as wr:
        wr.write(np.zeros((32, 32, 3), np.uint8))
    with VideoReader(str(tmp_path / "o.y4m")) as rd:
        assert rd.read().shape == (32, 32, 3)
