"""The ffmpeg branches of vfisr_tpu_torch/data/video_io.py against
vfisr_tpu/data/video_io.py, and the segment helpers' other branches.

Neither this host nor the card's machine has an ffmpeg binary, so stub
``ffmpeg`` and ``ffprobe`` scripts written into tmp_path stand in for them:
each logs its argv (and, when it reads ``-i -``, the bytes it was piped),
writes its output file, and fails where the test says (``STUB_FAIL``: an
argv element that makes it exit 1). ``FFMPEG``/``FFPROBE`` of both
packages point at the stubs. Held equal, each package run in turn on the
same paths: the argv lists, the bytes piped, the return values and the
``VideoMeta``. One difference is the reference's fault: where the mux of
``extract_clip`` fails, the reference has already deleted the video cut
and raises FileNotFoundError moving it into place; the port keeps the cut
and returns True (video only), as the reference's comment intends.

Without ffmpeg: ``extract_clip`` and ``get_video_duration`` through cv2 on
tests/test_gui.py's tiny mp4 against the reference; a Y4M source cut by
copying frames, against its own frames; the audio helpers' False.
"""

import hashlib
import json
import os
import stat
import sys

import cv2
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread
from vfisr_tpu.data import video_io as jio
from vfisr_tpu_torch.data import video_io as tio

STUB = r'''#!{python}
import hashlib, json, os, sys
argv = sys.argv[1:]
rec = {"tool": os.path.basename(sys.argv[0]), "argv": argv}
if os.path.basename(sys.argv[0]) == "ffprobe":
    stream = {"codec_type": "video", "width": 1920, "height": 1080,
              "r_frame_rate": "30000/1001", "codec_name": "h264"}
    if os.environ.get("STUB_NB_FRAMES"):
        stream["nb_frames"] = os.environ["STUB_NB_FRAMES"]
    print(json.dumps({"streams": [{"codec_type": "audio"}, stream],
                      "format": {"duration": "2.002"}}))
else:
    if argv[argv.index("-i") + 1] == "-":
        data = sys.stdin.buffer.read()
        rec["stdin_bytes"], rec["stdin_sha256"] = len(data), hashlib.sha256(data).hexdigest()
    fail = os.environ.get("STUB_FAIL")
    if fail and fail in argv:
        rec["rc"] = 1
    else:
        with open(argv[-1], "wb") as f:
            f.write(b"stub output of " + " ".join(argv[:-1]).encode())
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(rec) + "\n")
sys.exit(rec.get("rc", 0))
'''


@pytest.fixture
def stubs(tmp_path, monkeypatch):
    """(log path, read_log): stub binaries patched into both packages."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("ffmpeg", "ffprobe"):
        p = bin_dir / name
        p.write_text(STUB.replace("{python}", sys.executable))
        p.chmod(p.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "stub.log"
    monkeypatch.setenv("STUB_LOG", str(log))
    for mod in (jio, tio):
        monkeypatch.setattr(mod, "FFMPEG", str(bin_dir / "ffmpeg"))
        monkeypatch.setattr(mod, "FFPROBE", str(bin_dir / "ffprobe"))

    def take():
        recs = [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []
        log.unlink(missing_ok=True)
        return recs

    return take


def both(take, fn_name, *args, **kw):
    """(reference result, its log), (port result, its log) of one helper."""
    out = []
    for mod in (jio, tio):
        res = getattr(mod, fn_name)(*args, **kw)
        out.append((res, take()))
    return out


@pytest.mark.parametrize("nb_frames", [None, "60"])
def test_probe_video_ffprobe_branch(stubs, tmp_path, monkeypatch, nb_frames):
    if nb_frames:
        monkeypatch.setenv("STUB_NB_FRAMES", nb_frames)
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"not a y4m")
    (jm, jlog), (tm, tlog) = both(stubs, "probe_video", str(clip))
    assert jlog == tlog and len(tlog) == 1 and tlog[0]["tool"] == "ffprobe"
    assert tm.to_dict() == jm.to_dict()
    assert tm.fps == 29.97 and tm.frame_count == (60 if nb_frames else int(30000 / 1001 * 2.002))


def test_probe_video_y4m_needs_no_ffprobe(stubs, tmp_path):
    path = tmp_path / "a.y4m"
    with tio.VideoWriter(str(path), 16, 8, 30) as w:
        w.write(np.zeros((8, 16, 3), np.uint8))
    assert tio.probe_video(str(path)).frame_count == 1 and stubs() == []


def _frames(n=3, h=8, w=16):
    rng = np.random.default_rng(2)
    return rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("fps", [120.0, 30000 / 1001, 24])
def test_video_writer_ffmpeg_pipe(stubs, tmp_path, fps):
    frames = _frames()
    logs = []
    for mod in (jio, tio):
        w = mod.VideoWriter(str(tmp_path / "o.mp4"), 16, 8, fps, crf=20)
        w.write(frames[0])
        w.write_bgr(np.ascontiguousarray(frames[1][..., ::-1]))
        w.write(frames[2])
        w.close()
        logs.append(stubs())
    assert logs[0] == logs[1] and len(logs[1]) == 1
    rec = logs[1][0]
    assert rec["argv"][rec["argv"].index("-crf") + 1] == "20"
    assert rec["stdin_sha256"] == hashlib.sha256(frames.tobytes()).hexdigest()


def test_video_writer_pipes_a_device_tensor_and_i420(stubs, tmp_path):
    """The port's writer takes tensors and I420 planes too: the same bytes."""
    frames = _frames(2)
    with tio.VideoWriter(str(tmp_path / "o.mp4"), 16, 8, 30) as w:
        w.write(torch.from_numpy(frames[0]))
        w.write(frames[1])
    ref = stubs()[0]
    assert ref["stdin_sha256"] == hashlib.sha256(frames.tobytes()).hexdigest()
    planes = tio.rgb_to_i420(torch.from_numpy(frames[0])).numpy()
    with tio.VideoWriter(str(tmp_path / "o.mp4"), 16, 8, 30) as w:
        w.write_i420(planes)
    got = stubs()[0]
    back = tio.i420_to_rgb(torch.from_numpy(planes), 8, 16).numpy()
    assert got["stdin_sha256"] == hashlib.sha256(back.tobytes()).hexdigest()


@pytest.mark.parametrize("duration", [None, 1.5])
def test_extract_audio(stubs, tmp_path, duration):
    out = str(tmp_path / "a.aac")
    (jr, jlog), (tr, tlog) = both(stubs, "extract_audio", "raw.mp4", out, 2.0, duration)
    assert jr is tr is True and jlog == tlog and len(tlog) == 1


def test_extract_audio_failure(stubs, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_FAIL", "-vn")
    (jr, jlog), (tr, tlog) = both(stubs, "extract_audio", "raw.mp4", str(tmp_path / "a.aac"))
    assert jr is tr is False and jlog == tlog


@pytest.mark.parametrize("fail", [None, "-shortest"])
def test_mux_audio(stubs, tmp_path, monkeypatch, fail):
    if fail:
        monkeypatch.setenv("STUB_FAIL", fail)
    audio = tmp_path / "a.aac"
    audio.write_bytes(b"aac")
    out = str(tmp_path / "m.mp4")
    (jr, jlog), (tr, tlog) = both(stubs, "mux_audio", "v.mp4", str(audio), out)
    assert jr is tr is (fail is None) and jlog == tlog and len(tlog) == 1
    # a missing audio file: False, no call
    (jr, jlog), (tr, tlog) = both(stubs, "mux_audio", "v.mp4", str(tmp_path / "none"), out)
    assert jr is tr is False and jlog == tlog == []


@pytest.mark.parametrize("raw", [None, "raw.mp4"])
def test_extract_clip_ffmpeg_mux_success(stubs, tmp_path, raw):
    out = tmp_path / "cut" / "clip.mp4"
    results = []
    for mod in (jio, tio):
        ok = mod.extract_clip("full.mp4", raw, 1.25, 2.5, str(out))
        results.append((ok, stubs(), out.read_bytes(), sorted(os.listdir(out.parent))))
        out.unlink()
    assert results[0] == results[1]
    ok, log, data, files = results[1]
    assert ok is True and files == ["clip.mp4"]
    assert len(log) == (3 if raw else 1) and data.startswith(b"stub output of " +
                                                             (b"-y -i" if raw else b"-y -ss"))


def test_extract_clip_ffmpeg_mux_failure(stubs, tmp_path, monkeypatch):
    """The reference's fault (module docstring): same commands, then it
    raises; the port keeps the video cut."""
    monkeypatch.setenv("STUB_FAIL", "-shortest")
    out = tmp_path / "clip.mp4"
    with pytest.raises(FileNotFoundError):
        jio.extract_clip("full.mp4", "raw.mp4", 1.25, 2.5, str(out))
    jlog = stubs()
    assert tio.extract_clip("full.mp4", "raw.mp4", 1.25, 2.5, str(out)) is True
    assert stubs() == jlog and len(jlog) == 3
    assert out.read_bytes().startswith(b"stub output of -y -ss 1.25 -i full.mp4 -t 2.5 -c copy")
    assert sorted(os.listdir(tmp_path)) == ["bin", "clip.mp4"]


def test_extract_clip_ffmpeg_cut_failure(stubs, tmp_path, monkeypatch):
    monkeypatch.setenv("STUB_FAIL", "copy")
    (jr, jlog), (tr, tlog) = both(stubs, "extract_clip", "full.mp4", None, 0.0, 1.0,
                                  str(tmp_path / "c.mp4"))
    assert jr is tr is False and jlog == tlog and len(tlog) == 1


@pytest.fixture
def tiny_mp4(tmp_path):
    """tests/test_gui.py's ~1 s 8 fps mp4, written through cv2."""
    path = tmp_path / "vid" / "control.mp4"
    path.parent.mkdir(parents=True)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (96, 64))
    assert w.isOpened()
    for i in range(8):
        w.write(np.full((64, 96, 3), i * 30 % 255, dtype=np.uint8))
    w.release()
    return path


def test_cv2_branch_without_ffmpeg(tiny_mp4, tmp_path, monkeypatch):
    for mod in (jio, tio):
        monkeypatch.setattr(mod, "FFMPEG", None)
    assert tio.get_video_duration(str(tiny_mp4)) == jio.get_video_duration(str(tiny_mp4)) == 1.0
    assert tio.get_video_duration(str(tmp_path / "none.mp4")) == 0.0
    got = []
    for mod in (jio, tio):
        out = tmp_path / f"cut_{mod.__name__.split('.')[0]}.mp4"
        assert mod.extract_clip(str(tiny_mp4), None, 0.25, 0.5, str(out)) is True
        cap = cv2.VideoCapture(str(out))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        got.append(np.stack(frames))
    assert got[0].shape[0] == 4 and np.array_equal(got[0], got[1])
    assert tio.extract_audio(str(tiny_mp4), str(tmp_path / "a.aac")) is False
    assert tio.mux_audio(str(tiny_mp4), str(tiny_mp4), str(tmp_path / "m.mp4")) is False


@pytest.mark.parametrize("start,duration,n", [(0.25, 0.5, 4), (0.0, 10.0, 12), (1.0, 0.5, 4),
                                              (2.0, 0.5, 0)])
def test_extract_clip_cuts_y4m_frames(stubs, tmp_path, start, duration, n):
    """A Y4M source at 8 fps cut without ffmpeg (the stub is never called)
    or cv2: frames [round(start*fps), +round(duration*fps)) as stored."""
    src = tmp_path / "full.y4m"
    frames = np.random.default_rng(3).integers(0, 256, (12, 8, 16, 3), np.uint8)
    with tio.VideoWriter(str(src), 16, 8, 8) as w:
        for f in frames:
            w.write(f)
    assert tio.get_video_duration(str(src)) == 1.5
    out = tmp_path / "cut.y4m"
    assert tio.extract_clip(str(src), "raw.mp4", start, duration, str(out)) is (n > 0)
    first = int(round(start * 8))
    with tio.VideoReader(str(src)) as a, tio.VideoReader(str(out)) as b:
        src_planes = [a.read_i420() for _ in range(12)]
        assert b.fps == a.fps and b.frame_count == n
        for k in range(n):
            assert np.array_equal(b.read_i420(), src_planes[first + k])
    assert stubs() == []
    with pytest.raises(ValueError, match="name it .y4m"):
        tio.extract_clip(str(src), None, 0.0, 1.0, str(tmp_path / "cut.mp4"))
