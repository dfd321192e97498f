"""The blind study's clip generation (vfisr_tpu_torch/gui/ and
prepare_blind_study.py) against the reference's gui/benchmark_proper.py,
gui/benchmark_all.py, gui/generate_clips.py and
scripts/prepare_blind_study.py.

A fake writer, patched into both packages' ``video_io``, records the frames
that ``run_method``/``generate_method`` write. The clip is a 3-keyframe
interval in the registry's layout (720x1280, so that the area resize to
960x540 is a downscale, as it is from the study's 1080p sources: a static
pair, then a 16 px pan, whose 480x270 motion is 0 and 5.9 px, on either
side of adaptive_vfi's 3 px threshold). A narrow RIFE with the same parameters is
injected into both packages (``_torch_port.narrow_rife``; exact warps on
the CPU on both sides). The port runs every resize with float taps where
the reference calls cv2.resize (fixed point), so frames are held to
tests/test_resize.py's tolerance for cv2 against the taps, widened for the
two resizes in a row and the models on those inputs (``FRAME_TOL``: at most
4 LSB, more than 2 LSB on at most 0.5% of the bytes, a mean under 1 LSB).
The 'A'/'B' labels of ``hstack_pair`` are drawn equal to cv2.putText, byte
for byte. Also: the metadata's keys, Y4M naming where mp4 cannot be
written (cv2 hidden, no ffmpeg), ``benchmark_all`` raising on a failing
method where the reference prints it and goes on, and generate_clips'
spawned workers writing what the serial run writes.
"""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port import narrow_rife, one_torch_thread, sweep_interval
from vfisr_tpu_torch import prepare_blind_study as tpbs
from vfisr_tpu_torch.data import video_io as tio
from vfisr_tpu_torch.data.png import write_png
from vfisr_tpu_torch.gui import benchmark_all as tba
from vfisr_tpu_torch.gui import benchmark_proper as tbp
from vfisr_tpu_torch.gui import generate_clips as tgc

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from gui import benchmark_all as jba  # noqa: E402
from gui import benchmark_proper as jbp  # noqa: E402
from gui import generate_clips as jgc  # noqa: E402

import vfisr_tpu.data.video_io as jio  # noqa: E402
import vfisr_tpu.models.registry as jregistry  # noqa: E402

_spec = importlib.util.spec_from_file_location("ref_prepare_blind_study",
                                               ROOT / "scripts" / "prepare_blind_study.py")
jpbs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jpbs)

CLIP, OUT_W, OUT_H = "g", 384, 216
FRAME_TOL = dict(max=4, over2=5e-3, mean=1.0)


def frames_close(got, ref, tol=FRAME_TOL) -> None:
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, k
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= tol["max"] and (d > 2).mean() <= tol["over2"] \
            and d.mean() < tol["mean"], (k, d.max(), (d > 2).mean(), d.mean())


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    kfs, mids = sweep_interval([0, 16], seed=0, h=720, w=1280)
    d = root / "clips" / CLIP / "intervals" / "interval_0000"
    for sub, frames in (("keyframes", kfs), ("midpoints", mids)):
        (d / sub).mkdir(parents=True)
        for i, f in enumerate(frames):
            write_png(d / sub / f"frame_{i:04d}.png", f)
    (d / "meta.json").write_text(json.dumps({"clip_id": CLIP, "interval_id": 0}))
    return root


@pytest.fixture(scope="module")
def keyframes(data_dir):
    from vfisr_tpu_torch.data.extract_intervals import load_interval

    return load_interval(CLIP, 0, data_dir)[0]


@pytest.fixture(scope="module")
def rifes():
    return narrow_rife(7)


class FakeWriter:
    """A VideoWriter that keeps the frames it is given (numpy, or a tensor
    on any device) in ``written[path]`` and leaves a file of their bytes."""

    written = {}

    def __init__(self, path, width, height, fps, crf=18):
        self.path, self.frames = str(path), []
        FakeWriter.written[self.path] = self.frames

    def write(self, frame):
        self.frames.append(frame.cpu().numpy() if torch.is_tensor(frame) else np.array(frame))

    def close(self):
        Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        Path(self.path).write_bytes(b"".join(f.tobytes() for f in self.frames))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


@pytest.fixture
def injected(monkeypatch, rifes):
    """Fake writers and the narrow RIFE in both packages."""
    jr, tr = rifes
    FakeWriter.written = {}
    monkeypatch.setattr(jio, "VideoWriter", FakeWriter)
    monkeypatch.setattr(tio, "VideoWriter", FakeWriter)
    real_j, real_t = jregistry.get_model, tbp.get_model

    def jget(name, load=False, **kw):
        return jr if name == "rife" else real_j(name, load=load, **kw)

    def tget(name, load=False, **kw):
        return tr if name == "rife" else real_t(name, load=load, device="cpu")

    monkeypatch.setattr(jregistry, "get_model", jget)
    monkeypatch.setattr(tbp, "get_model", tget)
    monkeypatch.setattr(tgc, "get_model", tget)
    return FakeWriter.written


@pytest.mark.parametrize("method", ["control", "degraded", "lanczos", "bicubic", "optical_flow",
                                    "rife_bicubic", "rife_lanczos", "lanczos_edge",
                                    "adaptive_vfi"])
def test_run_method_frames_match(method, keyframes, injected, tmp_path):
    ref = jbp.run_method(method, keyframes, str(tmp_path / "j.mp4"), OUT_W, OUT_H, 120.0)
    got = tbp.run_method(method, keyframes, str(tmp_path / "t.mp4"), OUT_W, OUT_H, 120.0,
                         device="cpu")
    jf, tf = injected[str(tmp_path / "j.mp4")], injected[str(tmp_path / "t.mp4")]
    assert len(tf) == 3 + 3 * 2  # the keyframes and 3 frames per pair
    frames_close(tf, jf)
    assert set(got) == set(ref) and got["output_path"] == str(tmp_path / "t.mp4")
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-3
    if method == "control":  # every keyframe its own reference: no finite PSNR
        assert got["psnr"] is ref["psnr"] is None
    else:
        assert abs(got["psnr"] - ref["psnr"]) <= 0.5
    if method == "adaptive_vfi":  # the blend for the static pair, RIFE for the pan
        def lin(a, b):
            return tbp.linear_mid(torch.from_numpy(tf[a]), torch.from_numpy(tf[b]), 0.25).numpy()

        assert np.array_equal(tf[1], lin(0, 4)) and not np.array_equal(tf[5], lin(4, 8))


@pytest.mark.parametrize("method,aspect", [("control", "scale"), ("control", "crop"),
                                           ("control", "letterbox"), ("degraded", "scale"),
                                           ("bicubic", "scale"), ("rife_bicubic", "scale"),
                                           ("adaptive_vfi", "scale")])
def test_generate_method_frames_match(method, aspect, keyframes, injected, tmp_path):
    out_w, out_h = 192, 144  # another aspect ratio than the source's
    jgc.generate_method(method, keyframes, tmp_path / "j.mp4", out_w, out_h, 120.0,
                        (96, 54), aspect)
    tgc.generate_method(method, keyframes, tmp_path / "t.mp4", out_w, out_h, 120.0,
                        (96, 54), aspect, device="cpu")
    tf = injected[str(tmp_path / "t.mp4")]
    assert len(tf) == 9 and tf[0].shape == (out_h, out_w, 3)
    frames_close(tf, injected[str(tmp_path / "j.mp4")])


class FakeReader:
    """A VideoReader over given frames (``read`` and ``read_to``)."""

    frames = {}

    def __init__(self, path):
        self._it = iter(FakeReader.frames[str(path)])
        self.fps = 60.0

    def read(self):
        return next(self._it, None)

    def read_to(self, device):
        f = self.read()
        return None if f is None else torch.from_numpy(f).to(device)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        pass


@pytest.mark.parametrize("right_hw", [(144, 256), (160, 288)])
def test_hstack_pair_labels_equal_cv2(right_hw, injected, monkeypatch, tmp_path):
    rng = np.random.default_rng(5)
    FakeReader.frames = {"l": list(rng.integers(0, 256, (3, 144, 256, 3), np.uint8)),
                         "r": list(rng.integers(0, 256, (4, *right_hw, 3), np.uint8))}
    monkeypatch.setattr(jio, "VideoReader", FakeReader)
    monkeypatch.setattr(tpbs, "VideoReader", FakeReader)
    monkeypatch.setattr(tpbs, "VideoWriter", FakeWriter)
    assert jpbs.hstack_pair("l", "r", str(tmp_path / "j.mp4")) == 3
    assert tpbs.hstack_pair("l", "r", str(tmp_path / "t.mp4"), device="cpu") == 3
    jf, tf = injected[str(tmp_path / "j.mp4")], injected[str(tmp_path / "t.mp4")]
    if right_hw == (144, 256):  # no resize: every byte, labels included
        assert all(np.array_equal(a, b) for a, b in zip(tf, jf)) and len(tf) == len(jf)
    else:  # the right half bilinear-resized (tests/test_resize.py's tolerance)
        frames_close(tf, jf, dict(max=2, over2=0.0, mean=1.0))
        assert all(np.array_equal(a[:, :256], b[:, :256]) for a, b in zip(tf, jf))


def _hide_cv2(monkeypatch):
    """The card's machine: no cv2, no ffmpeg."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(tio, "FFMPEG", None)


def test_metadata_keys_and_y4m_naming(data_dir, rifes, monkeypatch, tmp_path):
    """The reference's main and the port's write the same metadata keys;
    without cv2 and ffmpeg the port writes .y4m videos, names them in the
    metadata, and prepare_blind_study pairs them into .y4m pairs."""
    jr, tr = rifes
    monkeypatch.setattr(jregistry, "get_model", lambda name, load=False, **kw: jr)
    monkeypatch.setattr(tbp, "get_model", lambda name, load=False, **kw: tr)
    common = ["--clip", CLIP, "--data-dir", str(data_dir), "--resolution", f"{OUT_W}x{OUT_H}",
              "--methods", "control,lanczos,rife_lanczos"]
    monkeypatch.setattr(sys, "argv", ["benchmark_proper", *common, "--output-dir",
                                      str(tmp_path / "j")])
    jbp.main()
    _hide_cv2(monkeypatch)
    assert tio.writable_suffix() == ".y4m"
    assert tbp.main([*common, "--output-dir", str(tmp_path / "t"), "--device", "cpu",
                     "--source-video", str(tmp_path / "raw.mp4")]) == 0
    jm = json.loads((tmp_path / "j" / "clips_metadata.json").read_text())["clips"][CLIP]
    tm = json.loads((tmp_path / "t" / "clips_metadata.json").read_text())["clips"][CLIP]
    assert set(tm) == set(jm) and set(tm["videos"]) == set(jm["videos"])
    for method, path in tm["videos"].items():
        assert path == str(tmp_path / "t" / f"{method}.y4m") and Path(path).is_file()
        assert set(tm["metrics"][method]) == set(jm["metrics"][method]) | {"audio"}
        assert tm["metrics"][method]["audio"] is False  # no ffmpeg: the audio is skipped
        assert tio.probe_video(path).frame_count == 9
    assert tpbs.main(["--benchmark-dir", str(tmp_path / "t"), "--output-dir",
                      str(tmp_path / "s"), "--seed", "3", "--device", "cpu"]) == 0
    key = json.loads((tmp_path / "s" / "answer_key.json").read_text())
    assert sorted(key) == ["pair_00.y4m", "pair_01.y4m"]
    assert {key[p]["A"] if key[p]["B"] == "control" else key[p]["B"] for p in key} == \
        {"lanczos", "rife_lanczos"}
    with tio.VideoReader(str(tmp_path / "s" / "pair_00.y4m")) as r:
        assert r.frame_count == key["pair_00.y4m"]["frames"] == 9 and r.header.width == 2 * OUT_W


def test_benchmark_all_failure_propagates(data_dir, monkeypatch, tmp_path, capsys):
    """The reference prints a failing method and exits 0 (ROADMAP §3); the
    port raises, naming it, after recording the methods before it."""
    def broken(name, load=False, **kw):
        raise RuntimeError("no checkpoint")

    monkeypatch.setattr(jregistry, "get_model", broken)
    monkeypatch.setattr(tbp, "get_model", broken)
    common = ["--clip", CLIP, "--data-dir", str(data_dir), "--resolution", f"{OUT_W}x{OUT_H}",
              "--methods", "lanczos,rife_lanczos"]
    monkeypatch.setattr(sys, "argv", ["benchmark_all", *common, "--output-dir",
                                      str(tmp_path / "j")])
    jba.main()
    assert "[rife_lanczos] FAILED: no checkpoint" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="method 'rife_lanczos' failed: no checkpoint"):
        tba.main([*common, "--output-dir", str(tmp_path / "t"), "--device", "cpu"])
    meta = json.loads((tmp_path / "t" / "clips_metadata.json").read_text())
    assert list(meta["clips"][CLIP]["videos"]) == ["lanczos"]


def test_generate_clips_workers_write_what_the_serial_run_writes(data_dir, monkeypatch,
                                                                 tmp_path):
    monkeypatch.setitem(tgc.PRESETS, "small", {"methods": ["control", "degraded", "bicubic"],
                                               "resolution": (OUT_W, OUT_H)})
    common = ["--preset", "small", "--clip", CLIP, "--data-dir", str(data_dir), "--device",
              "cpu"]
    assert tgc.main([*common, "--output-dir", str(tmp_path / "serial")]) == 0
    assert tgc.main([*common, "--output-dir", str(tmp_path / "pool"), "--workers", "2"]) == 0
    suffix = tio.writable_suffix()
    for method in ("control", "degraded", "bicubic"):
        a = tmp_path / "serial" / f"{method}{suffix}"
        b = tmp_path / "pool" / f"{method}{suffix}"
        with tio.VideoReader(str(a)) as ra, tio.VideoReader(str(b)) as rb:
            fa, fb = list(ra), list(rb)
        assert len(fa) == 9 and all(np.array_equal(x, y) for x, y in zip(fa, fb))


def test_clip_helpers_on_y4m(tmp_path):
    src = tmp_path / "full.y4m"
    with tio.VideoWriter(str(src), 16, 8, 10) as w:
        for i in range(20):
            w.write(np.full((8, 16, 3), i * 10, np.uint8))
    assert tbp.get_full_video_duration(src) == 2.0
    assert tbp.extract_clip(src, None, 0.5, 1.0, tmp_path / "cut.y4m") is True
    assert tbp.get_full_video_duration(tmp_path / "cut.y4m") == 1.0
