"""vfisr_tpu_torch/data/{registry,extract_intervals,preprocess_video}.py held
against vfisr_tpu/data/, and the dataset pipeline's CLIs.

One source clip for both packages: 40 frames at 1920x1080, 120 fps, written
by cv2 as mp4v (the container the reference reads), of a smooth seeded
texture panning 0, 6 and 12 px per frame over the three intervals that
``extract_intervals(count=3, duration=0.1)`` places (source frames [0,12),
[13,26) and [27,40): ``int(start_s * fps)`` floors 13.999... to 13). Both
packages decode it with cv2, so their source frames are identical; the
intervals are cut at 320x180 and the triplets made at 320x180 / 30 fps in
and 640x360 / 120 fps out, with ``device="cpu"`` in the port.

Tolerances: PNGs within 2 LSB on >= 99.5% of pixels with mean < 1 (cv2's
fixed-point Lanczos4 against the port's f32 taps, tests/test_resize.py).
Motion statistics: the reference's ``compute_motion_stats`` on the port's
own keyframes equals the port's within rel 2e-3 or 1e-4 px
(tests/test_torch_png.py: cv2's fixed-point bilinear resize of the gray
frames). Across the two pipelines, whose keyframes differ by those 2 LSB,
each pair's mean and median flow agree within rel 2e-3 or 1e-3 px, the
interval's variance of pair means within 1e-5 px^2 (means within 1e-3 px
around a spread of ~6e-3 px), and max_flow and std_flow, the flow field's
tail, are held only on the same keyframes: an outlier at the HUD box's
corner moves the static interval's max by up to 21%. Every other field
equal, except the timestamps, the source path and the probe's codec. The
one intended difference is the index kept across a second
``extract_intervals`` call, which has its own test.
"""

import contextlib
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from vfisr_tpu.data.extract_intervals import IntervalExtractor as JExtractor
from vfisr_tpu.data.preprocess_video import VideoPreprocessor as JPreprocessor
from vfisr_tpu.data.registry import ClipRegistry as JRegistry
from vfisr_tpu_torch.data import extract_intervals as text
from vfisr_tpu_torch.data.extract_intervals import IntervalExtractor as TExtractor
from vfisr_tpu_torch.data.png import read_png, write_png
from vfisr_tpu_torch.data.preprocess_video import VideoPreprocessor as TPreprocessor
from vfisr_tpu_torch.data.preprocess_video import load_clip_data
from vfisr_tpu_torch.data.registry import ClipRegistry as TRegistry
from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter

ROOT = Path(__file__).resolve().parents[1]
FRAMES, FPS = 40, 120
PANS = (0, 6, 12)  # px per source frame in each interval
OUT = (320, 180)
PRE = dict(input_resolution=(320, 180), input_fps=30, target_resolution=(640, 360),
           target_fps=120)
REL = 2e-3
SKIP_KEYS = {"source_path", "registered_at", "codec", "extracted", "last_processed",
             "processed_at"}


def _positions(n_frames: int, fps: float, pans) -> list:
    """Each source frame's pan offset: frames from an interval's start on
    move by its pan (the starts from the port's placement code)."""
    _, starts = text.interval_starts(n_frames / fps, len(pans), 0.1)
    first = [text.interval_frames(s, 0.1, fps, n_frames)[0] for s in starts]
    x, xs = 0, []
    for f in range(n_frames):
        xs.append(x)
        x += pans[sum(f >= s for s in first) - 1]
    return xs


def _texture(seed: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tex = cv2.resize(rng.integers(0, 256, (34, w // 30, 3), np.uint8), (w, 1080),
                     interpolation=cv2.INTER_CUBIC)
    return tex


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file: its many small CPU ops (Farneback,
    Lanczos4, LPIPS at 320x180) wait at OpenMP barriers for threads that
    the suite's other workers keep off the cores (seconds alone, minutes
    under the suite's -n 6 on 8 cores)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dataset")
    path = root / "clip.mp4"
    xs = _positions(FRAMES, FPS, PANS)
    tex = _texture(0, 1920 + xs[-1] + 1)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (1920, 1080))
    for x in xs:
        frame = tex[:, x:x + 1920].copy()
        frame[:180, :384] = (40, 230, 230)  # a static HUD box
        w.write(frame)
    w.release()
    return root, path


@pytest.fixture(scope="module")
def both(clip):
    """The whole pipeline in both packages: register, 3 intervals, triplets."""
    root, path = clip
    out = {}
    for name, reg, ext, pre in (
            ("jax", JRegistry, lambda d: JExtractor(d),
             lambda d: JPreprocessor(output_dir=d, **PRE)),
            ("torch", TRegistry, lambda d: TExtractor(d, device="cpu"),
             lambda d: TPreprocessor(output_dir=d, device="cpu", **PRE))):
        data = root / name / "data"
        entry = reg(data).register(path, "clip")
        metas = ext(data).extract_intervals("clip", count=3, duration=0.1,
                                            output_resolution=OUT, verbose=False)
        processed = pre(root / name / "processed").process(str(path), clip_name="clip")
        out[name] = dict(data=data, entry=entry, metas=metas, processed=processed,
                         proc_dir=root / name / "processed" / "clip")
    return out


def _strip(d):
    if isinstance(d, dict):
        return {k: _strip(v) for k, v in d.items() if k not in SKIP_KEYS}
    if isinstance(d, list):
        return [_strip(v) for v in d]
    return d


# (rel, abs) per motion field across the two pipelines; None: a float,
# compared only on the same keyframes (test_motion_stats_on_the_same_keyframes)
FIELD_TOL = {"mean_flow": (REL, 1e-3), "median_flow": (REL, 1e-3), "variance": (0, 1e-5),
             "max_flow": None, "std_flow": None}


def _assert_close(got, ref, path=""):
    """Equal structure and values; the motion fields within FIELD_TOL."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and got.keys() == ref.keys(), path
        for k in ref:
            _assert_close(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            _assert_close(a, b, f"{path}[{i}]")
    elif path.rsplit(".", 1)[-1] in FIELD_TOL:
        tol = FIELD_TOL[path.rsplit(".", 1)[-1]]
        assert isinstance(got, float) and np.isfinite(got), path
        if tol is not None:
            assert got == pytest.approx(ref, rel=tol[0], abs=tol[1]), path
    else:
        assert got == ref, path


def _assert_pngs_close(got_dir: Path, ref_dir: Path):
    names = sorted(p.name for p in ref_dir.glob("*.png"))
    assert names and sorted(p.name for p in got_dir.glob("*.png")) == names
    for name in names:
        a = read_png(got_dir / name).astype(int)
        b = read_png(ref_dir / name).astype(int)
        assert a.shape == b.shape, name
        d = np.abs(a - b)
        assert (d <= 2).mean() >= 0.995 and d.mean() < 1.0, (name, d.max(), d.mean())


@pytest.mark.parametrize("dur_s,count,d,start,auto", [
    (40 / 120, 3, 0.1, None, False), (36 / 120, 3, 0.1, None, False), (10.0, 1, 4.0, None, False),
    (10.0, 5, 2.0, None, True), (10.0, 3, 2.0, 9.0, False), (1.0, 4, 2.0, None, False)])
def test_placement_matches(tmp_path, dur_s, count, d, start, auto):
    """interval_starts gives the starts the reference's extract_intervals
    extracts (its float bound s + duration <= duration_s included)."""
    JRegistry(tmp_path).save({"clips": [{"clip_id": "c", "duration_s": dur_s,
                                         "source_path": "x"}]})
    (tmp_path / "clips" / "c").mkdir(parents=True)
    ex, seen = JExtractor(tmp_path), []
    ex.extract_single_interval = lambda vp, cid, iid, s, du, *a: seen.append(s) or {
        "interval_id": iid, "difficulty": "STATIC", "motion_stats": {}, "start_s": s,
        "end_s": s + du}
    ex.extract_intervals("c", count, d, start, auto, verbose=False)
    assert text.interval_starts(dur_s, count, d, start, auto)[1] == seen


def test_interval_frames_floor():
    """int(start_s * fps) floors 13.999... to 13 (40 frames at 120 fps, 3
    intervals of 0.1 s), and the end is capped by the frame count."""
    _, starts = text.interval_starts(40 / 120, 3, 0.1)
    assert [text.interval_frames(s, 0.1, 120.0, 40) for s in starts] == [(0, 12), (13, 26),
                                                                          (27, 40)]
    assert text.interval_frames(1.0, 0.5, 60000 / 1001, 80) == (59, 80)


def test_registry_matches(both):
    j, t = both["jax"], both["torch"]
    assert _strip(t["entry"]) == _strip(j["entry"])
    assert t["entry"]["fps"] == 120.0 and t["entry"]["frame_count"] == FRAMES
    assert _strip(TRegistry(t["data"]).list_clips()) == _strip(JRegistry(j["data"]).list_clips())
    with pytest.raises(ValueError, match="already registered"):
        TRegistry(t["data"]).register(t["entry"]["source_path"], "clip")


def test_intervals_match(both):
    j, t = both["jax"], both["torch"]
    assert [(m["start_frame"], m["end_frame"], m["keyframe_count"], m["midpoint_count"])
            for m in t["metas"]] == [(0, 12, 6, 6), (13, 26, 7, 6), (27, 40, 7, 6)]
    assert [m["difficulty"] for m in t["metas"]] == ["STATIC", "EASY", "EASY"]
    _assert_close(_strip(t["metas"]), _strip(j["metas"]))
    for m in t["metas"]:
        rel = Path("clips") / "clip" / "intervals" / m["interval_id"]
        ti, ji = t["data"] / rel, j["data"] / rel
        for sub in ("keyframes", "midpoints"):
            _assert_pngs_close(ti / sub, ji / sub)
        for name in ("complexity.json", "flow_stats.json"):
            _assert_close(json.loads((ti / "motion" / name).read_text()),
                          json.loads((ji / "motion" / name).read_text()))
        _assert_close(_strip(json.loads((ti / "meta.json").read_text())),
                      _strip(json.loads((ji / "meta.json").read_text())))
    for name in ("difficulty_index.json", "clip_meta.json"):
        _assert_close(_strip(json.loads((t["data"] / "clips" / "clip" / name).read_text())),
                      _strip(json.loads((j["data"] / "clips" / "clip" / name).read_text())))
    kfs, mids, meta = text.load_interval("clip", 1, t["data"])
    assert len(kfs) == 7 and len(mids) == 6 and kfs[0].shape == (180, 320, 3)


def test_motion_stats_on_the_same_keyframes(both):
    """The reference's compute_motion_stats on the port's own keyframes (as
    BGR) equals each pair of the port's complexity.json, every field."""
    from vfisr_tpu.data.extract_intervals import compute_motion_stats as jstats

    t = both["torch"]
    for i in range(3):
        idir = t["data"] / "clips" / "clip" / "intervals" / f"interval_{i:04d}"
        kfs, _, _ = text.load_interval("clip", i, t["data"])
        pairs = json.loads((idir / "motion" / "complexity.json").read_text())
        assert [p["pair_idx"] for p in pairs] == list(range(len(kfs) - 1))
        for p, a, b in zip(pairs, kfs, kfs[1:]):
            ref = jstats(np.ascontiguousarray(a[..., ::-1]), np.ascontiguousarray(b[..., ::-1]))
            for k, v in ref.items():
                assert p[k] == pytest.approx(v, rel=REL, abs=1e-4), (i, p["pair_idx"], k)


def test_preprocess_matches(both):
    j, t = both["jax"], both["torch"]
    assert t["processed"]["triplets"] == j["processed"]["triplets"] == 9
    md_t, tr_t = load_clip_data(t["proc_dir"])
    md_j = json.loads((j["proc_dir"] / "metadata.json").read_text())
    tr_j = json.loads((j["proc_dir"] / "triplets.json").read_text())
    assert tr_t == tr_j
    assert tr_t[0]["temporal_positions"] == [0.25, 0.5, 0.75]
    assert _strip(md_t) == _strip(md_j)
    assert (md_t["num_input_frames"], md_t["num_gt_frames"]) == (10, 40)
    for sub in ("input_1080p30", "ground_truth"):
        _assert_pngs_close(t["proc_dir"] / sub / "frames", j["proc_dir"] / sub / "frames")


def test_second_call_keeps_the_index(both, tmp_path):
    """A second extract_intervals call: the reference's clip_meta.json and
    difficulty_index.json list only that call's interval, while its
    intervals_count counts all four; the port's keep all four. Everything
    else of the call equals the reference's."""
    got = {}
    for name, ext in (("jax", lambda d: JExtractor(d)),
                      ("torch", lambda d: TExtractor(d, device="cpu"))):
        data = tmp_path / name
        shutil.copytree(both[name]["data"], data)
        meta = ext(data).extract_intervals("clip", start=0.0, duration=0.05,
                                          output_resolution=OUT, verbose=False)
        clip_dir = data / "clips" / "clip"
        got[name] = (meta, json.loads((clip_dir / "clip_meta.json").read_text()),
                     json.loads((clip_dir / "difficulty_index.json").read_text()),
                     json.loads((data / "clips_registry.json").read_text()))
    (jm, jc, jd, jr), (tm, tc, td, tr) = got["jax"], got["torch"]
    _assert_close(_strip(tm), _strip(jm))
    assert tm[0]["interval_id"] == "interval_0003"
    assert jc["intervals"] == ["interval_0003"] and list(jd) == ["interval_0003"]
    ids = [f"interval_{i:04d}" for i in range(4)]
    assert tc["intervals"] == ids and list(td) == ids
    assert tc["intervals_count"] == jc["intervals_count"] == 4
    _assert_close(td["interval_0003"], jd["interval_0003"])
    _assert_close(_strip(tr), _strip(jr))


@pytest.fixture(scope="module")
def y4m_clip(tmp_path_factory):
    """A 1080-high Y4M (the container the card's machine reads): 16 frames at
    120 fps panning 8 px per frame, written by the port."""
    root = tmp_path_factory.mktemp("torch_y4m")
    path = root / "src" / "game.y4m"
    tex = _texture(1, 1920 + 8 * 16)[..., ::-1]
    with VideoWriter(str(path), 1920, 1080, 120) as w:
        for i in range(16):
            w.write(np.ascontiguousarray(tex[:, 8 * i:8 * i + 1920]))
    return root, path


def test_y4m_extraction(y4m_clip):
    """The port alone on a Y4M: the frames it decodes on the device equal
    its host decode bit for bit (cv2's own Y4M decode differs from both by
    up to 3 LSB, so the reference is not held to these PNGs), and each PNG
    and pair statistic equals crop, Lanczos4 and compute_motion_stats of
    those frames."""
    root, path = y4m_clip
    data = root / "data"
    entry = TRegistry(data).register(path, "g")
    assert (entry["codec"], entry["fps"], entry["frame_count"]) == ("y4m C420jpeg", 120.0, 16)
    (meta,) = TExtractor(data, device="cpu").extract_intervals("g", start=0.0, duration=0.1,
                                                                output_resolution=OUT,
                                                                verbose=False)
    assert (meta["start_frame"], meta["end_frame"], meta["keyframe_count"]) == (0, 12, 6)
    with VideoReader(str(path)) as r:
        host = [r.read() for _ in range(12)]
    with VideoReader(str(path)) as r:
        assert all(np.array_equal(r.read_to("cpu").numpy(), f) for f in host[:3])
    import torch

    fitted = [text.fit_frame(torch.from_numpy(f), OUT).numpy() for f in host]
    kfs, mids, _ = text.load_interval("g", 0, data)
    assert all(np.array_equal(a, b) for a, b in zip(kfs + mids, fitted[0::2] + fitted[1::2]))
    comp = json.loads((data / "clips" / "g" / "intervals" / "interval_0000" / "motion"
                       / "complexity.json").read_text())
    ref = text.compute_motion_stats(kfs[0][..., ::-1], kfs[1][..., ::-1], device="cpu")
    assert comp[0] == {"pair_idx": 0, **ref}
    assert meta["difficulty"] == text.classify_difficulty(meta["motion_stats"]["mean_flow"])


def _main(module, argv):
    """Run a CLI's main in this process: (exit code, stdout)."""
    import importlib

    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            importlib.import_module(f"vfisr_tpu_torch.{module}").main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return code, buf.getvalue()


def test_pipeline_clis(y4m_clip, tmp_path, monkeypatch):
    """register_clip, extract_intervals, list_intervals (as a subprocess),
    validate_intervals (0 on the cached frames, 1 after one pixel changes),
    preprocess_video, batch_preprocess (.y4m taken, a failing video listed)
    and run_full_benchmark's commands, on the CPU."""
    _, src = y4m_clip
    data = tmp_path / "data"
    assert _main("register_clip", [str(src), "--clip-id", "g", "--data-dir", str(data)])[0] == 0
    code, out = _main("extract_intervals", ["--clip-id", "g", "--count", "2", "--duration",
                                            "0.05", "--resolution", "320x180", "--data-dir",
                                            str(data), "--device", "cpu"])
    assert code == 0 and "interval_0001: 3 kf / 3 gt" in out
    res = subprocess.run([sys.executable, "-m", "vfisr_tpu_torch.list_intervals", "--data-dir",
                          str(data)], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "g: 1920x1080@120.0fps" in res.stdout, res.stderr
    assert "interval_0000: 0.0-0.1s, 3 kf / 3 gt" in res.stdout
    validate = ["--clip", "g", "--interval", "0,1", "--data-dir", str(data), "--device", "cpu"]
    code, out = _main("validate_intervals", validate)
    assert code == 0 and out.count("OK") == 6 and "VALID" in out
    kf = data / "clips" / "g" / "intervals" / "interval_0001" / "keyframes" / "kf_0002.png"
    img = read_png(kf)
    img[5, 7, 1] ^= 1
    write_png(kf, img)
    code, out = _main("validate_intervals", validate)
    assert code == 1 and "kf_0002: MISMATCH max=1" in out and "1 mismatch(es)" in out

    pre = ["--input-resolution", "320x180", "--target-resolution", "640x360",
           "--device", "cpu"]
    code, out = _main("preprocess_video", [str(src), "--clip-name", "g", "--output-dir",
                                           str(tmp_path / "proc")] + pre)
    assert code == 0 and "4 input frames, 16 GT frames, 3 triplets" in out
    batch = tmp_path / "batch"
    batch.mkdir()
    shutil.copy(src, batch / "a.y4m")
    (batch / "notes.txt").write_text("not a video")
    with VideoWriter(str(batch / "b.y4m"), 64, 48, 120) as w:  # too small: fails validate
        w.write(np.zeros((48, 64, 3), np.uint8))
    code, out = _main("batch_preprocess", [str(batch), "--output-dir", str(tmp_path / "bout")]
                      + pre)
    summary = json.loads((tmp_path / "bout" / "batch_summary.json").read_text())
    assert code == 0 and "1 processed, 1 failed" in out
    assert [m["clip_name"] for m in summary["processed"]] == ["a"]
    assert summary["failed"][0]["video"].endswith("b.y4m")
    assert json.loads((tmp_path / "bout" / "a" / "triplets.json").read_text()) == \
        json.loads((tmp_path / "proc" / "g" / "triplets.json").read_text())

    calls = []
    monkeypatch.setattr(subprocess, "call", lambda cmd: calls.append(cmd) or 0)
    code, out = _main("run_full_benchmark", ["--data-dir", str(data), "--output-dir",
                                             str(tmp_path / "o"), "--max-frames", "3",
                                             "--device", "cpu", "--resume"])
    assert code == 0 and calls == [[sys.executable, "-m", "vfisr_tpu_torch.run_experiments",
                                    "--clip", "g", "--intervals", "0,1", "--data-dir", str(data),
                                    "--output-dir", str(tmp_path / "o"), "--device", "cpu",
                                    "--resume", "--max-frames", "3"]]
    monkeypatch.setattr(subprocess, "call", lambda cmd: 2)
    assert _main("run_full_benchmark", ["--data-dir", str(data)])[0] == 1


def test_evaluate_quality_cli(both, tmp_path):
    """The quality CLI on an interval's keyframes against its midpoints
    (PNG), its JSON equal to QualityEvaluator's numbers; a directory of JPEGs
    alone is read as the reference reads it (cv2's pixels), and a
    progressive JPEG raises UnsupportedJPEG."""
    from vfisr_tpu_torch.evaluation import QualityEvaluator

    idir = both["torch"]["data"] / "clips" / "clip" / "intervals" / "interval_0002"
    out = tmp_path / "q.json"
    code, text_out = _main("evaluate_quality", ["--pred-dir", str(idir / "keyframes"),
                                                "--gt-dir", str(idir / "midpoints"), "--output",
                                                str(out), "--comprehensive", "--device", "cpu"])
    got = json.loads(out.read_text())
    kfs, mids, _ = text.load_interval("clip", 2, both["torch"]["data"])
    res = QualityEvaluator("cpu").evaluate(kfs[:6], mids)
    assert code == 0 and got["frames"] == 6 and "comprehensive" in got
    assert (got["psnr"], got["ssim"], got["lpips"]) == (res.psnr, res.ssim, res.lpips)
    jpg = tmp_path / "jpg"
    jpg.mkdir()
    cv2.imwrite(str(jpg / "f_0000.jpg"), kfs[0])
    code, _ = _main("evaluate_quality", ["--pred-dir", str(jpg), "--gt-dir", str(idir / "midpoints"),
                                         "--device", "cpu"])
    assert code == 0
    import vfisr_tpu_torch.evaluate_quality as eq
    from vfisr_tpu_torch.data.jpeg import UnsupportedJPEG

    got = eq.load_dir(jpg)
    want = cv2.cvtColor(cv2.imread(str(jpg / "f_0000.jpg")), cv2.COLOR_BGR2RGB)
    assert len(got) == 1 and np.array_equal(got[0], want)
    prog = tmp_path / "prog"
    prog.mkdir()
    cv2.imwrite(str(prog / "f_0000.jpg"), kfs[0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(UnsupportedJPEG):
        eq.load_dir(prog)
