"""vfisr_tpu_torch/harness/experiments.py held against
vfisr_tpu/harness/experiments.py: the tables, the per-frame loop, the
results store, the shutdown handler, the legacy-mode reference extraction,
the sweep and its CLI.

``run_experiment`` runs its resizes, gray conversions and metrics on the
device where the reference calls cv2, so it is held to the reference's own
tolerance for its per-frame loop against its batched path
(tests/test_device_sweep.py): 0.35 dB and 0.01 SSIM, counts equal. Frames:
``_torch_port.sweep_interval`` (numpy, seeded), outputs at
192x108 with the degradation target shrunk to 128x72 in both packages.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import vfisr_tpu.harness.experiments as jex
import vfisr_tpu_torch.harness.device_sweep as tds
import vfisr_tpu_torch.harness.experiments as tex
from _torch_port import narrow_rife, one_torch_thread, sweep_interval
from vfisr_tpu_torch.data.png import write_png
from vfisr_tpu_torch.data.video_io import VideoWriter

ROOT = Path(__file__).resolve().parents[1]
OUT = (192, 108)  # outputs (w, h)


@pytest.fixture
def small_degrade(monkeypatch):
    for mod in (jex, tex, tds):
        monkeypatch.setattr(mod, "INPUT_W", 128)
        monkeypatch.setattr(mod, "INPUT_H", 72)


def _exp(name, **over):
    e = next(x for x in jex.EXPERIMENTS if x["name"] == name).copy()
    e.update(quality_resolution=OUT, quality_fps=60, **over)
    return e


def write_interval(data_dir: Path, clip_id: str, kfs, mids, idx: int = 0) -> Path:
    d = data_dir / "clips" / clip_id / "intervals" / f"interval_{idx:04d}"
    for sub, frames, stem in (("keyframes", kfs, "kf"), ("midpoints", mids, "gt")):
        (d / sub).mkdir(parents=True, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(d / sub / f"{stem}_{i:04d}.png", f)
    (d / "meta.json").write_text(json.dumps({"interval_id": d.name, "clip_id": clip_id,
                                             "difficulty": "EASY",
                                             "keyframe_count": len(kfs)}))
    return d


def test_tables_match():
    for name in ("LIGHT_EXPERIMENTS", "HEAVY_EXPERIMENTS", "EXPERIMENTS", "CORE_LIGHT",
                 "CORE_HEAVY", "QUALITY_LEVELS"):
        assert getattr(tex, name) == getattr(jex, name), name
    assert (tex.INPUT_W, tex.INPUT_H, tex.DEFAULT_QUALITY, tex.DURATION) == (
        jex.INPUT_W, jex.INPUT_H, jex.DEFAULT_QUALITY, jex.DURATION)
    for base, levels in ((tex.LIGHT_EXPERIMENTS[:2], None), (tex.CORE_HEAVY, ["low"])):
        assert (tex.generate_quality_experiments(base, levels)
                == jex.generate_quality_experiments(base, levels))
    for s in (0.125, 0.25, 0.5, 1.0, 2.0):
        assert tex._rife_native_scale(s) == jex._rife_native_scale(s)
    for m in (0.0, 0.5, 1.5, 2.5, 4.0):
        for qa in (False, True):
            assert tex.route_neural_expert(m, qa) == jex.route_neural_expert(m, qa)


@pytest.mark.parametrize("name", ["control", "degraded", "lanczos_blend_edge",
                                  "optical_flow_basic"])
def test_run_experiment_matches_reference_loop(small_degrade, name):
    kfs, mids = sweep_interval(pans=(0, 3, 8))
    exp = _exp(name)
    out = tex.run_experiment(kfs, mids, exp, verbose=False, device="cpu")
    ref = jex.run_experiment(kfs, mids, exp, verbose=False)
    assert set(out) == set(ref)
    for key in ("frames", "keyframes_evaluated", "vfi_frames_evaluated", "rife_frames_pct",
                "used_rife", "target_resolution", "vfi_method", "quality_level"):
        assert out[key] == ref[key], key
    for key in ("keyframe_psnr_db", "vfi_psnr_db", "overall_psnr_db"):
        if isinstance(ref[key], str) or ref[key] == 0:
            assert out[key] == ref[key], key
        else:
            assert out[key] == pytest.approx(ref[key], abs=0.35), key
    for key in ("keyframe_ssim", "vfi_ssim"):
        assert out[key] == pytest.approx(ref[key], abs=0.01), key


def test_run_experiment_adaptive_and_video(small_degrade, monkeypatch, tmp_path):
    """The per-frame loop's adaptive route per pair (a narrow RIFE injected)
    against the port's batched path on the same interval, and the Y4M the
    per-frame loop writes."""
    _, tr = narrow_rife(3)
    monkeypatch.setattr(tex._RIFESingleton, "_instance", tr)
    kfs, mids = sweep_interval(pans=(0, 3, 16))
    exp = _exp("adaptive_default", motion_thresh=1.0)
    video = tmp_path / "a.y4m"
    out = tex.run_experiment(kfs, mids, exp, output_path=str(video), verbose=False, device="cpu")
    ref = tds.run_experiment_batched(tds.DeviceInterval(kfs, mids, device="cpu"), exp)
    assert out["rife_frames_pct"] == ref["rife_frames_pct"] and 0 < out["rife_frames_pct"] < 100
    assert out["frames"] == ref["frames"] == 13
    assert out["vfi_psnr_db"] == pytest.approx(ref["vfi_psnr_db"], abs=0.35)
    from vfisr_tpu_torch.data.video_io import VideoReader

    with VideoReader(str(video)) as r:
        frames = list(r)
    assert len(frames) == 13 and frames[0].shape == (108, 192, 3)


def test_checkpoint_resume_and_legacy_keys(tmp_path):
    path = tmp_path / "experiment_results.json"
    ck = tex.ExperimentCheckpoint(path)
    ck.append({"name": "a", "interval_idx": 0, "clip_id": "clip_x"})
    ck.append({"name": "b", "interval_idx": 1})  # a legacy row, no clip
    ck2, jck = tex.ExperimentCheckpoint(path), jex.ExperimentCheckpoint(path)
    assert ck2.completed_keys() == jck.completed_keys() == {
        ("clip_x", "a", 0), (tex.LEGACY_CLIP_ID, "b", 1)}
    assert len(json.loads(path.read_text())["experiments"]) == 2
    assert not path.with_suffix(".tmp").exists()


def test_drop_rows_matches():
    rows = [
        {"name": "optical_flow_basic", "interval_idx": 0},
        {"name": "optical_flow_basic", "interval_idx": 1, "clip_id": "c2"},
        {"name": "uafi_default", "interval_idx": 0, "clip_id": "synth_001"},
        {"name": "rife_default", "interval_idx": 0, "clip_id": "c2"},
        {"name": "control"},
    ]
    for names, intervals, clip in ((["optical_flow_basic", "uafi_default"], [0], None),
                                   (["optical_flow_basic"], [0, 1], "c2"),
                                   (["uafi_default", "control"], [0], "synth_001")):
        assert tex.drop_rows(rows, names, intervals, clip) == jex.drop_rows(rows, names,
                                                                            intervals, clip)
    assert len(rows) == 5


def test_summarize_matches():
    data = {"experiments": [
        {"name": "a", "vfi_psnr_db": 30.0, "vfi_ssim": 0.9, "keyframe_psnr_db": 33.0, "time_s": 1.0},
        {"name": "a", "vfi_psnr_db": 32.0, "vfi_ssim": 0.8, "keyframe_psnr_db": "inf", "time_s": 3.0},
        {"name": "b", "vfi_psnr_db": "inf", "vfi_ssim": 1.0, "keyframe_psnr_db": 40.0, "time_s": 2.0},
        {"name": "c", "vfi_psnr_db": 35.5, "vfi_ssim": 0.95, "keyframe_psnr_db": 36.0, "time_s": 0.5}]}
    text = tex.summarize(data)
    assert text == jex.summarize(data)
    assert text.splitlines()[2].startswith("c ")


def test_graceful_shutdown_restores_handlers():
    before = signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGTERM)
    sd = tex.GracefulShutdown()
    sd.install()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert sd.requested
        with pytest.raises(SystemExit) as exc:
            os.kill(os.getpid(), signal.SIGTERM)
        assert exc.value.code == 130
    finally:
        sd.restore()
    assert (signal.getsignal(signal.SIGINT), signal.getsignal(signal.SIGTERM)) == before


def test_generate_reference_on_y4m(tmp_path):
    """A 4:3 Y4M, cropped to 16:9 and resized to 192x108. Against JAX's
    crop and resize on the frames the port's reader decodes: equal. Against
    the reference's generate_reference, which decodes with cv2 (its I420 to
    RGB rounds otherwise than ``VideoReader``'s, ~1 LSB darker or lighter
    throughout: 1.02 on average here): within 4 LSB, under 1.5 on average."""
    import jax.numpy as jnp

    from vfisr_tpu.core.resize import resize as jresize
    from vfisr_tpu.data.extract_intervals import crop16_9 as jcrop
    from vfisr_tpu_torch.data.video_io import VideoReader

    rng = np.random.default_rng(4)
    path = tmp_path / "raw.y4m"
    frames = [np.kron(rng.integers(0, 256, (12, 16, 3)), np.ones((10, 10, 1))).astype(np.uint8)
              for _ in range(7)]
    with VideoWriter(str(path), 160, 120, 30) as w:
        for f in frames:
            w.write(f)
    kfs, mids = tex.generate_reference(str(path), 0.0, duration=0.2, output_resolution=(192, 108),
                                       device="cpu")
    assert len(kfs) == len(mids) == 3
    with VideoReader(str(path)) as r:
        decoded = [r.read() for _ in range(6)]
    for got, f in zip([x for pair in zip(kfs, mids) for x in pair], decoded):
        want = np.asarray(jresize(jnp.asarray(jcrop(f)), (108, 192), "lanczos4"))
        assert got.shape == (108, 192, 3) and np.array_equal(got, want)
    jkfs, jmids = jex.generate_reference(str(path), 0.0, duration=0.2, output_resolution=(192, 108))
    assert len(jkfs) == len(jmids) == 3
    for a, b in zip(kfs + mids, jkfs + jmids):
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 4 and d.mean() < 1.5
    kfs2, mids2 = tex.generate_reference(str(path), 0.1, duration=0.2,
                                         output_resolution=(192, 108), extract_midpoints=False,
                                         device="cpu")
    # frames 3-6 of 7: keyframes 3 and 5
    assert len(kfs2) == 2 and mids2 == [] and np.array_equal(kfs2[0], mids[1])


def test_sweep_resume_replace_and_no_host_fallback(small_degrade, tmp_path, monkeypatch):
    """The sweep reads the interval's PNGs, writes its store and log, skips
    done rows on resume, re-runs exactly the selected rows on replace; a
    failing device path is that experiment's FAILED line, and the per-frame
    loop is never run in its place (the reference falls back to it,
    experiments.py:727-736)."""
    kfs, mids = sweep_interval(pans=(0, 3, 8))
    write_interval(tmp_path / "data", "clip_a", kfs, mids)
    exps = [_exp("lanczos_blend"), _exp("degraded")]
    kw = dict(data_dir=tmp_path / "data", output_dir=tmp_path / "out", use_lpips=False,
              device="cpu")
    res = tex.run_experiment_sweep("clip_a", [0], exps, **kw)
    rows = res["experiments"]
    assert [r["name"] for r in rows] == ["lanczos_blend", "degraded"]
    assert all(r["clip_id"] == "clip_a" and r["interval_difficulty"] == "EASY"
               and r["device_batched"] and r["frames"] == 13 for r in rows)
    res = tex.run_experiment_sweep("clip_a", [0], exps, resume=True, **kw)
    assert len(res["experiments"]) == 2
    res = tex.run_experiment_sweep("clip_a", [0], exps[:1], replace=True, **kw)
    assert [r["name"] for r in res["experiments"]] == ["degraded", "lanczos_blend"]

    host_calls = []
    monkeypatch.setattr(tex, "run_experiment", lambda *a, **k: host_calls.append(a))

    def failing(*a, **k):
        raise RuntimeError("device path failed")

    monkeypatch.setattr(tds, "run_experiment_batched", failing)
    res = tex.run_experiment_sweep("clip_a", [0], exps, **kw)
    assert res["experiments"] == [] and host_calls == []
    log = (tmp_path / "out" / "experiment_log.txt").read_text()
    assert log.count("FAILED: device path failed") == 2


def test_run_experiments_cli_on_cpu(tmp_path, monkeypatch):
    """``python -m vfisr_tpu_torch.run_experiments --device cpu``: legacy
    mode on a Y4M in a subprocess, at the default quality (2560x1440); then
    cached mode through its ``main`` in this process, the quality level
    shrunk to 192x108, with a video."""
    raw = tmp_path / "raw.y4m"
    with VideoWriter(str(raw), 192, 108, 30) as w:
        for f in sweep_interval(pans=(2, 2))[0]:
            w.write(np.ascontiguousarray(f[:108, :192]))
    cmd = [sys.executable, "-m", "vfisr_tpu_torch.run_experiments", "--raw", str(raw),
           "--experiment", "degraded", "--max-frames", "2", "--output-dir",
           str(tmp_path / "raw_out"), "--device", "cpu", "--no-lpips"]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    rows = json.loads((tmp_path / "raw_out" / "experiment_results.json").read_text())["experiments"]
    assert rows[0]["clip_id"] == "raw_raw" and rows[0]["source"] == str(raw)
    assert rows[0]["target_resolution"] == "2560x1440" and rows[0]["frames"] == 5
    assert "degraded" in res.stdout

    from vfisr_tpu_torch.run_experiments import main

    monkeypatch.setitem(tex.QUALITY_LEVELS["medium"], "resolution", OUT)
    kfs, mids = sweep_interval(pans=(4, 4))
    write_interval(tmp_path / "data", "clip_b", kfs, mids)
    main(["--clip", "clip_b", "--experiment", "lanczos_blend", "--data-dir",
          str(tmp_path / "data"), "--output-dir", str(tmp_path / "out"), "--device", "cpu",
          "--write-videos"])
    rows = json.loads((tmp_path / "out" / "experiment_results.json").read_text())["experiments"]
    assert len(rows) == 1 and rows[0]["target_resolution"] == "192x108"
    assert rows[0]["frames"] == 9 and rows[0]["output_video"].endswith("lanczos_blend_i0.y4m")
    assert (tmp_path / "out" / "videos" / "lanczos_blend_i0.y4m").is_file()
