"""vfisr_tpu_torch/harness/triplet.py held against vfisr_tpu/harness/triplet.py.

A processed clip in the reference's layout, written with cv2 (the
reference's writer): 3 input frames at 72x128 of a numpy-made scene panning
4 px per frame under a HUD box, ground truth at the 1.3333x raster (96x170)
rendered at t = 0.25/0.5/0.75, 2 triplets. Both packages' ``run_benchmarks``
on the CPU, for lanczos and a narrow RIFE with the same seeded parameters.

Tolerances on the quality summaries: PSNR 0.05 dB, SSIM 1e-3 and LPIPS 1e-3
(the frames agree within 2 LSB, tests/test_torch_registry.py; the
metrics themselves to ~1e-6, tests/test_torch_metrics.py). The schema,
the counts and the models' info equal.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import vfisr_tpu.harness.triplet as jtr
import vfisr_tpu_torch.harness.triplet as ttr
from _torch_port import narrow_rife, one_torch_thread, smooth_frames
from vfisr_tpu.models.traditional.baselines import LanczosBaseline as JLanczos
from vfisr_tpu_torch.data.png import read_png
from vfisr_tpu_torch.models.traditional.baselines import LanczosBaseline as TLanczos

ROOT = Path(__file__).resolve().parents[1]
H, W, SCALE, PAN = 72, 128, 1.3333, 4


def _render(canvas, x, h, w):
    """The canvas window at offset x (float: bilinear), resized to (h, w),
    with a HUD box."""
    x0 = int(np.floor(x))
    f = x - x0
    win = canvas[:, x0:x0 + W] * (1 - f) + canvas[:, x0 + 1:x0 + 1 + W] * f
    img = cv2.resize(win.astype(np.float32), (w, h), interpolation=cv2.INTER_LANCZOS4)
    img = np.clip(np.floor(img * 255 + 0.5), 0, 255).astype(np.uint8)
    img[: h // 6, : w // 5] = (230, 230, 40)
    return img


def write_clip(root: Path, name: str = "clip_t", n_frames: int = 3) -> Path:
    clip = root / name
    inp, gt = clip / "input_1080p30" / "frames", clip / "ground_truth" / "frames"
    inp.mkdir(parents=True)
    gt.mkdir(parents=True)
    canvas = smooth_frames(np.random.default_rng(9), 1, H, W + PAN * n_frames + 2, cell=10)[0]
    gh, gw = int(H * SCALE), int(W * SCALE)
    triplets = []
    for i in range(n_frames):
        cv2.imwrite(str(inp / f"frame_{i:04d}.png"), _render(canvas, PAN * i, H, W)[..., ::-1])
    for i in range(n_frames - 1):
        names = []
        for k, t in enumerate((0.25, 0.5, 0.75)):
            names.append(f"gt_{i:04d}_{k}.png")
            cv2.imwrite(str(gt / names[-1]), _render(canvas, PAN * (i + t), gh, gw)[..., ::-1])
        triplets.append({"triplet_id": i, "input_frame_0": f"frame_{i:04d}.png",
                         "input_frame_1": f"frame_{i + 1:04d}.png", "gt_intermediate": names,
                         "num_intermediate": 3})
    (clip / "metadata.json").write_text(json.dumps({"spatial_scale": SCALE, "fps": 30}))
    (clip / "triplets.json").write_text(json.dumps(triplets))
    return clip


@pytest.fixture(scope="module")
def rifes():
    return narrow_rife(21)


def _registries(monkeypatch, rifes):
    jr, tr = rifes
    monkeypatch.setattr(jtr, "get_available_models",
                        lambda: {"lanczos": JLanczos, "rife": lambda: jr})
    monkeypatch.setattr(ttr, "get_available_models",
                        lambda: {"lanczos": TLanczos, "rife": lambda device: tr})


def test_run_benchmarks_matches(tmp_path, monkeypatch, rifes):
    write_clip(tmp_path / "data")
    _registries(monkeypatch, rifes)
    out = ttr.run_benchmarks(tmp_path / "data", tmp_path / "t", models="lanczos,rife", warmup=1,
                             save_outputs=True, device="cpu")
    ref = jtr.run_benchmarks(str(tmp_path / "data"), str(tmp_path / "j"), models="lanczos,rife",
                             warmup=1)
    assert out.keys() == ref.keys() and out["models"] == ref["models"] == ["lanczos", "rife"]
    assert out["lpips_mode"] == ref["lpips_mode"]
    assert json.loads((tmp_path / "t" / "benchmark_results.json").read_text())["results"].keys() \
        == {"clip_t"}
    for model in ("lanczos", "rife"):
        r, j = out["results"]["clip_t"][model], ref["results"]["clip_t"][model]
        assert "error" not in r and r.keys() == j.keys()
        assert r["num_triplets"] == j["num_triplets"] == 2 and r["model_info"] == j["model_info"]
        assert r["speed_summary"].keys() == j["speed_summary"].keys()
        assert r["speed_summary"]["throughput_fps"] > 0
        for metric, tol in (("psnr", 0.05), ("ssim", 1e-3), ("lpips", 1e-3)):
            a, b = r["quality_summary"][metric], j["quality_summary"][metric]
            assert a.keys() == b.keys()
            for stat in a:
                assert a[stat] == pytest.approx(b[stat], abs=tol), (model, metric, stat)
    saved = tmp_path / "t" / "model_outputs" / "clip_t" / "rife" / "triplet_0001"
    frames = sorted(saved.glob("frame_*.png"))
    assert len(frames) == 5
    assert np.array_equal(read_png(frames[2]), cv2.imread(str(frames[2]))[..., ::-1])


def test_failures_are_error_rows(tmp_path, monkeypatch, rifes):
    """An evaluator that raises: the port writes the (clip, model) error
    row, where the reference makes up PSNR/SSIM with LPIPS 0.1
    (triplet.py:103-112). A missing frame: an error row too."""
    write_clip(tmp_path / "data")
    _registries(monkeypatch, rifes)

    def failing(self, pred, gt):
        raise RuntimeError("evaluator failed")

    monkeypatch.setattr(ttr.QualityEvaluator, "evaluate", failing)
    out = ttr.run_benchmarks(tmp_path / "data", tmp_path / "t", models="lanczos", warmup=0,
                             device="cpu")
    assert out["results"]["clip_t"]["lanczos"] == {"error": "evaluator failed"}
    monkeypatch.setattr(jtr.QualityEvaluator, "evaluate", failing)
    ref = jtr.run_benchmarks(str(tmp_path / "data"), str(tmp_path / "j"), models="lanczos",
                             warmup=0)
    assert ref["results"]["clip_t"]["lanczos"]["quality_summary"]["lpips"]["mean"] == 0.1
    monkeypatch.undo()
    _registries(monkeypatch, rifes)
    (tmp_path / "data" / "clip_t" / "ground_truth" / "frames" / "gt_0001_1.png").unlink()
    out = ttr.run_benchmarks(tmp_path / "data", tmp_path / "t", models="lanczos", warmup=0,
                             device="cpu")
    assert "gt_0001_1.png" in out["results"]["clip_t"]["lanczos"]["error"]


def test_merge_leaves_prev_unchanged():
    prev = {"timestamp": "t0", "models": ["a", "b"], "lpips_mode": "x",
            "results": {"c1": {"a": {"v": 1}, "b": {"v": 2}}, "c2": {"a": {"v": 3}}}}
    fresh = {"timestamp": "t1", "models": ["b", "z"], "lpips_mode": "y",
             "results": {"c1": {"b": {"v": 9}}, "c3": {"z": {"v": 7}}}}
    before = copy.deepcopy(prev)
    out = ttr.merge_benchmark_outputs(prev, fresh)
    assert prev == before  # the reference mutates prev["results"]
    assert out == jtr.merge_benchmark_outputs(copy.deepcopy(prev), fresh)
    assert out["results"]["c1"] == {"a": {"v": 1}, "b": {"v": 9}}
    assert out["timestamp"] == "t0" and out["merged_at"] == "t1" and out["models"] == ["a", "b", "z"]
    assert ttr.merge_benchmark_outputs(None, fresh) is fresh
    assert ttr.merge_benchmark_outputs({"results": []}, fresh) is fresh


def test_unknown_model_and_no_clip(tmp_path):
    write_clip(tmp_path / "data")
    with pytest.raises(SystemExit, match="unknown model"):
        ttr.run_benchmarks(tmp_path / "data", tmp_path / "t", models="nope", device="cpu")
    with pytest.raises(SystemExit, match="No preprocessed clips"):
        ttr.run_benchmarks(tmp_path / "data", tmp_path / "t", models="lanczos", clips="other",
                           device="cpu")


def test_benchmark_cli_on_cpu(tmp_path):
    """``python -m vfisr_tpu_torch.benchmark --device cpu``, then a --merge
    run of another model that keeps the first run's row."""
    write_clip(tmp_path / "data")
    base = [sys.executable, "-m", "vfisr_tpu_torch.benchmark", "-d", str(tmp_path / "data"),
            "-o", str(tmp_path / "out"), "--device", "cpu", "--warmup", "1", "--max-triplets", "1"]
    res = subprocess.run(base + ["-m", "lanczos"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    path = tmp_path / "out" / "benchmark_results.json"
    first = json.loads(path.read_text())
    assert first["results"]["clip_t"]["lanczos"]["num_triplets"] == 1
    res = subprocess.run(base + ["-m", "bicubic", "--merge"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    merged = json.loads(path.read_text())
    assert set(merged["results"]["clip_t"]) == {"lanczos", "bicubic"}
    assert merged["results"]["clip_t"]["lanczos"] == first["results"]["clip_t"]["lanczos"]
    assert merged["merged_models"] == ["bicubic"] and merged["timestamp"] == first["timestamp"]
