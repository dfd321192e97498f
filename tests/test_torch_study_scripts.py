"""The port's study and report scripts (lpips_ordering_study,
check_expert_downscale, generate_comprehensive_report,
generate_report_figures) held against the reference's scripts/.

- ``capture_degrade``: tolerance 0 on a gameplay frame: the smear rounds
  to cv2.filter2D's uint8 there, and the JPEG round trip at quality 28 is
  libjpeg-turbo's arithmetic (tests/test_torch_jpeg.py).
- The two studies on a tiny cv2-written clip (144x256, the sweep's 960x540
  degradation shrunk to 128x72 in both harness modules), with the experts
  replaced on both sides by the same numpy function (RIFE and VFIMamba are
  held elsewhere): the same pairs are taken; motion within 2e-3 px (the
  Farneback tolerance of tests/test_torch_inline.py), PSNR within
  ``PSNR_TOL`` dB and LPIPS within ``LPIPS_TOL`` (the port's area and
  Lanczos4 taps are float where cv2's are fixed point: frames a few LSB
  apart). Keys equal; the port adds the native trunk's peak memory on a
  card only.
- The report: the same text for the same results, except the lines that
  say where it ran (date, hardware, how the sweep ran and was timed, the
  commands, the tables' module). The results table equals the
  reference's but for one reference fault: it escapes an underscore with
  two backslashes (the last test).
"""

import importlib.util
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port import game_frames, one_torch_thread
from vfisr_tpu_torch import check_expert_downscale as tced
from vfisr_tpu_torch import generate_comprehensive_report as tgcr
from vfisr_tpu_torch import generate_report_figures as tgrf
from vfisr_tpu_torch import lpips_ordering_study as tlos

ROOT = Path(__file__).resolve().parents[1]


def _ref(name):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlos, jced = _ref("lpips_ordering_study"), _ref("check_expert_downscale")
jgcr, jgrf = _ref("generate_comprehensive_report"), _ref("generate_report_figures")

PSNR_TOL, LPIPS_TOL, MOTION_TOL = 0.02, 1e-3, 2e-3
OUT_W, OUT_H, IN_W, IN_H = 256, 144, 128, 72


def test_capture_degrade_matches_the_reference():
    f = game_frames(1, 135, 241, step=0.0)[0]
    ref = jlos.capture_degrade(f)
    got = tlos.capture_degrade(f, device="cpu").numpy()
    k = np.full((1, 9), 1 / 9, np.float32)
    blur_ref = cv2.filter2D(f, -1, k)
    from vfisr_tpu_torch.ops.conv import filter2d

    blur = torch.round(filter2d(torch.from_numpy(f).float()[None], k)[0]).clamp(0, 255).numpy()
    assert np.array_equal(blur, blur_ref)
    assert np.array_equal(got, ref)
    # the same blurred frame round-trips to cv2's pixels exactly
    from vfisr_tpu_torch.data import jpeg

    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(blur_ref, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, 28])
    assert np.array_equal(jpeg.decode(jpeg.encode(blur_ref, 28, "cpu"), "cpu").numpy(),
                          cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """24 frames of a 2 px-per-frame pan at 144x256, mp4v (both packages
    read it through cv2 here)."""
    path = tmp_path_factory.mktemp("clip") / "c.mp4"
    frames = game_frames(24, OUT_H, OUT_W, step=2.0)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 60, (OUT_W, OUT_H))
    for f in frames:
        w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    w.release()
    return path


def _expert(prev, curr, *args, **kw):
    """The experts' stand-in on both sides: a weighted blend in numpy."""
    a = np.asarray(prev.cpu() if torch.is_tensor(prev) else prev).astype(np.float32)
    b = np.asarray(curr.cpu() if torch.is_tensor(curr) else curr).astype(np.float32)
    return np.clip(np.floor(0.4 * a + 0.6 * b + 0.5), 0, 255).astype(np.uint8)


@pytest.fixture()
def small_harness(monkeypatch):
    import vfisr_tpu.harness.experiments as jexp
    import vfisr_tpu_torch.harness.experiments as texp

    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "INPUT_W", IN_W)
        monkeypatch.setattr(mod, "INPUT_H", IN_H)
        monkeypatch.setattr(mod, "_rife_interpolate", _expert)


def _close_rows(got, ref, keys):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert abs(g["motion"] - r["motion"]) <= MOTION_TOL
        for k in keys:
            tol = LPIPS_TOL if k.startswith("lpips") else PSNR_TOL
            assert abs(g[k] - r[k]) <= tol, (k, g[k], r[k])


def test_lpips_study_family_matches(clip, small_harness):
    from vfisr_tpu.evaluation.lpips import default_lpips as jlpips
    from vfisr_tpu_torch.evaluation.lpips import default_lpips as tlpips

    kw = dict(width=OUT_W, height=OUT_H, stride=2)
    ref = jlos.study_family(str(clip), 3, jlpips(), **kw)
    got = tlos.study_family(str(clip), 3, tlpips("cpu"), device="cpu", **kw)
    assert set(got) == set(ref) and got["pairs"] == ref["pairs"] == 3
    _close_rows(got["rows"], ref["rows"], ("lpips_blend", "lpips_rife", "psnr_blend", "psnr_rife"))
    for k in ("lpips_blend_mean", "lpips_rife_mean"):
        assert abs(got[k] - ref[k]) <= LPIPS_TOL
    # the capture family reads degraded frames
    deg = tlos.study_family(str(clip), 1, tlpips("cpu"), degrade_fn=lambda f: tlos.capture_degrade(
        f, device="cpu"), device="cpu", **kw)
    assert deg["rows"][0]["psnr_blend"] != got["rows"][0]["psnr_blend"]
    with pytest.raises(SystemExit, match="cannot open"):
        tlos.study_family(str(clip) + ".none", 1, None, device="cpu")


class _FakeMamba:
    max_internal_area = 1920 * 1080

    def interpolate(self, prev, curr, num_frames=1, timestamps=None):
        return [_expert(curr, prev)]


def test_check_expert_downscale_matches(clip, small_harness, monkeypatch, tmp_path, capsys):
    import vfisr_tpu.models.registry as jreg
    import vfisr_tpu_torch.models.registry as treg

    monkeypatch.setattr(jreg, "get_model", lambda *a, **k: _FakeMamba())
    monkeypatch.setattr(treg, "get_model", lambda *a, **k: _FakeMamba())
    common = ["--clips", f"{clip},{clip}.none", "--pairs", "2", "--stride", "2",
              "--motion-min", "0", "--width", str(OUT_W), "--height", str(OUT_H)]
    monkeypatch.setattr(sys, "argv", ["x", *common, "--out", str(tmp_path / "j.json")])
    assert jced.main() == 0
    assert tced.main([*common, "--out", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    ref = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(got) == set(ref) and got["pairs"] == ref["pairs"] == 2
    _close_rows(got["rows"], ref["rows"], ("psnr_capped", "psnr_native", "psnr_rife"))
    assert "skipped" in capsys.readouterr().out
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """experiment_results.json of two clips: every method on intervals 0-1
    of the headline clip, one method missing interval 1 on the other."""
    rng = np.random.default_rng(3)
    names = ["control", "degraded", "lanczos_blend", "lanczos_blend_edge", "optical_flow_basic",
             "rife_default", "adaptive_default", "adaptive_aggressive", "mcar_default",
             "uafi_default", "bicubic_blend"]
    rows = []
    for clip, intervals in (("synth_hard_001", (0, 1)), ("synth_001", (0, 1))):
        for name in names:
            for i in intervals:
                if clip == "synth_001" and name == "uafi_default" and i == 1:
                    continue
                rows.append({
                    "name": name, "clip_id": clip, "interval_idx": i,
                    "vfi_psnr_db": float(25 + 10 * rng.random()),
                    "vfi_ssim": float(0.8 + 0.1 * rng.random()),
                    "keyframe_psnr_db": float(30 + 5 * rng.random()),
                    "overall_psnr_db": float(28 + 5 * rng.random()),
                    "time_s": float(1 + 20 * rng.random()),
                    "rife_frames_pct": float(100 * rng.random()),
                    "vfi_lpips": float(0.1 * rng.random()), "lpips_mode": "calibrated_heads"})
    path = tmp_path_factory.mktemp("results") / "experiment_results.json"
    path.write_text(json.dumps({"experiments": rows}))
    return path


# the lines that say where the report ran: (reference's start, port's start)
WHERE = [("**Date:**", "**Date:**"), ("**Hardware:**", "**Hardware:** an H100"),
         ("- All per-pair analysis", "- All per-pair analysis"),
         ("- Device timing:", "- Time:"), ("python scripts/", "python -m vfisr_tpu_torch.")]


def test_comprehensive_report_text_matches(results, tmp_path):
    jgcr.comprehensive_report(str(results), tmp_path / "j.md", note="n")
    tgcr.comprehensive_report(str(results), tmp_path / "t.md", note="n", hardware="an H100")
    ref = (tmp_path / "j.md").read_text().splitlines()
    got = (tmp_path / "t.md").read_text().splitlines()
    assert len(got) == len(ref) > 60
    differ = [(r, g) for r, g in zip(ref, got) if r != g]
    assert differ and all(any(r.startswith(a) and g.startswith(b) for a, b in WHERE)
                          for r, g in differ), differ
    # hardware, the two methodology lines and the five commands (and the date
    # only where the two runs straddle midnight)
    assert len([d for d in differ if not d[0].startswith("**Date:**")]) == 8
    jgcr.methods_reference(tmp_path / "jm.md")
    tgcr.methods_reference(tmp_path / "tm.md")
    ref_m, got_m = ((tmp_path / n).read_text() for n in ("jm.md", "tm.md"))
    assert got_m == ref_m.replace("(vfisr_tpu/harness/", "(vfisr_tpu_torch/harness/")


def test_comprehensive_report_cli(results, tmp_path):
    tgcr.main(["--results", str(results), "--output-dir", str(tmp_path), "--hardware", "x"])
    assert "**Hardware:** x" in (tmp_path / "COMPREHENSIVE_REPORT.md").read_text()
    assert (tmp_path / "METHODS_REFERENCE.md").read_text().startswith("# VFI Methods Quick")


def test_report_figures_and_table(results, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", "--results", str(results), "--output-dir",
                                      str(tmp_path / "j")])
    jgrf.main()
    tgrf.main(["--results", str(results), "--output-dir", str(tmp_path / "t")])
    for d in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / d).iterdir()) == [
            "fig1_vfi_quality.png", "fig2_quality_speed.png", "fig3_categories.png",
            "fig4_rife_usage.png", "table1_results.tex"]
    ref = (tmp_path / "j" / "table1_results.tex").read_text()
    got = (tmp_path / "t" / "table1_results.tex").read_text()
    assert got == ref.replace("\\\\_", "\\_")


def test_results_table_escapes_underscores_for_latex(results, tmp_path, monkeypatch):
    """Reference fault (scripts/generate_report_figures.py:86): the name's
    underscores become ``\\\\_`` (a raw '\\\\_' inside its f-string), a line
    break in LaTeX. The port writes ``\\_``."""
    monkeypatch.setattr(sys, "argv", ["x", "--results", str(results), "--output-dir",
                                      str(tmp_path)])
    jgrf.main()
    assert "rife\\\\_default &" in (tmp_path / "table1_results.tex").read_text()
    row = tgrf.results_table([{"name": "rife_default", "vfi_psnr": 30.0, "time_s": 2.0}])
    assert "rife\\_default & 30.00 & 2.0 \\\\" in row and "\\\\_" not in row
