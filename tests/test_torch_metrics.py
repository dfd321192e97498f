"""vfisr_tpu_torch/evaluation/metrics.py (and the package's ``__all__``)
against vfisr_tpu/evaluation/metrics.py, on the CPU (``device="cpu"``).

Frames: 4 uint8 frames of a smooth random texture under a static HUD box,
panned 2 px per frame at 120x160, so every metric has content: the
short side allows ms_ssim's 5 scales, the flows are "easy" motion, the HUD
gives a UI mask. Predictions are the frames with seeded noise, and one
smaller prediction takes the resize path. Flows are exact warps on both
sides (each package's CPU default).

Tolerances: PSNR on frames of equal size is a float64 mean of the same
uint8 differences on both sides (numpy there, torch here: sums in another
order), so within 1e-9 dB; SSIM, MS-SSIM and the global SSIM within 1e-5. A
prediction of another size is resized ("linear", uint8 rounded as in the
reference): its f32 taps are summed in another order than JAX's einsum,
which moves values that sit on a rounding tie by 1 LSB (0.35% of the bytes
at 90x128 -> 120x160, whose repeated pixels make many ties), so there the
bytes are within 1 LSB (at most 1% of them off), PSNR within 0.01 dB and
SSIM within 1e-4; UI masks and Canny-based counts equal on uint8 frames;
LPIPS and FloLPIPS within 1e-5 relative; flows within 1e-3 px and the
metrics computed from them within 1e-4 relative (Farneback's f32 solve
in another order of sums).
"""

import re
from importlib import import_module

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smooth_frames
import vfisr_tpu_torch.evaluation as tev
from vfisr_tpu_torch.evaluation import metrics as tm

jev = import_module("vfisr_tpu.evaluation")
jm = import_module("vfisr_tpu.evaluation.metrics")

H, W, PAN = 120, 160, 2


def _sequence():
    """(gt, pred): 4 frames of a smooth random texture panned PAN px per
    frame under a static HUD (a box with bars), and their noisy copies."""
    rng = np.random.default_rng(0)
    wide = (smooth_frames(rng, 1, H, W + 4 * PAN, cell=6)[0] * 255).astype(np.uint8)
    gt = []
    for i in range(4):
        f = np.ascontiguousarray(wide[:, 3 * PAN - i * PAN:3 * PAN - i * PAN + W])
        f[4:22, 4:64] = (230, 230, 40)
        f[8:12, 8:56:6] = 20
        gt.append(f)
    pred = [np.clip(g.astype(int) + rng.integers(-9, 10, g.shape), 0, 255).astype(np.uint8)
            for g in gt]
    return gt, pred


GT, PRED = _sequence()


def _close(a, b, rel=1e-4):
    """Equal structure; floats within rel of max(1, |b|)."""
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _close(a[k], b[k], rel)
    elif isinstance(b, float):
        assert abs(a - b) <= rel * max(1.0, abs(b)), (a, b)
    else:
        assert a == b


@pytest.fixture
def tf32_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_public_names_match():
    assert tev.__all__ == jev.__all__
    assert all(hasattr(tev, n) for n in tev.__all__)


@pytest.mark.parametrize("pred_hw", [(H, W), (90, 128)])
def test_pair_metrics_match(pred_hw):
    gt, pred = GT[1], PRED[1]
    if pred_hw != (H, W):
        pred = np.ascontiguousarray(pred[::4, ::5].repeat(3, 0).repeat(4, 1)[:90, :128])
    resized = tm._match_size(pred, gt, "cpu")
    diff = np.abs(resized.astype(int) - jm._match_size(pred, gt).astype(int))
    assert resized.dtype == np.uint8 and diff.max() <= 1 and diff.mean() <= 1e-2
    psnr_tol, ssim_tol = (1e-9, 1e-5) if pred_hw == (H, W) else (1e-2, 1e-4)
    for name in ("compute_psnr_simple", "calc_psnr"):
        assert abs(getattr(tm, name)(pred, gt, "cpu") - getattr(jm, name)(pred, gt)) <= psnr_tol
    assert abs(tm.compute_ssim_simple(pred, gt, "cpu") - jm.compute_ssim_simple(pred, gt)) <= ssim_tol
    gray = np.ascontiguousarray(PRED[1][..., 0])
    assert abs(tm.compute_ssim_simple(gray, gt[..., 1], "cpu")
               - jm.compute_ssim_simple(gray, gt[..., 1])) <= 1e-5
    assert abs(tm.calc_ssim(resized, gt, "cpu") - jm.calc_ssim(resized, gt)) <= 1e-5
    assert tm.compute_psnr_simple(gt, gt, "cpu") == float("inf")


@pytest.mark.parametrize("value", [None, float("inf"), float("-inf"), float("nan"), 3.14159, 2])
def test_safe_round_matches(value):
    assert tm.safe_round(value) == jm.safe_round(value) or value != value


@pytest.mark.parametrize("px", [0.5, 1.0, 4.9, 5.0, 14.0, 29.9, 30.0, 80.0])
def test_classify_motion_difficulty_matches(px):
    flow = np.full((4, 5, 2), px / np.sqrt(2), np.float32)
    assert tm.classify_motion_difficulty(flow).value == jm.classify_motion_difficulty(flow).value


def test_flows_and_temporal_metrics_match():
    ref = [jm.compute_optical_flow(GT[i], GT[i + 1]) for i in range(3)]
    out = [tm.compute_optical_flow(GT[i], GT[i + 1], "cpu") for i in range(3)]
    assert all(o.shape == r.shape == (H, W, 2) and np.abs(o - r).max() <= 1e-3
               for o, r in zip(out, ref))
    assert tm.classify_motion_difficulty(out[0]) == tm.MotionDifficulty.EASY
    back = [jm.compute_optical_flow(GT[i + 1], GT[i]) for i in range(3)]
    _close(tm.compute_tof_smoothness(ref), jm.compute_tof_smoothness(ref))
    _close(tm.compute_flow_consistency(ref, back, "cpu"), jm.compute_flow_consistency(ref, back))
    _close(tm.compute_flicker_score(PRED, "cpu"), jm.compute_flicker_score(PRED))
    _close(tm.compute_temporal_metrics(PRED, "cpu").to_dict(),
           jm.compute_temporal_metrics(PRED).to_dict())
    assert tm.compute_temporal_metrics(PRED[:2], "cpu").to_dict() == \
        jm.compute_temporal_metrics(PRED[:2]).to_dict()


def test_gaming_metrics_match():
    for frame in (GT[0], PRED[2]):
        ref = jm.detect_ui_regions(frame)
        out = tm.detect_ui_regions(frame, "cpu")
        assert out.dtype == ref.dtype and np.array_equal(out, ref) and ref.sum() >= 100
    _close(tm.compute_ui_ghosting_score(PRED, GT, "cpu"), jm.compute_ui_ghosting_score(PRED, GT),
           1e-12)
    _close(tm.compute_edge_wobble_score(PRED, "cpu"), jm.compute_edge_wobble_score(PRED), 1e-12)
    _close(tm.compute_gaming_metrics(PRED, GT, "cpu").to_dict(),
           jm.compute_gaming_metrics(PRED, GT).to_dict(), 1e-12)


def test_stratified_metrics_match():
    out = tm.compute_stratified_metrics(PRED, GT, "cpu").to_dict()
    _close(out, jm.compute_stratified_metrics(PRED, GT).to_dict(), 1e-5)
    assert out["frame_counts"] == {"easy": 3}
    assert tm.compute_stratified_metrics(PRED[:1], GT[:1], "cpu").to_dict() == \
        {"by_difficulty": {}, "frame_counts": {}}


def test_comprehensive_benchmark_matches(capsys):
    ref = jm.run_comprehensive_benchmark(PRED, GT + GT[:1], verbose=False)
    out = tm.run_comprehensive_benchmark(PRED, GT + GT[:1], verbose=True, device="cpu")
    assert "COMPREHENSIVE VFI BENCHMARK RESULTS" in capsys.readouterr().out
    _close(out.to_dict(), ref.to_dict())
    assert out.total_frames == 4

    def words(s):
        return re.sub(r"[-\d.]+", "#", s)

    assert words(out.summary_table()) == words(ref.summary_table())


def test_quality_evaluator_matches(tf32_flags):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    out = tm.QualityEvaluator(device="cpu")
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    ref = jm.QualityEvaluator()
    assert out.lpips_mode == ref.lpips_mode == "calibrated_heads"
    r, o = ref.evaluate(PRED, GT), out.evaluate(PRED, GT)
    assert np.abs(np.array(o.psnr_per_frame) - r.psnr_per_frame).max() <= 1e-9
    assert o.ms_ssim is not None
    _close(o.to_dict(), r.to_dict(), 1e-5)
    assert np.abs(np.array(o.lpips_per_frame) / np.array(r.lpips_per_frame) - 1).max() <= 1e-5
    small = out.evaluate_pair(PRED[0][:100], GT[0][:100])  # too small for 5 scales
    assert small.keys() == {"psnr", "ssim", "lpips"}
    _close(out.evaluate_flolpips(PRED, GT), ref.evaluate_flolpips(PRED, GT), 1e-5)
    assert out.evaluate_flolpips(PRED[:1], GT[:1]) is None
    _close(out.evaluate_temporal_consistency(PRED), ref.evaluate_temporal_consistency(PRED), 1e-5)
    with pytest.raises(ValueError):
        out.evaluate(PRED, GT[:3])
