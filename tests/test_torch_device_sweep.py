"""vfisr_tpu_torch/harness/device_sweep.py held against
vfisr_tpu/harness/device_sweep.py: ``run_experiment_batched`` for all nine
methods on the same interval.

The interval: 144x256 keyframes of a smooth numpy-made scene panning by a
different amount per pair under a static HUD box, the true in-between
frames as midpoints; outputs at 192x108, the degradation target shrunk to
128x72 in both packages (as tests/test_device_sweep.py does: production
degrades 1080p down to 960x540). A narrow IFNet with the same seeded
parameters sits in both packages' ``_RIFESingleton``. Each package runs on
the CPU with its exact gather warps.

Tolerances: the counts, ``rife_frames_pct`` and ``expert_mix`` equal;
PSNR within 0.05 dB and SSIM within 1e-3 (the same f32 ops; a resized value
that lands on a .5 rounds to either side of ``_qu8`` now and then, and a
flipped pixel moves a 192x108 frame's PSNR by up to ~0.01 dB).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vfisr_tpu.harness.device_sweep as jds
import vfisr_tpu.harness.experiments as jex
import vfisr_tpu.utils.router_gate as jrg
import vfisr_tpu_torch.harness.device_sweep as tds
import vfisr_tpu_torch.harness.experiments as tex
import vfisr_tpu_torch.utils.router_gate as trg
from _torch_port import narrow_rife, one_torch_thread, sweep_interval

OUT = (192, 108)
PANS = (0, 3, 8, 16, 24)  # px per pair: a static pair, then faster pans
PSNR_TOL, SSIM_TOL = 0.05, 1e-3


@pytest.fixture(autouse=True)
def _small_degrade(monkeypatch):
    for mod in (jds, jex, tds, tex):
        monkeypatch.setattr(mod, "INPUT_W", 128)
        monkeypatch.setattr(mod, "INPUT_H", 72)


@pytest.fixture(scope="module")
def rifes():
    return narrow_rife(11)


@pytest.fixture
def experts(monkeypatch, rifes):
    jr, tr = rifes
    monkeypatch.setattr(jex._RIFESingleton, "_instance", jr)
    monkeypatch.setattr(tex._RIFESingleton, "_instance", tr)
    return jr, tr


def _exp(name, **over):
    e = next(x for x in jex.EXPERIMENTS if x["name"] == name).copy()
    e.update(quality_resolution=OUT, quality_fps=60, **over)
    return e


def _both(kfs, mids, exp, **kw):
    ref = jds.run_experiment_batched(jds.DeviceInterval(kfs, mids), exp, **kw)
    out = tds.run_experiment_batched(tds.DeviceInterval(kfs, mids, device="cpu"), exp, **kw)
    return out, ref


def _assert_same(out, ref):
    assert out["device_batched"] is True
    assert set(out) == set(ref)
    for key in ("frames", "keyframes_evaluated", "vfi_frames_evaluated", "lpips_frames_sampled",
                "rife_frames_pct", "expert_mix", "vfimamba_frames_pct", "used_rife",
                "target_resolution", "blend_thresh_effective"):
        assert out[key] == ref[key], key
    for key in ("keyframe_psnr_db", "vfi_psnr_db", "overall_psnr_db"):
        if isinstance(ref[key], str) or ref[key] == 0:
            assert out[key] == ref[key], key
        else:
            assert out[key] == pytest.approx(ref[key], abs=PSNR_TOL), key
    for key in ("keyframe_ssim", "vfi_ssim", "overall_ssim"):
        assert out[key] == pytest.approx(ref[key], abs=SSIM_TOL), key


@pytest.mark.parametrize("name,over", [
    ("control", {}), ("degraded", {}), ("lanczos_blend_edge", {}), ("optical_flow_basic", {}),
    ("uafi_default", {}), ("ughi_default", {}),
    ("mcar_default", {"mcar_low": 0.05, "mcar_high": 0.2}), ("rife_default", {}),
    ("adaptive_default", {"motion_thresh": 0.01})])
def test_methods_match(experts, name, over):
    """Every method, each one compile of the reference's chunk program (RIFE
    at native scale 1.0, one IFNet compile for rife, mcar and adaptive; the
    coarser scales are tests/test_torch_rife_scale.py's). MCAR with thresholds that split this interval's
    complexities (0.004 to 0.22) over its three tiers; adaptive with the
    quality-aware test's blend threshold, so only the static pair blends."""
    kfs, mids = sweep_interval(PANS)
    out, ref = _both(kfs, mids, _exp(name, **over), chunk_pairs=4)
    _assert_same(out, ref)
    assert out["frames"] == 4 * len(PANS) + 1
    if name in ("adaptive_default", "mcar_default"):
        assert 0 < out["rife_frames_pct"] < 100  # RIFE and another route


def test_quality_aware_routes_match(monkeypatch, tmp_path):
    """The quality-aware tier with fake experts (no model runs), as
    tests/test_device_sweep.py pins the reference: a gate whose bins give
    rife, rife_fast and vfimamba at this interval's motions."""
    gate = {"blend_vs_rife_crossover_px": 0.01, "expert_bins": {"sweep": [
        {"motion_lo": 0.0, "motion_hi": 0.8, "rife": 30.0, "rife_fast": 29.0, "vfimamba": 29.5},
        {"motion_lo": 0.8, "motion_hi": 2.0, "rife": 20.0, "rife_fast": 21.0, "vfimamba": 20.5},
        {"motion_lo": 2.0, "motion_hi": 1e9, "rife": 20.0, "rife_fast": 20.5, "vfimamba": 22.0}]}}
    path = tmp_path / "gate.json"
    path.write_text(json.dumps(gate))
    monkeypatch.setattr(jrg, "DEFAULT_PATH", path)
    monkeypatch.setattr(trg, "DEFAULT_PATH", path)
    jrg.clear_cache()
    trg.clear_cache()
    calls = {"jax": [], "torch": []}
    tts = torch.tensor(tds.TS).view(1, 3, 1, 1, 1)
    jts = jnp.asarray(tds.TS)[None, :, None, None, None]

    def jblend(prev, curr):
        return prev.astype(jnp.float32)[:, None] * (1 - jts) + curr.astype(jnp.float32)[:, None] * jts

    def tblend(prev, curr):
        return prev.float()[:, None] * (1 - tts) + curr.float()[:, None] * tts

    monkeypatch.setattr(jds, "_rife_chunk", lambda p, c, scale=0.5: (
        calls["jax"].append(("rife", scale)), jblend(p, c))[1])
    monkeypatch.setattr(jds, "_vfimamba_chunk", lambda p, c: (
        calls["jax"].append(("vfimamba", None)), jblend(p, c))[1])
    monkeypatch.setattr(tds, "_rife_chunk", lambda p, c, scale=0.5: (
        calls["torch"].append(("rife", scale)), tblend(p, c))[1])
    monkeypatch.setattr(tds, "_vfimamba_chunk", lambda p, c: (
        calls["torch"].append(("vfimamba", None)), tblend(p, c))[1])
    try:
        kfs, mids = sweep_interval(PANS)
        out, ref = _both(kfs, mids, _exp("adaptive_aggressive"), chunk_pairs=4)
    finally:
        jrg.clear_cache()
        trg.clear_cache()
    _assert_same(out, ref)
    mix = out["expert_mix"]
    assert sum(mix.values()) == out["vfi_frames_evaluated"] == len(PANS)
    assert mix["blend"] >= 1 and mix["vfimamba"] >= 1 and mix["rife"] + mix["rife_fast"] >= 1
    assert calls["torch"] == calls["jax"]


def test_tail_chunk_padding():
    """6 pairs in chunks of 4: the padded tail chunk counts only its real
    pairs, and every per-frame metric equals an unchunked run's; with fewer
    midpoints than pairs the evaluation stops where they end (the tail
    chunk's clamped window reads past them)."""
    kfs, mids = sweep_interval(pans=(0, 3, 8, 16, 24, 4))
    exp = _exp("optical_flow_basic")  # a light method: chunks of up to 8

    def run(m, k):
        return tds.run_experiment_batched(tds.DeviceInterval(kfs, m, device="cpu"), exp,
                                          chunk_pairs=k)

    for m, n_eval in ((mids, 6), (mids[:3], 3)):
        out, one = run(m, 4), run(m, 6)
        assert one["frames"] == out["frames"] == 25
        assert one["vfi_frames_evaluated"] == out["vfi_frames_evaluated"] == n_eval
        assert out["keyframes_evaluated"] == 7
        for key in ("keyframe_psnr_db", "vfi_psnr_db", "keyframe_ssim", "vfi_ssim"):
            assert one[key] == pytest.approx(out[key], abs=1e-6), key


def test_lpips_sampling_and_video(tmp_path):
    """LPIPS on every 10th evaluated VFI frame (the 10th pair's t = 0.5
    frame against its midpoint); a video of every frame."""
    kfs, mids = sweep_interval(pans=(2,) * 10)
    seen = []
    lp = lambda a, b: (seen.append((a.shape, b.shape, a.dtype, b.dtype)), 0.25)[1]  # noqa: E731
    exp = _exp("lanczos_blend_edge")
    out = tds.run_experiment_batched(tds.DeviceInterval(kfs, mids, device="cpu"), exp,
                                     lpips_fn=lp, lpips_mode="calibrated_heads",
                                     output_path=str(tmp_path / "v.y4m"), chunk_pairs=4)
    assert out["lpips_frames_sampled"] == 1 and out["vfi_frames_evaluated"] == 10
    assert out["vfi_lpips"] == 0.25 and out["lpips_mode"] == "calibrated_heads"
    assert seen == [((108, 192, 3), (108, 192, 3), np.uint8, np.uint8)]
    from vfisr_tpu_torch.data.video_io import VideoReader

    with VideoReader(str(tmp_path / "v.y4m")) as r:
        frames = list(r)
    assert len(frames) == out["frames"] == 41 and frames[0].shape == (108, 192, 3)


def test_unknown_method_raises():
    kfs, mids = sweep_interval(pans=(2, 2))
    with pytest.raises(ValueError, match="no device-batched path"):
        tds.run_experiment_batched(tds.DeviceInterval(kfs, mids, device="cpu"),
                                   {"name": "x", "vfi": "no_such_method",
                                    "quality_resolution": (64, 64), "quality_fps": 60})
    assert tds.DEVICE_METHODS == jds.DEVICE_METHODS


def test_failing_expert_raises(monkeypatch, tmp_path):
    """A failing VFIMamba expert raises out of the chunk: no RIFE@0.5 in its
    place and no reload (the reference falls back, device_sweep.py:474-490)."""
    gate = {"blend_vs_rife_crossover_px": 0.0, "expert_bins": {"sweep": [
        {"motion_lo": 0.0, "motion_hi": 1e9, "rife": 20.0, "rife_fast": 20.0, "vfimamba": 25.0}]}}
    path = tmp_path / "gate.json"
    path.write_text(json.dumps(gate))
    monkeypatch.setattr(trg, "DEFAULT_PATH", path)
    trg.clear_cache()
    rife_calls = []

    def failing(prev, curr):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(tds, "_vfimamba_chunk", failing)
    monkeypatch.setattr(tds, "_rife_chunk", lambda *a, **k: rife_calls.append(a))
    monkeypatch.setattr(tex._VFIMambaSingleton, "release",
                        classmethod(lambda cls: pytest.fail("released")))
    try:
        kfs, mids = sweep_interval(pans=(8, 8))
        with pytest.raises(RuntimeError, match="out of memory"):
            tds.run_experiment_batched(tds.DeviceInterval(kfs, mids, device="cpu"),
                                       _exp("adaptive_aggressive"), chunk_pairs=2)
    finally:
        trg.clear_cache()
    assert rife_calls == []
