"""vfisr_tpu_torch/calibrate_router.py held against scripts/calibrate_router.py.

The experts are stubbed on both sides with one cheap function (a fixed
0.4/0.6 blend), so no full-width RIFE or VFIMamba program compiles under
JAX; Farneback, the resizes, SSIM and the warps are real. The port runs
with ``device="cpu"`` on one intra-op thread.

Tolerances:
- ``_bins_from_rows``, the crossover and the scene gate's threshold and
  counts: equal (the same seeded rows; the scene gate's labelled pairs made
  from stub worlds whose frames carry their world and index, the signals
  drawn in call order).
- ``_signals_small`` / ``_signals_full`` against the reference's JAX
  expressions on the same uint8 frames: within 2e-4 (SSIMs in [0, 1]; the
  f32 Farneback of the two packages, tests/test_torch_flow.py).
- ``_measure_rows`` / ``measure_native_rows`` on 16-frame mp4 clips cv2
  writes (both read them with cv2): motions within 2% or 0.02 px, PSNRs within 0.1
  dB (cv2's fixed-point area, Lanczos4 and bilinear resizes against the
  port's f32 taps move the grays and frames by an LSB or two).
"""

import importlib
import importlib.util
import json
import sys
import tempfile
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)
from vfisr_tpu_torch import calibrate_router as cal
from vfisr_tpu_torch.harness import experiments as texp
from vfisr_tpu_torch.utils import router_gate

ROOT = Path(__file__).resolve().parents[1]
CLIP_HW, CLIP_FRAMES = (48, 80), 16
QUALITY = (256, 144)  # (w, h) of the sweep's SR frames here


def _reference():
    spec = importlib.util.spec_from_file_location("ref_calibrate_router",
                                                  ROOT / "scripts" / "calibrate_router.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _stub_expert(prev, curr, t, *args, **kwargs):
    return (np.asarray(prev, np.float32) * 0.4 + np.asarray(curr, np.float32) * 0.6).astype(np.uint8)


@pytest.fixture
def stub_experts(monkeypatch):
    import vfisr_tpu.harness.experiments as jexp

    for mod in (jexp, texp):
        monkeypatch.setattr(mod, "_rife_interpolate", _stub_expert)
        monkeypatch.setattr(mod, "_vfimamba_interpolate", _stub_expert)


def _write_clip(path, h, w):
    """16 mp4v frames of a textured world panning 3 px per frame (frame 10
    on: 9 px) under a static box."""
    rng = np.random.default_rng(0)
    world = cv2.resize(rng.integers(0, 256, (h // 4, 3 * w // 4, 3), np.uint8), (3 * w, h),
                       interpolation=cv2.INTER_CUBIC)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 60, (w, h))
    x = 0
    for i in range(CLIP_FRAMES):
        f = np.ascontiguousarray(world[:, x:x + w])
        cv2.rectangle(f, (8, 8), (40, 24), (20, 200, 60), -1)
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        x += 3 if i < 10 else 9
    writer.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """The native regime's clip, at CLIP_HW."""
    return _write_clip(tmp_path_factory.mktemp("calib") / "clip.mp4", *CLIP_HW)


@pytest.fixture(scope="module")
def sweep_clip(tmp_path_factory):
    """The sweep regime's clip at 960x540, the size its keyframes are
    degraded to (cv2's INTER_AREA upscale, which a smaller clip would take,
    is not the port's: the sweep only ever downscales)."""
    return _write_clip(tmp_path_factory.mktemp("calib") / "sweep.mp4", 540, 960)


def _close_rows(got, ref, keys):
    assert len(got) == len(ref) and len(got) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        m_tol = max(0.02 * abs(r["motion"]), 0.02)
        assert abs(g["motion"] - r["motion"]) <= m_tol, (g, r)
        for k in keys:
            assert abs(g[k] - r[k]) <= 0.1, (k, g, r)


def test_measure_rows_match_reference(clip, sweep_clip, stub_experts):
    w, h = QUALITY
    ref = REF._measure_rows(sweep_clip, 4, w, h, stride=1, with_experts=True)
    got = cal._measure_rows(sweep_clip, 4, w, h, stride=1, with_experts=True, device="cpu")
    _close_rows(got, ref, ("psnr_blend", "psnr_rife", "psnr_rife_fast", "psnr_vfimamba"))
    ref = REF.measure_native_rows(clip, 3, stride=2)
    got = cal.measure_native_rows(clip, 3, 2, "cpu")
    _close_rows(got, ref, ("psnr_rife", "psnr_vfimamba"))


def _seeded_rows(seed, n, experts):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        r = {"motion": round(float(rng.gamma(1.5, 2.0)), 4)}
        for e in experts:
            if rng.random() > 0.1:
                r[f"psnr_{e}"] = round(float(rng.uniform(18, 40)), 4)
        rows.append(r)
    return rows


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 24), (2, 61), (3, 90)])
def test_bins_and_crossover_match_reference(seed, n, monkeypatch):
    experts = ("blend", "rife", "rife_fast", "vfimamba")
    rows = _seeded_rows(seed, n, experts)
    for r in rows:
        r.setdefault("psnr_blend", 30.0)
        r.setdefault("psnr_rife", 30.0)
    for ex in (experts, ("rife", "vfimamba")):
        assert cal._bins_from_rows(rows, ex) == REF._bins_from_rows(rows, ex)
    halves = [rows[: n // 2], rows[n // 2:]]
    monkeypatch.setattr(REF, "_measure_rows", lambda clip, *a, **k: [dict(r) for r in halves[int(clip)]])
    monkeypatch.setattr(cal, "_measure_rows", lambda clip, *a, **k: [dict(r) for r in halves[int(clip)]])
    assert cal.measure_crossover("0,1", 0, 0, 0) == REF.measure_crossover("0,1", 0, 0, 0)


class _Signals:
    """Stub signals drawn in call order from a seeded generator; the frame
    carries its world and index (pixel (0, 0)), so a cut pair draws from
    the cut distribution. ``overlap`` lets the classes overlap."""

    def __init__(self, seed, overlap):
        self.rng = np.random.default_rng(seed)
        self.overlap = overlap

    def __call__(self, f0, f1):
        (w0, i0), (w1, i1) = (tuple(int(v) for v in np.asarray(f)[0, 0, 0, :2]) for f in (f0, f1))
        n = 24
        cuts = [(0.45, 0.80), (0.45, 0.80), (0.62,)][w0]
        cut = w0 != w1 or sum(int(n * c) <= i0 for c in cuts) != sum(int(n * c) <= i1 for c in cuts)
        lo = 0.3 if self.overlap else 0.55
        s = self.rng.uniform(0.1, 0.6) if cut else self.rng.uniform(0.3, 1.0)
        w = self.rng.uniform(0.1, 0.5) if cut else self.rng.uniform(lo, 1.0)
        return np.array([s], np.float32), np.array([w], np.float32)


def _world(k, n=24):
    frames = np.zeros((n, 4, 4, 3), np.uint8)
    frames[:, 0, 0, 0] = k
    frames[:, 0, 0, 1] = np.arange(n)
    return frames


@pytest.mark.parametrize("overlap", [False, True])
def test_scene_gate_matches_reference(overlap, monkeypatch, tmp_path):
    """The labelled pairs, the pooled rows and the threshold and counts of
    both packages, on stub worlds (24 frames each: 2 hard, 1 smooth) and
    stub signals."""
    jcolor, jresize, jap, jflow = (importlib.import_module(f"vfisr_tpu.{m}") for m in (
        "core.color", "core.resize", "models.novel.adaptive_pipeline", "ops.flow"))

    # the reference: its worlds through a fake VideoCapture, its jitted
    # signals un-jitted and stubbed at scene_cut_signals
    state = {}
    fake_msc = types.ModuleType("make_synthetic_clip")
    fake_msc.render_hard_clip = lambda p, seconds, seed, profile: state.setdefault(p, seed - 520) * 0 + 24
    fake_msc.render_clip = lambda p, seconds, seed: state.setdefault(p, 2) * 0 + 24

    class Capture:
        def __init__(self, path):
            self.frames = list(_world(state[path]))

        def read(self):
            if not self.frames:
                return False, None
            return True, cv2.cvtColor(self.frames.pop(0), cv2.COLOR_RGB2BGR)

        def release(self):
            pass

    ref_sig = _Signals(5, overlap)
    with monkeypatch.context() as m:
        m.setattr(tempfile, "mkdtemp", lambda prefix: str(tmp_path))  # it leaks the dir
        m.setitem(sys.modules, "make_synthetic_clip", fake_msc)
        m.setattr(cv2, "VideoCapture", Capture)
        m.setattr(jax, "jit", lambda f: f)
        m.setattr(jcolor, "rgb_to_gray", lambda x: x)
        m.setattr(jresize, "resize", lambda x, *a: x)
        m.setattr(jflow, "farneback_flow", lambda a, b, *p: a[..., :2])
        m.setattr(jap, "scene_cut_signals", lambda s0, s1, fl, *a: (None, *ref_sig(s0, s1)))
        ref = REF.measure_scene_gate(extra_worlds=2, seconds=0.4)

    # the port: its worlds through a fake VideoReader, its signals stubbed
    import vfisr_tpu_torch.data.synthetic_clip as tsc

    port_state = {}
    monkeypatch.setattr(tsc, "render_hard_clip", lambda p, seconds, seed, profile, device: port_state.setdefault(p, seed - 520) * 0 + 24)
    monkeypatch.setattr(tsc, "render_clip", lambda p, seconds, seed, device: port_state.setdefault(p, 2) * 0 + 24)

    class Reader:
        def __init__(self, path):
            self.frames = list(_world(port_state[path]))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

        def read_to(self, device):
            return torch.from_numpy(self.frames.pop(0)) if self.frames else None

    port_sig = _Signals(5, overlap)
    monkeypatch.setattr(cal, "VideoReader", Reader)
    monkeypatch.setattr(cal, "_signals_small", lambda f0, f1, thr: port_sig(f0, f1))
    monkeypatch.setattr(cal, "_signals_full", lambda f0, f1, thr: port_sig(f0, f1))
    got = cal.measure_scene_gate(extra_worlds=2, seconds=0.4, device="cpu")
    assert got == ref
    assert got["cut_pairs"] > 0 and got["noncut_pairs"] > 0
    assert (got["false_holds"] == 0) and (overlap or got["missed_cuts"] == 0)


def test_scene_signals_match_reference():
    """Both runtime paths of the gate's signals on the same uint8 frames: a
    textured frame, a 4 px pan of it, and another world (a cut). The frames
    are at the flagship's 480x270 analysis size, where both paths take
    their flow at one shape: the reference's expressions (its
    calibrate_router.py:236-259) in pieces, one jitted Farneback compiled
    once for both."""
    from vfisr_tpu.core.color import rgb_to_gray
    from vfisr_tpu.core.resize import resize
    from vfisr_tpu.models.novel.adaptive_pipeline import scene_cut_signals
    from vfisr_tpu.ops.flow import farneback_flow

    flow_of = jax.jit(lambda g0, g1: farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2))
    gate = jax.jit(lambda s0, s1, fl: scene_cut_signals(s0, s1, fl, 0.65, 1.0)[1:])

    @jax.jit
    def small_grays(f0u8, f1u8):
        return tuple(rgb_to_gray(resize(f.astype(jnp.float32), (270, 480), "linear"))
                     for f in (f0u8, f1u8))

    @jax.jit
    def quarter(g0, g1, flow):
        h, wd = g0.shape[-2:]
        sh, sw = h // 4, wd // 4
        s0 = resize(g0[..., None], (sh, sw), "linear")[..., 0]
        s1 = resize(g1[..., None], (sh, sw), "linear")[..., 0]
        fl = resize(flow, (sh, sw), "linear") * jnp.asarray([sw / wd, sh / h], flow.dtype)
        return s0, s1, fl

    def signals(f0u8, f1u8):
        g0, g1 = small_grays(f0u8, f1u8)
        s, w = gate(g0, g1, flow_of(g0, g1))
        g0, g1 = rgb_to_gray(f0u8.astype(jnp.float32)), rgb_to_gray(f1u8.astype(jnp.float32))
        s2, w2 = gate(*quarter(g0, g1, flow_of(g0, g1)))
        return jnp.concatenate([s, w, s2, w2])

    rng = np.random.default_rng(3)
    h, w = 270, 480
    world = cv2.resize(rng.integers(0, 256, (h // 8, w // 4, 3), np.uint8), (2 * w, h),
                       interpolation=cv2.INTER_CUBIC)
    other = cv2.resize(rng.integers(0, 256, (h // 8, w // 8, 3), np.uint8), (w, h),
                       interpolation=cv2.INTER_LINEAR)
    a = np.ascontiguousarray(world[:, :w])
    f0 = np.stack([a, a])
    f1 = np.stack([np.ascontiguousarray(world[:, 4:4 + w]), other])
    ref = np.asarray(signals(jnp.asarray(f0), jnp.asarray(f1)))
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    got = torch.cat([*cal._signals_small(t0, t1, 0.65), *cal._signals_full(t0, t1, 0.65)]).numpy()
    assert np.abs(got - ref).max() <= 2e-4, (got, ref)
    # [ssim, warped] of (pan, cut), flagship path then router path: the pan
    # re-aligns under the warp, the cut does not
    assert got[2] > got[3] + 0.2 and got[6] > got[7] + 0.2, got


def test_refusals_and_missing_experts(clip, stub_experts, monkeypatch, tmp_path, capsys):
    with pytest.raises(SystemExit, match="shipped gate file"):
        cal.main(["--out", "weights/router_gate.json", "--device", "cpu"])
    # an expert whose weights file is absent is left out, by name
    real = cal.default_weights
    monkeypatch.setattr(cal, "default_weights", lambda n: None if n == "vfimamba" else real(n))
    w, h = QUALITY
    rows = cal._measure_rows(clip, 2, w, h, with_experts=True, device="cpu")
    assert rows and all("psnr_vfimamba" not in r and "psnr_rife_fast" in r for r in rows)
    assert "weights/vfimamba.npz not found" in capsys.readouterr().out
    # any other failure raises
    monkeypatch.setattr(cal, "default_weights", real)

    def boom(*a, **k):
        raise RuntimeError("expert failed")

    monkeypatch.setattr(texp, "_vfimamba_interpolate", boom)
    with pytest.raises(RuntimeError, match="expert failed"):
        cal._measure_rows(clip, 2, w, h, with_experts=True, device="cpu")


def test_cli_keeps_sections_from_the_gate_it_is_given(clip, stub_experts, tmp_path):
    """--skip-* sections come from --from; the file written loads through
    the port's readers."""
    out = tmp_path / "gate.json"
    w, h = QUALITY
    rec = cal.main(["--clip", clip, "--pairs", "3", "--stride", "1", "--width", str(w),
                    "--height", str(h), "--skip-experts", "--skip-bins", "--skip-scene-gate",
                    "--out", str(out), "--device", "cpu"])
    shipped = json.loads((ROOT / "weights" / "router_gate.json").read_text())
    disk = json.loads(out.read_text())
    assert disk == json.loads(json.dumps(rec))
    for k in ("experts", "expert_bins", "scene_gate"):
        assert disk[k] == shipped[k]
    assert disk["pairs_measured"] == 3 and len(disk["rows"]) == 3
    router_gate.clear_cache()
    assert router_gate.blend_crossover_px(str(out)) == disk["blend_vs_rife_crossover_px"]
    assert router_gate.scene_warp_threshold(str(out)) == shipped["scene_gate"]["warped_ssim_threshold"]
    assert router_gate.expert_bins("native", str(out)) == shipped["expert_bins"]["native"]
    assert router_gate.bin_winner("native", 8.0, path=str(out)) == "vfimamba"
    router_gate.clear_cache()
