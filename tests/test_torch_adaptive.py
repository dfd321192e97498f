"""vfisr_tpu_torch's adaptive router and pipeline held against vfisr_tpu's.

Inputs are numpy-made 64x96 frames: a smooth texture panned by d px per
frame, a static HUD box, and a cut to another texture. At this size the
shipped calibration (weights/router_gate.json) routes d = 0.1 (below
``bin_winner``'s 0.25 px static threshold) and d = 3 to RIFE and d = 1 to
VFIMamba, and the cut is held. The near-static streams drift 0.1 px rather
than 0: on an exactly static pair Farneback's solve is degenerate, and one
border pixel of the reference's flow takes 0.1 px from last-bit noise where
the port's stays 0 (the true flow). The experts injected into
both pipelines are narrow nets (RIFE channels 32/24/16/16 with 2 convs;
VFIMamba d_model 32, d_state 4, 2 blocks) with Flax-initialised parameters
plus seeded noise, carried to the port with ``params_from_jax``.

Tolerances, f32: booleans, HUD masks and routes equal; analysis signals
within 1e-4 (relative above 1; Farneback is an iterative solve summed in
another order); interpolated frames within 1e-4, or 2/255 with the windowed
warp, whose RIFE windows are bf16 (RIFEModel's config): a flow that differs
in its last f32 bits can move a bf16 tap weight across a rounding step (the
bound chip_smoke.py holds the kernel to in bf16 windows); uint8 frames
within 1 LSB.
Warps are the exact gather on both sides (each package's CPU default) or,
where marked, the windowed warp (``_torch_port.windowed_reference``).
"""

import contextlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import noisy_params, one_torch_thread, rel_err, windowed_reference
from vfisr_tpu.models.novel import adaptive_pipeline as jap
from vfisr_tpu.models.sota import rife as jrife, vfimamba as jvm
from vfisr_tpu.utils import router_gate as jgate
from vfisr_tpu_torch.models.novel import adaptive_pipeline as tap
from vfisr_tpu_torch.models.sota import rife as trife, vfimamba as tvm
from vfisr_tpu_torch.utils import router_gate as tgate
from vfisr_tpu_torch.utils.checkpoint import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
GATE = ROOT / "weights" / "router_gate.json"
H, W = 64, 96
TS = (0.25, 0.5, 0.75)
BOOL_SIGNALS = ("is_scene_change", "has_particles", "hud_mask")
FLOAT_SIGNALS = ("ssim", "warped_ssim", "motion_mean", "motion_max", "motion_std",
                 "particle_score", "hud_coverage")


def pan_frame(offset: float, texture: int = 0) -> np.ndarray:
    """[H,W,3] float frame on the uint8 grid: a smooth texture moved right
    by ``offset`` px, a static HUD box top left."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    x = xx - offset
    if texture == 0:
        f = np.stack([0.5 + 0.3 * np.sin(x / 5.0 + yy / 7.0),
                      0.5 + 0.3 * np.cos(x / 4.0) * np.sin(yy / 6.0),
                      0.5 + 0.2 * np.sin((x + yy) / 9.0)], -1)
    else:  # another scene, a cut: seeded random 2x2 blocks
        f = np.kron(np.random.default_rng(1).random((H // 2, W // 2, 3)), np.ones((2, 2, 1)))
    f[:H // 6, :W // 5] = (0.9, 0.9, 0.1)
    return (np.clip(np.floor(f * 255.0 + 0.5), 0, 255) / 255.0).astype(np.float32)


# per pair of the batch: (pan px per frame, cut at the last pair)
STREAMS = ((0.1, False), (0.1, False), (1, False), (3, False), (2, True))
ROUTES = ("rife", "rife", "vfimamba", "rife", "scene_change")
HISTORY = 5  # frames pushed before the measured pair: the HUD ring is full


def stream_batch(k: int):
    """(x0, x1) [5,H,W,3] of step k of the five streams."""
    x0 = np.stack([pan_frame(k * d) for d, _ in STREAMS])
    x1 = np.stack([pan_frame((k + 1) * d, texture=int(cut and k == HISTORY))
                   for d, cut in STREAMS])
    return x0, x1


def _np(v):
    return v.float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32)


def _same_signals(tsig, jsig):
    for k in BOOL_SIGNALS:
        assert np.array_equal(tsig[k].numpy(), np.asarray(jsig[k])), k
    for k in FLOAT_SIGNALS:
        assert rel_err(_np(tsig[k]), jsig[k]) <= 1e-4, k


@pytest.mark.parametrize("warp", ["exact", "windowed"])
def test_analyze_core_matches_with_full_history(warp):
    """_push_history + _analyze_core over a stream: every signal and the
    full-res HUD mask after the ring holds >= 5 frames."""
    thr = dict(scene_thr=0.65, scene_warp_thr=float(tgate.scene_warp_threshold()),
               particle_thr=0.4, hud_var_thr=10.0, hud_agree_eps=3.0)
    jh, jc = jnp.zeros((5, 10, 180, 320), jnp.float32), jnp.zeros((5,), jnp.int32)
    th, tc = torch.zeros((5, 10, 180, 320)), torch.zeros((5,), dtype=torch.int32)
    with (windowed_reference() if warp == "windowed" else contextlib.nullcontext()):
        for k in range(HISTORY + 1):
            x0, x1 = stream_batch(k)
            jh, jc = jap._push_history(jh, jc, jnp.asarray(x0))
            th, tc = tap._push_history(th, tc, torch.from_numpy(x0))
            assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-3
        jsig = jap._analyze_core(jnp.asarray(x0), jnp.asarray(x1), jh, jc, **thr)
        tsig = tap._analyze_core(torch.from_numpy(x0), torch.from_numpy(x1), th, tc, **thr)
    _same_signals(tsig, jsig)
    assert int(tc.min()) >= 5 and float(tsig["hud_coverage"].min()) > 0.01  # HUD engaged
    assert tsig["is_scene_change"].tolist() == [False] * 4 + [True]


def _write_gate(tmp_path, name, **over):
    gate = json.loads(GATE.read_text())
    for k, v in over.items():
        if v is None:
            gate.pop(k, None)
        else:
            gate[k] = v
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(gate))
    return path


def _gates(tmp_path):
    native = json.loads(GATE.read_text())["expert_bins"]["native"]
    losing = [dict(b, vfimamba=b["rife"] - 1.0) for b in native]
    return {
        "shipped": GATE,
        "no_bins": _write_gate(tmp_path, "no_bins", expert_bins=None),
        "losing_bins": _write_gate(tmp_path, "losing_bins",
                                   expert_bins={"native": losing, "sweep": []}),
        "gapped_bins": _write_gate(tmp_path, "gapped_bins", expert_bins={"native": [
            dict(native[1], motion_lo=1.0, motion_hi=3.0), dict(native[3], motion_lo=5.0)]}),
        "heavy_below": _write_gate(tmp_path, "heavy_below", expert_bins=None,
                                   experts={"rife": 33.0, "vfimamba": 31.0}),
        "absent": tmp_path / "absent.json",
    }


@pytest.fixture
def jax_gate(monkeypatch):
    """Points vfisr_tpu's router_gate at a file (it has no path argument in
    the router)."""
    def use(path):
        monkeypatch.setattr(jgate, "DEFAULT_PATH", Path(path))
        jgate.clear_cache()

    yield use
    jgate.clear_cache()


def test_gate_functions_match(tmp_path):
    motions = [0.0, 0.1, 0.25, 0.5, 1.218, 2.0, 4.0, 4.701, 5.5, 8.0, 12.0, 1e10, -1.0]
    for name, path in _gates(tmp_path).items():
        p = str(path)
        assert tgate.expert_bins("native", p) == jgate.expert_bins("native", p), name
        assert tgate.heavy_expert_allowed("vfimamba", "rife", p) == jgate.heavy_expert_allowed(
            "vfimamba", "rife", p), name
        assert tgate.blend_crossover_px(p) == jgate.blend_crossover_px(p), name
        assert tgate.scene_warp_threshold(p) == jgate.scene_warp_threshold(p), name
        for m in motions:
            for kw in ({}, {"margin_db": 0.0}, {"margin_db": 2.0, "static_eps_px": 0.0},
                       {"experts": ("vfimamba", "rife")}, {"experts": ("rife",)}):
                assert tgate.bin_winner("native", m, path=p, **kw) == jgate.bin_winner(
                    "native", m, path=p, **kw), (name, m, kw)
    # the shipped calibration: RIFE static and in 1.218-4.701 px, VFIMamba else
    assert [tgate.bin_winner("native", m) for m in (0.1, 0.5, 2.0, 5.0, 8.0, 30.0)] == [
        "rife", "vfimamba", "rife", "vfimamba", "vfimamba", "vfimamba"]
    assert tgate.load_gate(str(tmp_path / "absent.json")) is None


def test_routing_masks_match(tmp_path, jax_gate):
    mm = np.asarray([0.1, 0.5, 2.0, 5.0, 8.0, 30.0, 3.0, 0.0], np.float32)
    sig = {"motion_mean": mm,
           "motion_max": np.asarray([1, 2, 3, 30, 9, 40, 26, 0], np.float32),
           "has_particles": np.asarray([0, 0, 1, 0, 0, 0, 0, 0], bool),
           "is_scene_change": np.asarray([0, 0, 0, 0, 1, 0, 0, 0], bool)}
    for name, path in _gates(tmp_path).items():
        for quality_aware in (True, False):
            jax_gate(path)
            jr = jap.AdaptiveRouter(quality_aware=quality_aware)
            tr = tap.AdaptiveRouter(quality_aware=quality_aware, device="cpu", gate_path=str(path))
            assert tr.scene_warp_ssim_threshold == jr.scene_warp_ssim_threshold
            jm = jr.routing_masks({k: jnp.asarray(v) for k, v in sig.items()})
            tm = tr.routing_masks({k: torch.from_numpy(v) for k, v in sig.items()})
            for k in ("scene", "vfimamba", "rife"):
                assert tm[k].tolist() == np.asarray(jm[k]).tolist(), (name, quality_aware, k)


def test_load_gates_the_heavy_expert(tmp_path, jax_gate):
    """load() keeps VFIMamba iff the calibration shows it winning some
    native motion bin (or, without bins, at least RIFE's held-out PSNR)."""
    expect = {"losing_bins": False, "heavy_below": False, "shipped": True}
    gates = _gates(tmp_path)
    for name, want in expect.items():
        jax_gate(gates[name])
        jp = jap.AdaptivePipeline(device="cpu")
        jp.load()
        tp = tap.AdaptivePipeline(device="cpu", gate_path=str(gates[name]))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        tp.load()  # both experts run f32: TF32 off
        assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
        assert tp.enable_vfimamba == jp.enable_vfimamba == want, name
        assert (tp._vfimamba is not None) == want
    assert tp._vfimamba.variant == "full" and tp._vfimamba.info.parameters == 14_725_138
    with pytest.raises(FileNotFoundError):
        tap.AdaptivePipeline(device="cpu", vfimamba_weights=str(tmp_path / "none.npz")).load()


# ---- the pipeline, with narrow experts injected into both packages ----

RIFE_NARROW = dict(channels=(32, 24, 16, 16), num_convs=2)
MAMBA_NARROW = dict(d_model=32, d_state=4, dt_rank=4, layers=2, refine_levels=2)


def _experts():
    """(jax rife, jax vfimamba, port rife, port vfimamba), narrow, loaded."""
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    t = jnp.asarray([0.5])
    jr = jrife.RIFEModel(device="cpu", config=jrife.RIFEConfig(**RIFE_NARROW))
    rnet = jrife.IFNet(jr.CONFIG)
    rflat, jr.params = noisy_params(rnet.init(jax.random.PRNGKey(0), z, z, t)["params"], 1)
    jr._apply = jax.jit(lambda p, a, b, s: rnet.apply({"params": p}, a, b, s))
    jv = jvm.VFIMambaModel(device="cpu")
    jv.cfg = jvm.MambaConfig(**MAMBA_NARROW)
    vnet = jvm.VFIMambaNet(jv.cfg)
    vflat, jv.params = noisy_params(vnet.init(jax.random.PRNGKey(1), z, z, t)["params"], 2)
    jv._apply = jax.jit(lambda p, a, b, s: vnet.apply({"params": p}, a, b, s))

    tr = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(**RIFE_NARROW))
    tr.module = trife.IFNet(tr.CONFIG)
    tr.module.load_state_dict(params_from_jax(rflat))
    tv = tvm.VFIMambaModel(device="cpu")
    tv.cfg = tvm.MambaConfig(**MAMBA_NARROW)
    tv.module = tvm.VFIMambaNet(tv.cfg)
    tv.module.load_state_dict(params_from_jax(vflat))
    for m in (jr, jv, tr, tv):
        m._loaded = True
    tr.module.eval(), tv.module.eval()
    return jr, jv, tr, tv


@pytest.fixture(scope="module")
def experts():
    return _experts()


def _pipelines(experts, mode):
    jr, jv, tr, tv = experts
    jp = jap.AdaptivePipeline(device="cpu", route_mode=mode)
    tp = tap.AdaptivePipeline(device="cpu", route_mode=mode)
    jp._rife, jp._vfimamba, tp._rife, tp._vfimamba = jr, jv, tr, tv
    jp._loaded = tp._loaded = True
    return jp, tp


def _run_stream(pipe, to_dev):
    """Push HISTORY steps of the streams through the router, then one
    interpolate_batch call on the step after."""
    for k in range(HISTORY):
        pipe.router.analyze_device(*(to_dev(x) for x in stream_batch(k)))
    return pipe.interpolate_batch(*(to_dev(x) for x in stream_batch(HISTORY)), TS)


@pytest.mark.parametrize("mode,warp", [("hosted", "exact"), ("masked", "exact"),
                                       ("hosted", "windowed")])
def test_pipeline_matches(experts, mode, warp):
    jp, tp = _pipelines(experts, mode)
    with (windowed_reference() if warp == "windowed" else contextlib.nullcontext()):
        jout = _run_stream(jp, jnp.asarray)
        tout = _run_stream(tp, torch.from_numpy)
    assert tout.shape == jout.shape == (5, 3, H, W, 3)
    assert tp.stats.to_dict() == jp.stats.to_dict()
    assert tp.stats.to_dict() == {"total": 5, "rife": 3, "rife_pct": 60.0, "vfimamba": 1,
                                  "vfimamba_pct": 20.0, "scene_change": 1,
                                  "scene_change_pct": 20.0}
    tol = 2.0 / 255.0 if warp == "windowed" else 1e-4
    assert np.abs(tout.numpy() - np.asarray(jout)).max() <= tol
    # the cut pair's midpoints are its x0, but where the HUD composite (t >=
    # 0.5) takes x1; HUD pixels of the other pairs are their source's
    x0, x1 = stream_batch(HISTORY)
    for i, t in enumerate(TS):
        mid = tout[4, i].numpy()
        from_x0 = (mid == x0[4]).all(-1)
        assert from_x0.all() if t < 0.5 else (from_x0 | (mid == x1[4]).all(-1)).all()
    hud = np.zeros((H, W), bool)
    hud[:H // 6, :W // 5] = True
    for i, t in enumerate(TS):
        src = x0 if t < 0.5 else x1
        assert np.array_equal(tout[:4, i][:, hud], src[:4][:, hud])


def test_masked_equals_hosted(experts):
    """Both route modes give the same frames, within 1e-5: hosted runs each
    expert on its own runs of pairs, masked on the whole batch, and the
    VFIMamba matmuls sum in another order at another batch size."""
    outs = []
    for mode in ("hosted", "masked"):
        _, tp = _pipelines(experts, mode)
        outs.append(_run_stream(tp, torch.from_numpy))
        assert tp.stats.to_dict()["vfimamba"] == 1
    assert (outs[0] - outs[1]).abs().max() <= 1e-5


def test_per_pair_api_matches(experts):
    """analyze, process_pair, compute_motion and detect_scene_change on
    uint8 frames, the reference's per-pair API."""
    jp, tp = _pipelines(experts, "hosted")
    frames = [np.asarray(pan_frame(k) * 255.0 + 0.5, np.uint8) for k in range(HISTORY + 2)]
    for k in range(HISTORY):
        ja, ta = jp.router.analyze(frames[k], frames[k + 1]), tp.router.analyze(
            frames[k], frames[k + 1])
    for f in ("is_scene_change", "has_particles", "recommended_model"):
        assert getattr(ta, f) == getattr(ja, f), f
    for f in ("motion_mean", "motion_max", "motion_std", "hud_coverage", "confidence"):
        assert abs(getattr(ta, f) - getattr(ja, f)) <= 1e-4 * max(1.0, abs(getattr(ja, f))), f
    assert np.array_equal(tp.router.hud_mask, jp.router.hud_mask)
    jres = jp.process_pair(frames[HISTORY], frames[HISTORY + 1])
    tres = tp.process_pair(frames[HISTORY], frames[HISTORY + 1])
    assert tres.extra_info["analysis"]["recommended_model"] == "vfimamba"
    assert tres.extra_info["routing_stats"] == jres.extra_info["routing_stats"]
    assert len(tres.frames) == len(jres.frames) == 5
    for a, b in zip(tres.frames, jres.frames):
        assert a.shape == b.shape == (85, 127, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
    jm, tm = jp.router.compute_motion(frames[0], frames[3]), tp.router.compute_motion(
        frames[0], frames[3])
    assert all(abs(a - b) <= 1e-4 * max(1.0, abs(b)) for a, b in zip(tm[:3], jm[:3]))
    cut = np.asarray(pan_frame(0, texture=1) * 255.0 + 0.5, np.uint8)
    for pair in ((frames[0], frames[1]), (frames[0], cut)):
        (tc, ts), (jc, js) = (tp.router.detect_scene_change(*pair),
                              jp.router.detect_scene_change(*pair))
        assert tc == jc and abs(ts - js) <= 1e-5
