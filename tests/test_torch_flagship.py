"""vfisr_tpu_torch's fused flagship step held against vfisr_tpu's, end to end.

Both sides run the windowed warp (the semantics the weights were trained
through): the JAX package through the Pallas kernel in interpret mode
(``_torch_port.windowed_reference``), the port through the kernel's plain
twin. Inputs are synthetic gameplay frames (gradient, moving textured
rectangle, static HUD box) at 64x96, output 96x128, analysis 32x64, run as
a stream so the HUD ring fills and the HUD composite engages.

Tolerances (f32 IFNet): signals equal (booleans) or within 1e-4; mids
within 1e-4; uint8 frames within 1 LSB. The bf16 deploy config is held in
test_torch_flagship_bf16.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import game_frames, windowed_reference
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.pipeline import flagship as jflag
from vfisr_tpu.utils.checkpoint import load_params
from vfisr_tpu.utils.router_gate import scene_warp_threshold
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.pipeline import flagship as tflag

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights" / "rife.npz"
N_PAIRS = 7  # the HUD ring needs 5 frames before the composite engages
BOOL_SIGNALS = ("is_scene_change", "has_particles", "route_vfimamba", "hud_mask_small")
FLOAT_SIGNALS = ("ssim", "warped_ssim", "motion_mean", "motion_max", "motion_std",
                 "particle_score", "hud_coverage")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_flagship_step_f32_matches():
    frames = game_frames(N_PAIRS + 1, 64, 96)
    cfg_kw = dict(out_hw=(96, 128), analysis_hw=(32, 64),
                  scene_warp_ssim_threshold=float(scene_warp_threshold()))
    jmod = jrife.IFNet(jrife.RIFEConfig(dtype=jnp.float32, warp_dtype=jnp.float32,
                                        level_warp_radius=(2, 2), final_warp_radius=(3, 4)))
    jparams = load_params(str(WEIGHTS))
    tmodel = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(
        dtype=torch.float32, warp_dtype=torch.float32,
        level_warp_radius=(2, 2), final_warp_radius=(3, 4)))
    tmodel.load(str(WEIGHTS))
    tstep = tflag.make_flagship_step(tmodel.module, tflag.FlagshipConfig(**cfg_kw))
    jh, jc = jflag.init_history(1)
    th, tc = tflag.init_history(1, "cpu")
    hud_seen = False
    with windowed_reference():
        jstep = jax.jit(jflag.make_flagship_step(jmod, jparams, jflag.FlagshipConfig(**cfg_kw)))
        for i in range(N_PAIRS):
            x0 = frames[i:i + 1].astype(np.float32) / 255.0
            x1 = frames[i + 1:i + 2].astype(np.float32) / 255.0
            jup, jmids, jh, jc, jsig = jstep(jnp.asarray(x0), jnp.asarray(x1), jh, jc)
            tup, tmids, th, tc, tsig = tstep(torch.from_numpy(x0), torch.from_numpy(x1), th, tc)
            assert tup.dtype == torch.uint8 and tup.shape == jup.shape == (4, 96, 128, 3)
            for k in BOOL_SIGNALS:
                assert np.array_equal(tsig[k].numpy(), np.asarray(jsig[k])), k
            for k in FLOAT_SIGNALS:
                np.testing.assert_allclose(_np(tsig[k]), _np(jsig[k]), rtol=1e-4, atol=1e-4,
                                           err_msg=k)
            np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4)
            assert np.array_equal(tc.numpy(), np.asarray(jc))
            assert np.abs(_np(tmids) - _np(jmids)).max() <= 1e-4
            diff = np.abs(tup.numpy().astype(int) - np.asarray(jup).astype(int))
            assert diff.max() <= 1
            hud_seen |= bool(np.asarray(jsig["hud_coverage"])[0] > 0.01)
    assert hud_seen  # the HUD composite was exercised


def test_flagship_vfi_entry_points_cpu():
    vfi = tflag.FlagshipVFI(device="cpu", config=tflag.FlagshipConfig(analysis_hw=(32, 64)))
    frames = game_frames(3, 64, 96)
    res = vfi.process_pair(frames[0], frames[1])
    assert len(res.frames) == 5 and res.frames[0].shape == (85, 127, 3)
    assert res.frames[0].dtype == np.uint8 and res.model_used == "FlagshipAdaptiveVFI"
    assert set(res.extra_info) == {"is_scene_change", "motion_mean", "hud_coverage", "route_vfimamba"}
    assert int(vfi._hist[1][0]) == 1
    up = vfi.fused_stream_step(frames[1], frames[2], 1.333, (0.25, 0.5, 0.75))
    assert up.shape == (4, 85, 127, 3) and int(vfi._hist[1][0]) == 2
    x = torch.from_numpy(frames[:2].astype(np.float32) / 255.0)
    mids = vfi.interpolate_batch(x[:1], x[1:], (0.5,))
    assert mids.shape == (1, 1, 64, 96, 3)
    assert vfi.upscale_batch(x).shape == (2, 85, 127, 3)
    assert vfi.info.parameters == sum(v.size for v in np.load(WEIGHTS).values())


def test_history_ring_shifts():
    hist, cnt = tflag.init_history(1, "cpu")
    h2, c2 = tflag.push_history(hist, cnt, torch.full((1, 32, 48, 3), 0.5))
    assert int(c2[0]) == 1
    assert float(h2[:, -1].abs().sum()) > 0 and float(h2[:, 0].abs().sum()) == 0


def test_port_imports_no_jax_cv2_or_reference():
    """Importing every module of the port (the trainer, its CLI included),
    and chip_smoke.py, pulls in no jax, no cv2 and nothing of vfisr_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vfisr_tpu_torch\n"
        "for m in pkgutil.walk_packages(vfisr_tpu_torch.__path__, 'vfisr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('train', 'train.train', 'train.device_data', 'train.__main__'):\n"
        "    importlib.import_module('vfisr_tpu_torch.' + m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cv2', 'vfisr_tpu', 'flax'))\n"
        "print(len([m for m in sys.modules if m.startswith('vfisr_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
