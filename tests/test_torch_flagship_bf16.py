"""The port's FlagshipVFI in its bf16 deploy config held against vfisr_tpu's
fused step, end to end, with the windowed warp on both sides (see
test_torch_flagship.py for the set-up).

The port runs through its entry points (``FlagshipVFI.load`` of
weights/rife.npz and router_gate.json, then ``fused_stream_step``); the JAX
side runs ``make_flagship_step`` with the same deploy config, weights and
calibrated scene gate (its ``FlagshipVFI.load`` adds only an eager Flax
init, which costs more time here than the whole comparison).

Tolerance: bf16 activations round at other places in XLA and PyTorch, and
the IFNet carries those differences into its flows, so the bound is on the
uint8 output frames: max |diff| <= 6 LSB and mean |diff| <= 0.5 LSB
(measured on this input: max 3, mean <= 0.22), with the HUD ring count
equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import game_frames, one_torch_thread, windowed_reference
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.pipeline import flagship as jflag
from vfisr_tpu.utils.checkpoint import load_params
from vfisr_tpu.utils.router_gate import scene_warp_threshold
from vfisr_tpu_torch.pipeline import flagship as tflag

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "rife.npz"
N_PAIRS = 6


def test_flagship_vfi_bf16_deploy_matches():
    frames = game_frames(N_PAIRS + 1, 64, 96)
    ts = (0.25, 0.5, 0.75)
    tvfi = tflag.FlagshipVFI(device="cpu", config=tflag.FlagshipConfig(analysis_hw=(32, 64)))
    tvfi.load(str(WEIGHTS))
    cfg = tvfi._module.config
    assert (cfg.dtype, cfg.warp_dtype) == (torch.bfloat16, torch.bfloat16)
    assert (cfg.level_warp_radius, cfg.final_warp_radius) == ((2, 2), (3, 4))
    assert tvfi.base_config.scene_warp_ssim_threshold == float(scene_warp_threshold())

    jmod = jrife.IFNet(jrife.RIFEConfig(dtype=jnp.bfloat16, level_warp_radius=(2, 2),
                                        final_warp_radius=(3, 4)))
    jcfg = jflag.FlagshipConfig(out_hw=(85, 127), analysis_hw=(32, 64), timestamps=ts,
                                scene_warp_ssim_threshold=float(scene_warp_threshold()))
    jh, jc = jflag.init_history(1)
    with windowed_reference():
        jstep = jax.jit(jflag.make_flagship_step(jmod, load_params(str(WEIGHTS)), jcfg))
        for i in range(N_PAIRS):
            x0 = jnp.asarray(frames[i], jnp.float32)[None] / 255.0
            x1 = jnp.asarray(frames[i + 1], jnp.float32)[None] / 255.0
            jup, _, jh, jc, _ = jstep(x0, x1, jh, jc)
            tup = tvfi.fused_stream_step(frames[i], frames[i + 1], 1.333, ts)
            assert tup.dtype == torch.uint8 and tup.shape == jup.shape == (4, 85, 127, 3)
            diff = np.abs(tup.numpy().astype(int) - np.asarray(jup).astype(int))
            assert diff.max() <= 6 and diff.mean() <= 0.5, (i, diff.max(), diff.mean())
            assert np.array_equal(tvfi._hist[1].numpy(), np.asarray(jc))
