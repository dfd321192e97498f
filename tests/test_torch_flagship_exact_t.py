"""The flagship step's per-timestep branch (``FlagshipConfig.shared_flow=
False``) in vfisr_tpu_torch held against vfisr_tpu's.

One step at the existing flagship tests' size (64x96 in, 96x128 out,
analysis 32x64) with a narrow IFNet (``_torch_port.RIFE_NARROW``, the
deploy radii, f32) carrying the same seeded parameters in both packages,
each package's exact CPU warp. The per-timestep step runs the IFNet once
on the pair repeated T times, timestamps tiled pair-major. Tolerances as
tests/test_torch_flagship.py: mids within 1e-4, uint8 frames within 1 LSB,
boolean signals equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port import RIFE_NARROW, game_frames, noisy_params, one_torch_thread
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.pipeline import flagship as jflag
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.pipeline import flagship as tflag
from vfisr_tpu_torch.utils.checkpoint import params_from_jax

RADII = dict(level_warp_radius=(2, 2), final_warp_radius=(3, 4))
CFG = dict(out_hw=(96, 128), analysis_hw=(32, 64), shared_flow=False)


def test_per_timestep_step_matches():
    jnet = jrife.IFNet(jrife.RIFEConfig(warp_dtype=jnp.float32, **RIFE_NARROW, **RADII))
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"]
    flat, tree = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), 21)
    tnet = trife.IFNet(trife.RIFEConfig(warp_dtype=torch.float32, **RIFE_NARROW, **RADII))
    tnet.load_state_dict(params_from_jax(flat))
    tnet.eval().requires_grad_(False)

    frames = game_frames(2, 64, 96)
    x0, x1 = (frames[i:i + 1].astype(np.float32) / 255.0 for i in (0, 1))
    jstep = jax.jit(jflag.make_flagship_step(jnet, tree, jflag.FlagshipConfig(**CFG)))
    jup, jmids, _, _, jsig = jstep(jnp.asarray(x0), jnp.asarray(x1), *jflag.init_history(1))
    tcfg = tflag.FlagshipConfig(**CFG)
    tstep = tflag.make_flagship_step(tnet, tcfg)
    tup, tmids, _, _, tsig = tstep(torch.from_numpy(x0), torch.from_numpy(x1),
                                   *tflag.init_history(1, "cpu"))
    assert tup.shape == jup.shape == (4, 96, 128, 3) and tmids.shape == jmids.shape
    for k in ("is_scene_change", "route_vfimamba", "hud_mask_small"):
        assert np.array_equal(tsig[k].numpy(), np.asarray(jsig[k])), k
    assert float(np.abs(tmids.numpy() - np.asarray(jmids)).max()) <= 1e-4
    assert np.abs(tup.numpy().astype(int) - np.asarray(jup).astype(int)).max() <= 1

    # the branch is another computation than the shared-flow step's
    shared = tflag.make_flagship_step(tnet, dataclasses.replace(tcfg, shared_flow=True))
    smids = shared(torch.from_numpy(x0), torch.from_numpy(x1), *tflag.init_history(1, "cpu"))[1]
    assert float((smids - tmids).abs().max()) > 1e-3


def test_flagship_vfi_threads_shared_flow():
    """FlagshipVFI builds its steps from the config it holds, and a change
    of timestamps keeps shared_flow (as dataclasses.replace does in the
    reference's fused_stream_step)."""
    vfi = tflag.FlagshipVFI(device="cpu", config=tflag.FlagshipConfig(
        analysis_hw=(32, 64), shared_flow=False))
    vfi._module = trife.IFNet(trife.RIFEConfig(warp_dtype=torch.float32, **RIFE_NARROW, **RADII))
    vfi._module.eval().requires_grad_(False)
    vfi._loaded = True
    calls = []
    real = trife.shared_flow_apply
    tflag.shared_flow_apply = lambda *a: calls.append(a) or real(*a)
    try:
        frames = game_frames(3, 64, 96)
        up = vfi.fused_stream_step(frames[0], frames[1], 1.333, (0.5,))
        assert up.shape == (2, 85, 127, 3)
        assert vfi.base_config.shared_flow is False and vfi.base_config.timestamps == (0.5,)
        assert len(vfi.process_pair(frames[1], frames[2], num_intermediate=2).frames) == 4
        assert vfi.base_config.shared_flow is False and not calls
        # interpolate_batch is shared-flow whatever the config says
        x = torch.from_numpy(frames[:2].astype(np.float32) / 255.0)
        assert vfi.interpolate_batch(x[:1], x[1:], (0.25, 0.5)).shape == (1, 2, 64, 96, 3)
        assert len(calls) == 1
    finally:
        tflag.shared_flow_apply = real
