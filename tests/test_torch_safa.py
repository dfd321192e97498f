"""vfisr_tpu_torch's SAFA (models/sota/safa.py) held against vfisr_tpu's.

A narrow net (c = 40, 2 decoder blocks; parameters from Flax init plus
numpy noise, so the zero-init flow and pixel-shuffle heads carry signal)
and the full-width net from weights/safa.npz, on numpy-seeded frames.
Warps: the exact gather on both sides (each package's CPU default), and,
for the narrow net, the windowed warp the GPU runs: the Pallas kernel in
interpret mode (``_torch_port.windowed_reference``, which hands it the 40
channels in slices of 8: each channel's output is the same in any slice)
against the port's plain twin, which takes all 40 at once.

Tolerance: 1e-4 on the [0, 1] frame everywhere (f32 on both sides; the
convolutions' sums run in another order through up to 15 convs, the
feature warps and a clip; the Lanczos4 resample at 1.333 adds none). uint8
frames: 1 LSB.
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (game_frames, noisy_params, one_torch_thread, smooth_frames,
                         windowed_reference)
from vfisr_tpu.models.sota import safa as jsafa
from vfisr_tpu_torch.models.sota import safa as tsafa
from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "safa.npz"
TOL = 1e-4
NARROW = dict(c=40, num_dec_blocks=2)


def _pair(seed, n, h, w, shift=3):
    """A smooth frame and the same frame moved right by ``shift`` px (with
    fresh content entering on the left), [n,h,w,3] each."""
    big = smooth_frames(np.random.default_rng(seed), n, h, w + shift, cell=6)
    return big[:, :, shift:].copy(), big[:, :, :w].copy()


@pytest.fixture(scope="module")
def full():
    """(jax SAFAModel, port SAFAModel) loaded from weights/safa.npz."""
    jm, tm = jsafa.SAFAModel(), tsafa.SAFAModel(device="cpu")
    jm.load(), tm.load()
    return jm, tm


@pytest.fixture(scope="module")
def narrow():
    """(jax SAFAModel, port SAFAModel) with the narrow net injected."""
    jnet = jsafa.SAFANet(**NARROW)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    flat, tree = noisy_params(jnet.init(jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"],
                              6)
    jm, tm = jsafa.SAFAModel(), tsafa.SAFAModel(device="cpu")
    jm.params = tree
    jm._apply = jax.jit(lambda p, a, b, t: jnet.apply({"params": p}, a, b, t))
    tm.module = tsafa.SAFANet(**NARROW).eval().requires_grad_(False)
    tm.module.load_state_dict(params_from_jax(flat))
    jm._loaded = tm._loaded = True
    # op by op: the interpret-mode warps compile in seconds each, where one
    # jit of the whole net around them takes minutes
    jm._eager = lambda p, a, b, t: jnet.apply({"params": p}, a, b, t)
    return jm, tm


def _nets(jm, tm, x0, x1, ts, eager=False):
    apply = jm._eager if eager else jm._apply
    ref = np.asarray(apply(jm.params, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(ts)))
    out = tm.net(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(ts)).numpy()
    return out, ref


@pytest.mark.parametrize("warp", ["exact", "windowed"])
def test_narrow_net_matches(narrow, warp):
    jm, tm = narrow
    x0, x1 = _pair(1, 1, 40, 72)
    ts = np.array([0.3], np.float32)
    launches = []
    with (windowed_reference() if warp == "windowed" else contextlib.nullcontext()) as jwarp:
        if jwarp is not None:  # count the port's windowed warps and their widths
            import vfisr_tpu_torch.ops.cuda.warp as tw

            real = tw.warp_windowed

            def counting(img, *a, **k):
                launches.append(img.shape[-1])
                return real(img, *a, **k)

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tw, "warp_windowed", counting)
                out, ref = _nets(jm, tm, x0, x1, ts, eager=True)
        else:
            out, ref = _nets(jm, tm, x0, x1, ts)
    assert out.shape == ref.shape == (1, 80, 144, 3)
    assert np.abs(out - ref).max() <= TOL
    assert 0.05 < out.std()  # not a flat or saturated frame
    if warp == "windowed":  # six feature warps at 40 channels, two frame warps
        assert sorted(launches) == [3, 3] + [40] * 6


def test_full_width_net_from_checkpoint_matches(full):
    jm, tm = full
    assert tm.info.parameters == jm.info.parameters == sum(
        v.size for v in load_npz(str(WEIGHTS)).values())
    state = tm.module.state_dict()
    want = params_from_jax(load_npz(str(WEIGHTS)))
    assert set(state) == set(want) and all(torch.equal(state[k], want[k]) for k in want)
    assert {"Conv_0.weight", "Conv_2.bias", "dec_c.weight"} <= set(state)
    assert tuple(state["flow0_a.weight"].shape) == (176, 358, 3, 3)
    assert tuple(state["dec_a.weight"].shape) == (176, 353, 3, 3)
    assert tuple(state["dec_c.weight"].shape) == (176, 185, 3, 3)
    x0, x1 = _pair(2, 1, 32, 48)
    out, ref = _nets(jm, tm, x0, x1, np.array([0.5], np.float32))
    assert out.shape == ref.shape == (1, 64, 96, 3)
    assert np.abs(out - ref).max() <= TOL


def test_joint_2x_tiled_matches(full):
    """Tiles of (48, 64) with 16 px of overlap over a 70x100 pair (reflect
    padding past the bottom and right, a ragged grid), two timesteps."""
    jm, tm = full
    x0, x1 = _pair(3, 1, 70, 100)
    ts = np.array([0.25, 0.75], np.float32)
    ref = np.asarray(jm._joint_2x_tiled(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(ts),
                                        tile_hw=(48, 64), overlap=16))
    out = tm._joint_2x_tiled(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(ts),
                             tile_hw=(48, 64), overlap=16).numpy()
    assert out.shape == ref.shape == (2, 140, 200, 3)
    assert np.abs(out - ref).max() <= TOL


def test_joint_batch_process_and_interpolate_match(narrow):
    """joint_batch at 1.333 (padded to 16, then Lanczos4), joint_process
    (endpoints and midpoints, uint8) and interpolate_batch (scale 1.0)."""
    jm, tm = narrow
    x0, x1 = _pair(4, 2, 40, 56)
    ts = (0.25, 0.5, 0.75)
    ref = np.asarray(jm.joint_batch(jnp.asarray(x0), jnp.asarray(x1), ts, 1.333))
    out = tm.joint_batch(torch.from_numpy(x0), torch.from_numpy(x1), ts, 1.333).numpy()
    assert out.shape == ref.shape == (2, 3, 53, 74, 3)
    assert np.abs(out - ref).max() <= TOL
    ref = np.asarray(jm.interpolate_batch(jnp.asarray(x0), jnp.asarray(x1), ts))
    out = tm.interpolate_batch(torch.from_numpy(x0), torch.from_numpy(x1), ts).numpy()
    assert out.shape == ref.shape == (2, 3, 40, 56, 3)
    assert np.abs(out - ref).max() <= TOL
    u8 = game_frames(2, 40, 56)
    frames, jframes = tm.joint_process(u8[0], u8[1], 3, 1.333), jm.joint_process(u8[0], u8[1], 3, 1.333)
    assert len(frames) == len(jframes) == 5
    for a, b in zip(frames, jframes):
        assert a.dtype == np.uint8 and a.shape == np.asarray(b).shape == (53, 74, 3)
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
    mids, jmids = tm.interpolate(u8[0], u8[1], 1), jm.interpolate(u8[0], u8[1], 1)
    assert np.abs(mids[0].astype(int) - np.asarray(jmids[0]).astype(int)).max() <= 1
    res = tm.process_pair(u8[0], u8[1], 1, 1.333)
    assert res.model_used == "SAFA" and len(res.frames) == 3
    assert np.array_equal(tm.upscale(u8[0]), np.asarray(jm.upscale(u8[0])))


def test_budget_switch(narrow):
    """Above tile_px_budget input pixels joint_batch takes the tiled path
    (12 tiles of 360x480 for a 1080p pair; here the default tiles over a
    pair one pixel past the budget), else one padded call."""
    jm, tm = narrow
    assert tm.tile_px_budget == jm.tile_px_budget == 700_000
    assert (tm.TILE_HW, tm.OVERLAP) == ((360, 480), 48)
    calls = []
    real = tm.net

    def counting(a, b, ts):
        calls.append(tuple(a.shape))
        return real(a, b, ts)

    tm.net = counting
    try:
        x0, x1 = _pair(5, 1, 24, 40)
        for budget, want in ((24 * 40, [(2, 32, 48, 3)]), (24 * 40 - 1, [(2, 456, 576, 3)])):
            tm.tile_px_budget = jm.tile_px_budget = budget
            calls.clear()
            ref = np.asarray(jm.joint_batch(jnp.asarray(x0), jnp.asarray(x1), (0.5, 0.5), 2.0))
            out = tm.joint_batch(torch.from_numpy(x0), torch.from_numpy(x1), (0.5, 0.5), 2.0).numpy()
            assert calls == want
            assert out.shape == ref.shape == (1, 2, 48, 80, 3)
            assert np.abs(out - ref).max() <= TOL
    finally:
        tm.net = real
        tm.tile_px_budget = jm.tile_px_budget = 700_000
