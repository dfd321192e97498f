"""vfisr_tpu_torch's VFIMamba held against vfisr_tpu's.

Parameters come from Flax (``init``, then seeded noise on every leaf so the
zero-init heads carry signal) and are carried to the port with
``params_from_jax``; the full-width net loads weights/vfimamba.npz on both
sides. Inputs are numpy-seeded.

Tolerances, f32 on both sides:
- ``selective_scan`` against ``_selective_scan`` + ``sum(h * C)``: 1e-5 of
  the largest |y|. The port runs the recurrence step by step where the
  reference runs a log-depth associative scan, so the f32 sums are taken in
  another order.
- ``S6`` and ``BiMambaBlock``: 1e-5 of the largest output.
- ``VFIMambaNet``: 1e-4 on the [0, 1] frame, 1e-3 px on the flow: the scan
  order above, LayerNorm's variance formula (Flax: E[x^2] - E[x]^2) and the
  convolution sums in another order, through 2-12 blocks, the refinement
  pyramid and the warps.
Warps are the exact gather on both sides (each package's CPU default), and
the narrow net also runs with the windowed warp (the Pallas kernel in
interpret mode, ``_torch_port.windowed_reference``, against the port's
plain twin), the semantics the GPU runs.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import noisy_params, one_torch_thread, rel_err, smooth_frames, windowed_reference
from vfisr_tpu.core.resize import resize as jresize
from vfisr_tpu.models.sota import vfimamba as jvm
from vfisr_tpu.utils.checkpoint import _flatten, load_params as jload_params
from vfisr_tpu_torch.core.resize import resize as tresize
from vfisr_tpu_torch.models.sota import vfimamba as tvm
from vfisr_tpu_torch.utils.checkpoint import load_npz, load_params, params_from_jax, params_to_jax

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "vfimamba.npz"
NARROW = dict(d_model=32, d_state=4, dt_rank=4, layers=2, refine_levels=2)


def _unflat(flat: dict) -> dict:
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def _torch(module, flat):
    module.load_state_dict(params_from_jax(flat))
    return module.eval()


@pytest.mark.parametrize("length", [45, 100, 8])
def test_selective_scan_matches(length):
    """Across chunk boundaries (SCAN_CHUNK = 32): 45 and 100 steps, and
    within one chunk: 8."""
    rng = np.random.default_rng(length)
    r, di, s = 3, 6, 4
    dt = np.log1p(np.exp(rng.normal(size=(r, length, di)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(di, s))).astype(np.float32)
    u, B, C = (rng.normal(size=shape).astype(np.float32)
               for shape in ((r, length, di), (r, length, s), (r, length, s)))
    a = jnp.exp(jnp.asarray(dt)[..., None] * A)
    b = (jnp.asarray(dt) * u)[..., None] * jnp.asarray(B)[:, :, None, :]
    ref = jnp.sum(jvm._selective_scan(a, b) * jnp.asarray(C)[:, :, None, :], axis=-1)
    out = tvm.selective_scan(*(torch.from_numpy(v) for v in (dt, A, u, B, C)))
    assert out.shape == ref.shape
    assert rel_err(out.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("kind", ["S6", "BiMambaBlock"])
def test_s6_and_block_match(kind):
    cfg_kw = dict(d_model=32, d_state=4, dt_rank=4)
    jmod = getattr(jvm, kind)(jvm.MambaConfig(**cfg_kw))
    x = np.random.default_rng(1).normal(size=(3, 21, 32)).astype(np.float32)
    flat, tree = noisy_params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2, 0.2)
    ref = jmod.apply({"params": tree}, jnp.asarray(x))
    tmod = _torch(getattr(tvm, kind)(tvm.MambaConfig(**cfg_kw)), flat)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x))
    assert rel_err(out.numpy(), ref) <= 1e-5


def _net_pair(cfg_kw, seed=0):
    jmod = jvm.VFIMambaNet(jvm.MambaConfig(**cfg_kw))
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    flat, tree = noisy_params(jmod.init(jax.random.PRNGKey(seed), z, z, jnp.asarray([0.5]))["params"],
                              seed + 5)
    return jmod, flat, tree, _torch(tvm.VFIMambaNet(tvm.MambaConfig(**cfg_kw)), flat)


def _check_net(jmod, jparams, tmod, x0, x1, ts):
    ref = jax.jit(lambda p, a, b, t: jmod.apply({"params": p}, a, b, t))(
        jparams, jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(ts))
    with torch.no_grad():
        out = tmod(torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(ts))
    (om, of, ok), (rm, rf, rk) = out, ref
    assert om.shape == rm.shape and of.shape == rf.shape and ok.shape == rk.shape
    assert float(np.abs(np.asarray(rf)).max()) > 0.05  # the flow heads are live
    assert np.abs(of.numpy() - np.asarray(rf)).max() <= 1e-3
    assert np.abs(ok.numpy() - np.asarray(rk)).max() <= 1e-4
    assert np.abs(om.numpy() - np.asarray(rm)).max() <= 1e-4


@pytest.mark.parametrize("refine_levels", [2, 0])
def test_narrow_net_matches_exact_warp(refine_levels):
    jmod, _, tree, tmod = _net_pair(dict(NARROW, refine_levels=refine_levels))
    frames = smooth_frames(np.random.default_rng(3), 4, 64, 96)
    ts = np.asarray([0.25, 0.75], np.float32)
    _check_net(jmod, tree, tmod, frames[:2], frames[2:], ts)


def test_narrow_net_matches_windowed_warp():
    jmod, _, tree, tmod = _net_pair(NARROW, seed=1)
    frames = smooth_frames(np.random.default_rng(4), 2, 64, 96)
    with windowed_reference():
        _check_net(jmod, tree, tmod, frames[:1], frames[1:], np.asarray([0.5], np.float32))


def test_full_width_model_matches():
    """weights/vfimamba.npz (d_model 256, 12 blocks, d_state 16, refine
    levels 2) through both packages' VFIMambaModel at 64x64, 3 timesteps."""
    jm = jvm.VFIMambaModel(variant="full", device="cpu")
    jm.load(str(WEIGHTS))
    tm = tvm.VFIMambaModel(variant="full", device="cpu")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tm.load(str(WEIGHTS))  # the net runs f32: TF32 off
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert tm.info.parameters == jm.info.parameters == sum(
        v.size for v in load_npz(str(WEIGHTS)).values())
    frames = smooth_frames(np.random.default_rng(5), 2, 64, 64)
    ts = (0.25, 0.5, 0.75)
    ref = jm.interpolate_batch(jnp.asarray(frames[:1]), jnp.asarray(frames[1:]), ts)
    out = tm.interpolate_batch(torch.from_numpy(frames[:1]), torch.from_numpy(frames[1:]), ts)
    assert out.shape == ref.shape == (1, 3, 64, 64, 3)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-4


def test_partial_load_of_a_checkpoint_without_refinement(tmp_path):
    """A checkpoint without the refine_lvl* stages (v1) loads with
    ``partial`` semantics: the stages keep their init (the zero-init last
    conv makes them a no-op) and both packages give the same output."""
    flat = {k: v for k, v in load_npz(str(WEIGHTS)).items() if not k.startswith("refine_lvl")}
    path = tmp_path / "vfimamba_v1.npz"
    np.savez(path, **flat)
    jm = jvm.VFIMambaModel(variant="full", device="cpu")
    with pytest.warns(UserWarning, match="absent"):
        jm.load(str(path))
    tm = tvm.VFIMambaModel(variant="full", device="cpu")
    with pytest.warns(UserWarning, match="absent"):
        tm.load(str(path))
    got = params_to_jax(tm.module.state_dict())
    assert all(np.array_equal(got[k], v) for k, v in flat.items())
    assert all(np.abs(got[k]).max() == 0 for k in got if k.startswith("refine_lvl")
               and k.split("/")[0].endswith("_c2"))
    with pytest.raises(ValueError, match="missing"):
        load_params(str(path), got)
    frames = smooth_frames(np.random.default_rng(6), 2, 64, 64)
    ref = jm.interpolate_batch(jnp.asarray(frames[:1]), jnp.asarray(frames[1:]), (0.5,))
    out = tm.interpolate_batch(torch.from_numpy(frames[:1]), torch.from_numpy(frames[1:]), (0.5,))
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-4


def test_load_params_matches_reference(tmp_path):
    """The port's load_params keeps the reference's key set and values,
    strict and partial, including a checkpoint's extra keys."""
    like = {"a/kernel": np.ones((2, 3), np.float32), "b/bias": np.zeros(3, np.float32)}
    path = tmp_path / "p.npz"
    np.savez(path, **{"a/kernel": np.full((2, 3), 2.0, np.float32), "c/bias": np.ones(2)})
    ref = _flatten(jload_params(str(path), _unflat(like), partial=True))
    with pytest.warns(UserWarning):
        got = load_params(str(path), like, partial=True)
    assert set(got) == set(ref) == set(like)
    assert all(np.array_equal(got[k], np.asarray(ref[k])) for k in got)
    np.savez(path, **{"a/kernel": np.ones((3, 2), np.float32), "b/bias": np.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        load_params(str(path), like)


def test_flax_layouts_round_trip():
    """Dense, LayerNorm and S6's conv_w carry over both ways."""
    jmod = jvm.BiMambaBlock(jvm.MambaConfig(d_model=16, d_state=4, dt_rank=4))
    flat = _flatten(jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 16)))["params"])
    state = params_from_jax(flat)
    assert state["LayerNorm_0.weight"].shape == (16,)
    assert state["s6_fwd.conv_w"].shape == (32, 1, 4)
    assert state["Dense_0.weight"].shape == (32, 16)
    tmod = tvm.BiMambaBlock(tvm.MambaConfig(d_model=16, d_state=4, dt_rank=4))
    tmod.load_state_dict(state)  # strict: every key and shape
    back = params_to_jax(tmod.state_dict())
    assert set(back) == set(flat)
    assert all(np.array_equal(back[k], np.asarray(flat[k])) for k in flat)


@pytest.mark.parametrize("hw,out", [((8, 12), (16, 24)), ((17, 12), (68, 96)), ((5, 7), (9, 20))])
def test_upsample_is_jax_image_resize_bilinear(hw, out):
    x = np.random.default_rng(7).normal(size=(2, *hw, 5)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *out, 5), "bilinear")
    got = tvm._upsample(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6


@pytest.mark.parametrize("size", [(16, 24), (32, 48), (21, 30), (90, 130)])
def test_area_resize_matches(size):
    x = smooth_frames(np.random.default_rng(8), 2, 64, 96)
    ref = jresize(jnp.asarray(x), size, "area")
    out = tresize(torch.from_numpy(x), size, "area")
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5


def test_internal_area_cap_matches_away_from_the_edge():
    """Above the cap the trunk runs area-downscaled and the midpoints are
    Lanczos-upscaled back; at an exact halving both packages' sizes agree."""
    jmod, _, tree, tmod = _net_pair(NARROW, seed=2)
    jm = jvm.VFIMambaModel(device="cpu", max_internal_area=32 * 48)
    jm.cfg, jm.params = jmod.cfg, tree
    jm._apply = jax.jit(lambda p, a, b, t: jmod.apply({"params": p}, a, b, t))
    tm = tvm.VFIMambaModel(device="cpu", max_internal_area=32 * 48)
    tm.module = tmod
    frames = smooth_frames(np.random.default_rng(9), 2, 64, 96)
    ref = jm.interpolate_batch(jnp.asarray(frames[:1]), jnp.asarray(frames[1:]), (0.5,))
    out = tm.interpolate_batch(torch.from_numpy(frames[:1]), torch.from_numpy(frames[1:]), (0.5,))
    assert out.shape == ref.shape == (1, 1, 64, 96, 3)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-4


def test_internal_area_cap_floors_a_sliver_over():
    """An input a sliver over the cap: the reference's rounded sizes land
    over the cap again (so it recurses without end); the port's floored
    sizes land under it and the call finishes."""
    cap, (h, w) = 32 * 32, (28, 37)
    s = (cap / float(h * w)) ** 0.5
    assert round(h * s) * round(w * s) > cap  # the reference's fault
    assert int(h * s) * int(w * s) <= cap
    *_, tmod = _net_pair(NARROW, seed=3)
    tm = tvm.VFIMambaModel(device="cpu", max_internal_area=cap)
    tm.module = tmod
    frames = smooth_frames(np.random.default_rng(10), 2, h, w)
    out = tm.interpolate_batch(torch.from_numpy(frames[:1]), torch.from_numpy(frames[1:]), (0.5,))
    assert out.shape == (1, 1, h, w, 3) and torch.isfinite(out).all()
