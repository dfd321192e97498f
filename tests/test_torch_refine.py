"""RIFE's RefineNet (``RIFEConfig.refine``) in vfisr_tpu_torch held against
vfisr_tpu's.

A narrow IFNet (scales (2, 1), channels (16, 8), one trunk conv per block,
f32, each package's exact CPU warp) with ``refine=True`` and the same
seeded normal parameters in both packages: the RefineNet's transpose conv
starts at zero in both, so a fresh head adds nothing and the noise is what
makes the check see it. Tolerances: frames in [0, 1] within 1e-4 (the
same network, conv sums in another order); a scalar loss's gradient
within 1e-3 of the largest gradient of each parameter, as
tests/test_torch_train.py holds a narrow IFNet's step; the checkpoint
round trip exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import noisy_params, one_torch_thread, smooth_frames
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax

NARROW = dict(scales=(2, 1), channels=(16, 8), num_convs=1, refine=True)
HW = (32, 48)


@pytest.fixture(scope="module")
def nets():
    jcfg = jrife.RIFEConfig(warp_dtype=jnp.float32, **NARROW)
    jnet = jrife.IFNet(jcfg)
    z = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"]
    flat, tree = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), 11)
    tnet = trife.IFNet(trife.RIFEConfig(warp_dtype=torch.float32, **NARROW))
    tnet.load_state_dict(params_from_jax(flat))
    return jnet, tree, flat, tnet


def _inputs():
    f = smooth_frames(np.random.default_rng(12), 4, *HW)
    return f[:2], f[2:], np.asarray([0.3, 0.5], np.float32)


def test_refine_keys_round_trip_exactly(nets):
    _, _, flat, tnet = nets
    keys = {k for k in flat if k.startswith("refine/")}
    assert keys == {f"refine/{m}/{p}" for m in ("Conv_0", "Conv_1", "ConvTranspose_0")
                    for p in ("kernel", "bias")}
    back = params_to_jax(tnet.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)])
def test_same_transpose_conv_is_torch_padding_one(hw):
    """Flax ConvTranspose(3, (4,4), strides 2, padding "SAME") equals torch
    conv_transpose2d(padding=1) with the flipped kernel: output 2H x 2W."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    layer = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    params = {"kernel": jnp.asarray(rng.normal(size=(4, 4, 5, 3)).astype(np.float32)),
              "bias": jnp.asarray(rng.normal(size=(3,)).astype(np.float32))}
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    sd = params_from_jax({f"ConvTranspose_0/{k}": np.asarray(v) for k, v in params.items()})
    conv = torch.nn.ConvTranspose2d(5, 3, 4, stride=2, padding=1)
    conv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        out = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    assert float(np.abs(out - ref).max()) <= 1e-5


def test_refine_forward_matches(nets):
    jnet, tree, _, tnet = nets
    a, b, t = _inputs()
    ref = jnet.apply({"params": tree}, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
    with torch.no_grad():
        out = tnet(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        assert float(np.abs(o.numpy() - np.asarray(r)).max()) <= 1e-4
    # the head is live: without it the frame is another one
    plain = {k: v for k, v in tree.items() if k != "refine"}
    off = jrife.IFNet(jrife.RIFEConfig(warp_dtype=jnp.float32, **dict(NARROW, refine=False)))
    ref_off = off.apply({"params": plain}, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))[0]
    assert float(np.abs(np.asarray(ref_off) - np.asarray(ref[0])).max()) > 1e-3


def test_refine_gradient_matches(nets):
    jnet, tree, _, tnet = nets
    a, b, t = _inputs()
    gt = smooth_frames(np.random.default_rng(14), 2, *HW)

    def jloss(p):
        merged = jnet.apply({"params": p}, jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))[0]
        return jnp.mean(jnp.abs(merged - jnp.asarray(gt)))

    jl, jg = jax.value_and_grad(jloss)(tree)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jg)}
    tnet.zero_grad()
    net = tnet.train().requires_grad_(True)
    loss = (net(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))[0]
            - torch.from_numpy(gt)).abs().mean()
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5
    grads = params_to_jax({k: p.grad for k, p in net.named_parameters()})
    assert set(grads) == set(jflat) and any(k.startswith("refine/") for k in grads)
    for k, g in grads.items():
        scale = max(float(np.abs(jflat[k]).max()), 1e-6)
        assert float(np.abs(g - jflat[k]).max()) <= 1e-3 * scale, k
    assert float(np.abs(grads["refine/ConvTranspose_0/kernel"]).max()) > 0
