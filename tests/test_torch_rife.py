"""vfisr_tpu_torch's IFNet held against vfisr_tpu's, with the weights carried
by ``params_from_jax``.

f32 on both sides with the exact warp (each package's CPU default).
Tolerance 1e-4: the same network, with convolution sums taken in another
order (~1e-6 relative per layer through ~40 layers and the warps).
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import smooth_frames
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.utils.checkpoint import load_params
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "rife.npz"
TOL = 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _max_err(t: torch.Tensor, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def test_conv_transpose_carries_over():
    """Flax ConvTranspose(5, (4,4), strides=2, padding=1) == torch
    conv_transpose2d(flipped kernel, stride 2, padding 2)."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 7, 9, 6), np.float32)
    mod = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding=1)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": jnp.asarray(rng.normal(size=params["kernel"].shape), jnp.float32),
              "bias": jnp.asarray(rng.normal(size=(5,)), jnp.float32)}
    ref = mod.apply({"params": params}, jnp.asarray(x))
    sd = params_from_jax({f"ConvTranspose_0/{k}": np.asarray(v) for k, v in params.items()})
    deconv = torch.nn.ConvTranspose2d(6, 5, 4, stride=2, padding=2)
    deconv.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    out = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape == (2, 12, 16, 5)
    assert _max_err(out.detach(), ref) <= 1e-5


@pytest.mark.parametrize("hw", [(13, 17), (40, 72), (8, 24)])
def test_resize_bilinear_matches_jax_image_resize(hw):
    rng = np.random.default_rng(1)
    x = rng.random((2, 20, 36, 4), np.float32)
    ref = jrife._resize_bilinear(jnp.asarray(x), hw)
    out = trife._resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
    assert _max_err(out, ref) <= 1e-5


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny IFNet of tests/test_flagship.py, JAX-initialised; its
    zero-init ConvTranspose heads get random kernels so flows are nonzero."""
    cfg_j = jrife.RIFEConfig(scales=(4, 2, 1), channels=(16, 12, 8), num_convs=2,
                             warp_dtype=jnp.float32)
    module = jrife.IFNet(cfg_j)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                  jnp.zeros((1, 32, 32, 3)), jnp.asarray([0.5]))["params"]
    rng = np.random.default_rng(2)
    flat = _flat(jax.tree_util.tree_map(np.asarray, params))
    for k in flat:
        if k.startswith("block") and "ConvTranspose_0" in k:
            flat[k] = (rng.normal(size=flat[k].shape) * 0.05).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, _unflat(flat))
    cfg_t = trife.RIFEConfig(scales=(4, 2, 1), channels=(16, 12, 8), num_convs=2,
                             warp_dtype=torch.float32)
    tnet = trife.IFNet(cfg_t)
    tnet.load_state_dict(params_from_jax(flat))
    return module, params, tnet.eval()


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def test_tiny_ifnet_matches(tiny_pair):
    module, params, tnet = tiny_pair
    rng = np.random.default_rng(3)
    f = smooth_frames(rng, 4, 64, 96)
    t = np.array([0.25, 0.75], np.float32)
    ref = jax.jit(module.apply)({"params": params}, jnp.asarray(f[:2]), jnp.asarray(f[2:]),
                                jnp.asarray(t))
    with torch.no_grad():
        out = tnet(torch.from_numpy(f[:2]), torch.from_numpy(f[2:]), torch.from_numpy(t))
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.1  # flows really move
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _max_err(o, r) <= TOL


@pytest.fixture(scope="module")
def real_pair():
    """weights/rife.npz at full width, f32, on both sides."""
    cfg_j = jrife.RIFEConfig(dtype=jnp.float32, level_warp_radius=(2, 2), final_warp_radius=(3, 4))
    jparams = load_params(str(WEIGHTS))
    model = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(
        dtype=torch.float32, level_warp_radius=(2, 2), final_warp_radius=(3, 4)))
    model.load(str(WEIGHTS))
    return jrife.IFNet(cfg_j), jparams, model


def test_real_weights_load_every_key(real_pair):
    _, jparams, model = real_pair
    flat = load_npz(str(WEIGHTS))
    assert set(params_from_jax(flat)) == set(model.module.state_dict())
    assert model.param_count() == sum(v.size for v in flat.values())
    assert model.module.block0.Conv_0.weight.shape == (128, 12, 3, 3)


def test_real_weights_ifnet_matches(real_pair):
    module, jparams, model = real_pair
    rng = np.random.default_rng(4)
    f = smooth_frames(rng, 2, 64, 96)
    ref = jax.jit(module.apply)({"params": jparams}, jnp.asarray(f[:1]), jnp.asarray(f[1:]),
                                jnp.asarray([0.5]))
    with torch.no_grad():
        out = model.module(torch.from_numpy(f[:1]), torch.from_numpy(f[1:]), torch.tensor([0.5]))
    for o, r in zip(out, ref):
        assert _max_err(o, r) <= TOL


def test_real_weights_shared_flow_matches(real_pair):
    module, jparams, model = real_pair
    rng = np.random.default_rng(5)
    f = smooth_frames(rng, 4, 64, 96)
    ts = (0.25, 0.5, 0.75)
    ref = jax.jit(lambda p, a, b: jrife.shared_flow_apply(module, p, a, b, ts))(
        jparams, jnp.asarray(f[:2]), jnp.asarray(f[2:]))
    with torch.no_grad():
        out = trife.shared_flow_apply(model.module, torch.from_numpy(f[:2]), torch.from_numpy(f[2:]), ts)
    assert out.shape == ref.shape == (6, 64, 96, 3)
    assert _max_err(out, ref) <= TOL
