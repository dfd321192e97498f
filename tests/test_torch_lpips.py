"""vfisr_tpu_torch/evaluation/lpips.py against vfisr_tpu/evaluation/lpips.py.

Both packages take the same frames (numpy, from a seed) in each weight
mode: random features (the seeded AlexNet with uniform heads), calibrated
heads (weights/lpips_heads.npz), and official weights from a file written
in the JAX package's layout. Tolerances: ``_init_params`` equal, element
for element; distances, distance maps and FloLPIPS within 1e-5 relative
(f32 convs with sums in another order); ``image_resize`` within 1e-6 of
``jax.image.resize``.
"""

from importlib import import_module

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import game_frames, one_torch_thread
from vfisr_tpu_torch.evaluation import lpips as tl

jl = import_module("vfisr_tpu.evaluation.lpips")

H, W = 120, 160


def _frames():
    """Two HWC uint8 frames of a pan, and a float NHWC batch of two."""
    f = game_frames(3, H, W, step=6.0)
    noisy = np.clip(f[2] + np.random.default_rng(0).normal(0, 10, f[2].shape), 0, 255)
    return f[0], f[1], np.stack([f[1], noisy]).astype(np.float32) / 255.0


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture
def tf32_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("seed", [0, 7])
def test_init_params_equal(seed):
    ref, out = jl._init_params(seed), tl._init_params(seed)
    assert ref.keys() == out.keys()
    assert all(out[k].dtype == ref[k].dtype and np.array_equal(out[k], ref[k]) for k in ref)


@pytest.mark.parametrize("calibrated,mode", [(False, "random_features"),
                                             (True, "calibrated_heads")])
def test_distance_matches(calibrated, mode, tf32_flags):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    f0, f1, batch = _frames()
    ref = jl.LPIPS(load_calibrated=calibrated)
    out = tl.LPIPS(load_calibrated=calibrated, device="cpu")
    assert out.mode == ref.mode == mode
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert all(np.array_equal(out.params[k], ref.params[k]) for k in ref.params)
    for a, b in ((f0, f1), (batch, batch[::-1])):
        r, o = ref(a, b), out(a, b)
        assert o.shape == r.shape and _rel(o, r) <= 1e-5
    assert float(out(f0, f0)[0]) == 0.0


def test_distance_map_and_flow_weighted_match():
    """The map's taps are upsampled to the first tap's 29x39; the flow
    magnitude (120x160) is shrunk ~4x to it, which jax.image.resize
    antialiases."""
    f0, f1, _ = _frames()
    ref, out = jl.LPIPS(), tl.LPIPS(device="cpu")
    dref = np.asarray(ref._distance_map(ref._prep(f0), ref._prep(f1)))
    dout = out._distance_map(out._prep(f0), out._prep(f1)).numpy()
    assert dout.shape == dref.shape == (1, 29, 39) and _rel(dout, dref) <= 1e-5
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    mag = 3.0 + 2.0 * np.sin(xx / 3.0) * np.cos(yy / 5.0)  # detail the antialias filters out
    for m in (mag, mag[None]):
        r, o = ref.flow_weighted(f0, f1, m), out.flow_weighted(f0, f1, m)
        assert o.shape == r.shape == (1,) and _rel(o, r) <= 1e-5


@pytest.mark.parametrize("src,dst", [((1, 120, 160), (1, 29, 39)), ((2, 13, 17), (2, 29, 39)),
                                     ((1, 29, 39), (3, 29, 39)), ((2, 7, 50), (2, 20, 11))])
def test_image_resize_matches_jax(src, dst):
    x = np.random.default_rng(1).random(src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    out = tl.image_resize(torch.from_numpy(x), dst).numpy()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= 1e-6


def test_official_weights_file_loads(tmp_path):
    """A file in the JAX package's layout (HWIO convs, biases, heads) loads
    in both packages as official weights; a missing explicit path raises
    in the port."""
    rng = np.random.default_rng(5)
    params = jl._init_params(3)
    for k in params:
        if not k.endswith("_w") or k.startswith("lin"):
            params[k] = (rng.random(params[k].shape) * 0.1).astype(np.float32)
    path = tmp_path / "lpips_alex.npz"
    np.savez(path, **params)
    ref, out = jl.LPIPS(str(path)), tl.LPIPS(str(path), device="cpu")
    assert out.mode == ref.mode == "official_weights"
    f0, f1, _ = _frames()
    assert _rel(out(f0, f1), ref(f0, f1)) <= 1e-5
    with pytest.raises(FileNotFoundError):
        tl.LPIPS(str(tmp_path / "missing.npz"), device="cpu")
