"""vfisr_tpu_torch's SPAN (models/sota/span.py) held against vfisr_tpu's.

Both packages load the shipped checkpoints (weights/span_x2.npz,
weights/span_x4.npz); the two-stage models take narrow experts with seeded
parameters (Flax init plus numpy noise, carried by ``params_from_jax``).
Inputs are numpy-seeded frames. Tolerances:
- ``SPANNet`` and ``upscale_batch``: 1e-5 on the [0, 1] frame (f32 both
  sides; 22 convolutions whose sums run in another order);
- the crossfade: equal, but for rare one-step differences on the 1/255
  grid it floors to (the blend contracted into an FMA by XLA, not by
  PyTorch);
- uint8 frames (``upscale``, ``process_pair``): 1 LSB, 2 LSB where a
  midpoint one grid step apart goes through Lanczos4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import game_frames, noisy_params, one_torch_thread, smooth_frames
from vfisr_tpu.models.novel import adaptive_pipeline as jap
from vfisr_tpu.models.sota import rife as jrife, span as jspan, vfimamba as jvm
from vfisr_tpu_torch.models.novel import adaptive_pipeline as tap
from vfisr_tpu_torch.models.sota import rife as trife, span as tspan, vfimamba as tvm
from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
TS = (0.25, 0.5, 0.75)


@pytest.fixture(scope="module")
def span_models():
    """{scale: (jax SPANModel, port SPANModel)}, both loaded from the shipped
    checkpoint."""
    out = {}
    for r in (2, 4):
        jm, tm = jspan.SPANModel(scale=r), tspan.SPANModel(scale=r, device="cpu")
        jm.load(), tm.load()
        out[r] = (jm, tm)
    return out


@pytest.mark.parametrize("r", [2, 4])
def test_spannet_from_checkpoint_matches(span_models, r):
    jm, tm = span_models[r]
    assert tm.info.parameters == jm.info.parameters == sum(
        v.size for v in load_npz(str(WEIGHTS / f"span_x{r}.npz")).values())
    assert tm.info.name == jm.info.name == f"SPAN_x{r}"
    x = smooth_frames(np.random.default_rng(r), 2, 24, 40, cell=4)
    ref = np.asarray(jm._apply(jm.params, jnp.asarray(x)))
    with torch.no_grad():
        out = tm.module(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 24 * r, 40 * r, 3)
    assert np.abs(out - ref).max() <= 1e-5


@pytest.mark.parametrize("r", [2, 4])
def test_depth_to_space_reads_channels_as_r_r_3(r):
    """The upsampler's channel k = (i*r + j)*3 + c lands at row offset i,
    column offset j, colour c, as the reference's NHWC reshape reads it;
    F.pixel_shuffle (channels as (3, r, r)) would place it elsewhere."""
    n, h, w = 2, 3, 5
    x = np.arange(n * 3 * r * r * h * w, dtype=np.float32).reshape(n, 3 * r * r, h, w)
    out = tspan.depth_to_space(torch.from_numpy(x), r).numpy()
    nhwc = x.transpose(0, 2, 3, 1)
    ref = nhwc.reshape(n, h, w, r, r, 3).transpose(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, 3)
    assert np.array_equal(out, ref)
    for i in range(r):
        for j in range(r):
            assert np.array_equal(out[:, i::r, j::r, 1], x[:, (i * r + j) * 3 + 1])
    shuffled = F.pixel_shuffle(torch.from_numpy(x), r).permute(0, 2, 3, 1).numpy()
    assert not np.array_equal(out, shuffled)


@pytest.mark.parametrize("r,scale,hw", [(2, 1.333, (30, 44)), (2, 2.0, (24, 32)),
                                        (4, 1.333, (30, 44))])
def test_upscale_batch_matches(span_models, r, scale, hw):
    """The net, Lanczos4 to scale_size where the net's size differs, then
    the clip to [0, 1]; and the per-frame uint8 API."""
    jm, tm = span_models[r]
    x = smooth_frames(np.random.default_rng(5), 2, *hw, cell=4)
    ref = np.asarray(jm.upscale_batch(jnp.asarray(x), scale))
    out = tm.upscale_batch(torch.from_numpy(x), scale).numpy()
    assert out.shape == ref.shape
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert np.abs(out - ref).max() <= 1e-5
    u8 = game_frames(1, *hw)[0]
    a, b = tm.upscale(u8, scale), np.asarray(jm.upscale(u8, scale))
    assert a.dtype == np.uint8 and a.shape == b.shape
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_interpolate_is_the_crossfade(span_models):
    jm, tm = span_models[2]
    x = game_frames(3, 24, 40).astype(np.float32) / 255.0
    ref = np.asarray(jm.interpolate_batch(jnp.asarray(x[:2]), jnp.asarray(x[1:]), TS))
    out = tm.interpolate_batch(torch.from_numpy(x[:2]), torch.from_numpy(x[1:]), TS).numpy()
    assert out.shape == ref.shape == (2, 3, 24, 40, 3)
    d = np.abs(out.astype(np.float64) - ref)
    assert d.max() <= 1.0 / 255.0 + 1e-6 and (d > 1e-5).mean() <= 0.01


def _narrow_rife():
    cfg = dict(channels=(32, 24, 16, 16), num_convs=2)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jr = jrife.RIFEModel(device="cpu", config=jrife.RIFEConfig(**cfg))
    net = jrife.IFNet(jr.CONFIG)
    flat, jr.params = noisy_params(net.init(jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"], 3)
    jr._apply = jax.jit(lambda p, a, b, s: net.apply({"params": p}, a, b, s))
    tr = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(**cfg))
    tr.module = trife.IFNet(tr.CONFIG).eval()
    tr.module.load_state_dict(params_from_jax(flat))
    return jr, tr


def _narrow_vfimamba():
    cfg = dict(d_model=32, d_state=4, dt_rank=4, layers=2, refine_levels=2)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    jv = jvm.VFIMambaModel(device="cpu")
    jv.cfg = jvm.MambaConfig(**cfg)
    net = jvm.VFIMambaNet(jv.cfg)
    flat, jv.params = noisy_params(net.init(jax.random.PRNGKey(1), z, z, jnp.asarray([0.5]))["params"], 4)
    jv._apply = jax.jit(lambda p, a, b, s: net.apply({"params": p}, a, b, s))
    tv = tvm.VFIMambaModel(device="cpu")
    tv.cfg = tvm.MambaConfig(**cfg)
    tv.module = tvm.VFIMambaNet(tv.cfg).eval()
    tv.module.load_state_dict(params_from_jax(flat))
    return jv, tv


@pytest.mark.parametrize("name", ["rife_span", "vfimamba_span"])
def test_two_stage_with_narrow_experts_matches(span_models, name):
    """create_rife_span / create_vfimamba_span: the VFI expert (narrow,
    injected) then SPAN x2 on every frame, through process_pair."""
    jvfi, tvfi = _narrow_rife() if name == "rife_span" else _narrow_vfimamba()
    jm = getattr(jspan, f"create_{name}")(device="cpu")
    tm = getattr(tspan, f"create_{name}")(device="cpu")
    assert type(tm.vfi_model) is type(tvfi) and type(tm.sr_model) is tspan.SPANModel
    jm.vfi_model, jm.sr_model = jvfi, span_models[2][0]
    tm.vfi_model, tm.sr_model = tvfi, span_models[2][1]
    for m in (jvfi, tvfi):
        m._loaded = True
    jm.load(), tm.load()
    assert tm.info.name == jm.info.name and tm.info.parameters == jm.info.parameters
    u8 = game_frames(2, 40, 56)
    res, jres = tm.process_pair(u8[0], u8[1], 1), jm.process_pair(u8[0], u8[1], 1)
    assert len(res.frames) == len(jres.frames) == 3
    for a, b in zip(res.frames, jres.frames):
        assert a.shape == np.asarray(b).shape == (53, 74, 3)
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 2


def test_adaptive_pipeline_span_upscale_batch():
    """AdaptivePipeline(sr_model_name="span") loads SPANModel (x2) and its
    upscale_batch and upscale go through it; the default stays Lanczos4."""
    jp = jap.AdaptivePipeline(device="cpu", sr_model_name="span", enable_vfimamba=False)
    tp = tap.AdaptivePipeline(device="cpu", sr_model_name="span", enable_vfimamba=False)
    jp.load()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    tp.load()
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert isinstance(tp._sr, tspan.SPANModel) and tp._sr.scale == 2 and tp._sr._loaded
    x = smooth_frames(np.random.default_rng(8), 2, 30, 44, cell=4)
    ref = np.asarray(jp.upscale_batch(jnp.asarray(x), 1.333))
    out = tp.upscale_batch(torch.from_numpy(x), 1.333).numpy()
    assert out.shape == ref.shape == (2, 39, 58, 3)
    assert np.abs(out - ref).max() <= 1e-5
    assert np.abs(out - tp._sr.upscale_batch(torch.from_numpy(x), 1.333).numpy()).max() == 0.0
    u8 = game_frames(1, 30, 44)[0]
    assert np.abs(tp.upscale(u8).astype(int) - np.asarray(jp.upscale(u8)).astype(int)).max() <= 1
    lanczos = tap.AdaptivePipeline(device="cpu")
    assert lanczos._sr is None
    assert not np.array_equal(lanczos.upscale_batch(torch.from_numpy(x), 1.333).numpy(), out)
