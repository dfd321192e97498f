"""vfisr_tpu_torch's model registry, model contract and traditional baselines
held against vfisr_tpu's.

Inputs are numpy-made synthetic gameplay frames (``_torch_port.game_frames``)
at 64x96. Tolerances: float frames within 1e-5, except where the crossfade
or the flow blend floors to the 1/255 grid, which may land one step apart
(the same f32 blend, contracted into a fused multiply-add by XLA and not by
PyTorch): at most 1/255 there, on under 1% of the values; uint8 frames
within 1 LSB, and the upscaled uint8 frames of the baselines' process_pair
within 2 LSB (a midpoint one grid step apart, through Lanczos4, whose taps'
absolute sum exceeds 1); Farneback-based frames (OpticalFlowVFI) as the
blend, since the flows agree to 1e-4 px (test_torch_analysis.py).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import game_frames, noisy_params
from vfisr_tpu.core.resize import resize as jresize
from vfisr_tpu.models import base as jbase, registry as jreg
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.models.traditional import baselines as jbl
from vfisr_tpu_torch.core.resize import resize as tresize
from vfisr_tpu_torch.models import base as tbase, registry as treg
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.models.traditional import baselines as tbl
from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TS = (0.25, 0.5, 0.75)
NOT_PORTED = ("span", "safa", "rife_span", "vfimamba_span")


def _frames(n=2):
    f = game_frames(n, 64, 96)
    return f, f.astype(np.float32) / 255.0


def _close_on_grid(out, ref):
    """Floored-to-1/255 frames: equal but for rare one-step differences."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= 1.0 / 255.0 + 1e-6
    assert (d > 1e-5).mean() <= 0.01


def test_same_names():
    assert treg.list_models() == jreg.list_models()
    assert len(treg.list_models()) == 13
    assert sorted(treg.get_available_models()) == sorted(jreg.get_available_models())


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_models_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        treg.get_model(name, device="cpu")


def test_unknown_model_raises():
    with pytest.raises(KeyError):
        treg.get_model("nope")


@pytest.mark.parametrize("name,cls", [
    ("bicubic", "BicubicBaseline"), ("lanczos", "LanczosBaseline"),
    ("optical_flow", "OpticalFlowVFI"), ("rife", "RIFEModel"), ("rife_lite", "RIFELiteModel"),
    ("vfimamba", "VFIMambaModel"), ("vfimamba_s", "VFIMambaModel"),
    ("adaptive", "AdaptivePipeline"), ("flagship", "FlagshipVFI")])
def test_ported_models_construct(name, cls):
    model = treg.get_model(name, device="cpu")
    jmodel = jreg.get_model(name, device="cpu")
    assert type(model).__name__ == type(jmodel).__name__ == cls
    assert isinstance(model, tbase.BaseModel) and model.device == torch.device("cpu")
    assert not model._loaded
    info, jinfo = model.info, jmodel.info
    assert (info.name, info.type, info.supports_vfi, info.supports_sr) == (
        jinfo.name, jinfo.type, jinfo.supports_vfi, jinfo.supports_sr)


def test_get_model_loads_rife():
    model = treg.get_model("rife", load=True, device="cpu")
    assert model._loaded and model.info.parameters == sum(
        v.size for v in load_npz(str(ROOT / "weights" / "rife.npz")).values())
    with pytest.raises(NotImplementedError, match="scale"):
        model.interpolate_batch(torch.zeros(1, 32, 32, 3), torch.zeros(1, 32, 32, 3), (0.5,),
                                scale=0.5)


@pytest.mark.parametrize("cls", ["BicubicBaseline", "LanczosBaseline", "OpticalFlowVFI"])
def test_baselines_match(cls):
    u8, x = _frames(3)
    jm, tm = getattr(jbl, cls)(), getattr(tbl, cls)(device="cpu")
    jm.load(), tm.load()
    ref = jm.interpolate_batch(jnp.asarray(x[:2]), jnp.asarray(x[1:]), TS)
    out = tm.interpolate_batch(torch.from_numpy(x[:2]), torch.from_numpy(x[1:]), TS)
    assert out.shape == ref.shape == (2, 3, 64, 96, 3)
    _close_on_grid(out.numpy(), ref)
    up, jup = tm.upscale_batch(torch.from_numpy(x[:1])), jm.upscale_batch(jnp.asarray(x[:1]))
    assert up.shape == jup.shape == (1, 85, 127, 3)
    assert np.abs(up.numpy() - np.asarray(jup)).max() <= 1e-5
    res, jres = tm.process_pair(u8[0], u8[1]), jm.process_pair(u8[0], u8[1])
    assert res.model_used == jres.model_used and len(res.frames) == len(jres.frames) == 5
    for a, b in zip(res.frames, jres.frames):
        assert a.dtype == np.uint8 and a.shape == np.asarray(b).shape == (85, 127, 3)
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 2
    assert sorted(tbl.get_traditional_models()) == sorted(jbl.get_traditional_models())


@pytest.mark.parametrize("size", [(85, 127), (45, 70), (32, 48)])
def test_cubic_resize_matches(size):
    u8, x = _frames(1)
    ref = jresize(jnp.asarray(x), size, "cubic")
    out = tresize(torch.from_numpy(x), size, "cubic")
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-5
    assert np.array_equal(tresize(torch.from_numpy(u8), size, "cubic").numpy(),
                          np.asarray(jresize(jnp.asarray(u8), size, "cubic")))


def test_two_stage_model_matches():
    """TwoStageModel(Bicubic VFI, Lanczos SR) through both packages."""
    u8, _ = _frames(2)
    tm = tbase.TwoStageModel(tbl.BicubicBaseline(device="cpu"), tbl.LanczosBaseline(device="cpu"),
                             device="cpu")
    jm = jbase.TwoStageModel(jbl.BicubicBaseline(), jbl.LanczosBaseline())
    tm.load(), jm.load()
    assert vars(tm.info) == vars(jm.info)
    res, jres = tm.process_pair(u8[0], u8[1]), jm.process_pair(u8[0], u8[1])
    assert set(res.extra_info) == {"vfi_time_ms", "sr_time_ms"}
    for a, b in zip(res.frames, jres.frames):
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1


def test_rife_model_batch_api_matches():
    """RIFEModel.interpolate_batch (timesteps folded into the batch, padded
    to 32) and its per-frame API, narrow net with seeded parameters, at a
    size that needs padding (40x56)."""
    cfg_kw = dict(channels=(32, 24, 16, 16), num_convs=2)
    jm = jrife.RIFEModel(device="cpu", config=jrife.RIFEConfig(**cfg_kw))
    net = jrife.IFNet(jm.CONFIG)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    flat, jm.params = noisy_params(net.init(jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"], 0)
    jm._loaded = True
    jm._apply = jax.jit(lambda p, a, b, t: net.apply({"params": p}, a, b, t))
    tm = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(**cfg_kw))
    tm.module = trife.IFNet(tm.CONFIG).eval()
    tm.module.load_state_dict(params_from_jax(flat))
    tm._loaded = True
    u8 = game_frames(3, 40, 56)
    x = u8.astype(np.float32) / 255.0
    ref = jm.interpolate_batch(jnp.asarray(x[:2]), jnp.asarray(x[1:]), TS)
    out = tm.interpolate_batch(torch.from_numpy(x[:2]), torch.from_numpy(x[1:]), TS)
    assert out.shape == ref.shape == (2, 3, 40, 56, 3)
    assert np.abs(out.numpy() - np.asarray(ref)).max() <= 1e-4
    for a, b in zip(tm.interpolate(u8[0], u8[1], 2), jm.interpolate(u8[0], u8[1], 2)):
        assert np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1
    assert np.array_equal(tm.upscale(u8[0]), np.asarray(jm.upscale(u8[0])))
    res = tm.process_pair(u8[0], u8[1])
    assert len(res.frames) == 5 and res.model_used == "RIFE" and res.vram_peak_mb == 0.0
