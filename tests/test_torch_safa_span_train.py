"""SAFA and SPAN training in vfisr_tpu_torch held against vfisr_tpu's.

- A narrow SAFA (c = 40, 2 decoder blocks, crop 32: endpoints 32x32, the
  midpoint supervised at 64x64; parameters from Flax init plus numpy noise,
  so the zero-init heads carry signal): the loss and every parameter's
  gradient of one step with remat against ``jax.value_and_grad`` of the
  JAX forward under ``jax.checkpoint``, within 1e-4 of each tensor's largest
  gradient (loss: 1e-4 relative); then three ``make_train_step`` steps
  against the JAX step and optax, the loss per step within 1e-4 relative,
  and each tensor's update (parameters after the steps less before) within
  1e-2 of its norm, with at most 1% of its elements off by more than 1% of
  its largest: AdamW divides each element's step by that element's own
  gradient, so an element whose gradient is at the rounding noise of the
  two packages' sums steps by up to the learning rate either way (a few
  in ten thousand here). Warps: the exact gather on both sides, each
  package's CPU default (the windowed path's backward, K2's twin and the
  shifted adjoint, is held in tests/test_torch_warp_shifted.py, and a
  whole narrow step on it in tests/test_torch_safa_train_windowed.py).
- The feature warp's clip where a flow sits on +-feat_warp_clamp: the
  port's ``SAFANet._feat_warp`` flow gradient against ``jnp.clip`` and the
  JAX warp (half the gradient at the bound; ``torch.clamp`` would pass
  all), on each package's CPU default warp.
- Narrow SPAN x2 and x4 (16 features): three ``make_sr_train_step`` steps
  against the JAX SR step, as above.
- ``render_sr_scene`` fed the JAX ``device_sr_batch``'s own draws: 1e-5.
- The CLI trains safa, span and span_x4 for two steps on the CPU, and the
  JAX models load what it saves, strictly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import noisy_params, one_torch_thread, rel_err, smooth_frames
from vfisr_tpu.core.warp import backward_warp as jax_backward_warp
from vfisr_tpu.models.sota import safa as jsafa
from vfisr_tpu.models.sota import span as jspan
from vfisr_tpu.train import train as jtrain
from vfisr_tpu.train.device_data import device_sr_batch as jax_sr_batch
from vfisr_tpu.utils.checkpoint import _flatten, load_params
from vfisr_tpu_torch.models.base import cudnn_wins, without_cudnn
from vfisr_tpu_torch.models.sota import safa as tsafa
from vfisr_tpu_torch.models.sota import span as tspan
from vfisr_tpu_torch.train import __main__ as tcli
from vfisr_tpu_torch.train import device_data as tdd
from vfisr_tpu_torch.train import train as ttrain
from vfisr_tpu_torch.utils.checkpoint import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _flax_init(net, *args):
    return net.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args))["params"]


def _grads_match(module, jgrads):
    jg = params_from_jax(_flatten(jax.device_get(jgrads)))
    named = dict(module.named_parameters())
    assert set(named) == set(jg)
    for k, g in jg.items():
        ref = g.numpy()
        assert np.abs(ref).max() > 0, k
        err = np.abs(named[k].grad.numpy() - ref).max() / np.abs(ref).max()
        assert err <= TOL, (k, err)


def _updates_match(module, jparams, flat0):
    """Each tensor's update since flat0 against the JAX one (see the
    module docstring)."""
    jp, p0 = params_from_jax(_flatten(jax.device_get(jparams))), params_from_jax(flat0)
    for k, p in module.named_parameters():
        ref = jp[k].numpy() - p0[k].numpy()
        diff = np.abs(p.detach().numpy() - p0[k].numpy() - ref)
        assert np.abs(ref).max() > 0, k  # the steps moved it
        assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(ref), k
        assert (diff > 1e-2 * np.abs(ref).max()).mean() <= 1e-2, k


@pytest.fixture(scope="module")
def narrow_safa():
    """(Flax net, flat params, port net, batch) of a narrow SAFA."""
    rng = np.random.default_rng(4)
    n, crop = 2, 32
    f = smooth_frames(rng, 2 * n, crop, crop, cell=5)
    gt = smooth_frames(rng, n, 2 * crop, 2 * crop, cell=10)
    batch = {"img0": f[:n], "img1": f[n:], "gt": gt,
             "t": rng.uniform(0.2, 0.8, n).astype(np.float32)}
    jnet = jsafa.SAFANet(c=40, num_dec_blocks=2)
    flat, _ = noisy_params(_flax_init(jnet, f[:1], f[:1], np.array([0.5], np.float32)), 9)
    return jnet, flat, batch


def _port_safa(flat):
    net = tsafa.SAFANet(c=40, num_dec_blocks=2)
    net.load_state_dict(params_from_jax(flat))
    return net.train()


def _jparams(flat):
    from vfisr_tpu.utils.checkpoint import _unflatten

    return jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))


def test_safa_train_step_loss_and_grads_match_jax(narrow_safa):
    jnet, flat, batch = narrow_safa

    def forward(params, b):
        return jtrain.vfi_loss(jnet.apply({"params": params}, b["img0"], b["img1"], b["t"]),
                               b["gt"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jax.checkpoint(forward)))(_jparams(flat), jb)
    net = _port_safa(flat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = torch.utils.checkpoint.checkpoint(
        lambda *a: ttrain.vfi_loss(net(*a[:3]), a[3]), tb["img0"], tb["img1"], tb["t"], tb["gt"],
        use_reentrant=False)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    _grads_match(net, jgrads)


def test_safa_make_train_step_matches_jax(narrow_safa):
    jnet, flat, batch = narrow_safa
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # 3 total steps: warmup 1, so the first update has lr 0 and the second
    # the peak; the third loss shows the update
    jstate, tx = jtrain.create_train_state(_jparams(flat), learning_rate=1e-3, total_steps=3)
    jstep = jtrain.make_train_step(lambda p, a, b, t: jnet.apply({"params": p}, a, b, t), tx)
    jlosses = []
    for _ in range(3):
        jstate, jl = jstep(jstate, jb)
        jlosses.append(float(jl))
    net = _port_safa(flat)
    tstep = ttrain.make_train_step(net, ttrain.create_train_state(net.parameters(), 1e-3,
                                                                  total_steps=3))
    tlosses = [tstep(tb).item() for _ in range(3)]
    assert tlosses[2] != tlosses[1]  # the update moved the loss
    for k, (a, b) in enumerate(zip(tlosses, jlosses)):
        assert abs(a - b) <= TOL * abs(b), (k, a, b)
    _updates_match(net, jstate.params, flat)


@pytest.mark.parametrize("on", [8.0, -8.0])
def test_feature_warp_clip_gradient_matches_jnp_clip(on):
    """Flows on the clamp get half the gradient (jnp.clip, as maximum and
    minimum split a tie); past it none, inside it all."""
    rng = np.random.default_rng(5)
    n, h, w, c = 1, 12, 14, 6
    feat = rng.random((n, h, w, c), np.float32)
    flow = rng.uniform(-3.0, 3.0, (n, h, w, 2)).astype(np.float32)
    flow[0, ::3, :, 0] = on
    flow[0, 1::3, :, 1] = 2 * on
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)

    def jfeat(fl):
        return jax_backward_warp(jnp.asarray(feat), jnp.clip(fl, -8.0, 8.0), 1.0,
                                 border="replicate", img_grad="shifted:8")

    _, vjp = jax.vjp(jfeat, jnp.asarray(flow))
    (ref,) = vjp(jnp.asarray(ct))
    net = tsafa.SAFANet(c=8, num_dec_blocks=1)
    fl = torch.from_numpy(flow).permute(0, 3, 1, 2).requires_grad_(True)
    out = net._feat_warp(torch.from_numpy(feat), fl)  # NCHW view of the NHWC warp
    out.backward(torch.from_numpy(ct).permute(0, 3, 1, 2))
    got = fl.grad.permute(0, 2, 3, 1).numpy()
    assert rel_err(got, ref) <= 1e-5
    on_bound = flow[..., 0] == on
    assert np.abs(np.asarray(ref)[..., 0][on_bound]).max() > 0  # half, not none


@pytest.mark.parametrize("scale", [2, 4])
def test_span_make_sr_train_step_matches_jax(scale):
    rng = np.random.default_rng(scale)
    n, crop = 2, 32
    hr = smooth_frames(rng, n, crop, crop, cell=4)
    lr_img = smooth_frames(rng, n, crop // scale, crop // scale, cell=3)
    batch = {"lr": lr_img, "hr": hr}
    jnet = jspan.SPANNet(feature_channels=16, upscale=scale)
    flat, jparams = noisy_params(_flax_init(jnet, lr_img[:1]), 11)
    jstate, tx = jtrain.create_train_state(jparams, learning_rate=1e-3, total_steps=3)
    jstep = jtrain.make_sr_train_step(lambda p, x: jnet.apply({"params": p}, x), tx)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = []
    for _ in range(3):
        jstate, jl = jstep(jstate, jb)
        jlosses.append(float(jl))
    net = tspan.SPANNet(feature_channels=16, upscale=scale)
    net.load_state_dict(params_from_jax(flat))
    net.train()
    tstep = ttrain.make_sr_train_step(net, ttrain.create_train_state(net.parameters(), 1e-3,
                                                                     total_steps=3))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tlosses = [tstep(tb).item() for _ in range(3)]
    assert tlosses[2] != tlosses[1]
    for k, (a, b) in enumerate(zip(tlosses, jlosses)):
        assert abs(a - b) <= TOL * abs(b), (k, a, b)
    _updates_match(net, jstate.params, flat)


def jax_sr_draws(key, n: int, c: int) -> dict:
    """The random arrays vfisr_tpu's device_sr_batch draws from key, in the
    port's draw_sr_scene layout (device_data.py:165-193)."""
    ks = jax.random.split(key, 10)
    u = jax.random.uniform
    g0, g1, gate = max(c // 16, 2), max(c // 4, 4), max(c // 24, 2)
    d = dict(wmix=u(ks[0], (n, 1, 1, 1), minval=0.25, maxval=0.75),
             tex=(u(ks[1], (n, g0, g0, 3)), u(ks[2], (n, g1, g1, 3))),
             boxes=u(ks[3], (n, 6, 4)), cols=u(ks[4], (n, 6, 3), minval=0.1, maxval=1.0),
             per=jax.random.randint(ks[5], (n, 1, 1), 2, 5).astype(jnp.float32),
             gate=u(ks[6], (n, gate, gate, 3)),
             pitch=jax.random.randint(ks[7], (n, 1, 1), 16, 64).astype(jnp.float32),
             speck=u(ks[8], (n, c, c)), tone=u(ks[9], (n, 1, 1, 3), minval=0.1, maxval=1.0))
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), d)


@pytest.mark.parametrize("size,detail", [(48, 0.6), (96, 0.5)])
def test_render_sr_scene_matches_jax(size, detail):
    key = jax.random.PRNGKey(size)
    ref = np.asarray(jax_sr_batch(key, 2, size, detail)["gt"])
    got = tdd.render_sr_scene(jax_sr_draws(key, 2, size), size, detail)["gt"]
    assert tuple(got.shape) == ref.shape == (2, size, size, 3)
    assert rel_err(got.numpy(), ref) <= 1e-5


def test_device_sr_batch_is_seeded():
    a, b = (tdd.device_sr_batch(torch.Generator().manual_seed(3), 2, 40)["gt"] for _ in range(2))
    assert torch.equal(a, b) and 0.0 <= a.min() and a.max() <= 1.0 and a.std() > 0.1


@pytest.mark.parametrize("model,weights,jmodel", [
    ("safa", "safa.npz", lambda: jsafa.SAFAModel()),
    ("span", "span_x2.npz", lambda: jspan.SPANModel(scale=2)),
    ("span_x4", "span_x4.npz", lambda: jspan.SPANModel(scale=4)),
])
def test_cli_trains_and_jax_loads(model, weights, jmodel, tmp_path, capsys):
    out = tmp_path / f"{model}.npz"
    # two steps: the schedule's first has lr 0
    loss = tcli.main(["--model", model, "--steps", "2", "--batch", "1", "--crop", "32",
                      "--device", "cpu", "--out", str(out), "--log-every", "1"])
    assert np.isfinite(loss) and out.is_file()
    assert "step 2/2" in capsys.readouterr().out
    jm = jmodel()
    jm.load()  # the shipped checkpoint, as the CLI starts from it
    trained = load_params(str(out), like=jm.params)  # strict: every key and shape
    shipped = _flatten(load_params(str(ROOT / "weights" / weights)))
    moved = [k for k, v in _flatten(trained).items() if not np.array_equal(v, shipped[k])]
    assert moved and set(_flatten(trained)) == set(shipped)


def test_cli_default_outputs_and_safa_data_refusal():
    """span writes weights/span_x2.npz (refused: it exists); --data with
    safa is refused for the reference's reason."""
    with pytest.raises(SystemExit, match="span_x2.npz already exists"):
        tcli.main(["--model", "span", "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="span_x4.npz already exists"):
        tcli.main(["--model", "span_x4", "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="GT at 2x"):
        tcli.main(["--model", "safa", "--data", "data/processed", "--device", "cpu"])


def test_trainable_and_the_shape_cudnn_choice():
    """trainable() unfreezes the loaded module; SAFA's and SPAN's planned
    convs keep cuDNN only at the input shapes where it was measured to win
    (``models/base.py::CUDNN_WINS``), whatever the module's mode."""
    for model in (tsafa.SAFAModel(device="cpu"), tspan.SPANModel(scale=4, device="cpu")):
        with pytest.raises(RuntimeError, match="load"):
            model.trainable()
        model.load()
        assert not any(p.requires_grad for p in model.module.parameters())
        module = model.trainable()
        assert module.training and all(p.requires_grad for p in module.parameters())
    full, span = tsafa.SAFANet(), tspan.SPANNet(feature_channels=48)
    cases = [(full.Conv_2, (16, 176, 48, 48), True), (full.dec_b0, (16, 176, 48, 48), True),
             (full.Conv_2, (3, 176, 114, 144), False), (full.Conv_2, (16, 176, 64, 64), False),
             (full.flow0_a, (16, 358, 48, 48), False), (full.dec_c, (16, 185, 192, 192), False),
             (span.conv_cat, (16, 192, 96, 96), True), (span.conv_cat, (16, 192, 48, 48), True),
             (span.conv_cat, (4, 192, 1080, 1920), False)]
    assert [cudnn_wins(conv, shape) for conv, shape, _ in cases] == [w for *_, w in cases]
    net = tsafa.SAFANet(c=8, num_dec_blocks=1)
    narrow_span = tspan.SPANNet(feature_channels=8)
    planned = ["Conv_2", "flow0_a", "flow0_b", "flow1_a", "flow1_b", "dec_a", "dec_b0", "dec_c",
               "conv_cat"]
    calls = {}
    for module in (net, narrow_span):
        for name, m in module.named_modules():
            if isinstance(m, torch.nn.Conv2d):
                m.register_forward_hook(
                    lambda *a, name=name: calls.update({name: torch.backends.cudnn.enabled}))
    x = torch.zeros((1, 32, 32, 3))
    for training in (False, True):
        calls.clear()
        with torch.no_grad():
            net.train(training)(x, x, torch.tensor([0.5]))
            narrow_span.train(training)(x[:, :8, :8])
        assert sorted(k for k, on in calls.items() if not on) == sorted(planned), training
        assert len(calls) > len(planned) and torch.backends.cudnn.enabled
    with without_cudnn():
        assert not torch.backends.cudnn.enabled
