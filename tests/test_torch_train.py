"""vfisr_tpu_torch's training slice held against vfisr_tpu's.

- Losses (charbonnier, soft census, vfi_loss, sr_loss) against the JAX
  ones: 1e-5 relative to max(1, the reference).
- The schedule against ``optax.warmup_cosine_decay_schedule`` as
  ``create_train_state`` builds it, and three optimizer updates on the same
  given gradients (one clipped by the global norm) against the optax chain:
  1e-6 relative to max(1, the reference).
- A whole training step of a narrow IFNet (scales (4,2,1), channels
  (16,16,8), 2 convs, 64x64, batch 2, f32 windowed warps with small radii,
  level (1,1) and final (1,2), which keep the interpret-mode kernels quick
  to compile; params carried over by ``params_from_jax``): the loss and every parameter's gradient,
  with remat, against ``jax.value_and_grad`` of the JAX forward under
  ``jax.checkpoint``, within 1e-4 of each tensor's largest magnitude; then
  three ``make_train_step`` steps against the JAX step, the loss per step
  within 1e-4 relative. Both sides run the windowed warp: the JAX package
  the Pallas kernel in interpret mode (``_torch_port.windowed_reference``),
  the port the kernels' plain twins (K1 forward, K2 backward).
- The checkpoint: a port-saved ``.npz`` loads with
  ``vfisr_tpu.utils.checkpoint.load_params`` into the JAX IFNet, and the
  two forwards agree within 1e-5.
- The CLI on the CPU, its refusals, and ``RIFELiteModel``.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import one_torch_thread, rel_err, smooth_frames, windowed_reference
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.train import train as jtrain
from vfisr_tpu.utils.checkpoint import _flatten, _unflatten, load_params
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.train import __main__ as tcli
from vfisr_tpu_torch.train import train as ttrain
from vfisr_tpu_torch.utils.checkpoint import (load_npz, params_from_jax, params_to_jax,
                                              save_npz)

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(scales=(4, 2, 1), channels=(16, 16, 8), num_convs=2, level_warp_radius=(1, 1),
              final_warp_radius=(1, 2))


def _pair(rng, n=2, hw=24):
    return (rng.random((n, hw, hw, 3), np.float32),
            np.clip(rng.random((n, hw, hw, 3), np.float32) * 1.2 - 0.1, 0, 1))


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    pred, gt = _pair(rng)
    tp, tg = torch.from_numpy(pred), torch.from_numpy(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    assert rel_err(ttrain.charbonnier(tp - tg), jtrain.charbonnier(jp - jg)) <= 1e-5
    assert rel_err(ttrain.census_soft(tp), jtrain.census_soft(jp)) <= 1e-5
    assert rel_err(ttrain.vfi_loss(tp, tg).item(), jtrain.vfi_loss(jp, jg)) <= 1e-5
    assert rel_err(ttrain.sr_loss(tp, tg).item(), jtrain.sr_loss(jp, jg)) <= 1e-5


@pytest.mark.parametrize("total", [3, 50, 100_000])
def test_schedule_matches_optax(total):
    lr = 2e-4
    state = ttrain.create_train_state([torch.nn.Parameter(torch.zeros(1))], lr, total_steps=total)
    warmup = min(2000, max(total // 10, 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1), lr * 0.01)
    counts = sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, total + 7})
    for k in counts:
        assert abs(state.schedule(k) - float(ref(k))) <= 1e-6 * lr, k


def test_optimizer_updates_match_optax():
    rng = np.random.default_rng(2)
    shapes = {"conv/kernel": (3, 3, 4, 5), "conv/bias": (5,), "dense/kernel": (6, 2)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in shapes.items()}
    # the second step's global norm exceeds 1, so the clip engages there
    grads = [{k: rng.normal(0, scale, s).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.05, 1.0, 0.02)]
    jstate, tx = jtrain.create_train_state(
        jax.tree_util.tree_map(jnp.asarray, params), learning_rate=1e-2, total_steps=20)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    tstate = ttrain.create_train_state(list(tparams.values()), learning_rate=1e-2, total_steps=20)
    jp, opt_state = jstate.params, jstate.opt_state
    for g in grads:
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        ttrain.apply_gradients(tstate, list(tparams.values()))
        for k, p in tparams.items():
            assert rel_err(p.detach().numpy(), jp[k]) <= 1e-6, (tstate.step, k)
    assert tstate.step == 3


def _narrow_models(rng):
    """The narrow JAX IFNet with random params (flow heads included, so the
    warps move) and the port's copy of it."""
    jmod = jrife.IFNet(jrife.RIFEConfig(**NARROW, warp_dtype=jnp.float32))
    tmod = trife.IFNet(trife.RIFEConfig(**NARROW, warp_dtype=torch.float32))
    shapes = {k: v.shape for k, v in params_to_jax(tmod.state_dict()).items()}
    flat = {k: (rng.normal(0, 0.2, s) / np.sqrt(np.prod(s[:-1])) if k.endswith("kernel")
                else rng.normal(0, 0.05, s)).astype(np.float32) for k, s in shapes.items()}
    tmod.load_state_dict(params_from_jax(flat))
    return jmod, jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)), tmod, flat


def _batch(rng, n=2, hw=64):
    f = smooth_frames(rng, 3 * n, hw, hw, cell=6)
    return {"img0": f[:n], "gt": f[n:2 * n], "img1": f[2 * n:],
            "t": rng.uniform(0.2, 0.8, n).astype(np.float32)}


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(3)
    jmod, jparams, tmod, flat = _narrow_models(rng)
    return jmod, jparams, tmod, flat, _batch(rng)


def test_train_step_loss_and_grads_match_jax(narrow, monkeypatch):
    jmod, jparams, tmod, _, batch = narrow

    def forward(params, b):
        pred = jmod.apply({"params": params}, b["img0"], b["img1"], b["t"])[0]
        return jtrain.vfi_loss(pred, b["gt"])

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with windowed_reference():
        jloss, jgrads = jax.jit(jax.value_and_grad(jax.checkpoint(forward)))(jparams, jb)
    jgrads = params_from_jax(_flatten(jax.device_get(jgrads)))

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tmod.zero_grad(set_to_none=True)
    with monkeypatch.context() as mp:
        mp.setattr("vfisr_tpu_torch.core.warp.default_warp_backend", lambda device: "windowed")
        loss = torch.utils.checkpoint.checkpoint(
            lambda *a: ttrain.vfi_loss(tmod(*a[:3])[0], a[3]),
            tb["img0"], tb["img1"], tb["t"], tb["gt"], use_reentrant=False)
        loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    named = dict(tmod.named_parameters())
    assert set(named) == set(jgrads)
    for k, g in jgrads.items():
        ref = g.numpy()
        assert np.abs(ref).max() > 0, k
        err = np.abs(named[k].grad.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (k, err)


def test_make_train_step_matches_jax(narrow, monkeypatch):
    jmod, jparams, _, flat, batch = narrow
    tmod = trife.IFNet(trife.RIFEConfig(**dict(NARROW, warp_dtype=torch.float32)))
    tmod.load_state_dict(params_from_jax(flat))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def apply_fn(params, img0, img1, t):
        return jmod.apply({"params": params}, img0, img1, t)

    # 3 total steps: warmup 1, so the first update has lr 0 and the second
    # the peak; the third loss shows the update
    jstate, tx = jtrain.create_train_state(jparams, learning_rate=1e-3, total_steps=3)
    tstate = ttrain.create_train_state(tmod.parameters(), learning_rate=1e-3, total_steps=3)
    tstep = ttrain.make_train_step(tmod, tstate)
    with windowed_reference():
        jstep = jtrain.make_train_step(apply_fn, tx)
        jlosses = []
        for _ in range(3):
            jstate, jl = jstep(jstate, jb)
            jlosses.append(float(jl))
    with monkeypatch.context() as mp:
        mp.setattr("vfisr_tpu_torch.core.warp.default_warp_backend", lambda device: "windowed")
        tlosses = [tstep(tb).item() for _ in range(3)]
    assert tlosses[2] != tlosses[1]  # the update moved the loss
    for k, (a, b) in enumerate(zip(tlosses, jlosses)):
        assert abs(a - b) <= 1e-4 * abs(b), (k, a, b)


def test_saved_npz_loads_into_jax(narrow, tmp_path):
    jmod, jparams, tmod, flat, batch = narrow
    path = tmp_path / "narrow.npz"
    save_npz(str(path), params_to_jax(tmod.state_dict()))
    assert not (tmp_path / "narrow.npz.tmp.npz").exists()
    loaded = load_params(str(path), like=jparams)
    back = _flatten(loaded)
    assert set(back) == set(flat) and all(np.array_equal(back[k], flat[k]) for k in flat)
    jout = np.asarray(jax.jit(jmod.apply)({"params": loaded}, batch["img0"], batch["img1"],
                                          batch["t"])[0])
    with torch.no_grad():
        tout = tmod(*(torch.from_numpy(batch[k]) for k in ("img0", "img1", "t")))[0].numpy()
    assert np.abs(tout - jout).max() <= 1e-5


def test_rife_lite_loads_and_trains():
    model = trife.RIFELiteModel(device="cpu")
    model.load()  # weights/rife_lite.npz, strict by name and shape
    assert model.CONFIG.channels == (176, 112, 80)
    flat = load_npz(str(ROOT / "weights" / "rife_lite.npz"))
    assert model.param_count() == sum(v.size for v in flat.values())
    assert not any(p.requires_grad for p in model.module.parameters())
    module = model.trainable()
    assert module.training and all(p.requires_grad for p in module.parameters())


def test_cli_trains_on_cpu(tmp_path, capsys):
    out = tmp_path / "rife.npz"
    loss = tcli.main(["--model", "rife", "--steps", "2", "--batch", "2", "--crop", "96",
                      "--device", "cpu", "--out", str(out), "--log-every", "1"])
    assert np.isfinite(loss) and out.is_file()
    text = capsys.readouterr().out
    assert "step 2/2" in text and "saved" in text
    jmod = jrife.IFNet(jrife.RIFEConfig())
    like = load_params(str(ROOT / "weights" / "rife.npz"))
    trained = load_params(str(out), like=like)  # the JAX package takes it, strictly
    moved = [k for k, v in _flatten(trained).items() if not np.array_equal(v, _flatten(like)[k])]
    assert moved and jmod.config.channels == (256, 160, 112, 80)


def test_cli_turns_tf32_off(tmp_path, monkeypatch):
    """The trainer runs the f32 config in f32: cuDNN and matmul TF32 off
    after main, whatever they were before (monkeypatch restores them)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tcli.main(["--model", "rife", "--steps", "1", "--batch", "1", "--crop", "96", "--device",
               "cpu", "--out", str(tmp_path / "r.npz")])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="already exists"):
        tcli.main(["--model", "rife", "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not ported"):
        tcli.main(["--model", "vfimamba", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--model span trains on LR/HR pairs"):
        tcli.main(["--model", "span", "--data", "data/processed", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        tcli.main(["--model", "rife", "--steps", "1"])


def test_radius_flags_reach_the_config(tmp_path, monkeypatch):
    seen = {}
    real = trife.RIFEModel.__init__

    def spy(self, device="cuda", seed=0, config=None):
        seen["config"] = config
        real(self, device, seed, config)

    monkeypatch.setattr(trife.RIFEModel, "__init__", spy)
    tcli.main(["--model", "rife", "--steps", "1", "--batch", "1", "--crop", "96", "--device",
               "cpu", "--out", str(tmp_path / "r.npz"), "--level-radius", "2,2",
               "--final-radius", "3,4"])
    assert seen["config"] == dataclasses.replace(trife.RIFEModel.CONFIG, level_warp_radius=(2, 2),
                                                 final_warp_radius=(3, 4))
