"""vfisr_tpu_torch's VFIMamba training held against vfisr_tpu's.

- ``selective_scan``'s gradient (the ``_SelectiveScan`` Function: the
  adjoint recurrence over the forward's chunks) against ``jax.vjp`` of
  ``_selective_scan`` followed by ``sum(h * C)``, at lengths that span
  several chunks (SCAN_CHUNK = 32) and one within a chunk: output and every
  input's gradient within 1e-5 of the reference's largest magnitude (f32
  sums in other orders: a step-by-step recurrence against a log-depth
  scan). ``torch.autograd.gradcheck`` of the Function in float64.
- A narrow VFIMambaNet (d_model 32, d_state 4, 2 blocks, both refinement
  levels; 64x160 frames, so the horizontal scans span two chunks), the same
  parameters on both sides (the port's seeded init plus seeded noise, so
  the zero-init heads carry signal): the training loss and every
  parameter's gradient against ``jax.value_and_grad``, with
  ``MambaConfig.remat`` on and off on both sides. The loss within 1e-5
  relative; each gradient within 1e-4 of its largest magnitude of the
  port's own float64 run, and within 3e-4 of the JAX gradient's: both f32
  gradients are roundoff away from the float64 one (the largest, the
  x_proj gradients summed over every row and step, up to 6e-5 for the JAX
  package and 5e-5 for the port), and their difference reaches 1.4e-4 (the
  scan's order as above, LayerNorm's variance formula, convolution sums,
  through the refinement pyramid and the warps). Warps are the exact
  gather on both sides, each package's CPU default.
- The CLI, ``--model vfimamba_s --device cpu --steps 2``: its npz loads,
  strictly, into the JAX net's parameter tree (``load_params`` against
  ``jax.eval_shape`` of its init), and the trained parameters moved.
"""

import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smooth_frames  # noqa: F401 (autouse fixture)
from vfisr_tpu.models.sota import vfimamba as jvm
from vfisr_tpu.train import train as jtrain
from vfisr_tpu.utils.checkpoint import _flatten, _unflatten, load_params
from vfisr_tpu_torch.models.sota import vfimamba as tvm
from vfisr_tpu_torch.train import __main__ as tcli
from vfisr_tpu_torch.train import train as ttrain
from vfisr_tpu_torch.utils.checkpoint import params_from_jax, params_to_jax

ROOT = Path(__file__).resolve().parents[1]
NARROW = dict(d_model=32, d_state=4, dt_rank=4, layers=2, refine_levels=2)


def _scan_inputs(rng, r, length, di, s, dtype=np.float32):
    dt = np.log1p(np.exp(rng.normal(size=(r, length, di)))).astype(dtype)
    A = -np.exp(rng.normal(size=(di, s))).astype(dtype)
    u, B, C = (rng.normal(size=shape).astype(dtype)
               for shape in ((r, length, di), (r, length, s), (r, length, s)))
    return dt, A, u, B, C


def _jax_scan(dt, A, u, B, C):
    a = jnp.exp(dt[..., None] * A)
    b = (dt * u)[..., None] * B[:, :, None, :]
    return jnp.sum(jvm._selective_scan(a, b) * C[:, :, None, :], axis=-1)


@pytest.mark.parametrize("length", [70, 45, 8])
def test_selective_scan_vjp_matches_jax(length):
    rng = np.random.default_rng(length)
    ins = _scan_inputs(rng, 3, length, 6, 4)
    gy = rng.normal(size=(3, length, 6)).astype(np.float32)
    ref, vjp = jax.vjp(_jax_scan, *(jnp.asarray(v) for v in ins))
    ref_grads = vjp(jnp.asarray(gy))
    tins = [torch.from_numpy(v).requires_grad_(True) for v in ins]
    out = tvm.selective_scan(*tins)
    grads = torch.autograd.grad(out, tins, torch.from_numpy(gy))
    for name, got, want in zip(("y", "dt", "A", "u", "B", "C"), (out, *grads), (ref, *ref_grads)):
        want = np.asarray(want)
        err = np.abs(got.detach().numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, (name, err)


def test_selective_scan_gradcheck():
    ins = _scan_inputs(np.random.default_rng(0), 2, 40, 3, 2, np.float64)
    tins = tuple(torch.from_numpy(v).requires_grad_(True) for v in ins)
    assert torch.autograd.gradcheck(tvm._SelectiveScan.apply, tins)


def test_selective_scan_without_grad_saves_nothing():
    """Inference takes the plain loop: no Function, no graph."""
    ins = [torch.from_numpy(v).requires_grad_(True)
           for v in _scan_inputs(np.random.default_rng(1), 2, 40, 3, 2)]
    with torch.no_grad():
        assert tvm.selective_scan(*ins).grad_fn is None
    assert "SelectiveScan" in type(tvm.selective_scan(*ins).grad_fn).__name__


@pytest.fixture(scope="module")
def narrow_net():
    """The narrow net's parameters (flat, JAX layout) and a batch."""
    torch.manual_seed(0)
    flat = params_to_jax(tvm.VFIMambaNet(tvm.MambaConfig(**NARROW)).state_dict())
    rng = np.random.default_rng(7)
    flat = {k: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32) for k, v in flat.items()}
    f = smooth_frames(rng, 6, 64, 160, cell=6)
    batch = {"img0": f[:2], "gt": f[2:4], "img1": f[4:],
             "t": np.asarray([0.3, 0.6], np.float32)}
    return flat, batch


@pytest.mark.parametrize("remat", [True, False])
def test_narrow_net_loss_and_grads_match_jax(narrow_net, remat):
    flat, batch = narrow_net
    jmod = jvm.VFIMambaNet(jvm.MambaConfig(**NARROW, remat=remat))

    def loss_fn(params, b):
        pred = jmod.apply({"params": params}, b["img0"], b["img1"], b["t"])[0]
        return jtrain.vfi_loss(pred, b["gt"])

    jparams = jax.tree_util.tree_map(jnp.asarray, _unflatten(flat))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = params_from_jax(_flatten(jax.device_get(jgrads)))

    def port(dtype):
        tmod = tvm.VFIMambaNet(tvm.MambaConfig(**NARROW, remat=remat))
        tmod.load_state_dict(params_from_jax(flat))
        tmod = tmod.to(dtype)
        tb = {k: torch.from_numpy(v).to(dtype) for k, v in batch.items()}
        loss = ttrain.vfi_loss(tmod(tb["img0"], tb["img1"], tb["t"])[0], tb["gt"])
        loss.backward()
        return loss.item(), {k: p.grad.double().numpy() for k, p in tmod.named_parameters()}

    loss, grads = port(torch.float32)
    _, grads64 = port(torch.float64)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert set(grads) == set(jgrads)
    for k, g in jgrads.items():
        ref = g.numpy()
        assert np.abs(ref).max() > 0, k
        err = np.abs(grads[k] - ref).max() / np.abs(ref).max()
        assert err <= 3e-4, (k, err)
        err64 = np.abs(grads[k] - grads64[k]).max() / np.abs(grads64[k]).max()
        assert err64 <= 1e-4, (k, err64)


def test_remat_recomputes_each_block(narrow_net, monkeypatch):
    """With remat each BiMambaBlock runs twice in a training step (forward
    and recompute), without it once, and the gradients are the same."""
    flat, batch = narrow_net
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, calls = {}, {}
    for remat in (True, False):
        tmod = tvm.VFIMambaNet(tvm.MambaConfig(**NARROW, remat=remat))
        tmod.load_state_dict(params_from_jax(flat))
        n = [0]
        tmod.block0.register_forward_pre_hook(lambda *a, n=n: n.__setitem__(0, n[0] + 1))
        ttrain.vfi_loss(tmod(tb["img0"], tb["img1"], tb["t"])[0], tb["gt"]).backward()
        grads[remat] = {k: p.grad for k, p in tmod.named_parameters()}
        calls[remat] = n[0]
    assert calls == {True: 2, False: 1}
    for k, g in grads[True].items():
        assert torch.allclose(g, grads[False][k], rtol=0, atol=1e-6 * g.abs().max().item()), k


def test_cli_trains_vfimamba_s_and_jax_loads_it(tmp_path, capsys):
    out = tmp_path / "vfimamba_s.npz"
    loss = tcli.main(["--model", "vfimamba_s", "--device", "cpu", "--steps", "2", "--batch", "1",
                      "--crop", "64", "--out", str(out), "--log-every", "1"])
    assert np.isfinite(loss) and out.is_file()
    text = capsys.readouterr().out
    assert "Training vfimamba_s" in text and "step 2/2" in text and "saved" in text
    jmod = jvm.VFIMambaNet(jvm._SMALL)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), z, z, jnp.asarray([0.5])))
    like = jax.tree_util.tree_map(lambda v: np.zeros(v.shape, v.dtype), shapes["params"])
    trained = load_params(str(out), like=like)  # every key, every shape: strict
    start = params_to_jax(_start_params())
    got = _flatten(trained)
    assert set(got) == set(start)
    assert any(not np.array_equal(got[k], start[k]) for k in start)


def _start_params() -> dict:
    """The parameters the CLI starts VFIMamba-S from (a v1 checkpoint: its
    refinement levels stay at their init, with a warning)."""
    model = tvm.VFIMambaModel(variant="small", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model.load()
    return model.module.state_dict()


def test_cli_refuses_to_overwrite_the_shipped_checkpoint():
    for name in ("vfimamba", "vfimamba_s"):
        if (ROOT / "weights" / f"{name}.npz").is_file():
            with pytest.raises(SystemExit, match="already exists"):
                tcli.main(["--model", name, "--steps", "1", "--device", "cpu"])


def test_cli_builds_vfimamba_with_per_block_remat(monkeypatch):
    """The trainer turns the blocks' remat on and the whole-forward remat
    off for VFIMamba (scripts/train.py), and keeps the whole-forward remat
    for RIFE."""
    seen = {}

    def spy(module, state, *a, use_remat=True, **k):
        seen["use_remat"], seen["remat"] = use_remat, getattr(module, "cfg", None)
        raise SystemExit("spied")

    monkeypatch.setattr(tcli, "make_train_step", spy)
    with pytest.raises(SystemExit, match="spied"):
        tcli.main(["--model", "vfimamba", "--steps", "1", "--device", "cpu",
                   "--out", "/nonexistent/x.npz"])
    assert seen["use_remat"] is False and seen["remat"].remat is True
    with pytest.raises(SystemExit, match="spied"):
        tcli.main(["--model", "rife_lite", "--steps", "1", "--device", "cpu",
                   "--out", "/nonexistent/x.npz"])
    assert seen["use_remat"] is True


def test_decoder_conv_takes_cudnn_only_at_the_training_shapes():
    """Conv_3 goes through ``models/base.py::planned_conv``: cuDNN at the
    batch-16, crop-192 training shapes where its plan was measured to win
    (``CUDNN_WINS``), PyTorch's own convolution at 1/8 of a 1080p triple,
    where cuDNN's plan lost; the other convs keep cuDNN."""
    from vfisr_tpu_torch.models.base import cudnn_wins

    full, small = tvm.VFIMambaNet(tvm._FULL), tvm.VFIMambaNet(tvm._SMALL)
    assert cudnn_wins(full.Conv_3, (16, 512, 24, 24)) and cudnn_wins(small.Conv_3,
                                                                     (16, 384, 24, 24))
    assert not cudnn_wins(full.Conv_3, (3, 512, 136, 240))
    net = tvm.VFIMambaNet(tvm.MambaConfig(**NARROW))
    calls = {}
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(
                lambda *a, name=name: calls.update({name: torch.backends.cudnn.enabled}))
    x = torch.zeros((1, 64, 64, 3))
    with torch.no_grad():
        net(x, x, torch.tensor([0.5]))
    assert [k for k, on in calls.items() if not on] == ["Conv_3"] and len(calls) == 13

