"""vfisr_tpu_torch.parallel (mesh, shard_batch, spatial_apply, the dry run)
and the data-parallel train steps against vfisr_tpu's mesh and train steps.

Every process group runs in spawned processes on gloo
(``vfisr_tpu_torch.parallel.launch.run``, rank functions in
``tests/_torch_dist.py``), rendezvous through a FileStore under tmp_path (no
TCP port to collide with other test workers), one intra-op thread per rank,
and a time limit per group (``GROUP_TIMEOUT``): a group that hangs fails.
The JAX side runs here, on the conftest's 8 virtual CPU devices.

- 8 ranks: ``make_mesh(8)``'s shape and its refusals (more devices than
  ranks, as the JAX function refuses; fewer, since a rank is a device);
  ``shard_batch``'s blocks equal to the shards JAX places on device i (16/8
  per rank), H-sharded over data 2 x spatial 4 too; a batch the axis does
  not divide raises.
- 4 ranks, one group: the narrow IFNet of tests/test_parallel.py (scales
  (2, 1), channels (16, 8), 1 conv, batch 8, 32x32) trained data-parallel
  for three steps (the first update at lr 0, the second at 1e-3), against
  the JAX package's ``make_train_step(mesh=None)`` on the same batch and
  parameters: losses within 1e-5 relative and parameters within 1e-5
  absolute (the JAX test's tolerances), the first step's averaged, clipped gradients within
  1e-4 of each tensor's largest (tests/test_torch_train.py's); against the
  port's one-process step: 1e-6. Every rank's parameters equal. Narrow SPAN
  x2 (8 features) through ``make_sr_train_step`` with the mesh against the
  one-process SR step: 1e-6. H-sharded narrow SPAN ([2, 64, 64, 3], data 2 x
  spatial 2) against the JAX ``module.apply``: 1e-4 (the JAX sharding
  test's); against the port unsharded: 1e-5.
- The dry run CLI with ``--n 2 --device cpu``, and its refusal of more
  ranks than cards on ``cuda``.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_port import noisy_params, one_torch_thread, smooth_frames
from vfisr_tpu.models.sota import rife as jrife
from vfisr_tpu.models.sota import span as jspan
from vfisr_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vfisr_tpu.parallel.mesh import shard_batch as jax_shard_batch
from vfisr_tpu.train import train as jtrain
from vfisr_tpu.utils.checkpoint import _flatten
from vfisr_tpu_torch.parallel import dryrun
from vfisr_tpu_torch.parallel.launch import run
from vfisr_tpu_torch.train.train import make_sr_train_step

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 300.0  # seconds per process group
WORLD = 4


@pytest.fixture(scope="module")
def mesh8(tmp_path_factory):
    return run(td.mesh_rank, 8, timeout=GROUP_TIMEOUT,
               store_dir=str(tmp_path_factory.mktemp("store8")))


def test_mesh_over_8_ranks_and_refusals(mesh8):
    for r in mesh8:
        assert r["shape"] == (8, 1) and r["shape_2x4"] == (2, 4)
        assert "requested 9 devices, have 8" in r["refused_9"]
        assert "spans the process group" in r["refused_4"]
        assert "does not split" in r["refused_12"]


def test_shard_batch_blocks_equal_jax_shards(mesh8):
    x = np.arange(16 * 8 * 8 * 3, dtype=np.float32).reshape(16, 8, 8, 3)
    t = np.arange(16, dtype=np.float32)
    for h_sharded, spatial, keys in ((False, 1, ("x", "t")), (True, 4, ("x_h", "t_h"))):
        sharded = jax_shard_batch(jax_make_mesh(8, spatial=spatial), {"x": x, "t": t},
                                  h_sharded=h_sharded)
        for key, name in zip(("x", "t"), keys):
            by_device = {s.device.id: np.asarray(s.data) for s in sharded[key].addressable_shards}
            for rank, r in enumerate(mesh8):
                assert np.array_equal(r[name], by_device[rank]), (name, rank)
    assert mesh8[3]["x"].shape == (2, 8, 8, 3)  # 16/8 per rank
    assert all(np.array_equal(r["replicated"], x) for r in mesh8)
    assert mesh8[5]["x_h"].shape == (8, 2, 8, 3)  # data 2, H 8/4


@pytest.fixture(scope="module")
def narrow_inputs():
    """Seeded parameters and batches of the narrow IFNet and SPAN (flat
    numpy for the port; JAX trees)."""
    rng = np.random.default_rng(19)
    net = jrife.IFNet(jrife.RIFEConfig(**td.IFNET, refine=False))
    z = jnp.zeros((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"]
    iflat, itree = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), 5)
    frames = smooth_frames(rng, 24, 32, 32, cell=4)
    vfi = {"img0": frames[:8], "img1": frames[8:16], "gt": frames[16:],
           "t": np.full((8,), 0.5, np.float32)}
    snet = jspan.SPANNet(**td.SPAN)
    sshapes = jax.eval_shape(snet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"]
    sflat, stree = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), sshapes), 6)
    sr = {"lr": smooth_frames(rng, 8, 16, 16, cell=3), "hr": smooth_frames(rng, 8, 32, 32, cell=4)}
    sr_x = smooth_frames(rng, 2, 64, 64, cell=6)
    return dict(net=net, iflat=iflat, itree=itree, vfi=vfi, snet=snet, sflat=sflat, stree=stree,
                sr=sr, sr_x=sr_x)


@pytest.fixture(scope="module")
def group4(narrow_inputs, tmp_path_factory):
    n = narrow_inputs
    return run(td.group_rank, WORLD, n["iflat"], n["vfi"], n["sflat"], n["sr"], n["sr_x"],
               timeout=GROUP_TIMEOUT, store_dir=str(tmp_path_factory.mktemp("store4")))


@pytest.fixture(scope="module")
def jax_vfi(narrow_inputs):
    """The JAX step without a mesh: losses, the first step's clipped
    gradients, the parameters after STEPS steps (port names)."""
    from vfisr_tpu_torch.utils.checkpoint import params_from_jax

    n = narrow_inputs

    def apply_fn(p, i0, i1, t):
        return n["net"].apply({"params": p}, i0, i1, t)

    state, tx = jtrain.create_train_state(n["itree"], learning_rate=td.LR, total_steps=3)
    step = jtrain.make_train_step(apply_fn, tx, mesh=None, use_remat=False)
    batch = {k: jnp.asarray(v) for k, v in n["vfi"].items()}

    def loss_of(p):
        out = apply_fn(p, batch["img0"], batch["img1"], batch["t"])
        return jtrain.vfi_loss(out[0], batch["gt"])

    grads = jax.grad(loss_of)(n["itree"])
    norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads))))
    grads = jax.tree.map(lambda g: g * min(1.0, 1.0 / norm), grads)
    losses = []
    for _ in range(td.STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    conv = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                         params_from_jax(_flatten(jax.device_get(tree))).items()}
    return {"losses": losses, "grads": conv(grads), "params": conv(state.params)}


@pytest.fixture(scope="module")
def one_process(narrow_inputs):
    n = narrow_inputs
    return {"vfi": td.train(td.ifnet(n["iflat"]), td.vfi_step, n["vfi"]),
            "sr": td.train(td.span(n["sflat"]).train(), make_sr_train_step, n["sr"])}


def _close(got: dict, ref: dict, atol: float) -> None:
    assert set(got) == set(ref)
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= atol, (k, err)


def test_dp_step_matches_jax(group4, jax_vfi):
    for r in group4:
        for a, b in zip(r["vfi"]["losses"], jax_vfi["losses"]):
            assert abs(a - b) <= 1e-5 * abs(b), (a, b)
        _close(r["vfi"]["params"], jax_vfi["params"], 1e-5)
        for k, ref in jax_vfi["grads"].items():
            err = np.abs(r["vfi"]["grads"][k] - ref).max() / np.abs(ref).max()
            assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("kind", ["vfi", "sr"])
def test_dp_step_matches_one_process(group4, one_process, kind):
    ref = one_process[kind]
    assert ref["losses"][2] != ref["losses"][1]  # the second update moved the loss
    assert any(np.abs(p).max() > 0 for p in ref["grads"].values())
    for r in group4:
        for a, b in zip(r[kind]["losses"], ref["losses"]):
            assert abs(a - b) <= 1e-6 * abs(b), (a, b)
        _close(r[kind]["grads"], ref["grads"], 1e-6)
        _close(r[kind]["params"], ref["params"], 1e-6)


@pytest.mark.parametrize("kind", ["vfi", "sr"])
def test_dp_ranks_hold_equal_params(group4, kind):
    for r in group4[1:]:
        for k, p in r[kind]["params"].items():
            assert np.array_equal(p, group4[0][kind]["params"][k]), k


def test_spatial_span_matches_jax(group4, narrow_inputs):
    n = narrow_inputs
    ref = np.asarray(n["snet"].apply({"params": n["stree"]}, jnp.asarray(n["sr_x"])))
    assert ref.shape == (2, 128, 128, 3)
    for r in group4:
        got = r["spatial"]
        assert got.shape == (1, 128, 128, 3)
        assert np.abs(got[0] - ref[r["data_index"]]).max() <= 1e-4


def test_spatial_span_matches_unsharded(group4, narrow_inputs):
    n = narrow_inputs
    with torch.no_grad():
        ref = td.span(n["sflat"]).eval()(torch.from_numpy(n["sr_x"])).numpy()
    for r in group4:
        assert np.abs(r["spatial"][0] - ref[r["data_index"]]).max() <= 1e-5


def test_dryrun_cli_on_cpu():
    res = subprocess.run([sys.executable, "-m", "vfisr_tpu_torch.parallel.dryrun", "--n", "2",
                          "--device", "cpu", "--timeout", str(GROUP_TIMEOUT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=GROUP_TIMEOUT + 60)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "dryrun OK: 2-rank mesh (2, 1) on cpu" in res.stdout


def test_dryrun_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="have 1 CUDA card"):
        dryrun.dryrun(2, "cuda")
