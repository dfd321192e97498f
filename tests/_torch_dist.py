"""Rank functions for tests/test_torch_parallel.py. The ranks are spawned
processes (``vfisr_tpu_torch.parallel.launch.run``) that import this module
by name, so it imports torch, numpy and the port only: no jax, no test
module."""

from __future__ import annotations

import numpy as np
import torch

from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
from vfisr_tpu_torch.models.sota.span import SPANNet
from vfisr_tpu_torch.parallel.mesh import (local_block, make_mesh, replicated_sharding,
                                            shard_batch, spatial_apply)
from vfisr_tpu_torch.train.train import create_train_state, make_sr_train_step, make_train_step
from vfisr_tpu_torch.utils.checkpoint import params_from_jax

# tests/test_parallel.py's narrow IFNet and SPAN
IFNET = dict(scales=(2, 1), channels=(16, 8), num_convs=1)
SPAN = dict(feature_channels=8, upscale=2)
STEPS = 3  # total_steps 3: the first update at lr 0, the third loss shows the second
LR = 1e-3


def ifnet(flat: dict) -> IFNet:
    net = IFNet(RIFEConfig(**IFNET, warp_dtype=torch.float32))
    net.load_state_dict(params_from_jax(flat))
    return net.train()


def span(flat: dict) -> SPANNet:
    net = SPANNet(**SPAN)
    net.load_state_dict(params_from_jax(flat))
    return net


def train(net: torch.nn.Module, make_step, batch: dict, mesh=None) -> dict:
    """STEPS steps of ``make_step`` on the batch (with a mesh, this rank's
    block): the losses, each parameter's gradient after the first step
    (clipped, averaged over the ranks) and the parameters after the last."""
    state = create_train_state(net.parameters(), learning_rate=LR, total_steps=3)
    step = make_step(net, state, mesh=mesh)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if mesh is not None:
        tb = shard_batch(mesh, tb)
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(step(tb).item())
        if grads is None:
            grads = {k: p.grad.clone().numpy() for k, p in net.named_parameters()}
    return {"losses": losses, "grads": grads,
            "params": {k: p.detach().clone().numpy() for k, p in net.named_parameters()}}


def vfi_step(net, state, mesh=None):
    return make_train_step(net, state, use_remat=False, mesh=mesh)


def mesh_rank(rank: int, world: int) -> dict:
    """The 8-rank mesh, ``shard_batch``'s blocks and the refusals."""
    out = {"shape": tuple(make_mesh(8, device_type="cpu").shape)}
    for n, spatial in ((world + 1, 1), (world // 2, 1)):
        try:
            make_mesh(n, spatial=spatial, device_type="cpu")
        except ValueError as e:
            out[f"refused_{n}"] = str(e)
    x = torch.arange(16 * 8 * 8 * 3, dtype=torch.float32).reshape(16, 8, 8, 3)
    t = torch.arange(16, dtype=torch.float32)
    mesh = make_mesh(8, device_type="cpu")
    block = shard_batch(mesh, {"x": x, "t": t})
    out["x"], out["t"] = block["x"].numpy(), block["t"].numpy()
    out["replicated"] = local_block(mesh, x, replicated_sharding(mesh)).numpy()
    mesh24 = make_mesh(8, spatial=4, device_type="cpu")
    out["shape_2x4"] = tuple(mesh24.shape)
    out["x_h"] = shard_batch(mesh24, {"x": x}, h_sharded=True)["x"].numpy()
    out["t_h"] = shard_batch(mesh24, {"t": t}, h_sharded=True)["t"].numpy()
    try:
        shard_batch(mesh, {"x": x[:12]})
    except ValueError as e:
        out["refused_12"] = str(e)
    return out


def group_rank(rank: int, world: int, ifnet_flat: dict, vfi_batch: dict, span_flat: dict,
               sr_batch: dict, sr_x: np.ndarray) -> dict:
    """The 4-rank group: the data-parallel VFI and SR steps (data 4), then
    H-sharded SPAN (data 2 x spatial 2)."""
    mesh = make_mesh(world, device_type="cpu")
    out = {"vfi": train(ifnet(ifnet_flat), vfi_step, vfi_batch, mesh),
           "sr": train(span(span_flat).train(), make_sr_train_step, sr_batch, mesh)}
    mesh22 = make_mesh(world, spatial=2, device_type="cpu")
    x = shard_batch(mesh22, {"x": torch.from_numpy(sr_x)}, h_sharded=True)["x"]
    with torch.no_grad():
        out["spatial"] = spatial_apply(span(span_flat).eval(), x, mesh22).numpy()
    out["data_index"] = mesh22.get_local_rank("data")
    return out
