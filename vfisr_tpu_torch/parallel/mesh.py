"""Device mesh, batch sharding and H-sharded inference over torch.distributed
(port of ``vfisr_tpu/parallel/mesh.py``).

One process per device: a rank of the initialised process group is a
device of the JAX mesh (NCCL with one rank per card; gloo over CPU tensors,
or over CUDA tensors where several ranks share one card). The mesh is a
``DeviceMesh`` with the axes ``('data', 'spatial')``:

- **data**: each rank holds its block of the batch; the train step
  all-reduces the gradients over this axis (``train/train.py``), where XLA
  inserts the psum under ``jit``.
- **spatial**: H shards across the ranks of a row of the mesh;
  ``spatial_apply`` exchanges the halo rows that the model's convolutions
  read across a block's edge, which XLA's SPMD partitioner inserts.

Tensors stay plain local tensors and the collectives are explicit: the
placements (``Shard``/``Replicate``) say which block of a global tensor a
rank holds, and ``shard_batch`` cuts it. The models are not routed through
DTensor, whose convolution rules do not cover an NHWC conv sharded on H.
Parameters are replicated (the models are small; see the JAX module).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data", "spatial"),
              spatial: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (data x spatial) mesh over the ranks of the initialised process
    group: data = n / spatial. A rank is a device, so the mesh spans the
    whole group: more devices than ranks raise ValueError, as in the JAX
    function, and so do fewer (start n ranks instead)."""
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    if n != world:
        raise ValueError(f"a mesh spans the process group: requested {n} devices of {world} ranks")
    if n % spatial:
        raise ValueError(f"{n} devices do not split into spatial groups of {spatial}")
    return init_device_mesh(device_type, (n // spatial, spatial), mesh_dim_names=tuple(axis_names))


def data_sharding(mesh: DeviceMesh) -> Tuple:
    """The batch (dim 0) over 'data', replicated over the other axes."""
    return tuple(Shard(0) if a == "data" else Replicate() for a in mesh.mesh_dim_names)


def spatial_sharding(mesh: DeviceMesh, h_axis: int = 1) -> Tuple:
    """The batch over 'data' and H (dim ``h_axis``) over 'spatial'."""
    dims = {"data": 0, "spatial": h_axis}
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in mesh.mesh_dim_names)


def replicated_sharding(mesh: DeviceMesh) -> Tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_block(mesh: DeviceMesh, x: torch.Tensor, placements: Tuple) -> torch.Tensor:
    """This rank's block of the global tensor x under ``placements`` (one per
    mesh axis). A sharded dim that the axis does not divide raises
    ValueError, where XLA refuses the sharding."""
    for axis, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        n, k = mesh.size(axis), mesh.get_local_rank(axis)
        size, rest = divmod(x.shape[pl.dim], n)
        if rest:
            raise ValueError(f"dim {pl.dim} of {tuple(x.shape)} does not split over the "
                             f"{n} ranks of axis {mesh.mesh_dim_names[axis]!r}")
        x = x.narrow(pl.dim, k * size, size)
    return x.contiguous()


def shard_batch(mesh: DeviceMesh, batch: Dict[str, torch.Tensor],
                h_sharded: bool = False) -> Dict[str, torch.Tensor]:
    """Each rank's block of every [N, ...] tensor of a batch dict: N over
    'data', and with ``h_sharded`` dim 1 over 'spatial' for tensors of 3 or
    more dims."""
    return {k: local_block(mesh, x, spatial_sharding(mesh) if h_sharded and x.ndim >= 3
                           else data_sharding(mesh))
            for k, x in batch.items()}


def receptive_radius(module: torch.nn.Module) -> int:
    """Rows an output row reads on either side: the sum of every Conv2d's
    vertical reach, ``dilation * (kernel - 1) // 2`` (the depth of a
    sequential stack, an upper bound where branches run side by side).
    A strided conv raises: its output rows are not the input's."""
    radius = 0
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            if m.stride[0] != 1:
                raise ValueError(f"{m}: H-sharding needs stride 1")
            radius += m.dilation[0] * (m.kernel_size[0] - 1) // 2
    return radius


def spatial_apply(module: torch.nn.Module, x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """``module`` on this rank's rows of an H-sharded NHWC input (the
    counterpart of ``jit(apply)`` on an input placed with
    ``spatial_sharding``): x is the rank's block, [n, h, W, C] (from
    ``shard_batch(..., h_sharded=True)``). The rank takes ``receptive_radius``
    rows from each neighbour (the 'spatial' group all-gathers the blocks'
    edge rows), runs the module, crops the halo from its output (times the
    module's upscale factor) and all-gathers the rows: it returns the whole
    height of its data block, [n, s*H, s*W, C]. At the image's own top and
    bottom no halo is added, so the module's padding applies there as
    unsharded."""
    axis = mesh.mesh_dim_names.index("spatial")
    n_rows, k = mesh.size(axis), mesh.get_local_rank(axis)
    if n_rows == 1:
        return module(x)
    group = mesh.get_group(axis)
    radius, h = receptive_radius(module), x.shape[1]
    if radius > h:
        raise ValueError(f"a halo of {radius} rows exceeds a block of {h} rows")
    top = bottom = x[:, :0]
    if radius:
        edges = torch.cat([x[:, :radius], x[:, h - radius:]], 1).contiguous()
        gathered = [torch.empty_like(edges) for _ in range(n_rows)]
        dist.all_gather(gathered, edges, group=group)
        if k > 0:
            top = gathered[k - 1][:, radius:]
        if k < n_rows - 1:
            bottom = gathered[k + 1][:, :radius]
    ext = torch.cat([top, x, bottom], 1)
    out = module(ext)
    s, rest = divmod(out.shape[1], ext.shape[1])
    if rest or s < 1:
        raise ValueError(f"output rows {out.shape[1]} are not a multiple of input rows "
                         f"{ext.shape[1]}")
    out = out[:, top.shape[1] * s:out.shape[1] - bottom.shape[1] * s].contiguous()
    rows = [torch.empty_like(out) for _ in range(n_rows)]
    dist.all_gather(rows, out, group=group)
    return torch.cat(rows, 1)
