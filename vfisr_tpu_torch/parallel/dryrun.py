"""Multi-device dry run of the data-parallel train step (port of
``__graft_entry__.py::dryrun_multichip``).

    python -m vfisr_tpu_torch.parallel.dryrun --n 4
    python -m vfisr_tpu_torch.parallel.dryrun --n 2 --device cpu

Starts N ranks (``parallel/launch.py``): NCCL with one rank per card on
``cuda`` (N more than the cards raises), gloo over CPU tensors with
``--device cpu``. They build the mesh, run one data-parallel step of the
dry run's RIFE (scales (4, 2, 1), channels (32, 24, 16), 2 convs per block;
64x64 frames, batch max(N, 2), a seeded uniform batch), and check that the
loss is finite and that every rank holds the same parameters after it.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.distributed as dist

from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
from vfisr_tpu_torch.parallel.launch import run
from vfisr_tpu_torch.parallel.mesh import make_mesh, shard_batch
from vfisr_tpu_torch.train.train import create_train_state, make_train_step

DRYRUN_RIFE = dict(scales=(4, 2, 1), channels=(32, 24, 16), num_convs=2)
HW = 64


def _rank(rank: int, world: int, device_type: str) -> dict:
    device = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    torch.backends.cudnn.allow_tf32 = False  # the f32 config in f32, as the trainer runs it
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(world, device_type=device_type)
    torch.manual_seed(rank)  # rank 0's init reaches every rank through the step's broadcast
    module = IFNet(RIFEConfig(**DRYRUN_RIFE)).to(device).train()
    state = create_train_state(module.parameters())
    step = make_train_step(module, state, mesh=mesh)
    n = max(world, 2)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.rand(n, HW, HW, 3, generator=gen) for k in ("img0", "img1", "gt")}
    batch["t"] = torch.full((n,), 0.5)
    loss = step(shard_batch(mesh, {k: v.to(device) for k, v in batch.items()}))
    flat = torch.cat([p.detach().reshape(-1) for p in module.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return {"loss": float(loss), "differing": int((flat != ref).sum()), "step": state.step,
            "mesh": tuple(mesh.shape)}


def dryrun(n: int, device: str = "cuda", timeout: float = 600.0) -> list:
    """One data-parallel step on n ranks; each rank's loss, mesh shape and
    count of parameters differing from rank 0's. Raises when a check
    fails."""
    if device == "cuda":
        cards = torch.cuda.device_count()
        if n > cards:
            raise ValueError(f"requested {n} ranks, have {cards} CUDA card(s); NCCL takes one "
                             "rank per card")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    results = run(_rank, n, device, backend=backend, device=device, timeout=timeout)
    for rank, r in enumerate(results):
        if not torch.isfinite(torch.tensor(r["loss"])):
            raise RuntimeError(f"rank {rank}: non-finite loss {r['loss']}")
        if r["differing"] or r["step"] != 1:
            raise RuntimeError(f"rank {rank}: {r['differing']} parameters differ from rank 0's "
                               f"after {r['step']} step(s)")
        if r["loss"] != results[0]["loss"]:
            raise RuntimeError(f"rank {rank}: loss {r['loss']} against rank 0's {results[0]['loss']}")
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.parallel.dryrun",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, required=True, help="ranks (devices) of the mesh")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole run")
    args = parser.parse_args(argv)
    results = dryrun(args.n, args.device, args.timeout)
    print(f"dryrun OK: {args.n}-rank mesh {results[0]['mesh']} on {args.device}, one "
          f"data-parallel train step, loss={results[0]['loss']:.6f}, parameters equal on every rank")
    return 0


if __name__ == "__main__":
    sys.exit(main())
