"""Entry points of the port (counterpart of the repository's
``__graft_entry__.py``): a single-card export check and a multi-device dry
run.

- ``entry()`` returns the port's IFNet forward (``RIFEConfig()``, seeded
  init, 256x256 frames, t = 0.5) as a module of (img0, img1, t) -> the
  merged frame, with its example tensors, after checking that it exports
  through ``torch.export`` (``utils/aot.py::export_program``, which empties
  the port's per-shape caches before and after the trace).
- ``dryrun_multichip(n)`` runs ``parallel/dryrun.py``'s data-parallel
  train step on n ranks, then the deployment check of the reference
  (``__graft_entry__.py:158-196``): the fused flagship step
  (``FlagshipConfig(out_hw=(96, 128), analysis_hw=(64, 64))``, the dry run's
  narrow IFNet) on n seeded 64x64 pairs, sharded by pair over the n ranks,
  against the same step on all n pairs in one process: midpoints within
  1e-5, the uint8 frames within 1 LSB, the routes equal. NCCL with one rank
  per card on ``cuda``, gloo with ``device="cpu"``; ``flagship_sharded``
  runs the deployment check alone over a backend of the caller's choice
  (gloo over one card: NCCL refuses two ranks on one device).

    python -m vfisr_tpu_torch.graft_entry [--n N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

ENTRY_HW = 256
FLAGSHIP_HW = 64
FLAGSHIP_OUT_HW = (96, 128)
FLAGSHIP_ANALYSIS_HW = (64, 64)
MIDS_TOL = 1e-5  # the reference's tolerance of the sharded midpoints


class _Merged(torch.nn.Module):
    """The IFNet's forward returning the merged frame alone."""

    def __init__(self, module: torch.nn.Module):
        super().__init__()
        self.module = module

    def forward(self, img0, img1, t):
        return self.module(img0, img1, t)[0]


def entry(device: str = "cuda"):
    """(fn, example_args): the port's IFNet forward at 256x256 and its
    example tensors, checked through ``torch.export``."""
    from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
    from vfisr_tpu_torch.utils.aot import export_program

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = IFNet(RIFEConfig())
    fn = _Merged(module).to(device).eval()
    img0 = torch.zeros((1, ENTRY_HW, ENTRY_HW, 3), dtype=torch.float32, device=device)
    img1 = torch.zeros_like(img0)
    t = torch.tensor([0.5], dtype=torch.float32, device=device)
    with torch.no_grad():
        export_program(fn, img0, img1, t)
    return fn, (img0, img1, t)


def _flagship_module() -> torch.nn.Module:
    """The dry run's narrow IFNet from a seeded init (the same parameters
    in every process)."""
    from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
    from vfisr_tpu_torch.parallel.dryrun import DRYRUN_RIFE

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return IFNet(RIFEConfig(**DRYRUN_RIFE)).eval()


def flagship_pairs(n: int) -> tuple:
    """The check's n seeded 64x64 pairs (x0, x1) as numpy arrays."""
    rng = np.random.default_rng(2)
    return tuple(rng.random((n, FLAGSHIP_HW, FLAGSHIP_HW, 3)).astype(np.float32)
                 for _ in range(2))


def flagship_run(x0: torch.Tensor, x1: torch.Tensor, device) -> dict:
    """The fused flagship step on pairs x0, x1 [P,H,W,3] on device, from a
    fresh HUD history: the uint8 frames, the midpoints and the routes on
    the CPU."""
    from vfisr_tpu_torch.pipeline.flagship import FlagshipConfig, init_history, make_flagship_step

    cfg = FlagshipConfig(out_hw=FLAGSHIP_OUT_HW, analysis_hw=FLAGSHIP_ANALYSIS_HW)
    step = make_flagship_step(_flagship_module().to(device), cfg)
    hist, hcnt = init_history(x0.shape[0], device)
    up, mids, _, _, sig = step(x0.to(device), x1.to(device), hist, hcnt)
    return {"up": up.cpu(), "mids": mids.cpu(), "route": sig["route_vfimamba"].cpu()}


def _flagship_rank(rank: int, world: int, device_type: str, pairs: tuple) -> dict:
    """One rank of the deployment check: its block of the pairs (sharded
    over the mesh's 'data' axis) through the step."""
    from vfisr_tpu_torch.parallel.mesh import make_mesh, shard_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    mesh = make_mesh(world, device_type=device_type)
    block = shard_batch(mesh, {"x0": torch.from_numpy(pairs[0]).to(device),
                               "x1": torch.from_numpy(pairs[1]).to(device)})
    return flagship_run(block["x0"], block["x1"], device)


def flagship_ranks(n: int, device: str = "cuda", backend: str | None = None,
                   timeout: float = 600.0) -> list:
    """Each of n ranks' results of the step on its block of
    ``flagship_pairs(n)`` (``backend``: NCCL on cuda, gloo on cpu by
    default)."""
    from vfisr_tpu_torch.parallel.launch import run

    backend = backend or ("nccl" if device == "cuda" else "gloo")
    return run(_flagship_rank, n, device, flagship_pairs(n), backend=backend, device=device,
               timeout=timeout)


def check_sharded(ref: dict, ranks: list, label: str) -> dict:
    """The ranks' results against ``flagship_run`` on all their pairs in one
    process: midpoints within MIDS_TOL, uint8 frames within 1 LSB, routes
    equal; raises where a check fails."""
    n = len(ranks)
    t_count = ref["mids"].shape[0] // n
    mids = torch.cat([r["mids"] for r in ranks])
    up = torch.cat([r["up"] for r in ranks])
    route = torch.cat([r["route"] for r in ranks])
    # the step's up holds each block's x0 frames, then its midpoints
    ref_up = torch.cat([torch.cat([ref["up"][i:i + 1],
                                   ref["up"][n + i * t_count:n + (i + 1) * t_count]])
                        for i in range(n)])
    mids_err = (mids - ref["mids"]).abs().max().item()
    up_err = int((up.int() - ref_up.int()).abs().max().item())
    if mids_err > MIDS_TOL:
        raise RuntimeError(f"sharded flagship midpoints diverge from one process: {mids_err}")
    if up_err > 1:
        raise RuntimeError(f"sharded uint8 SR output differs by {up_err} LSB")
    if not torch.equal(route, ref["route"]):
        raise RuntimeError(f"sharded routes {route.tolist()} against {ref['route'].tolist()}")
    print(f"dryrun_multichip OK: flagship inference sharded by pair over {n} ranks ({label}) "
          f"matches one process (pairs={n}, midpoints max diff {mids_err:.3e}, max uint8 "
          f"diff={up_err})")
    return {"mids_err": mids_err, "up_err": up_err, "pairs": n}


def flagship_sharded(n: int, device: str = "cuda", backend: str | None = None,
                     timeout: float = 600.0) -> dict:
    """The deployment check: the flagship step on n seeded pairs, sharded
    by pair over n ranks (``flagship_ranks``), against the same step in this
    process (``check_sharded``)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ref = flagship_run(*(torch.from_numpy(x) for x in flagship_pairs(n)), device)
    ranks = flagship_ranks(n, device, backend, timeout)
    return dict(check_sharded(ref, ranks, f"{backend} on {device}"), backend=backend)


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """The data-parallel train step on n ranks, then the sharded flagship
    check (NCCL on cuda with one rank per card, gloo on cpu)."""
    from vfisr_tpu_torch.parallel.dryrun import dryrun

    results = dryrun(n_devices, device, timeout)
    print(f"dryrun_multichip OK: {n_devices}-rank mesh {results[0]['mesh']} on {device}, one "
          f"train step, loss={results[0]['loss']:.4f}")
    return flagship_sharded(n_devices, device, timeout=timeout)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.graft_entry",
                                     description="Export check and multi-device dry run")
    parser.add_argument("--n", type=int, default=2, help="ranks of the dry run")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    with torch.no_grad():
        out = fn(*example)
    print(f"entry OK: IFNet forward exported and run, output {tuple(out.shape)} on {args.device}")
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
