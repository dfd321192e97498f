"""What the windowed warp's residual radius buys in quality, and what it
costs (counterpart of ``scripts/profile_radius.py``):

    python -m vfisr_tpu_torch.profile_radius [--device cuda|cpu] [--reps N]

For six (level, final) radius pairs of the bf16 IFNet with
``weights/rife.npz``: the midpoint PSNR on 12 held-out synthetic gaming
scenes at 512 px (``train/data.py::synthetic_batch`` from
``np.random.default_rng(987)``), and the IFNet forward's ms at 3 x 1080p
(padded to 1088, timesteps 0.25/0.5/0.75; the median of CUDA-event times
after warm-up). One JSON line per pair:
``{"l<ly><lx>_f<fy><fx>": {"psnr", "fwd_ms"}}``. A missing checkpoint
raises (the reference's script goes on with random weights).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.core.frames import pad_to_multiple
from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple
from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.sota.rife import RIFEConfig
from vfisr_tpu_torch.profile_flagship import HW, WEIGHTS, load_ifnet, random_pairs
from vfisr_tpu_torch.train.data import synthetic_batch

RADII = (((2, 4), (4, 6)), ((2, 4), (3, 5)), ((2, 4), (3, 4)), ((2, 4), (2, 4)),
         ((2, 2), (2, 4)), ((2, 4), (2, 6)))
HELD_OUT = (987, 12, 512)  # seed, scenes, crop


def held_out(seed: int = HELD_OUT[0], scenes: int = HELD_OUT[1], crop: int = HELD_OUT[2]) -> dict:
    return synthetic_batch(np.random.default_rng(seed), scenes, crop)


@torch.no_grad()
def midpoint_psnr(module, batch: dict, device) -> float:
    """The mean PSNR of the IFNet's midpoints against the scenes' ground
    truth, both as uint8 (clip to [0, 1], * 255, truncated)."""
    args = [torch.from_numpy(batch[k]).to(device) for k in ("img0", "img1", "t")]
    merged = module(*args)[0].float().cpu().numpy()
    gt = batch["gt"]
    return float(np.mean([
        compute_psnr_simple((np.clip(m, 0, 1) * 255).astype(np.uint8),
                            (g * 255).astype(np.uint8), device=str(device))
        for m, g in zip(merged, gt)]))


def radius_case(module, batch: dict, x0, x1, device, reps: int, warmup: int, key: str) -> dict:
    psnr = midpoint_psnr(module, batch, device)
    ts = torch.tensor([0.25, 0.5, 0.75], device=device)
    x0p, _ = pad_to_multiple(x0, 32)
    x1p, _ = pad_to_multiple(x1, 32)

    @torch.no_grad()
    def fwd():
        return module(x0p, x1p, ts)[0]

    return {key: {"psnr": psnr, "fwd_ms": p50_ms(fwd, device, reps, warmup)}}


def cases(device, reps: int, warmup: int, hw=HW, batch=None, weights=WEIGHTS, radii=RADII,
          config=None):
    """config: RIFEConfig fields besides the radii (bf16 by default)."""
    batch = batch if batch is not None else held_out()
    x0, x1 = random_pairs(3, hw, device, seed=1)
    for rl, rf in radii:
        cfg = RIFEConfig(**{"dtype": torch.bfloat16, **(config or {}), "level_warp_radius": rl,
                            "final_warp_radius": rf})
        module = load_ifnet(device, cfg, weights)
        yield radius_case(module, batch, x0, x1, device, reps, warmup,
                          f"l{rl[0]}{rl[1]}_f{rf[0]}{rf[1]}")


def main(argv=None) -> int:
    return profile_main("profile_radius", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
