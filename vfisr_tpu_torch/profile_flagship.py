"""The flagship fused step's throughput against the pair batch (counterpart
of ``scripts/profile_flagship.py``):

    python -m vfisr_tpu_torch.profile_flagship [--device cuda|cpu] [--reps N]

``pipeline/flagship.py::make_flagship_step`` (router analysis at 480x270,
HUD ring, RIFE in the bf16 deploy config with warp radii (2,2)/(3,4), the
branchless scene and HUD composites, Lanczos4 SR to 1440p) on P random
1080p pairs [P,H,W,3] per step, for P = 1 and 2 with shared-flow timesteps
and P = 1 with an IFNet pass per timestep. The IFNet carries
``weights/rife.npz`` (the reference's script took a random init; the
weights do not change the work). Per case one JSON line: ``pairs``,
``shared_flow``, ``step_ms`` (the median of CUDA-event times after
warm-up) and ``interp_fps`` = 3 P / step.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.sota.rife import RIFEConfig, RIFEModel
from vfisr_tpu_torch.pipeline.flagship import FlagshipConfig, init_history, make_flagship_step
from vfisr_tpu_torch.utils.paths import REPO_ROOT

HW, OUT_HW = (1080, 1920), (1440, 2560)
CASES = ((1, True), (2, True), (1, False))  # (pairs, shared_flow)
WEIGHTS = REPO_ROOT / "weights" / "rife.npz"
DEPLOY = RIFEConfig(dtype=torch.bfloat16, level_warp_radius=(2, 2), final_warp_radius=(3, 4))


def load_ifnet(device, config: RIFEConfig = DEPLOY, weights=WEIGHTS) -> torch.nn.Module:
    """The IFNet of ``config`` on device with ``weights`` (strict: a missing
    or mismatched file raises)."""
    model = RIFEModel(device=str(device), config=config)
    model.load(str(weights))
    return model.module


def random_pairs(pairs: int, hw, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((pairs, *hw, 3), np.float32)).to(device)
                 for _ in range(2))


def flagship_case(module, pairs: int, shared: bool, device, reps: int, warmup: int, hw=HW,
                  out_hw=OUT_HW) -> dict:
    cfg = FlagshipConfig(out_hw=out_hw, shared_flow=shared)
    step = make_flagship_step(module, cfg)
    f0, f1 = random_pairs(pairs, hw, device)
    hist, hcnt = init_history(pairs, device)
    ms = p50_ms(lambda: step(f0, f1, hist, hcnt), device, reps, warmup)
    return {"pairs": pairs, "shared_flow": shared, "step_ms": ms,
            "interp_fps": len(cfg.timestamps) * pairs * 1000.0 / ms,
            "weights": str(WEIGHTS.relative_to(REPO_ROOT))}


def cases(device, reps: int, warmup: int, hw=HW, out_hw=OUT_HW, module=None):
    module = module if module is not None else load_ifnet(device)
    for pairs, shared in CASES:
        yield flagship_case(module, pairs, shared, device, reps, warmup, hw, out_hw)


def main(argv=None) -> int:
    return profile_main("profile_flagship", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
