"""Throughput of the IFNet pipeline against the pair batch (counterpart of
``scripts/profile_pairs.py``):

    python -m vfisr_tpu_torch.profile_pairs [--device cuda|cpu] [--reps N]

One step on P random 1080p pairs: pad to a multiple of 32, each pair
repeated over the 3 timesteps (0.25/0.5/0.75), the IFNet in bf16 at its
default warp radii (level (2,4), final (4,6)) at batch 3 P, unpad, and
Lanczos4 SR of the P x0 frames and the 3 P midpoints to 1440p as uint8;
P = 1, 2, 4. The IFNet carries ``weights/rife.npz``. Per case one JSON line:
``pairs``, ``step_ms`` (the median of CUDA-event times after warm-up) and
``interp_fps`` = 3 P / step.
"""

from __future__ import annotations

import sys

import torch

from vfisr_tpu_torch.core.frames import pad_to_multiple, to_uint8, unpad
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.sota.rife import RIFEConfig
from vfisr_tpu_torch.profile_flagship import HW, OUT_HW, WEIGHTS, load_ifnet, random_pairs
from vfisr_tpu_torch.utils.paths import REPO_ROOT

PAIRS = (1, 2, 4)
TS = (0.25, 0.5, 0.75)


@torch.no_grad()
def pipeline_step(module, x0: torch.Tensor, x1: torch.Tensor, out_hw=OUT_HW):
    """(up uint8 [P + 3P, OH, OW, 3], mids [3P, H, W, 3]) of pairs x0, x1."""
    p, h, w, _ = x0.shape
    x0p, _ = pad_to_multiple(x0, 32)
    x1p, _ = pad_to_multiple(x1, 32)
    ts = torch.tensor(TS, dtype=x0.dtype, device=x0.device).repeat(p)
    merged = module(x0p.repeat_interleave(len(TS), 0), x1p.repeat_interleave(len(TS), 0), ts)[0]
    mids = unpad(merged, h, w).float()
    up = to_uint8(resize(torch.cat([x0, mids]), out_hw, "lanczos4"))
    return up, mids


def pairs_case(module, pairs: int, device, reps: int, warmup: int, hw=HW, out_hw=OUT_HW) -> dict:
    x0, x1 = random_pairs(pairs, hw, device)
    ms = p50_ms(lambda: pipeline_step(module, x0, x1, out_hw), device, reps, warmup)
    return {"pairs": pairs, "step_ms": ms, "interp_fps": len(TS) * pairs * 1000.0 / ms,
            "weights": str(WEIGHTS.relative_to(REPO_ROOT))}


def cases(device, reps: int, warmup: int, hw=HW, out_hw=OUT_HW, module=None):
    module = module if module is not None else load_ifnet(device,
                                                          RIFEConfig(dtype=torch.bfloat16))
    for pairs in PAIRS:
        yield pairs_case(module, pairs, device, reps, warmup, hw, out_hw)


def main(argv=None) -> int:
    return profile_main("profile_pairs", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
