"""The adaptive fast path end to end, and the full-resolution analyzer
alone (counterpart of ``scripts/profile_adaptive.py``):

    python -m vfisr_tpu_torch.profile_adaptive [--device cuda|cpu] [--reps N]

On one random 1080p pair:
- ``analyze_fullres_ms``: ``models/novel/adaptive_pipeline.py::_analyze_core``
  (scene SSIM, full-resolution Farneback, particles, the HUD ring) with the
  scene threshold 0.65, the SSIM-only gate (warp threshold 1.0), particles
  0.4 and HUD variance 10.0 (the reference's script passes three of the
  four thresholds positionally, which its ``_analyze_core`` no longer
  takes);
- ``analyze_480x270_ms``: linear resize to 480x270, gray, Farneback and the
  mean flow magnitude;
- ``adaptive_step_ms`` and ``adaptive_interp_fps``: that analysis, the
  IFNet in the bf16 deploy config (radii (2,2)/(3,4), ``weights/rife.npz``)
  over the 3 timesteps, the branchless scene-cut gate and Lanczos4 SR of
  the 4 frames to 1440p as uint8.

One JSON line per case, times the median of CUDA-event times after
warm-up.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import pad_to_multiple, to_uint8, unpad
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.novel.adaptive_pipeline import _analyze_core
from vfisr_tpu_torch.ops.flow import farneback_flow
from vfisr_tpu_torch.profile_flagship import HW, OUT_HW, load_ifnet, random_pairs

ANALYSIS_HW = (270, 480)
TS = (0.25, 0.5, 0.75)


def motion_480x270(a: torch.Tensor, b: torch.Tensor, analysis_hw=ANALYSIS_HW) -> torch.Tensor:
    """The mean Farneback flow magnitude of each pair at the analysis size."""
    g0 = rgb_to_gray(resize(a, analysis_hw, "linear") * 255.0)
    g1 = rgb_to_gray(resize(b, analysis_hw, "linear") * 255.0)
    flow = farneback_flow(g0, g1, 0.5, 3, 15, 3, 5, 1.2)
    return torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2).mean(dim=(1, 2))


@torch.no_grad()
def adaptive_step(module, a: torch.Tensor, b: torch.Tensor, out_hw=OUT_HW,
                  analysis_hw=ANALYSIS_HW):
    """(up uint8 [4, OH, OW, 3], mids [3, H, W, 3]) of one pair."""
    h, w = a.shape[1:3]
    scene = motion_480x270(a, b, analysis_hw) > 1e9  # the scene-cut gate (never on random data)
    ap, _ = pad_to_multiple(a, 32)
    bp, _ = pad_to_multiple(b, 32)
    ts = torch.tensor(TS, dtype=a.dtype, device=a.device)
    merged = module(ap.repeat_interleave(len(TS), 0), bp.repeat_interleave(len(TS), 0), ts)[0]
    mids = unpad(merged, h, w).float()
    mids = torch.where(scene[:, None, None, None], a, mids)  # branchless gate
    return to_uint8(resize(torch.cat([a, mids]), out_hw, "lanczos4")), mids


def cases(device, reps: int, warmup: int, hw=HW, out_hw=OUT_HW, analysis_hw=ANALYSIS_HW,
          module=None):
    x0, x1 = random_pairs(1, hw, device)
    hist = torch.zeros((1, 10, 180, 320), device=device)
    hcnt = torch.zeros((1,), dtype=torch.int32, device=device)
    with torch.no_grad():
        yield {"analyze_fullres_ms": p50_ms(
            lambda: _analyze_core(x0, x1, hist, hcnt, 0.65, 1.0, 0.4, 10.0), device, reps,
            warmup)}
        yield {"analyze_480x270_ms": p50_ms(lambda: motion_480x270(x0, x1, analysis_hw), device,
                                            reps, warmup)}
    module = module if module is not None else load_ifnet(device)
    ms = p50_ms(lambda: adaptive_step(module, x0, x1, out_hw, analysis_hw), device, reps, warmup)
    yield {"adaptive_step_ms": ms, "adaptive_interp_fps": len(TS) * 1000.0 / ms}


def main(argv=None) -> int:
    return profile_main("profile_adaptive", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
