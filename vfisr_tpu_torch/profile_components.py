"""The flagship path's components timed alone (counterpart of
``scripts/profile_components.py``):

    python -m vfisr_tpu_torch.profile_components [--device cuda|cpu] [--reps N]

- the windowed warp (K1, ``ops/cuda/warp.py::warp_windowed``, f32 windows)
  on [6,1088,1920,3] (both sides of 3 timesteps, the final fusion warp's
  batch) with random +-4 px flows at (r, tile) = (8, 32x256), (6, 32x256),
  (4, 32x256), (6, 16x256), (4, 16x256), (2, 16x256): the 16x256 tiles take
  ``csrc/warp_tiled.cu``;
- the IFNet forward at batch 3 (one pair x 3 timesteps) at 1088x1920, f32
  against bf16 (default warp radii, ``weights/rife.npz``);
- Lanczos4 resize of 4 1080p frames to 1440p;
- the whole flagship step on one pair (``profile_flagship``'s P = 1 case).

One JSON line per case: ``{key: ms}`` (the median of CUDA-event times
after warm-up), the reference's keys; the warp lines also name the kernel
that ran and its launches.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.sota.rife import RIFEConfig
from vfisr_tpu_torch.ops.cuda import warp as kw
from vfisr_tpu_torch.profile_flagship import flagship_case, load_ifnet

PADDED_HW = (1088, 1920)  # 1080p padded to a multiple of 32
WARP_CASES = ((8, (32, 256)), (6, (32, 256)), (4, (32, 256)), (6, (16, 256)), (4, (16, 256)),
              (2, (16, 256)))


def kernel_name(tile) -> str:
    return "warp_windowed_kernel" if tuple(tile) == kw.TILE else "warp_tiled"


def warp_case(img, flow, r, tile, device, reps: int, warmup: int, key: str,
              compute_dtype=torch.float32) -> dict:
    """K1 on img, flow at (r, tile): {key: ms, kernel, launches}."""
    before = kw.launches
    ms = p50_ms(lambda: kw.warp_windowed(img, flow, 1.0, r, compute_dtype=compute_dtype,
                                         tile=tile), device, reps, warmup)
    return {key: ms, "kernel": kernel_name(tile) if device.type == "cuda" else "plain twin",
            "launches": kw.launches - before}


def ifnet_case(module, x0, x1, device, reps: int, warmup: int, key: str) -> dict:
    ts = torch.tensor([0.25, 0.5, 0.75], device=device)

    @torch.no_grad()
    def fwd():
        return module(x0, x1, ts)[0]

    return {key: p50_ms(fwd, device, reps, warmup)}


def resize_case(frames, out_hw, device, reps: int, warmup: int, key: str) -> dict:
    return {key: p50_ms(lambda: resize(frames, out_hw, "lanczos4"), device, reps, warmup)}


def cases(device, reps: int, warmup: int, hw=PADDED_HW, frame_hw=(1080, 1920),
          out_hw=(1440, 2560), modules=None):
    """modules: {"f32": IFNet, "bf16": IFNet, "deploy": IFNet} in place of
    the ones loaded from weights/rife.npz."""
    rng = np.random.default_rng(0)
    img6 = torch.from_numpy(rng.random((6, *hw, 3), np.float32)).to(device)
    flow6 = torch.from_numpy((rng.random((6, *hw, 2), np.float32) - 0.5) * 8).to(device)
    for r, tile in WARP_CASES:
        yield warp_case(img6, flow6, r, tile, device, reps, warmup,
                        f"warp_r{r}_t{tile[0]}x{tile[1]}_6x1080p_ms")
    del img6, flow6
    x0 = torch.from_numpy(rng.random((3, *hw, 3), np.float32)).to(device)
    x1 = torch.from_numpy(rng.random((3, *hw, 3), np.float32)).to(device)
    modules = modules or {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        module = modules.get(name) or load_ifnet(device, RIFEConfig(dtype=dt))
        yield ifnet_case(module, x0, x1, device, reps, warmup, f"ifnet_fwd_3x1080p_{name}_ms")
        del module
    fr4 = torch.from_numpy(rng.random((4, *frame_hw, 3), np.float32)).to(device)
    yield resize_case(fr4, out_hw, device, reps, warmup, "resize_lanczos_4x1080p_to_1440p_ms")
    line = flagship_case(modules.get("deploy") or load_ifnet(device), 1, True, device, reps,
                         warmup, frame_hw, out_hw)
    yield {"flagship_step_1x1080p_ms": line["step_ms"]}


def main(argv=None) -> int:
    return profile_main("profile_components", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
