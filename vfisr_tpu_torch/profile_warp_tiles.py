"""The windowed warp (K1) over output tiles at the deploy radius, bf16
windows (counterpart of ``scripts/profile_warp_tiles.py``):

    python -m vfisr_tpu_torch.profile_warp_tiles [--device cuda|cpu] [--reps N]

A smooth gaming flow (fx = 6 sin(2 pi y / 540) + 3, fy = 2 cos(2 pi x /
960)) warps [6,1088,1920,3] at r = (3, 4) over the reference's seven tiles,
and [6,544,960,3] (the flow halved and subsampled) at r = (2, 2) over its
three. The 32x256 tile takes the tile kernels of ``csrc/warp_windowed.cu``,
every other ``csrc/warp_tiled.cu``. One JSON line per tile:
``warp_r34_bf16_t<th>x<tw>_ms`` or ``warp_r22_bf16_half_t<th>x<tw>_ms``
(the median of CUDA-event times after warm-up), the kernel that ran and
its launches.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.evaluation.speed import profile_main
from vfisr_tpu_torch.profile_components import PADDED_HW, warp_case

TILES = ((32, 256), (40, 256), (40, 640), (104, 640), (104, 256), (40, 1920), (8, 640))
HALF_TILES = ((32, 256), (40, 960), (104, 960))


def gaming_flow(h: int, w: int) -> np.ndarray:
    """[h, w, 2] f32 (dx, dy): a large-scale sinusoidal field plus a pan."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx = 6.0 * np.sin(2 * np.pi * yy / 540) + 3.0
    fy = 2.0 * np.cos(2 * np.pi * xx / 960)
    return np.stack([fx, fy], axis=-1).astype(np.float32)


def cases(device, reps: int, warmup: int, hw=PADDED_HW, tiles=TILES, half_tiles=HALF_TILES):
    h, w = hw
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.random((6, h, w, 3), np.float32)).to(device)
    flow1 = gaming_flow(h, w)
    flow = torch.from_numpy(np.broadcast_to(flow1, (6, h, w, 2)).copy()).to(device)
    for tile in tiles:
        yield warp_case(img, flow, (3, 4), tile, device, reps, warmup,
                        f"warp_r34_bf16_t{tile[0]}x{tile[1]}_ms", torch.bfloat16)
    img_h = torch.from_numpy(rng.random((6, h // 2, w // 2, 3), np.float32)).to(device)
    flow_h = torch.from_numpy(np.broadcast_to(flow1[::2, ::2] / 2,
                                              (6, h // 2, w // 2, 2)).copy()).to(device)
    for tile in half_tiles:
        yield warp_case(img_h, flow_h, (2, 2), tile, device, reps, warmup,
                        f"warp_r22_bf16_half_t{tile[0]}x{tile[1]}_ms", torch.bfloat16)


def main(argv=None) -> int:
    return profile_main("profile_warp_tiles", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
