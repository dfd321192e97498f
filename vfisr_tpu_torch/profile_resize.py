"""The resize paths at the pipeline's SR shape and the degrade shape
(counterpart of ``scripts/profile_resize.py``):

    python -m vfisr_tpu_torch.profile_resize [--device cuda|cpu] [--reps N]

``sr_4x1080p_to_1440p`` (Lanczos4) and ``degrade_4x1080p_to_540p`` (area)
on 4 random frames: the port's tap gather (``core/resize.py::resize``,
``_apply_axis`` per axis, f32) against a dense matmul of the same weights
per axis, at ``high`` (f32 with TF32 off) and ``default_tf32`` (TF32 on,
the TPU's single-pass default's counterpart). One JSON line per (shape,
form): ``{"<shape>_<form>": {"ms", "max_err_vs_gather"}}``, the median of
CUDA-event times after warm-up and the largest difference from the f32
gather's output. TF32 is off again after each case.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import _tap_table, resize
from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main

RESIZE_CASES = (("sr_4x1080p_to_1440p", (4, 1080, 1920, 3), (1440, 2560), "lanczos4"),
                ("degrade_4x1080p_to_540p", (4, 1080, 1920, 3), (540, 960), "area"))


def dense_weights(in_size: int, out_size: int, method: str, device) -> torch.Tensor:
    """[out, in] f32: the tap table's weights scattered into a matrix (taps
    clamped onto the same source pixel add up)."""
    idx, w = _tap_table(in_size, out_size, method)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.repeat(np.arange(out_size), idx.shape[1]), idx.reshape(-1)),
              w.reshape(-1))
    return torch.from_numpy(m).to(device)


def resize_dense(x: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,C] f32 through the row and column matrices wh [OH, H], ww
    [OW, W]."""
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, y)


def resize_cases(name: str, shape, out_hw, method: str, device, reps: int, warmup: int,
                 seed: int = 0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(shape, np.float32)).to(device)
    wh = dense_weights(shape[1], out_hw[0], method, device)
    ww = dense_weights(shape[2], out_hw[1], method, device)
    ref = resize(x, out_hw, method)
    forms = (("gather", lambda: resize(x, out_hw, method), False),
             ("high", lambda: resize_dense(x, wh, ww), False),
             ("default_tf32", lambda: resize_dense(x, wh, ww), True))
    for form, fn, tf32 in forms:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            ms = p50_ms(fn, device, reps, warmup)
            err = float((fn() - ref).abs().max())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        yield {f"{name}_{form}": {"ms": ms, "max_err_vs_gather": err}}


def cases(device, reps: int, warmup: int, resize_cases_=RESIZE_CASES):
    for name, shape, out_hw, method in resize_cases_:
        yield from resize_cases(name, shape, out_hw, method, device, reps, warmup)


def main(argv=None) -> int:
    return profile_main("profile_resize", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
