"""Lowerings of the IFBlock's 3x3 residual conv at its block shapes, bf16,
batch 3 (counterpart of ``scripts/profile_conv.py``):

    python -m vfisr_tpu_torch.profile_conv [--device cuda|cpu] [--reps N]

The reference's three forms of the same conv (NHWC input, HWIO kernel):
- ``native``: ``conv2d`` as the IFBlock runs it (NCHW, cuDNN on); also
  ``native_no_cudnn`` (PyTorch's own convolution: the other choice
  ``models/base.py::planned_conv`` makes) and ``native_channels_last``
  (cuDNN on a channels-last input);
- ``im2col``: the 9 shifted copies of the padded input along C, one
  [M, 9C] x [9C, C] GEMM;
- ``taps9``: 9 GEMMs [M, C] x [C, C], each accumulated in f32.

At ``b2_136x240_c112``, ``b3_136x240_c80`` and ``b1_68x120_c160`` (IFBlock
trunks at 1/4 of their block's input). One JSON line per (shape, form):
``{"<shape>_<form>": {"ms", "max_err_vs_native"}}``, the median of
CUDA-event times after warm-up and the largest difference from the native
form's output. These inform ``models/base.py::CUDNN_WINS``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from vfisr_tpu_torch.evaluation.speed import p50_ms, profile_main
from vfisr_tpu_torch.models.base import without_cudnn

SHAPES = (("b2_136x240_c112", (3, 136, 240, 112)), ("b3_136x240_c80", (3, 136, 240, 80)),
          ("b1_68x120_c160", (3, 68, 120, 160)))


def _shifted(x: torch.Tensor):
    """The 9 shifted [N,H,W,C] views of x padded by one pixel, in (dy, dx)
    row-major order."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]


def im2col(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,C], k [3,3,C,O] (HWIO): one [M, 9C] x [9C, O] GEMM."""
    cols = torch.cat(_shifted(x), dim=-1)
    return cols @ k.reshape(9 * x.shape[-1], k.shape[-1])


def taps9(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x [N,H,W,C], k [3,3,C,O]: nine [M, C] x [C, O] GEMMs summed in f32."""
    acc = None
    for i, xs in enumerate(_shifted(x)):
        part = (xs @ k[i // 3, i % 3]).float()
        acc = part if acc is None else acc + part
    return acc.to(x.dtype)


def native(x_nchw: torch.Tensor, k_oihw: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x_nchw, k_oihw, padding=1)


def conv_cases(label: str, shape, device, reps: int, warmup: int, dtype=torch.bfloat16,
               seed: int = 0):
    """The five forms at one shape: one dict per form."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = torch.from_numpy(rng.random(shape, np.float32)).to(device, dtype)
    k = torch.from_numpy((rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32))
    k = k.to(device, dtype)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
    k_oihw = k.permute(3, 2, 0, 1).contiguous()

    def no_cudnn():
        with without_cudnn():
            return native(x_nchw, k_oihw)

    forms = {  # name: (call, whether its output is NCHW)
        "native": (lambda: native(x_nchw, k_oihw), True),
        "native_no_cudnn": (no_cudnn, True),
        "native_channels_last": (lambda: native(x_cl, k_oihw), True),
        "im2col": (lambda: im2col(x, k), False),
        "taps9": (lambda: taps9(x, k), False),
    }
    ref = None
    for name, (fn, nchw) in forms.items():
        with torch.no_grad():
            ms = p50_ms(fn, device, reps, warmup)
            y = fn().float()
        y = y.permute(0, 2, 3, 1) if nchw else y
        ref = y if ref is None else ref
        yield {f"{label}_{name}": {"ms": ms,
                                    "max_err_vs_native": float((y - ref).abs().max())}}


def cases(device, reps: int, warmup: int, shapes=None):
    for label, shape in shapes or SHAPES:
        yield from conv_cases(label, shape, device, reps, warmup)


def main(argv=None) -> int:
    return profile_main("profile_conv", __doc__.split("\n\n")[0], cases, argv)


if __name__ == "__main__":
    sys.exit(main())
