"""The precision of the reference's convolutions and matrix products.

The reference computes in float32 (``FULL``). The control of the check
that decides ``correct`` is the same reference one precision step below
what the configuration states, on every convolution and matrix product:
an operation stated in bfloat16 takes fp8 (e4m3, one scale per tensor),
one stated in float32 with TF32 off takes TF32 (inputs rounded to a
10-bit mantissa, sums in float32, as the tensor cores take them). Each
operation of the reference names the precision the configuration states
for it (``stated``); ``Precision`` rounds its inputs accordingly and
computes in float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    if x.device.type == "meta":
        return x
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float32 through float8_e4m3fn with one scale per tensor (its
    largest magnitude maps to 448), and back."""
    if x.device.type == "meta":
        return x
    x = x.float()
    scale = x.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@dataclass(frozen=True)
class Precision:
    """lower=False: every operation in float32 (the reference). lower=True:
    each operation's inputs rounded one step below its stated precision
    (the control)."""

    lower: bool = False

    def q(self, x: torch.Tensor, stated: str) -> torch.Tensor:
        if not self.lower or x is None:
            return x
        if stated == "bfloat16":
            return round_fp8(x)
        if stated == "float32":
            return round_tf32(x)
        raise ValueError(f"no lower precision for {stated!r}")

    def cast(self, x: torch.Tensor, dtype: torch.dtype, stated: str) -> torch.Tensor:
        """``x.to(dtype)`` where the program casts to its stated dtype: the
        control stores the value in fp8 there where bfloat16 is stated
        (TF32 changes the arithmetic of products, not what is stored)."""
        x = x.to(dtype)
        return self.q(x, stated) if self.lower and stated == "bfloat16" else x

    def conv2d(self, x, w, b, stride=1, padding=0, groups=1, stated="float32"):
        return F.conv2d(self.q(x, stated), self.q(w, stated), b, stride, padding, 1, groups)

    def conv_transpose2d(self, x, w, b, stride, padding, stated="float32"):
        return F.conv_transpose2d(self.q(x, stated), self.q(w, stated), b, stride, padding)

    def conv1d(self, x, w, groups, stated="float32"):
        return F.conv1d(self.q(x, stated), self.q(w, stated), None, 1, 0, 1, groups)

    def linear(self, x, w, b, stated="float32"):
        return F.linear(self.q(x, stated), self.q(w, stated), b)

    def matmul(self, a, b, stated="float32"):
        return torch.matmul(self.q(a, stated), self.q(b, stated))


FULL = Precision(False)
CONTROL = Precision(True)
