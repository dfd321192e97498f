"""Seeded weights, made on the device in a few large calls.

Every parameter is center + scale * u with u uniform in [-1, 1) from one
``torch.rand`` call of a generator on the device seeded from ``--seed``:

- a weight of two or more axes: center 0, scale 1/sqrt(fan_in) (PyTorch's
  default bound for convolutions and linear layers; a 4x4 stride-2
  transpose convolution sums c_in * 4 taps per output);
- a bias: center 0, scale 0.1;
- a LayerNorm weight and Mamba's skip ``D``: center 1, scale 0.1;
- Mamba's ``A_log``: center log(1..S) along the state (S4D-real, as Mamba
  initialises it), scale 0.1.

The program and the reference get the same tensors: the reference as they
are, the program copied into its modules (cast to the module's dtype).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch


def _rule(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if leaf == "A_log":
        return 0.0, 0.1
    if leaf == "D" or (owner.startswith("LayerNorm") and leaf == "weight"):
        return 1.0, 0.1
    if len(shape) < 2:
        return 0.0, 0.1
    if "ConvTranspose" in owner:
        fan_in = shape[0] * shape[2] * shape[3] // 4
    else:
        fan_in = int(np.prod(shape[1:]))
    return 0.0, 1.0 / math.sqrt(fan_in)


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed % (2 ** 64), stream]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make(shapes: List[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every (name, shape), all views of one
    buffer drawn on ``device``."""
    sizes = [int(np.prod(s)) for _, s in shapes]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, 1))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    rules = [_rule(n, tuple(s)) for n, s in shapes]
    counts = torch.tensor(sizes, device=device)
    center = torch.repeat_interleave(torch.tensor([c for c, _ in rules], device=device), counts)
    scale = torch.repeat_interleave(torch.tensor([s for _, s in rules], device=device), counts)
    flat = torch.addcmul(center, scale, u)
    out, off = {}, 0
    for (name, shape), size in zip(shapes, sizes):
        t = flat[off:off + size].view(shape)
        if name.endswith("A_log"):
            t += torch.log(torch.arange(1, shape[1] + 1, device=device, dtype=torch.float32))
        out[name] = t
        off += size
    return out
