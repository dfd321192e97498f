"""The port's CUDA kernels held against their plain twins, on the card.

These have no CPU mode (nvcc builds the kernels on the card's machine), so
they carry the ``cuda`` marker and skip without a card. The file imports no
jax, so it also runs where jax is not installed (``--noconftest`` skips
tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: 1e-5 with f32 windows, 2/255 with bf16 windows (the kernel and
its twin take the same rounding steps; the bound is the twin's own against
the Pallas kernel).
"""

import numpy as np
import pytest
import torch

from _torch_port import smooth_flow
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 / 255.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("r,amp", [((3, 4), 6.0), ((2, 2), 25.0)])
def test_warp_kernel_matches_plain(border, dt, r, amp):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    rng = np.random.default_rng(7)
    n, h, w, c = 2, 272, 480, 3
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda().to(dt)
    flow = torch.from_numpy(smooth_flow(rng, n, h, w, amp, 2.0)).cuda()
    before = tw.launches
    out = tw.warp_windowed(img, flow, 1.0, r=r, border=border, compute_dtype=dt)
    torch.cuda.synchronize()
    assert tw.launches == before + 1
    ref = tw.warp_windowed_plain(img, flow, 1.0, r=r, border=border, compute_dtype=dt)
    assert out.dtype == dt
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dt]
