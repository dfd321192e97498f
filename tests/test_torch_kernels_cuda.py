"""The port's CUDA kernels held against their plain twins, on the card.

These have no CPU mode (nvcc builds the kernels on the card's machine), so
they carry the ``cuda`` marker and skip without a card. The file imports no
jax, so it also runs where jax is not installed (``--noconftest`` skips
tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: 1e-5 with f32 windows, 2/255 with bf16 windows, relative to
max(1, the reference's largest magnitude) (the kernel and its twin take the
same rounding steps; the bound is the twin's own against the Pallas kernel).
"""

import numpy as np
import pytest
import torch

from _torch_port import smooth_flow
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 / 255.0}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")


def _err(out, ref):
    return (out.float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("r,amp", [((3, 4), 6.0), ((2, 2), 25.0)])
def test_warp_kernel_matches_plain(border, dt, r, amp):
    _needs_card()
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


def _grad_flow(rng, kind, n, h, w):
    if kind == "zero":
        return torch.zeros((n, h, w, 2))
    if kind == "integer":
        return torch.from_numpy(rng.integers(-3, 4, (n, h, w, 2)).astype(np.float32))
    if kind == "past_r":
        return torch.from_numpy(smooth_flow(rng, n, h, w, 25.0, 4.0))
    return torch.from_numpy(smooth_flow(rng, n, h, w, 6.0, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("kind", ["random", "zero", "integer", "past_r"])
def test_warp_grad_kernel_matches_plain(border, dt, kind):
    """K2 (the flow gradient, both axes in one launch) against its twin; a
    per-batch t and a non-contiguous cotangent, as autograd hands it."""
    _needs_card()
    rng = np.random.default_rng(11)
    n, h, w, c = 2, 136, 300, 3
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    flow = _grad_flow(rng, kind, n, h, w).cuda()
    t = torch.tensor([0.75, 1.0], device="cuda")
    ct = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32)).cuda().permute(0, 2, 3, 1)
    before = tw.grad_launches
    gflow, cg = tw.warp_windowed_grad(img, flow, t, ct, (2, 4), border, dt)
    torch.cuda.synchronize()
    assert tw.grad_launches == before + 1
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, t, ct, (2, 4), border, dt)
    assert gflow.dtype == flow.dtype and cg.dtype == torch.float32
    assert _err(gflow, ref_gflow) <= TOL[dt] and _err(cg, ref_cg) <= TOL[dt]
    assert ref_cg.abs().max().item() > 0  # the case has a gradient to check


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_warp_grad_kernel_bf16_img_and_flow(dt):
    """bf16 img, cotangent and flow: the per-channel derivative rounds to
    bf16, grad_flow is written in bf16."""
    _needs_card()
    rng = np.random.default_rng(5)
    n, h, w, c = 1, 96, 260, 4
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda().bfloat16()
    flow = torch.from_numpy(smooth_flow(rng, n, h, w, 5.0, 1.0)).cuda().bfloat16()
    ct = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32)).cuda().bfloat16()
    gflow, cg = tw.warp_windowed_grad(img, flow, 1.0, ct, (3, 4), "replicate", dt)
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, 1.0, ct, (3, 4), "replicate", dt)
    torch.cuda.synchronize()
    assert gflow.dtype == torch.bfloat16
    assert _err(cg, ref_cg) <= TOL[dt] and _err(gflow, ref_gflow) <= TOL[torch.bfloat16]
