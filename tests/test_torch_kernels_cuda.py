"""The port's CUDA kernels held against their plain twins, on the card.

These have no CPU mode (nvcc builds the kernels on the card's machine), so
they carry the ``cuda`` marker and skip without a card. The file imports no
jax, so it also runs where jax is not installed (``--noconftest`` skips
tests/conftest.py, which imports jax):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Tolerances: 1e-5 with f32 windows, 2/255 with bf16 windows, relative to
max(1, the reference's largest magnitude) (the kernel and its twin take the
same rounding steps; the bound is the twin's own against the Pallas kernel).
The window origins the kernels compute (``kernel_origins``) must equal
``window_origins`` exactly: output parity alone can hide an origin one
pixel off while the residual stays inside the window.
"""

import numpy as np
import pytest
import torch

from _torch_port import adversarial_flow, smooth_flow
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


# (kind, (n, h, w, c), r, window dtype, border): the origin's edge cases
# (_torch_port.adversarial_flow) at the flagship's ragged 1080 rows, the
# analysis' 270x480, the training's 48x48 (row-split CTAs) and a
# Farneback-like 5-channel f32 window that the kernels take in passes
ADVERSARIAL = [
    ("tie", (2, 64, 512, 3), (2, 2), torch.float32, "replicate"),
    ("tie", (2, 1080, 1920, 3), (3, 4), torch.bfloat16, "replicate"),
    ("large", (2, 270, 480, 1), 8, torch.float32, "replicate"),
    ("large", (4, 48, 48, 3), (2, 4), torch.bfloat16, "constant"),
    ("ragged", (2, 1080, 1920, 3), (2, 2), torch.bfloat16, "constant"),
    ("ragged", (1, 270, 480, 5), 8, torch.float32, "replicate"),
    ("per_batch_t", (4, 48, 48, 3), (4, 6), torch.bfloat16, "replicate"),
    ("per_batch_t", (3, 136, 300, 4), 2, torch.float32, "constant"),
    ("odd_row", (2, 272, 480, 3), (2, 2), torch.bfloat16, "replicate"),
    ("odd_row", (2, 1080, 1920, 3), (3, 4), torch.bfloat16, "constant"),
]


def _adversarial(kind, shape, seed):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    flow, t = adversarial_flow(kind, rng, n, h, w)
    t = torch.from_numpy(t).cuda() if isinstance(t, np.ndarray) else t
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    return img, torch.from_numpy(flow).cuda(), t


@pytest.mark.cuda
@pytest.mark.parametrize("flow_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape,r,cd,border", ADVERSARIAL)
def test_kernel_origins_match_window_origins(kind, shape, r, cd, border, flow_dt):
    _needs_card()
    _, flow, t = _adversarial(kind, shape, 21)
    flow = flow.to(flow_dt)
    ry, rx = (r, r) if isinstance(r, int) else r
    t_arr = torch.as_tensor(t, dtype=torch.float32, device="cuda").reshape(-1).expand(
        shape[0]).contiguous()
    got = tw.kernel_origins(flow, t, r, cd)
    ref = tw.window_origins(flow, t_arr, ry, rx, cd == torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got, ref), (got != ref).nonzero()[:8].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,r,cd,border", ADVERSARIAL)
def test_warp_kernels_match_plain_adversarial(kind, shape, r, cd, border):
    """K1 and K2 against their twins where the origin is hardest to get
    right; one launch each."""
    _needs_card()
    img, flow, t = _adversarial(kind, shape, 22)
    img = img.to(cd)
    before, before_grad = tw.launches, tw.grad_launches
    out = tw.warp_windowed(img, flow, t, r, border, cd)
    ref = tw.warp_windowed_plain(img, flow, t, r, border, cd)
    ct = torch.randn(img.shape, generator=torch.Generator("cuda").manual_seed(3),
                     device="cuda").to(cd)
    gflow, cg = tw.warp_windowed_grad(img, flow, t, ct, r, border, cd)
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, t, ct, r, border, cd)
    torch.cuda.synchronize()
    assert (tw.launches, tw.grad_launches) == (before + 1, before_grad + 1)
    assert _err(out, ref) <= TOL[cd]
    assert _err(gflow, ref_gflow) <= TOL[cd] and _err(cg, ref_cg) <= TOL[cd]


@pytest.mark.cuda
def test_launch_takes_t_as_number_or_tensor():
    """launch and launch_grad: t as a Python number, an f32 tensor of N or
    1 elements on the card, or anything _t_array converts."""
    _needs_card()
    rng = np.random.default_rng(12)
    n, h, w, c = 2, 96, 300, 3
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    flow = torch.from_numpy(smooth_flow(rng, n, h, w, 5.0, 1.0)).cuda()
    ct = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32)).cuda()
    for t in (0.75, torch.tensor([0.75, 0.75], device="cuda"), torch.tensor(0.75, device="cuda"),
              torch.tensor([0.75]), (0.75, 0.75)):
        out = torch.empty_like(img)
        tw.launch(img, flow, t, out, (2, 4), "replicate", torch.float32)
        gflow, cg = torch.empty_like(flow), torch.empty_like(flow)
        tw.launch_grad(img, flow, t, ct, gflow, cg, (2, 4), "replicate", torch.float32)
        ref = tw.warp_windowed_plain(img, flow, 0.75, (2, 4))
        ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, 0.75, ct, (2, 4))
        torch.cuda.synchronize()
        assert _err(out, ref) <= TOL[torch.float32]
        assert _err(cg, ref_cg) <= TOL[torch.float32]
        assert _err(gflow, ref_gflow) <= TOL[torch.float32]
