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


# K1 past the channels one window holds: channel groups. (n, h, w) of
# SAFA's feature warps at a 1080p tile (114x144) and a ragged 3-tile-wide
# image; flows as SAFA's, clamped to +-8, plus noise past the radius
GROUPED_C = (10, 16, 33, 176)


@pytest.mark.cuda
@pytest.mark.parametrize("c", GROUPED_C)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("n,h,w", [(3, 114, 144), (1, 70, 530)])
def test_warp_kernel_channel_groups_match_plain(n, h, w, border, dt, c):
    """Grouped K1 against its twin: bit for bit with f32 windows, 2/255
    with bf16 ones (the twin takes any C)."""
    _needs_card()
    rng = np.random.default_rng(c)
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    flow = torch.from_numpy(np.clip(smooth_flow(rng, n, h, w, 6.0, 3.0), -8, 8)).cuda()
    pl = tw.plan(img, 8, dt)
    assert pl is not None and pl["groups"] * pl["cg"] >= c
    if dt == torch.float32 or c > 17:
        assert pl["grouped"] == 1, pl
    before = tw.launches
    out = tw.warp_windowed(img, flow, 1.0, 8, border, dt)
    ref = tw.warp_windowed_plain(img, flow, 1.0, 8, border, dt)
    torch.cuda.synchronize()
    assert tw.launches == before + 1
    if dt == torch.float32:
        assert torch.equal(out, ref), (out - ref).abs().max().item()
    else:
        assert _err(out, ref) <= TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 176])
def test_warp_kernel_channel_groups_unaligned_image(c):
    """A contiguous view 4 bytes past a 16-byte boundary: the groups copy
    element by element instead of in 16-byte chunks, with the same bits."""
    _needs_card()
    rng = np.random.default_rng(3)
    n, h, w = 2, 64, 144
    base = torch.from_numpy(rng.random(n * h * w * c + 1, np.float32)).cuda()
    img = base[1:].view(n, h, w, c)
    assert img.is_contiguous() and img.data_ptr() % 16 == 4
    flow = torch.from_numpy(smooth_flow(rng, n, h, w, 5.0, 2.0)).cuda()
    out = tw.warp_windowed(img, flow, 0.5, 8, "replicate", torch.float32)
    ref = tw.warp_windowed_plain(img, flow, 0.5, 8, "replicate", torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


@pytest.mark.cuda
def test_plans_of_the_paths_and_k2_refusal():
    """The flagship's, training's and adaptive path's K1 launches keep the
    whole-C layout (one group, one chunk, one slot); K1 and K2 at 176
    channels take groups (SAFA's feature warps at a 1080p tile and at the
    training crop), walked by CTAs of at most 1024 pixels through a ring
    of 2 or 3 slots, K2 in one chunk per tile there (one launch, no
    scratch); K2 at the RIFE training's shapes keeps the whole-C layout.
    K2 refuses nothing it used to take, and no longer refuses a window it
    cannot hold whole: it launches once there."""
    _needs_card()
    f32, bf = torch.float32, torch.bfloat16
    for shape, dt, r, cd in [((2, 1088, 1920, 3), bf, (3, 4), bf), ((1, 1080, 1920, 5), f32, 8, f32),
                             ((6, 1088, 1920, 3), f32, (4, 6), bf), ((3, 1088, 1920, 3), f32, 8, f32),
                             ((48, 192, 192, 4), f32, 2, f32), ((3, 456, 576, 3), f32, 8, f32)]:
        img = torch.empty(shape, dtype=dt, device="cuda")
        pl = tw.plan(img, r, cd)
        assert pl is not None and pl["grouped"] == 0 and pl["groups"] == 1, (shape, pl)
        assert (pl["chunks"], pl["stages"]) == (1, 1), (shape, pl)
    for shape, r, cd in [((16, 192, 192, 3), (4, 6), bf), ((16, 96, 96, 3), (2, 4), bf),
                         ((16, 192, 192, 3), 8, f32)]:
        pl = tw.plan(torch.empty(shape, device="cuda"), r, cd, grad=True)
        assert pl is not None and pl["grouped"] == 0 and pl["groups"] == 1, (shape, pl)
    for shape in [(3, 114, 144, 176), (16, 48, 48, 176)]:
        img = torch.rand(shape, device="cuda")
        for grad in (False, True):
            pl = tw.plan(img, 8, f32, grad=grad)
            assert pl is not None and pl["grouped"] == 1 and pl["groups"] * pl["cg"] >= 176, pl
            assert pl["cg"] == 4 and 0 < pl["pixels"] <= 1024 and pl["stages"] in (2, 3), pl
            assert pl["chunks"] == 1 or not grad, pl
    flow = torch.zeros((16, 48, 48, 2), device="cuda")
    before = tw.grad_launches
    gflow, cg = tw.warp_windowed_grad(img, flow, 1.0, torch.ones_like(img), 8, "replicate", f32)
    torch.cuda.synchronize()
    assert tw.grad_launches == before + 1 and bool(torch.isfinite(cg).all())


# K2 past the channels one window holds (10 at f32, r = 8): channel groups,
# at SAFA's training feature shape (16x48x48) and a ragged 3-tile-wide image
GROUPED_C_K2 = (11, 16, 33, 176)


@pytest.mark.cuda
@pytest.mark.parametrize("c", GROUPED_C_K2)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("n,h,w", [(16, 48, 48), (1, 70, 530)])
def test_warp_grad_kernel_channel_groups_match_plain(n, h, w, border, dt, c):
    """Grouped K2 against its twin: each group's partial sums in channel
    order, the groups added in order, so within f32 rounding of the twin's
    sum (tolerances as above, relative to the largest |cg|); a per-batch t
    and a non-contiguous cotangent, as autograd hands it."""
    _needs_card()
    rng = np.random.default_rng(100 + c)
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    flow = torch.from_numpy(np.clip(smooth_flow(rng, n, h, w, 6.0, 3.0), -8, 8)).cuda()
    t = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).cuda()
    ct = torch.from_numpy(rng.normal(0, 1, (n, c, h, w)).astype(np.float32)).cuda()
    ct = ct.permute(0, 2, 3, 1)
    pl = tw.plan(img, 8, dt, grad=True)
    assert pl is not None and pl["grouped"] == 1 and pl["groups"] * pl["cg"] >= c, pl
    before = tw.grad_launches
    gflow, cg = tw.warp_windowed_grad(img, flow, t, ct, 8, border, dt)
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, t, ct, 8, border, dt)
    torch.cuda.synchronize()
    assert tw.grad_launches == before + 1
    scale = ref_cg.abs().max().item()
    assert scale > 0
    assert (cg - ref_cg).abs().max().item() <= TOL[dt] * scale
    assert (gflow - ref_gflow).abs().max().item() <= TOL[dt] * scale * 1.5


@pytest.mark.cuda
@pytest.mark.parametrize("c", [16, 176])
def test_warp_grad_kernel_channel_groups_deterministic(c):
    """Two identical grouped K2 launches give the same bits (no atomics),
    also from an image view 4 bytes past a 16-byte boundary (element by
    element copies), which matches the aligned image's result exactly."""
    _needs_card()
    rng = np.random.default_rng(c)
    n, h, w = 16, 48, 48
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda()
    shifted = torch.empty(n * h * w * c + 1, device="cuda")[1:].view(n, h, w, c)
    shifted.copy_(img)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    flow = torch.from_numpy(np.clip(smooth_flow(rng, n, h, w, 6.0, 3.0), -8, 8)).cuda()
    ct = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32)).cuda()
    a = tw.warp_windowed_grad(img, flow, 1.0, ct, 8, "replicate", torch.float32)
    b = tw.warp_windowed_grad(img, flow, 1.0, ct, 8, "replicate", torch.float32)
    u = tw.warp_windowed_grad(shifted, flow, 1.0, ct, 8, "replicate", torch.float32)
    torch.cuda.synchronize()
    assert tw.plan(img, 8, torch.float32, grad=True)["grouped"] == 1
    for x, y in ((a, b), (a, u)):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


# The grouped kernels' own edge cases, K1 and K2 in one test each: SAFA's two
# feature shapes (a 1080p tile and the training crop), ragged last groups (C
# = 33: element by element) and chunks (C = 177), bf16 windows and images,
# the constant border, H = 114 and W = 48, 144 and 300, a t per image, and
# flows that reach the window's far rows and columns (_torch_port's
# adversarial flows: +-300 px clamp every residual to the window's edge).
# (n, h, w, c, img dtype, window dtype, border, flow)
GROUPED_EDGES = [
    (3, 114, 144, 176, torch.float32, torch.float32, "replicate", "safa"),
    (16, 48, 48, 176, torch.float32, torch.float32, "replicate", "safa"),
    (3, 114, 144, 176, torch.float32, torch.bfloat16, "constant", "past_r"),
    (16, 48, 48, 176, torch.float32, torch.float32, "constant", "large"),
    (1, 114, 300, 33, torch.float32, torch.float32, "replicate", "per_batch_t"),
    (2, 114, 144, 177, torch.float32, torch.float32, "constant", "tie"),
    (2, 48, 48, 177, torch.float32, torch.bfloat16, "replicate", "odd_row"),
    (1, 114, 300, 177, torch.float32, torch.float32, "replicate", "large"),
    (3, 114, 144, 176, torch.bfloat16, torch.bfloat16, "replicate", "per_batch_t"),
    (1, 48, 48, 176, torch.float32, torch.float32, "replicate", "safa"),
]


def _grouped_edge(n, h, w, c, img_dt, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "safa":
        flow, t = np.clip(smooth_flow(rng, n, h, w, 6.0, 3.0), -8, 8), 1.0
    elif kind == "past_r":
        flow, t = smooth_flow(rng, n, h, w, 25.0, 4.0), 1.0
    else:
        flow, t = adversarial_flow(kind, rng, n, h, w)
    t = torch.from_numpy(t).cuda() if isinstance(t, np.ndarray) else t
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32)).cuda().to(img_dt)
    ct = torch.from_numpy(rng.normal(0, 1, (n, h, w, c)).astype(np.float32)).cuda().to(img_dt)
    return img, torch.from_numpy(np.ascontiguousarray(flow)).cuda(), t, ct


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,img_dt,dt,border,kind", GROUPED_EDGES)
def test_grouped_kernels_edges_match_plain(n, h, w, c, img_dt, dt, border, kind):
    """Grouped K1 against its twin (bit for bit with f32 images and
    windows, else 2/255) and grouped K2 against its twin (tolerances as
    above, relative to the largest |cg|), one launch each; both plans take
    channel groups."""
    _needs_card()
    img, flow, t, ct = _grouped_edge(n, h, w, c, img_dt, kind, 1000 + c + w)
    assert tw.plan(img, 8, dt)["grouped"] == 1 and tw.plan(img, 8, dt, grad=True)["grouped"] == 1
    before, before_grad = tw.launches, tw.grad_launches
    out = tw.warp_windowed(img, flow, t, 8, border, dt)
    gflow, cg = tw.warp_windowed_grad(img, flow, t, ct, 8, border, dt)
    ref = tw.warp_windowed_plain(img, flow, t, 8, border, dt)
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, t, ct, 8, border, dt)
    torch.cuda.synchronize()
    assert (tw.launches, tw.grad_launches) == (before + 1, before_grad + 1)
    if img_dt == dt == torch.float32:
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    else:
        assert _err(out, ref) <= TOL[dt]
    scale = ref_cg.abs().max().item()
    assert scale > 0
    tol = TOL[dt if img_dt == torch.float32 else torch.bfloat16]
    assert (cg - ref_cg).abs().max().item() <= tol * scale
    assert (gflow.float() - ref_gflow.float()).abs().max().item() <= tol * scale * 1.5


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c", [(3, 114, 144, 176), (16, 48, 48, 176), (1, 48, 48, 177)])
def test_grouped_k2_twice_bit_identical(n, h, w, c):
    """Grouped K2 twice on the same inputs gives the same bits: at SAFA's
    two shapes (one chunk per tile, one launch) and on a small image whose
    plan takes several chunks (their partial sums added in chunk order)."""
    _needs_card()
    img, flow, t, ct = _grouped_edge(n, h, w, c, torch.float32, "safa", 7)
    pl = tw.plan(img, 8, torch.float32, grad=True)
    assert pl["grouped"] == 1 and (pl["chunks"] == 1) == (n > 1), pl
    a = tw.warp_windowed_grad(img, flow, t, ct, 8, "replicate", torch.float32)
    b = tw.warp_windowed_grad(img, flow, t, ct, 8, "replicate", torch.float32)
    ref_gflow, ref_cg = tw.warp_windowed_grad_plain(img, flow, t, ct, 8)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (a[1] - ref_cg).abs().max().item() <= TOL[torch.float32] * ref_cg.abs().max().item()
