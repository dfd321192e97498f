"""Backward warping (port of ``vfisr_tpu/core/warp.py``).

Two semantics:

- *windowed*: the TPU's Pallas warp, which the shipped weights were trained
  through (``models/sota/rife.py``). Here it is the CUDA kernel of
  ``ops/cuda/warp.py`` (its plain twin for CPU tensors), differentiable
  through ``_WindowedWarp``, whose backward is the flow-gradient kernel.
  The default on the GPU.
- *exact*: ``flow_warp``, a four-tap bilinear gather. What the JAX package
  runs off the TPU (its ``default_warp_backend`` returns 'gather' there),
  so the default for CPU tensors.

The windowed warp's image cotangent (``img_grad``) is autograd of the exact
warp ('gather', whose backward is a scatter: atomic on CUDA) or the dense
shifted adjoint ``warp_transpose_shifted`` ('shifted:R', deterministic; for
trainable feature warps whose flows are clamped to +-R, as SAFA's are).
"""

from __future__ import annotations

import math

import torch

from vfisr_tpu_torch.ops.cuda import warp as _kernels


def _gather_hw(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img [N,H,W,C], iy/ix [N,h,w] int64 in range -> [N,h,w,C]."""
    n, h, w, c = img.shape
    lin = (iy * w + ix).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(img.reshape(n, h * w, c), 1, lin).reshape(n, *iy.shape[1:], c)


def _reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """cv2 BORDER_REFLECT (edge repeated) index folding."""
    period = 2 * n
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - 1 - m)


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
                   border: str = "constant") -> torch.Tensor:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR) analog.

    img [N,H,W,C]; map_x/map_y [N,H',W'] absolute source coordinates.
    border: 'constant' (zeros), 'replicate' or 'reflect'.
    """
    n, h, w, c = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = (map_x - x0)[..., None]
    fy = (map_y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    if border == "reflect":
        def tap(yi, xi):
            return _gather_hw(img, _reflect_index(yi, h), _reflect_index(xi, w))
    elif border == "replicate":
        def tap(yi, xi):
            return _gather_hw(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    elif border == "constant":
        def tap(yi, xi):
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = _gather_hw(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
            return v * valid[..., None].to(img.dtype)
    else:
        raise ValueError(f"unknown border {border!r}")

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def flow_warp(img: torch.Tensor, flow: torch.Tensor, t: float = 1.0,
              border: str = "constant") -> torch.Tensor:
    """Backward-warp img [N,H,W,C] by t*flow, flow [N,H,W,2] = (dx, dy).

    Sample position (x + t*u, y + t*v), in at least f32: the reference
    builds the pixel grid in img's dtype, which in bf16 cannot hold the
    column index of a 1080p frame (ROADMAP §3).
    """
    n, h, w, _ = img.shape
    dt = torch.promote_types(torch.promote_types(img.dtype, flow.dtype), torch.float32)
    ys = torch.arange(h, device=img.device, dtype=dt).view(1, h, 1).expand(n, h, w)
    xs = torch.arange(w, device=img.device, dtype=dt).view(1, 1, w).expand(n, h, w)
    f = flow.to(dt)
    return remap_bilinear(img, xs + f[..., 0] * t, ys + f[..., 1] * t, border=border).to(img.dtype)


def default_warp_backend(device: torch.device) -> str:
    """'windowed' for CUDA tensors, 'exact' otherwise."""
    return "windowed" if device.type == "cuda" else "exact"


class _WindowedWarp(torch.autograd.Function):
    """The windowed warp with its gather-free flow gradient (port of
    ``vfisr_tpu/core/warp.py::_pallas_warp_diff`` and its VJP).

    forward: the warp kernel, K1 (``ops.cuda.warp.warp_windowed``, read
    from the module at each call), which reaches it through the custom op
    ``torch.ops.vfisr_tpu_torch.warp_windowed``: ``torch.export`` traces
    this forward and keeps that op as a node. backward: the flow and t gradients from
    K2 (``warp_windowed_grad``; each output pixel depends on its own flow
    only, so no scatter); the image cotangent, where img needs one, as the
    reference takes it for ``img_grad``: autograd of the exact
    ``flow_warp`` ('gather') or ``warp_transpose_shifted`` ('shifted:R').
    Saves the inputs, not the output, so ``torch.utils.checkpoint``
    recomputes the warp.
    """

    @staticmethod
    def forward(ctx, img, flow, t, radius, border, compute_dtype, img_grad="gather"):
        ctx.radius, ctx.border, ctx.compute_dtype = radius, border, compute_dtype
        ctx.img_grad = img_grad
        ctx.t_const = None if torch.is_tensor(t) else t
        ctx.save_for_backward(img, flow, t if torch.is_tensor(t) else None)
        return _kernels.warp_windowed(img, flow, t, r=radius, border=border,
                                      compute_dtype=compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        img, flow, t_saved = ctx.saved_tensors
        t = ctx.t_const if t_saved is None else t_saved
        need_img, need_flow, need_t = ctx.needs_input_grad[:3]
        g_img = g_flow = g_t = None
        if need_flow or need_t:
            g_flow, cg = _kernels.warp_windowed_grad(img, flow, t, ct, ctx.radius, ctx.border,
                                                     ctx.compute_dtype)
            if need_t:
                per_batch = (cg[..., 0] * flow[..., 0].float()
                             + cg[..., 1] * flow[..., 1].float()).sum(dim=(1, 2))
                g_t = (per_batch if t.numel() == img.shape[0] else per_batch.sum())
                g_t = g_t.reshape(t.shape).to(t.dtype)
        if need_img:
            if ctx.img_grad == "gather":
                with torch.enable_grad():
                    x = img.detach().requires_grad_(True)
                    tt = t.detach().reshape(-1, 1, 1) if torch.is_tensor(t) else t
                    out = flow_warp(x, flow.detach(), tt, border=ctx.border)
                    (g_img,) = torch.autograd.grad(out, x, ct)
            else:
                g_img = warp_transpose_shifted(ct, flow, t, ctx.border,
                                               _shift_radius(ctx.img_grad)).to(img.dtype)
        return g_img, g_flow, g_t, None, None, None, None


def _shift_radius(img_grad: str) -> int:
    """R of 'shifted:R' ('shifted' alone: 8, as the reference reads it)."""
    return int(img_grad.split(":")[1]) if ":" in img_grad else 8


def warp_transpose_shifted(ct: torch.Tensor, flow: torch.Tensor, t=1.0,
                           border: str = "replicate", max_disp: int = 8) -> torch.Tensor:
    """The adjoint of the bilinear backward warp by t*flow, with no
    gather or scatter (port of ``vfisr_tpu/core/warp.py::
    warp_transpose_shifted``): exact against the gather warp's image
    cotangent wherever |t*flow| <= max_disp.

    gimg[q] = sum over offsets o of ct[q+o] * hat(dy[q+o] + o_y) *
    hat(dx[q+o] + o_x), where (dy, dx) is each pixel's displacement after
    the border clip and hat(d) = max(0, 1 - |d|): a pixel within max_disp
    of q reaches it only from offsets |o| <= max_disp + 1, so the sum runs
    over (2*max_disp + 3)^2 shifted multiply-adds, as the reference's does,
    in its order. Offsets whose hat is 0 at every pixel add exactly 0 and
    are skipped: the displacements' range (``_shift_reach``, one read-back
    to the host per call) bounds the offsets that can reach. At SAFA's
    training shape that took a step from 281 to 161-165 ms against every
    offset with no read-back, on an H100 80GB HBM3 at 700 W (chip_smoke.py;
    PERF.md §6). Each offset's weight is formed
    once on [N,H,W] and added in place over the channels
    (``addcmul_``). ct [N,H,W,C], flow [N,H,W,2] (dx, dy), t a number or
    [N]; returns ct's dtype.
    """
    n, h, w, c = ct.shape
    big_r = int(max_disp) + 1
    dt = torch.promote_types(ct.dtype, torch.float32)
    tt = t.to(dt).reshape(-1, 1, 1) if torch.is_tensor(t) else t
    ys = torch.arange(h, device=ct.device, dtype=dt).view(1, h, 1)
    xs = torch.arange(w, device=ct.device, dtype=dt).view(1, 1, w)
    sy = ys + flow[..., 1].to(dt) * tt
    sx = xs + flow[..., 0].to(dt) * tt
    if border == "replicate":
        sy = sy.clamp(0.0, h - 1.0)
        sx = sx.clamp(0.0, w - 1.0)
    dy, dx = sy - ys, sx - xs  # [N,H,W] each
    ctf = ct.to(dt)
    acc = torch.zeros((n, h, w, c), dtype=dt, device=ct.device)
    reach = _shift_reach(dy, dx, big_r)

    def hat(d, s):
        return torch.clamp(1.0 - (d + s).abs(), min=0.0)

    hx = {s_x: hat(dx, s_x) for s_x in reach[1]}
    for s_y in reach[0]:  # the reference's order: oy = R - s_y ascending
        qy0, qy1 = max(0, -s_y), min(h, h - s_y)
        if qy1 <= qy0:
            continue
        py = slice(qy0 + s_y, qy1 + s_y)
        hy = hat(dy[:, py], s_y)
        for s_x in reach[1]:
            qx0, qx1 = max(0, -s_x), min(w, w - s_x)
            if qx1 <= qx0:
                continue
            px = slice(qx0 + s_x, qx1 + s_x)
            wgt = hy[:, :, px] * hx[s_x][:, py, px]
            acc[:, qy0:qy1, qx0:qx1].addcmul_(ctf[:, py, px], wgt[..., None])
    return acc.to(ct.dtype)


def _shift_reach(dy: torch.Tensor, dx: torch.Tensor, big_r: int) -> list:
    """For y and x, the shifts s in [-big_r, big_r] (source p = q + s),
    descending, whose hat can be nonzero somewhere: a pixel at displacement
    d reaches q = p - s where |d + s| < 1, so for d in [lo, hi], s in
    [-ceil(hi), -floor(lo)] (1 is a float, so d + s rounds to magnitude 1
    or more wherever it is that exactly). Reads the displacements' range
    back to the host: one sync per call."""
    lo_hi = torch.stack([dy.amin(), dy.amax(), dx.amin(), dx.amax()]).tolist()
    reach = []
    for lo, hi in (lo_hi[:2], lo_hi[2:]):
        if not (math.isfinite(lo) and math.isfinite(hi)):
            reach.append(range(big_r, -big_r - 1, -1))
            continue
        reach.append(range(min(big_r, -math.floor(lo)), max(-big_r, -math.ceil(hi)) - 1, -1))
    return reach


def backward_warp(img: torch.Tensor, flow: torch.Tensor, t=1.0, border: str = "constant",
                  backend: str | None = None, radius=8,
                  compute_dtype: torch.dtype = torch.float32,
                  img_grad: str = "gather") -> torch.Tensor:
    """Backend-dispatched backward warp: the windowed kernel or the exact
    gather. The two agree wherever a pixel's displacement stays within
    ``radius`` of its tile's mean. The reflect border always takes the
    exact path (the windowed kernel has replicate and constant only).
    Both are differentiable in img, flow and a tensor t. img_grad: the
    windowed warp's image cotangent, 'gather' (autograd of the exact warp)
    or 'shifted:R' (``warp_transpose_shifted``, exact for |t*flow| <= R;
    deterministic on CUDA, where the gather's scatter is atomic); the exact
    backend ignores it, as the reference's gather backend does."""
    if img_grad != "gather" and not img_grad.startswith("shifted"):
        raise ValueError(f"img_grad must be 'gather' or 'shifted:R'; got {img_grad!r}")
    backend = backend or default_warp_backend(img.device)
    if border == "reflect":
        backend = "exact"
    if backend == "windowed":
        return _WindowedWarp.apply(img.contiguous(), flow.contiguous(), t, radius, border,
                                   compute_dtype, img_grad)
    if backend != "exact":
        raise ValueError(f"unknown warp backend {backend!r}")
    return flow_warp(img, flow, t, border=border)
