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
"""

from __future__ import annotations

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
    from the module at each call). backward: the flow and t gradients from
    K2 (``warp_windowed_grad``; each output pixel depends on its own flow
    only, so no scatter); the image cotangent, where img needs one, as the
    reference takes it: autograd of the exact ``flow_warp``. Saves the
    inputs, not the output, so ``torch.utils.checkpoint`` recomputes the
    warp.
    """

    @staticmethod
    def forward(ctx, img, flow, t, radius, border, compute_dtype):
        ctx.radius, ctx.border, ctx.compute_dtype = radius, border, compute_dtype
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
            with torch.enable_grad():
                x = img.detach().requires_grad_(True)
                tt = t.detach().reshape(-1, 1, 1) if torch.is_tensor(t) else t
                out = flow_warp(x, flow.detach(), tt, border=ctx.border)
                (g_img,) = torch.autograd.grad(out, x, ct)
        return g_img, g_flow, g_t, None, None, None


def backward_warp(img: torch.Tensor, flow: torch.Tensor, t=1.0, border: str = "constant",
                  backend: str | None = None, radius=8,
                  compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Backend-dispatched backward warp: the windowed kernel or the exact
    gather. The two agree wherever a pixel's displacement stays within
    ``radius`` of its tile's mean. The reflect border always takes the
    exact path (the windowed kernel has replicate and constant only).
    Both are differentiable in img, flow and a tensor t."""
    backend = backend or default_warp_backend(img.device)
    if border == "reflect":
        backend = "exact"
    if backend == "windowed":
        return _WindowedWarp.apply(img.contiguous(), flow.contiguous(), t, radius, border,
                                   compute_dtype)
    if backend != "exact":
        raise ValueError(f"unknown warp backend {backend!r}")
    return flow_warp(img, flow, t, border=border)
