"""The windowed backward warp of the reference, in plain PyTorch.

Semantics stated by the measured program for its warp (the TPU kernel it
was ported from): each 32x256 output tile reads a window placed at the
tile's rounded mean displacement, and each pixel samples bilinearly at
p + t*flow[p], clipped to the content (replicate border) or to r px past
it over zeros (constant border), with its offset inside the window
clamped to [0, nsh - 1.001]. With bfloat16 windows the window values,
horizontal weights and horizontal sums are bfloat16, one more vertical
tap is added and the window's row origin is rounded down to even.

``recording()`` collects, for every call made inside it, the bytes the
warp needs: the image and the flow read once, the output written once,
in the dtypes of the call. The benchmark runs the reference on the meta
device inside it to count a step's warp traffic.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

TILE = (32, 256)
_calls: contextvars.ContextVar = contextvars.ContextVar("warp_calls", default=None)


@contextlib.contextmanager
def recording():
    """Yields a list that gets (shape, img dtype, flow dtype, bytes) for
    every warp called inside the block."""
    calls: list = []
    token = _calls.set(calls)
    try:
        yield calls
    finally:
        _calls.reset(token)


def _content_origin(ry, rx):
    th, tw = TILE
    return ((th + ry + 1 + th - 1) // th) * th, ((tw + rx + 1 + tw - 1) // tw) * tw


def window_origins(flow: torch.Tensor, t_arr: torch.Tensor, ry: int, rx: int,
                   bf16: bool) -> torch.Tensor:
    """Window origin (oy, ox) per output tile, canvas coordinates:
    [N, TY, TX, 2]. The tile mean of the edge-padded flow in f32 by 2x2
    halvings and then a row-major sum of the remaining cells, times t,
    rounded half to even, offset by -(r+1), clamped into the canvas."""
    n, h, w, _ = flow.shape
    th, tw = TILE
    ph_c, pw_c = (-h) % th, (-w) % tw
    pt, pl = _content_origin(ry, rx)
    m = flow.permute(0, 3, 1, 2).float()
    if ph_c or pw_c:
        m = torch.nn.functional.pad(m, (0, pw_c, 0, ph_c), mode="replicate")
    g = 1
    while th % (2 * g) == 0 and tw % (2 * g) == 0:
        g *= 2
    for _ in range(g.bit_length() - 1):
        m = (((m[..., 0::2, 0::2] + m[..., 0::2, 1::2]) + m[..., 1::2, 0::2])
             + m[..., 1::2, 1::2]) * 0.25
    ky, kx = th // g, tw // g
    if (ky, kx) != (1, 1):
        b, c2, hh, ww = m.shape
        blocks = m.reshape(b, c2, hh // ky, ky, ww // kx, kx)
        acc = None
        for i in range(ky):
            for j in range(kx):
                term = blocks[:, :, :, i, :, j]
                acc = term if acc is None else acc + term
        m = acc * (g * g / (th * tw))
    hc, wc = h + ph_c, w + pw_c
    ty0 = (pt + torch.arange(hc // th, device=flow.device) * th)[None, :, None]
    tx0 = (pl + torch.arange(wc // tw, device=flow.device) * tw)[None, None, :]
    oy = torch.clamp(ty0 + torch.round(m[:, 1] * t_arr[:, None, None]).long() - (ry + 1), 0, pt + hc)
    ox = torch.clamp(tx0 + torch.round(m[:, 0] * t_arr[:, None, None]).long() - (rx + 1), 0, pl + wc)
    if bf16:
        oy = oy - (oy & 1)
    return torch.stack([oy, ox], dim=-1)


def windowed_warp(img: torch.Tensor, flow: torch.Tensor, t, r, border: str,
                  compute_dtype: torch.dtype) -> torch.Tensor:
    """Backward-warp img [N,H,W,C] by t*flow (flow [N,H,W,2] = (dx, dy));
    t a number or [N]; r an int or (ry, rx). Returns img's dtype."""
    n, h, w, c = img.shape
    calls = _calls.get()
    if calls is not None:
        nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size()
        calls.append((tuple(img.shape), img.dtype, flow.dtype, nbytes))
    ry, rx = (r, r) if isinstance(r, int) else r
    bf16 = compute_dtype == torch.bfloat16
    th, tw = TILE
    pt, pl = _content_origin(ry, rx)
    nsh_y, nsh_x = 2 * ry + 2 + (1 if bf16 else 0), 2 * rx + 2
    if border == "constant":
        ylo, yhi, xlo, xhi = pt - ry, pt + h - 1 + ry, pl - rx, pl + w - 1 + rx
    else:
        ylo, yhi, xlo, xhi = pt, pt + h - 1, pl, pl + w - 1
    dev = img.device
    if isinstance(t, (int, float)):
        t_arr = torch.full((n,), float(t), dtype=torch.float32, device=dev)
    else:
        t_arr = torch.as_tensor(t, dtype=torch.float32, device=dev).reshape(-1).expand(n)
    origin = window_origins(flow, t_arr, ry, rx, bf16)
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    oy = origin[..., 0][:, ys // th][:, :, xs // tw]
    ox = origin[..., 1][:, ys // th][:, :, xs // tw]
    rows, cols = (ys % th)[None, :, None], (xs % tw)[None, None, :]
    # p + t*flow as one fused multiply-add, rounded once to f32
    f = flow.double()
    tb = t_arr.double()[:, None, None]
    sy_raw = ((pt + ys).double()[None, :, None] + f[..., 1] * tb).float()
    sx_raw = ((pl + xs).double()[None, None, :] + f[..., 0] * tb).float()
    ry_raw = (sy_raw.clamp(ylo, yhi) - oy.float()) - rows.float()
    rx_raw = (sx_raw.clamp(xlo, xhi) - ox.float()) - cols.float()
    ry_max = torch.tensor(nsh_y - 1.001, dtype=torch.float32).item()
    rx_max = torch.tensor(nsh_x - 1.001, dtype=torch.float32).item()
    ryf, rxf = ry_raw.clamp(0.0, ry_max), rx_raw.clamp(0.0, rx_max)
    a0, b0 = torch.floor(ryf), torch.floor(rxf)
    wy0, wy1 = 1.0 - (ryf - a0), 1.0 - ((a0 + 1.0) - ryf)
    wx0, wx1 = 1.0 - (rxf - b0), 1.0 - ((b0 + 1.0) - rxf)
    yi0 = oy + rows + a0.long() - pt
    xi0 = ox + cols + b0.long() - pl
    win = img.to(compute_dtype).reshape(n, h * w, c)

    def tap(yi, xi):
        v = torch.gather(win, 1, (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
                         .reshape(n, -1, 1).expand(-1, -1, c)).reshape(n, h, w, c)
        if border == "constant":
            v = v * ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None].to(v.dtype)
        return v

    wx0c, wx1c = wx0[..., None].to(compute_dtype), wx1[..., None].to(compute_dtype)
    inner = [(wx0c * tap(yi0 + a, xi0) + wx1c * tap(yi0 + a, xi0 + 1)).float() for a in (0, 1)]
    return (wy0[..., None] * inner[0] + wy1[..., None] * inner[1]).to(img.dtype)
