"""The IFNet of RIFE (arXiv:2011.06294, Practical-RIFE's coarse-to-fine
intermediate-flow network) in plain PyTorch, over a dict of parameters
named as the measured program names them (``block<i>.Conv_<j>.weight``).

Four IFBlocks at pyramid scales (8, 4, 2, 1): each takes the two frames
warped by the current flow, the timestep map, the mask and the flow,
downsamples by a stride-4 encoder, runs a trunk of residual 3x3 convs and
a 4x4 stride-2 transpose conv back, and adds a flow (4) and mask (1)
delta. Block inputs are warped at the level's own resolution, never finer
than half; the final fusion warps run at full resolution:
merged = sigmoid(m) warp(I0) + (1 - sigmoid(m)) warp(I1), clipped to [0, 1].
``shared_flow`` runs the trunk once at the timestep nearest 0.5 and
derives the others from its flow and mask (the deployment's fast path).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import FULL, Precision
from portbench.reference.warp import windowed_warp


@dataclass(frozen=True)
class IFNetConfig:
    scales: Tuple[int, ...] = (8, 4, 2, 1)
    channels: Tuple[int, ...] = (256, 160, 112, 80)
    num_convs: int = 8
    min_warp_scale: int = 2
    level_warp_radius: Tuple[int, int] = (2, 4)
    final_warp_radius: Tuple[int, int] = (4, 6)
    dtype: str = "float32"        # the precision the configuration states
    warp_dtype: str = "bfloat16"  # the warp's window dtype

    @staticmethod
    def from_dict(d: dict) -> "IFNetConfig":
        return IFNetConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def param_shapes(cfg: IFNetConfig):
    """[(name, shape)] of every parameter, in the program's order."""
    out = []
    for i, c in enumerate(cfg.channels):
        p = f"block{i}."
        out += [(p + "Conv_0.weight", (c // 2, 12, 3, 3)), (p + "Conv_0.bias", (c // 2,)),
                (p + "Conv_1.weight", (c, c // 2, 3, 3)), (p + "Conv_1.bias", (c,))]
        for j in range(cfg.num_convs):
            out += [(p + f"Conv_{2 + j}.weight", (c, c, 3, 3)), (p + f"Conv_{2 + j}.bias", (c,))]
        out += [(p + "ConvTranspose_0.weight", (c, 5, 4, 4)), (p + "ConvTranspose_0.bias", (5,))]
    return out


def _up2_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    xp = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)
    lo, mid, hi = xp.narrow(axis, 0, n), xp.narrow(axis, 1, n), xp.narrow(axis, 2, n)
    y = torch.stack([0.25 * lo + 0.75 * mid, 0.75 * mid + 0.25 * hi], dim=axis + 1)
    return y.reshape(*x.shape[:axis], 2 * n, *x.shape[axis + 1:])


def resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear, half-pixel; antialiased when downsampling; an exact
    2x upsample as a fixed 0.25/0.75 stencil."""
    h, w = x.shape[-2:]
    if tuple(hw) == (h, w):
        return x
    if tuple(hw) == (2 * h, 2 * w):
        return _up2_axis(_up2_axis(x, x.ndim - 2), x.ndim - 1)
    return F.interpolate(x.float(), size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True).to(x.dtype)


def _halve(x):
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) * 0.25


def _warp(img, flow, radius, warp_dtype):
    out = windowed_warp(img.permute(0, 2, 3, 1), flow.permute(0, 2, 3, 1), 1.0, radius,
                        "replicate", warp_dtype)
    return out.permute(0, 3, 1, 2)


def _block(P: Dict[str, torch.Tensor], i: int, x: torch.Tensor, cfg: IFNetConfig,
           prec: Precision) -> torch.Tensor:
    s = cfg.dtype
    p = f"block{i}."

    def conv(name, h, stride):
        return F.leaky_relu(prec.conv2d(h, P[p + name + ".weight"], P[p + name + ".bias"],
                                        stride, 1, stated=s), 0.2)

    h = conv("Conv_1", conv("Conv_0", x, 2), 2)
    for j in range(cfg.num_convs):
        h = conv(f"Conv_{2 + j}", h, 1) + h
    out = prec.conv_transpose2d(h, P[p + "ConvTranspose_0.weight"], P[p + "ConvTranspose_0.bias"],
                                2, 2, stated=s)
    return resize_bilinear(out, x.shape[-2:])


def ifnet(P: Dict[str, torch.Tensor], img0: torch.Tensor, img1: torch.Tensor, timestep,
          cfg: IFNetConfig, prec: Precision = FULL, dtype: torch.dtype = torch.float32):
    """img0/img1 [N,H,W,3] in [0, 1]; timestep [N]. Computes in ``dtype``
    (float32 for the check; the stated dtype when counting on the meta
    device). Returns (merged [N,H,W,3], flow [N,H,W,4], mask [N,H,W,1])."""
    wdt = getattr(torch, cfg.warp_dtype)
    n, h, w, _ = img0.shape
    x0 = prec.cast(img0, dtype, cfg.dtype).permute(0, 3, 1, 2)
    x1 = prec.cast(img1, dtype, cfg.dtype).permute(0, 3, 1, 2)
    t_scalar = torch.as_tensor(timestep, dtype=dtype, device=img0.device).reshape(-1, 1, 1, 1)
    ws_list = [max(s, cfg.min_warp_scale) for s in cfg.scales]
    pyr0, pyr1 = {1: x0}, {1: x1}
    s = 1
    while s < max(ws_list):
        pyr0[2 * s], pyr1[2 * s] = _halve(pyr0[s]), _halve(pyr1[s])
        s *= 2
    flow = mask = None
    for i, scale in enumerate(cfg.scales):
        ws = ws_list[i]
        sh, sw = max(h // ws, 1), max(w // ws, 1)
        t_map = t_scalar.expand(n, 1, sh, sw)
        if flow is None:
            flow = torch.zeros((n, 4, sh, sw), dtype=dtype, device=x0.device)
            mask = torch.zeros((n, 1, sh, sw), dtype=dtype, device=x0.device)
            warped0, warped1 = pyr0[ws], pyr1[ws]
        else:
            rescale = sh / flow.shape[2]
            flow = resize_bilinear(flow, (sh, sw)) * rescale
            mask = resize_bilinear(mask, (sh, sw))
            warped = _warp(torch.cat([pyr0[ws], pyr1[ws]], 0),
                           torch.cat([flow[:, 0:2], flow[:, 2:4]], 0), cfg.level_warp_radius, wdt)
            warped0, warped1 = warped[:n], warped[n:]
        inp = torch.cat([warped0, warped1, t_map, mask, flow], dim=1)
        down = max(scale // ws, 1)
        if down > 1:
            inp = resize_bilinear(inp, (max(sh // down, 1), max(sw // down, 1)))
        out = resize_bilinear(_block(P, i, inp, cfg, prec), (sh, sw))
        flow = flow + out[:, :4] * down
        mask = mask + out[:, 4:5]
    rescale = h / flow.shape[2]
    flow = resize_bilinear(flow, (h, w)) * rescale
    mask = resize_bilinear(mask, (h, w))
    warped = _warp(torch.cat([x0, x1], 0), torch.cat([flow[:, 0:2], flow[:, 2:4]], 0),
                   cfg.final_warp_radius, wdt)
    m = torch.sigmoid(mask)
    merged = torch.clamp(warped[:n] * m + warped[n:] * (1.0 - m), 0.0, 1.0)

    def nhwc(v):
        return v.to(img0.dtype).permute(0, 2, 3, 1)

    return nhwc(merged), nhwc(flow), nhwc(mask)


def shared_flow(P, x0, x1, timestamps, cfg: IFNetConfig, prec: Precision = FULL,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One trunk pass at the anchor timestep a (nearest 0.5); the others
    warp by F_t->0 = F_a->0 t/a and F_t->1 = F_a->1 (1-t)/(1-a) with the mask
    m_t = clip(sigmoid(mask) + a - t, 0, 1). x0/x1 [P,H,W,3] ->
    [P*T,H,W,3], pair-major."""
    wdt = getattr(torch, cfg.warp_dtype)
    p, h, w, _ = x0.shape
    ts = tuple(float(t) for t in timestamps)
    ai = min(range(len(ts)), key=lambda i: abs(ts[i] - 0.5))
    a = ts[ai]
    merged_a, flow, mask = ifnet(P, x0, x1, torch.full((p,), a, device=x0.device), cfg, prec,
                                 dtype)
    others = [t for i, t in enumerate(ts) if i != ai]
    m = torch.sigmoid(prec.cast(mask, dtype, cfg.dtype))
    imgs, flows = [], []
    for t in others:
        imgs += [prec.cast(x0, dtype, cfg.dtype), prec.cast(x1, dtype, cfg.dtype)]
        flows += [flow[..., 0:2] * (t / a), flow[..., 2:4] * ((1.0 - t) / (1.0 - a))]
    warped = windowed_warp(torch.cat(imgs, 0), prec.cast(torch.cat(flows, 0), dtype, cfg.dtype), 1.0,
                           cfg.final_warp_radius, "replicate", wdt)
    outs = {a: merged_a}
    for k, t in enumerate(others):
        w0 = warped[2 * k * p:(2 * k + 1) * p]
        w1 = warped[(2 * k + 1) * p:(2 * k + 2) * p]
        m_t = torch.clamp(m + (a - t), 0.0, 1.0)
        outs[t] = torch.clamp(w0 * m_t + w1 * (1.0 - m_t), 0.0, 1.0).to(x0.dtype)
    return torch.stack([outs[t] for t in ts], dim=1).reshape(p * len(ts), h, w, 3)
