"""VFIMamba (arXiv:2407.02315) as the measured program states it, in plain
PyTorch over a dict of parameters named as the program names them.

A stride-8 conv encoder per frame; a trunk of bidirectional Mamba (S6)
blocks over both frames' tokens interleaved along the scan axis, layers
alternating horizontal scans (rows are the batch) and vertical scans
(columns are the batch); a decoder to flow and mask at 1/8; a
coarse-to-fine refinement at 1/4 and 1/2 that warps area-downscaled frames
by the flow and adds a residual; full-resolution warps (radius 8, float32
windows), the mask blend and a residual refinement, clipped to [0, 1].

The selective scan is the recurrence h_t = exp(dt_t A) h_{t-1} +
(dt_t u_t) B_t, y_t = h_t . C_t, one step at a time in float32, in chunks of
32 steps (a and b formed per chunk, so memory stays at [R, 32, Di, S]).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.ops import resize
from portbench.reference.precision import FULL, Precision
from portbench.reference.warp import windowed_warp

CHUNK = 32


@dataclass(frozen=True)
class MambaConfig:
    d_model: int = 256
    d_state: int = 16
    expand: int = 2
    dt_rank: int = 16
    layers: int = 12
    conv_k: int = 4
    refine_levels: int = 2

    @staticmethod
    def from_dict(d: dict) -> "MambaConfig":
        return MambaConfig(**d)


def param_shapes(cfg: MambaConfig):
    d, s, di, r = cfg.d_model, cfg.d_state, cfg.d_model * cfg.expand, cfg.dt_rank

    def conv(name, cin, cout):
        return [(name + ".weight", (cout, cin, 3, 3)), (name + ".bias", (cout,))]

    def lin(name, cin, cout):
        return [(name + ".weight", (cout, cin)), (name + ".bias", (cout,))]

    out = conv("Conv_0", 3, 64) + conv("Conv_1", 64, 128) + conv("Conv_2", 128, d)
    out += lin("t_embed", 1, d)
    for i in range(cfg.layers):
        p = f"block{i}."
        out += [(p + "LayerNorm_0.weight", (d,)), (p + "LayerNorm_0.bias", (d,))]
        for side in ("s6_fwd", "s6_bwd"):
            q = p + side + "."
            out += lin(q + "in_proj", d, 2 * di) + [(q + "conv_w", (di, 1, cfg.conv_k))]
            out += lin(q + "x_proj", di, r + 2 * s) + lin(q + "dt_proj", r, di)
            out += [(q + "A_log", (di, s)), (q + "D", (di,))] + lin(q + "out_proj", di, d)
        out += [(p + "LayerNorm_1.weight", (d,)), (p + "LayerNorm_1.bias", (d,))]
        out += lin(p + "Dense_0", d, 2 * d) + lin(p + "Dense_1", 2 * d, d)
    out += conv("Conv_3", 2 * d, 128) + conv("Conv_4", 128, 5)
    for lvl in range(cfg.refine_levels):
        out += conv(f"refine_lvl{lvl}_c0", 18, 48) + conv(f"refine_lvl{lvl}_c1", 48, 48)
        out += conv(f"refine_lvl{lvl}_c2", 48, 5)
    return out + conv("Conv_5", 9, 32) + conv("Conv_6", 32, 3)


def selective_scan(dt, A, u, B, C, prec: Precision = FULL):
    """dt, u [R,L,Di]; A [Di,S]; B, C [R,L,S] -> y [R,L,Di]."""
    r, length, di = u.shape
    du = dt * u
    y = torch.empty_like(u)
    h = torch.zeros((r, di, A.shape[1]), dtype=u.dtype, device=u.device)
    for c0 in range(0, length, CHUNK):
        c1 = min(length, c0 + CHUNK)
        a = torch.exp(dt[:, c0:c1, :, None] * A)
        b = du[:, c0:c1, :, None] * B[:, c0:c1, None, :]
        hs = torch.empty_like(a)
        for j in range(c1 - c0):
            h = torch.addcmul(b[:, j], a[:, j], h, out=hs[:, j])
        y[:, c0:c1] = prec.matmul(hs, C[:, c0:c1, :, None])[..., 0]
    return y


def _s6(P, q, x, cfg: MambaConfig, prec: Precision):
    xs, z = prec.linear(x, P[q + "in_proj.weight"], P[q + "in_proj.bias"]).chunk(2, dim=-1)
    xs = F.pad(xs.transpose(1, 2), (cfg.conv_k - 1, 0))
    xs = F.silu(prec.conv1d(xs, P[q + "conv_w"], xs.shape[1]).transpose(1, 2))
    dt_raw, B, C = prec.linear(xs, P[q + "x_proj.weight"], P[q + "x_proj.bias"]).split(
        [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(prec.linear(dt_raw, P[q + "dt_proj.weight"], P[q + "dt_proj.bias"]))
    A = -torch.exp(P[q + "A_log"])
    y = selective_scan(dt, A, xs, B, C, prec) + P[q + "D"] * xs
    return prec.linear(y * F.silu(z), P[q + "out_proj.weight"], P[q + "out_proj.bias"])


def _block(P, i, x, cfg: MambaConfig, prec: Precision):
    p = f"block{i}."
    d = cfg.d_model
    h = F.layer_norm(x, (d,), P[p + "LayerNorm_0.weight"], P[p + "LayerNorm_0.bias"], 1e-6)
    x = x + _s6(P, p + "s6_fwd.", h, cfg, prec) + _s6(P, p + "s6_bwd.", h.flip(1), cfg, prec).flip(1)
    h = F.layer_norm(x, (d,), P[p + "LayerNorm_1.weight"], P[p + "LayerNorm_1.bias"], 1e-6)
    h = F.gelu(prec.linear(h, P[p + "Dense_0.weight"], P[p + "Dense_0.bias"]), approximate="tanh")
    return x + prec.linear(h, P[p + "Dense_1.weight"], P[p + "Dense_1.bias"])


def _conv(P, name, x, prec, stride=1):
    return prec.conv2d(x, P[name + ".weight"], P[name + ".bias"], stride, 1)


def _up(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def _warp(img, flow):
    return windowed_warp(img, flow.permute(0, 2, 3, 1).contiguous(), 1.0, 8, "replicate",
                         torch.float32)


def vfimamba(P: Dict[str, torch.Tensor], img0, img1, timestep, cfg: MambaConfig,
             prec: Precision = FULL) -> torch.Tensor:
    """img0/img1 [N,H,W,3] in [0, 1] (H, W multiples of 32); timestep [N]
    -> merged [N,H,W,3]."""
    n, h, w, _ = img0.shape
    d = cfg.d_model
    t = torch.as_tensor(timestep, dtype=img0.dtype, device=img0.device).reshape(-1, 1)

    def encode(x):
        x = F.silu(_conv(P, "Conv_0", x.permute(0, 3, 1, 2), prec, 2))
        x = F.silu(_conv(P, "Conv_1", x, prec, 2))
        return _conv(P, "Conv_2", x, prec, 2).permute(0, 2, 3, 1)

    f0, f1 = encode(img0), encode(img1)
    h8, w8 = f0.shape[1:3]
    x = torch.stack([f0, f1], dim=-2) + prec.linear(t, P["t_embed.weight"],
                                                    P["t_embed.bias"])[:, None, None, None, :]
    for i in range(cfg.layers):
        if i % 2 == 0:
            x = _block(P, i, x.reshape(n * h8, w8 * 2, d), cfg, prec).reshape(n, h8, w8, 2, d)
        else:
            xt = x.transpose(1, 2).reshape(n * w8, h8 * 2, d)
            x = _block(P, i, xt, cfg, prec).reshape(n, w8, h8, 2, d).transpose(1, 2)
    feat = x.reshape(n, h8, w8, 2 * d).permute(0, 3, 1, 2)
    out = _conv(P, "Conv_4", F.silu(_conv(P, "Conv_3", feat, prec)), prec)
    flow, mlogit = out[:, :4] * 8.0, out[:, 4:5]
    t_map = t.reshape(-1, 1, 1, 1)
    for lvl in range(cfg.refine_levels):
        s = 8 // (2 ** (lvl + 1))
        hs, ws = h // s, w // s
        flow, mlogit = _up(flow, (hs, ws)), _up(mlogit, (hs, ws))
        i0, i1 = resize(img0, (hs, ws), "area"), resize(img1, (hs, ws), "area")
        w0, w1 = _warp(i0, flow[:, 0:2] / float(s)), _warp(i1, flow[:, 2:4] / float(s))
        inp = torch.cat([i0.permute(0, 3, 1, 2), i1.permute(0, 3, 1, 2), w0.permute(0, 3, 1, 2),
                         w1.permute(0, 3, 1, 2), flow / 8.0, mlogit, t_map.expand(n, 1, hs, ws)], 1)
        dd = F.silu(_conv(P, f"refine_lvl{lvl}_c0", inp, prec))
        dd = F.silu(_conv(P, f"refine_lvl{lvl}_c1", dd, prec))
        dd = _conv(P, f"refine_lvl{lvl}_c2", dd, prec)
        flow = flow + dd[:, :4] * float(s)
        mlogit = mlogit + dd[:, 4:5]
    flow = _up(flow, (h, w))
    m = torch.sigmoid(_up(mlogit, (h, w))).permute(0, 2, 3, 1)
    warped0, warped1 = _warp(img0, flow[:, 0:2]), _warp(img1, flow[:, 2:4])
    merged = warped0 * m + warped1 * (1.0 - m)
    res = _conv(P, "Conv_6", F.silu(_conv(P, "Conv_5", torch.cat([merged, warped0, warped1], -1)
                                          .permute(0, 3, 1, 2), prec)), prec)
    return torch.clamp(merged + torch.tanh(res).permute(0, 2, 3, 1) * (1.0 / 16.0), 0.0, 1.0)
