"""The reference steps of the two configurations: what one step of the
measured program should produce, as uint8 I420 frames, from the same
frames, weights and HUD history.

- ``flagship_step``: the router analysis on a downscaled gray pair
  (Farneback, the SSIM scene-cut gate confirmed by a flow-compensated
  SSIM, the HUD ring's temporal variance with morphology), the IFNet's
  shared-flow timesteps, the scene-cut hold of x0, the HUD composite
  (where the endpoints agree), Lanczos4 to the output size, uint8.
- ``adaptive_step``: the full-resolution analysis, the route of each pair
  by the calibrated per-motion bins (``bin_winner``), RIFE per timestep or
  VFIMamba on the pairs routed to them, x0 on a scene cut, the HUD
  composite, then Lanczos4 and uint8.

Frames out: the P x0 frames, then the P*T midpoints pair-major.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench.reference import ops, rife, vfimamba
from portbench.reference.precision import FULL, Precision
from portbench.reference.warp import windowed_warp


def push_history(hist: torch.Tensor, cnt: torch.Tensor, frame: torch.Tensor):
    """Append the 320x180 gray of ``frame`` [N,H,W,3] to the ring [N,K,180,320]."""
    g = ops.rgb_to_gray(frame * 255.0)
    small = ops.resize(g[..., None], ops.HUD_RES, "linear")[..., 0]
    return torch.cat([hist[:, 1:], small[:, None]], 1), torch.clamp(cnt + 1, max=hist.shape[1])


def history_of(x0_frames, n: int, device, ring: int = 10):
    """The ring after pushing each of ``x0_frames`` ([N,H,W,3] each, oldest
    first) into an empty one."""
    hist = torch.zeros((n, ring, *ops.HUD_RES), device=device)
    cnt = torch.zeros((n,), dtype=torch.int32, device=device)
    for f in x0_frames:
        hist, cnt = push_history(hist, cnt, f)
    return hist, cnt


def _scene_cut(s0, s1, flow_small, thr, warp_thr, prec):
    score = ops.ssim(s0, s1, prec)
    warped = windowed_warp(s1[..., None], flow_small, 1.0, 8, "replicate", torch.float32)[..., 0]
    return (score < thr) & (ops.ssim(s0, warped, prec) < warp_thr)


def _hud_small(hist, cnt, var_thr):
    var = hist[:, -5:].var(dim=1, correction=0)
    small = (var < var_thr).float()
    return torch.where((cnt >= 5)[:, None, None], small, 0.0)


def _hud_composite(mids, x0, x1, hud, timestamps):
    """mids [P*T,H,W,3]; hud [P,H,W] bool: source x0 for t < 0.5, else x1."""
    p, h, w, _ = x0.shape
    t = len(timestamps)
    src = torch.stack([x0 if ts < 0.5 else x1 for ts in timestamps], 1).reshape(p * t, h, w, 3)
    return torch.where(hud.repeat_interleave(t, 0)[..., None], src, mids)


def flagship_step(P, x0, x1, hist, cnt, cfg: dict, prec: Precision = FULL,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x0/x1 [P,H,W,3] in [0, 1]; hist/cnt the ring before this step.
    Returns uint8 [(1+T)*P, OH, OW, 3]."""
    p, h, w, _ = x0.shape
    ts = tuple(cfg["timestamps"])
    t = len(ts)
    net = rife.IFNetConfig.from_dict(cfg["ifnet"])
    hist, cnt = push_history(hist, cnt, x0)
    ah, aw = cfg["analysis_hw"]
    g0 = ops.rgb_to_gray(ops.resize(x0, (ah, aw), "linear") * 255.0)
    g1 = ops.rgb_to_gray(ops.resize(x1, (ah, aw), "linear") * 255.0)
    flow = ops.farneback(g0, g1, prec)
    scene = _scene_cut(g0, g1, flow, cfg["scene_ssim_threshold"], cfg["scene_warp_ssim_threshold"],
                       prec)
    hud_small = ops.morph_open(ops.morph_close(_hud_small(hist, cnt, cfg["hud_var_threshold"])))
    coverage = (hud_small > 0.5).float().mean(dim=(1, 2))

    merged = rife.shared_flow(P, ops.pad_to_multiple(x0), ops.pad_to_multiple(x1), ts, net, prec,
                              dtype)
    mids = merged[:, :h, :w, :].to(x0.dtype)
    mids = torch.where(scene.repeat_interleave(t)[:, None, None, None],
                       x0.repeat_interleave(t, 0), mids)
    hud = ops.resize((hud_small > 0.5)[..., None].float(), (h, w), "nearest")[..., 0] > 0.5
    agree = torch.abs(ops.rgb_to_gray(x0 * 255.0) - ops.rgb_to_gray(x1 * 255.0)) <= cfg["hud_agree_eps"]
    hud = hud & agree & (coverage > cfg["hud_coverage_threshold"])[:, None, None]
    mids = _hud_composite(mids, x0, x1, hud, ts)
    return ops.to_uint8(ops.resize(torch.cat([x0, mids], 0), cfg["out_hw"], "lanczos4"))


def load_bins(path: Path) -> list:
    return json.loads(Path(path).read_text())["expert_bins"]["native"]


def bin_winner(bins: list, motion: float, margin_db: float = 0.25,
               static_eps_px: float = 0.25) -> str:
    """The measured-best expert at a pair's full-resolution motion_mean:
    'rife' when static; else the bin's, VFIMamba only when it wins by more
    than ``margin_db``; above the last bin edge the last bin decides."""
    if motion < static_eps_px:
        return "rife"
    chosen = next((b for b in bins if b["motion_lo"] <= motion < b["motion_hi"]), bins[-1])
    return "vfimamba" if chosen["vfimamba"] > chosen["rife"] + margin_db else "rife"


def analyze_full(x0, x1, hist, cnt, cfg: dict, prec: Precision = FULL) -> dict:
    """Full-resolution router signals of [N,H,W,3] pairs (hist/cnt after
    this step's push)."""
    n, h, w, _ = x0.shape
    g0, g1 = ops.rgb_to_gray(x0 * 255.0), ops.rgb_to_gray(x1 * 255.0)
    flow = ops.farneback(g0, g1, prec)
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    sh, sw = max(h // 4, 7), max(w // 4, 7)
    s0 = ops.resize(g0[..., None], (sh, sw), "linear")[..., 0]
    s1 = ops.resize(g1[..., None], (sh, sw), "linear")[..., 0]
    flow_small = ops.resize(flow, (sh, sw), "linear") * torch.tensor(
        [sw / w, sh / h], dtype=flow.dtype, device=flow.device)
    scene = _scene_cut(s0, s1, flow_small, cfg["scene_ssim_threshold"],
                       cfg["scene_warp_ssim_threshold"], prec)
    hud_full = ops.resize(_hud_small(hist, cnt, cfg["hud_var_threshold"])[..., None], (h, w),
                          "nearest")[..., 0]
    hud = ops.morph_open(ops.morph_close(hud_full)) > 0.5
    hud = hud & (torch.abs(g0 - g1) <= cfg["hud_agree_eps"])
    return {"scene": scene, "motion_mean": mag.mean(dim=(1, 2)), "hud": hud,
            "coverage": hud.float().mean(dim=(1, 2))}


def adaptive_step(P_rife, P_mamba, x0, x1, hist, cnt, cfg: dict, bins: list,
                  prec: Precision = FULL, route: str = None):
    """One pair (x0/x1 [1,H,W,3]); hist/cnt the ring before this step.
    Returns (uint8 [1+T, OH, OW, 3], route: 'rife', 'vfimamba' or 'scene').
    ``route`` forces a route (the meta-device count, where no value can be
    read)."""
    h, w = x0.shape[1:3]
    ts = tuple(cfg["timestamps"])
    t = len(ts)
    hist, cnt = push_history(hist, cnt, x0)
    sig = analyze_full(x0, x1, hist, cnt, cfg, prec)
    if route is None:
        route = ("scene" if bool(sig["scene"][0])
                 else bin_winner(bins, float(sig["motion_mean"][0])))
    x0r = ops.pad_to_multiple(x0).repeat_interleave(t, 0)
    x1r = ops.pad_to_multiple(x1).repeat_interleave(t, 0)
    tt = torch.tensor(ts, device=x0.device)
    if route == "rife":
        mids = rife.ifnet(P_rife, x0r, x1r, tt, rife.IFNetConfig.from_dict(cfg["rife"]), prec)[0]
    elif route == "vfimamba":
        mids = vfimamba.vfimamba(P_mamba, x0r, x1r, tt,
                                 vfimamba.MambaConfig.from_dict(cfg["vfimamba"]), prec)
    else:
        mids = x0r
    mids = mids[:, :h, :w, :]
    hud = sig["hud"] & (sig["coverage"] > cfg["hud_coverage_threshold"])[:, None, None]
    mids = _hud_composite(mids, x0, x1, hud, ts)
    frames = torch.cat([x0, mids], 0)
    return ops.to_uint8(ops.resize(frames, cfg["out_hw"], "lanczos4")), route
