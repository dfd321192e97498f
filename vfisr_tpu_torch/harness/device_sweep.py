"""The device-batched experiment path (port of
``vfisr_tpu/harness/device_sweep.py``).

The interval stays on the device as uint8 stacks; each chunk of K frame
pairs runs degrade -> SR -> edge -> VFI -> metrics as one sequence of torch
ops (``_chunk_program``, eager: its static arguments are plain Python), and
the host reads back only the metric scalars, and the frames when a video is
written. The metrics are ``experiments.run_experiment``'s: keyframe PSNR and
SSIM on the SR frame before edge enhancement against the reference frame,
VFI PSNR and SSIM on the t = 0.5 frame against the ground-truth midpoint,
LPIPS on every 10th evaluated VFI frame, overall = 0.25 * KF + 0.75 * VFI.

Methods: none/control, frame_dup, linear_blend, rife, adaptive,
optical_flow, ui_aware (UAFI), ughi and mcar. The flow methods compute
Farneback once per pair and warp with ``core/warp.py::backward_warp`` (the
windowed kernel, K1, on the GPU). Every failure raises: no method falls
back to another expert or to the per-frame loop.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.evaluation.metrics import safe_round
from vfisr_tpu_torch.methods.inline import (FAST_FLOW_PARAMS, FLOW_PARAMS, complexity_core,
                                            edge_enhance_core)
from vfisr_tpu_torch.ops.flow import farneback_flow, flow_magnitude
from vfisr_tpu_torch.ops.morphology import morph_close, morph_open
from vfisr_tpu_torch.ops.ssim import ssim_global_batch

DEVICE_METHODS = {"none", "frame_dup", "linear_blend", "rife", "adaptive",
                  "optical_flow", "ui_aware", "ughi", "mcar"}
# full-resolution Farneback per pair: smaller chunks
_HEAVY_FLOW_METHODS = {"ui_aware", "ughi", "mcar"}

INPUT_W, INPUT_H = 960, 540  # the degradation target
TS = (0.25, 0.5, 0.75)


class DeviceInterval:
    """An interval's frames on ``device`` as uint8 stacks [N, H, W, 3],
    uploaded once for every experiment of a sweep. keyframes, midpoints and
    ref_frames: lists of HWC uint8 RGB; the reference frames default to the
    keyframes."""

    def __init__(self, keyframes: List[np.ndarray], midpoints: Optional[List[np.ndarray]],
                 ref_frames: Optional[List[np.ndarray]] = None, device: str = "cuda"):
        self.device = torch.device(device)
        self.kf = to_device(np.stack(keyframes), device)
        self.mid = to_device(np.stack(midpoints), device) if midpoints else None
        self.ref = to_device(np.stack(ref_frames), device) if ref_frames is not None else self.kf
        self.n_kf = self.kf.shape[0]


def _psnr_per_frame(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, ...] x2 -> [N] PSNR in f32, inf where the frames are equal."""
    mse = torch.mean((a.float() - b.float()) ** 2, dim=tuple(range(1, a.ndim)))
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       10.0 * torch.log10(255.0 ** 2 / torch.clamp(mse, min=1e-12)))


def _qu8(x: torch.Tensor) -> torch.Tensor:
    """Float 0..255 onto the uint8 grid (round half up, clipped), kept
    float: the per-frame loop holds uint8 after every step."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def _ts(device) -> torch.Tensor:
    """The timesteps as [1, 3, 1, 1, 1]."""
    return torch.tensor(TS, dtype=torch.float32, device=device).view(1, 3, 1, 1, 1)


def _t_major(k: int, device) -> torch.Tensor:
    """[3K, 1, 1, 1]: each timestep repeated K times (timestep-major batches)."""
    return torch.tensor(TS, dtype=torch.float32, device=device).repeat_interleave(k).view(-1, 1, 1, 1)


def _chunk_program(src: torch.Tensor, ref: torch.Tensor, gt: torch.Tensor,
                   rife_mids: torch.Tensor, *, vfi: str, interp: str, edge: float, out_hw: tuple,
                   is_control: bool, motion_thresh: float, mcar_low: float, mcar_high: float,
                   want_frames: bool) -> dict:
    """One chunk: src and ref [K+1, H, W, 3] uint8 keyframes and reference
    frames, gt [K, Hg, Wg, 3] uint8 midpoints, rife_mids [K, 3, oh, ow, 3]
    float 0..255 (the neural expert's frames, or zeros). Returns the
    per-frame metrics ([K+1] keyframe, [K] VFI), rife_used [K], the t = 0.5
    frames as uint8, and with want_frames the frames to write."""
    oh, ow = out_hw
    k = src.shape[0] - 1
    dev = src.device
    srcf = src.float()

    if is_control:
        out = _qu8(resize(srcf, out_hw, "lanczos4"))
        out_m = out
    else:
        degraded = _qu8(resize(srcf, (INPUT_H, INPUT_W), "area"))
        out_m = _qu8(resize(degraded, out_hw, interp))  # before edge enhancement: metrics
        out = _qu8(edge_enhance_core(out_m, edge)) if edge > 0 else out_m

    ref_r = _qu8(resize(ref.float(), out_hw, "lanczos4"))
    kf_psnr = _psnr_per_frame(out_m, ref_r)
    kf_ssim = ssim_global_batch(rgb_to_gray(out_m), rgb_to_gray(ref_r))

    prev, curr = out[:-1], out[1:]  # [K, oh, ow, 3]
    ts = _ts(dev)
    rife_used = torch.zeros((k,), dtype=torch.bool, device=dev)
    if vfi in ("none", "frame_dup"):
        mids = prev[:, None].expand(k, 3, oh, ow, 3)
    elif vfi == "linear_blend":
        mids = prev[:, None] * (1 - ts) + curr[:, None] * ts
    elif vfi == "optical_flow":
        g0 = rgb_to_gray(resize(prev, (oh // 2, ow // 2), "linear"))
        g1 = rgb_to_gray(resize(curr, (oh // 2, ow // 2), "linear"))
        fl = resize(farneback_flow(g0, g1), out_hw, "linear") * 2.0
        # the zero border, as the per-frame loop's remap
        warped = backward_warp(prev.repeat(3, 1, 1, 1), fl.repeat(3, 1, 1, 1) * _t_major(k, dev),
                               1.0, border="constant")  # [3K, oh, ow, 3], timestep-major
        warped = warped.reshape(3, k, oh, ow, 3).transpose(0, 1)
        mids = warped * (1 - ts) + curr[:, None] * ts
    elif vfi == "ui_aware":
        # UAFI, its flow once per pair for the mask warp and the 3 timesteps
        flow = farneback_flow(rgb_to_gray(prev), rgb_to_gray(curr), *FLOW_PARAMS)
        t_all = torch.tensor([0.5, *TS], dtype=torch.float32, device=dev)
        warped_all = backward_warp(prev.repeat(4, 1, 1, 1),
                                   flow.repeat(4, 1, 1, 1) * t_all.repeat_interleave(k).view(-1, 1, 1, 1),
                                   1.0, border="constant", radius=(4, 6)).reshape(4, k, oh, ow, 3)
        recon_err = torch.mean(torch.abs(warped_all[0] - curr), dim=-1)
        ui = (recon_err > 30) & (flow_magnitude(flow) < 2)
        ui = morph_open(morph_close(ui.to(torch.uint8), 5), 5) > 0
        blended = warped_all[1:].transpose(0, 1) * (1 - ts) + curr[:, None] * ts
        # UI pixels from prev at t < 0.5, else from curr
        ui_src = torch.stack([prev, curr, curr], dim=1)
        mids = torch.where(ui[:, None, :, :, None], ui_src, blended)
    elif vfi == "ughi":
        g0, g1 = rgb_to_gray(prev), rgb_to_gray(curr)
        flow_fwd = farneback_flow(g0, g1, *FLOW_PARAMS)
        flow_bwd = farneback_flow(g1, g0, *FLOW_PARAMS)
        bwd_warped = backward_warp(flow_bwd, flow_fwd, 1.0, border="constant", radius=(4, 6))
        err = torch.sqrt((flow_fwd[..., 0] + bwd_warped[..., 0]) ** 2
                         + (flow_fwd[..., 1] + bwd_warped[..., 1]) ** 2)
        unc = torch.clamp(err / 10.0, 0, 1)
        motion_unc = torch.clamp(flow_magnitude(flow_fwd) / 50.0, 0, 1)
        unc = torch.maximum(unc, motion_unc * 0.5)
        t_f = _t_major(k, dev)
        imgs = torch.cat([prev.repeat(3, 1, 1, 1), curr.repeat(3, 1, 1, 1)], dim=0)
        flows = torch.cat([flow_fwd.repeat(3, 1, 1, 1) * t_f,
                           flow_bwd.repeat(3, 1, 1, 1) * -(1 - t_f)], dim=0)
        warped = backward_warp(imgs, flows, 1.0, border="constant",
                               radius=(4, 6)).reshape(2, 3, k, oh, ow, 3)
        w_fwd, w_bwd = warped[0].transpose(0, 1), warped[1].transpose(0, 1)
        base = w_fwd * (1 - ts) + w_bwd * ts
        simple = prev[:, None] * (1 - ts) + curr[:, None] * ts
        u5 = unc[:, None, :, :, None]
        mids = base * (1 - u5) + simple * u5
    elif vfi == "mcar":
        # three tiers by complexity (fast Farneback + Canny edge density)
        complexity, flow = complexity_core(rgb_to_gray(prev), rgb_to_gray(curr))
        warped = backward_warp(prev.repeat(3, 1, 1, 1), flow.repeat(3, 1, 1, 1) * _t_major(k, dev),
                               1.0, border="constant", radius=(4, 6))
        flow_mids = warped.reshape(3, k, oh, ow, 3).transpose(0, 1) * (1 - ts) + curr[:, None] * ts
        blend = prev[:, None] * (1 - ts) + curr[:, None] * ts
        low = complexity < mcar_low
        high = complexity >= mcar_high
        rife_used = high  # the RIFE tier (seldom reached: see methods/inline.py)
        mids = torch.where(low[:, None, None, None, None], blend, flow_mids)
        mids = torch.where(high[:, None, None, None, None], rife_mids, mids)
    elif vfi == "rife":
        mids = rife_mids
        rife_used = torch.ones((k,), dtype=torch.bool, device=dev)
    elif vfi == "adaptive":
        rife_used = _motion_chunk(prev, curr) > motion_thresh
        blend = prev[:, None] * (1 - ts) + curr[:, None] * ts
        mids = torch.where(rife_used[:, None, None, None, None], rife_mids, blend)
    else:
        raise ValueError(f"unsupported device vfi method {vfi}")
    mids = _qu8(mids)

    mid_half = mids[:, 1]
    gt_r = _qu8(resize(gt.float(), out_hw, "lanczos4"))
    res = {
        "kf_psnr": kf_psnr, "kf_ssim": kf_ssim,
        "vfi_psnr": _psnr_per_frame(mid_half, gt_r),
        "vfi_ssim": ssim_global_batch(rgb_to_gray(mid_half), rgb_to_gray(gt_r)),
        "rife_used": rife_used,
        "mid_half_u8": torch.clamp(mid_half + 0.5, 0, 255).to(torch.uint8),
    }
    if want_frames:
        # the order written per pair: mid1 mid2 mid3 kf_{i+1}
        seq = torch.cat([mids, curr[:, None]], dim=1)
        res["frames_u8"] = torch.clamp(seq + 0.5, 0, 255).to(torch.uint8)
        res["first_kf_u8"] = torch.clamp(out[0] + 0.5, 0, 255).to(torch.uint8)
    return res


def _motion_chunk(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """[K]: each pair's adaptive-router motion, the mean magnitude of the
    fast Farneback flow at 480x270: what ``_chunk_program``'s adaptive
    branch thresholds, and what the quality-aware tier reads back to pick
    each pair's expert from the calibrated 'sweep' bins."""
    ga = rgb_to_gray(resize(prev, (270, 480), "linear"))
    gb = rgb_to_gray(resize(curr, (270, 480), "linear"))
    return torch.mean(flow_magnitude(farneback_flow(ga, gb, *FAST_FLOW_PARAMS)), dim=(1, 2))


def _vfimamba_chunk(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
    """[K,oh,ow,3] float 0..255 x2 -> [K,3,oh,ow,3] float 0..255 VFIMamba
    frames, one timestep per call (a batch of one pair: the activations of
    three timesteps at 1440p do not fit beside the sweep's frames; above
    1920x1080 the model's internal cap runs the trunk at 1920x1080)."""
    from vfisr_tpu_torch.harness.experiments import _VFIMambaSingleton

    m = _VFIMambaSingleton.get(prev.device)
    x0, x1 = prev / 255.0, curr / 255.0
    return torch.cat([m.interpolate_batch(x0, x1, (t,)) for t in TS], dim=1) * 255.0


def _rife_chunk(prev: torch.Tensor, curr: torch.Tensor, scale: float = 0.5) -> torch.Tensor:
    """[K,oh,ow,3] frames (0..255) x2 -> [K,3,oh,ow,3] float 0..255 RIFE
    frames, the pyramid at the reference's rife_scale (0.5 the default,
    0.25 rife_fast; ``experiments._rife_native_scale``)."""
    from vfisr_tpu_torch.harness.experiments import _RIFESingleton, _rife_native_scale

    m = _RIFESingleton.get(prev.device)
    out = m.interpolate_batch(prev.float() / 255.0, curr.float() / 255.0, TS,
                              scale=_rife_native_scale(scale))
    return out * 255.0


def _pad_tail(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with its last frame repeated n more times."""
    return torch.cat([x, x[-1:].expand(n, *x.shape[1:])], dim=0)


def _window(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """x[start:start + size], the start clamped so the window stays whole
    (``lax.dynamic_slice``'s rule: a window past the midpoints' end is read
    but not evaluated)."""
    start = max(0, min(start, x.shape[0] - size))
    return x[start:start + size]


def run_experiment_batched(
    interval: DeviceInterval,
    experiment: dict,
    output_path: Optional[str] = None,
    out_fps: Optional[float] = None,
    lpips_fn=None,
    lpips_mode: Optional[str] = None,
    chunk_pairs: int = 8,
    rife_chunk_pairs: int = 2,
    verbose: bool = True,
) -> dict:
    """``experiments.run_experiment`` in chunks of pairs on the interval's
    device: the same result schema, with ``device_batched: True``. Chunks
    hold at most chunk_pairs pairs (4 for UAFI, UGHI and MCAR's
    full-resolution flows, rife_chunk_pairs where RIFE runs); the tail chunk
    is padded with the last frame and its padding masked out on the host."""
    from vfisr_tpu_torch.data.video_io import VideoWriter
    from vfisr_tpu_torch.harness.experiments import (DEFAULT_QUALITY, QUALITY_LEVELS,
                                                     route_neural_expert)

    name = experiment["name"]
    vfi = experiment.get("vfi", "linear_blend")
    sr_method = experiment.get("sr", "lanczos")
    edge = float(experiment.get("edge", 0))
    rife_scale = float(experiment.get("rife_scale", 0.5))
    motion_thresh = float(experiment.get("motion_thresh", 3.0))
    quality_aware = bool(experiment.get("quality_aware", False))
    qa_bins = None
    if quality_aware:
        # the blend route also bounded by the measured blend-vs-RIFE
        # crossover, the neural pairs by the calibrated expert bins
        from vfisr_tpu_torch.utils.router_gate import blend_crossover_px, expert_bins

        crossover = blend_crossover_px()
        if crossover is not None:
            motion_thresh = min(motion_thresh, crossover)
        if vfi == "adaptive":
            qa_bins = expert_bins("sweep")
    expert_counts = {"blend": 0, "rife": 0, "rife_fast": 0, "vfimamba": 0}
    mcar_low = float(experiment.get("mcar_low", 0.3))
    mcar_high = float(experiment.get("mcar_high", 0.7))
    exp_fps = experiment.get("quality_fps", QUALITY_LEVELS[DEFAULT_QUALITY]["fps"])
    out_w, out_h = experiment.get("quality_resolution", QUALITY_LEVELS[DEFAULT_QUALITY]["resolution"])
    is_control = name == "control" or name.startswith("control_")
    interp = "cubic" if sr_method == "bicubic" else "lanczos4"
    if vfi not in DEVICE_METHODS:
        raise ValueError(f"{vfi} has no device-batched path")
    needs_rife = vfi in ("rife", "adaptive", "mcar")
    if vfi in _HEAVY_FLOW_METHODS:
        chunk_pairs = min(chunk_pairs, 4)
    if needs_rife:
        chunk_pairs = min(chunk_pairs, rife_chunk_pairs)

    writer = VideoWriter(output_path, out_w, out_h, out_fps or exp_fps) if output_path else None

    n_pairs = interval.n_kf - 1
    kf_pad = _pad_tail(interval.kf, chunk_pairs)
    ref_pad = _pad_tail(interval.ref, chunk_pairs + 1)
    mid_pad = _pad_tail(interval.mid, chunk_pairs) if interval.mid is not None else None
    kf_psnr_all, kf_ssim_all = [], []
    vfi_psnr_all, vfi_ssim_all, rife_used_all = [], [], []
    lpips_vals = []
    cnt = 0
    t0 = time.time()

    try:
        for start in range(0, n_pairs, chunk_pairs):
            k_real = min(chunk_pairs, n_pairs - start)
            # whole-size chunks; the tail's padding frames are masked below
            src = _window(kf_pad, start, chunk_pairs + 1)
            ref = _window(ref_pad, start, chunk_pairs + 1)
            gt = (_window(mid_pad, start, chunk_pairs) if mid_pad is not None
                  else interval.kf[0].expand(chunk_pairs, *interval.kf.shape[1:]))

            rife_mids = torch.zeros((chunk_pairs, 3, out_h, out_w, 3), dtype=torch.float32,
                                    device=src.device)
            chunk_labels = None
            if needs_rife:
                # the experts interpolate the SR frames
                srcf = src.float()
                if is_control:
                    up = resize(srcf, (out_h, out_w), "lanczos4")
                else:
                    up = resize(resize(srcf, (INPUT_H, INPUT_W), "area"), (out_h, out_w), interp)
                    if edge > 0:
                        up = edge_enhance_core(up, edge)
                if qa_bins is not None:
                    # each pair's expert from the bins; rife_mids holds the
                    # chosen expert's frames (the blend-or-neural choice
                    # stays in _chunk_program)
                    upq = _qu8(up)  # _chunk_program's quantised frames
                    motion = _motion_chunk(upq[:-1], upq[1:]).cpu().numpy()
                    chunk_labels = []
                    for m in motion:
                        e, so = route_neural_expert(float(m), True)
                        chunk_labels.append("vfimamba" if e == "vfimamba"
                                            else ("rife_fast" if so == 0.25 else "rife"))
                    mids_by = {}
                    if "rife" in chunk_labels:
                        mids_by["rife"] = _rife_chunk(upq[:-1], upq[1:], 0.5)
                    if "rife_fast" in chunk_labels:
                        mids_by["rife_fast"] = _rife_chunk(upq[:-1], upq[1:], 0.25)
                    parts = []
                    for j, lab in enumerate(chunk_labels):
                        if lab == "vfimamba":
                            parts.append(_vfimamba_chunk(upq[j:j + 1], upq[j + 1:j + 2]))
                        else:
                            parts.append(mids_by[lab][j:j + 1])
                    rife_mids = torch.cat(parts, dim=0)
                else:
                    rife_mids = _rife_chunk(up[:-1], up[1:], rife_scale)

            res = _chunk_program(src, ref, gt, rife_mids, vfi=vfi, interp=interp, edge=edge,
                                 out_hw=(out_h, out_w), is_control=is_control,
                                 motion_thresh=motion_thresh, mcar_low=mcar_low,
                                 mcar_high=mcar_high, want_frames=writer is not None)
            first_chunk = start == 0
            kf_lo = 0 if first_chunk else 1
            kf_psnr_all.extend(res["kf_psnr"][kf_lo:k_real + 1].tolist())
            kf_ssim_all.extend(res["kf_ssim"][kf_lo:k_real + 1].tolist())
            if interval.mid is not None and vfi != "none" and not is_control:
                # the per-frame loop evaluates while midpoints last
                k_eval = max(0, min(k_real, interval.mid.shape[0] - start))
                vfi_psnr_all.extend(res["vfi_psnr"][:k_eval].tolist())
                vfi_ssim_all.extend(res["vfi_ssim"][:k_eval].tolist())
                ru_chunk = res["rife_used"][:k_eval].tolist()
                rife_used_all.extend(ru_chunk)
                if vfi == "adaptive":
                    for j, used in enumerate(ru_chunk):
                        expert_counts[(chunk_labels[j] if chunk_labels else "rife")
                                      if used else "blend"] += 1
                if lpips_fn is not None:
                    for j in range(k_eval):
                        if (start + j + 1) % 10 == 0:  # every 10th evaluated VFI frame
                            pred = res["mid_half_u8"][j].cpu().numpy()
                            gt_j = gt[j]
                            if tuple(gt_j.shape[:2]) != pred.shape[:2]:
                                gt_j = _qu8(resize(gt_j.float(), pred.shape[:2], "lanczos4"))
                            lpips_vals.append(lpips_fn(pred, gt_j.to(torch.uint8).cpu().numpy()))
            if writer is not None:
                if first_chunk:
                    writer.write(res["first_kf_u8"].cpu().numpy())
                    cnt += 1
                for pair in res["frames_u8"][:k_real].cpu().numpy():
                    for f in pair:
                        writer.write(f)
                    cnt += 4
            else:
                cnt += k_real * 4 + (1 if first_chunk else 0)
    finally:
        if writer is not None:
            writer.close()
    elapsed = time.time() - t0

    def _avg(v):
        # the per-frame loop sums the PSNRs, so equal frames make the mean inf
        return float(np.mean(v)) if len(v) else 0.0

    avg_kf_psnr = _avg(kf_psnr_all)
    avg_kf_ssim = float(np.mean(kf_ssim_all)) if kf_ssim_all else 0.0
    avg_vfi_psnr = _avg(vfi_psnr_all)
    avg_vfi_ssim = float(np.mean(vfi_ssim_all)) if vfi_ssim_all else 0.0
    avg_lpips = float(np.mean(lpips_vals)) if lpips_vals else None
    if vfi_psnr_all:
        overall_psnr = 0.25 * avg_kf_psnr + 0.75 * avg_vfi_psnr
        overall_ssim = 0.25 * avg_kf_ssim + 0.75 * avg_vfi_ssim
    else:
        overall_psnr, overall_ssim = avg_kf_psnr, avg_kf_ssim
    rife_pct = (100.0 * float(np.mean(rife_used_all))
                if rife_used_all and vfi in ("adaptive", "mcar")
                else (100.0 if vfi == "rife" else 0.0))

    return {
        "name": name,
        "config": experiment,
        "frames": cnt,
        "time_s": round(elapsed, 2),
        "fps_achieved": round(cnt / elapsed, 1) if elapsed > 0 else 0,
        "keyframe_psnr_db": safe_round(avg_kf_psnr, 2),
        "keyframe_ssim": round(avg_kf_ssim, 4),
        "vfi_psnr_db": safe_round(avg_vfi_psnr, 2),
        "vfi_ssim": round(avg_vfi_ssim, 4),
        "vfi_lpips": round(avg_lpips, 4) if avg_lpips is not None else None,
        "lpips_mode": lpips_mode if avg_lpips is not None else None,
        "overall_psnr_db": safe_round(overall_psnr, 2),
        "overall_ssim": round(overall_ssim, 4),
        "psnr_db": safe_round(overall_psnr, 2),
        "ssim": round(overall_ssim, 4),
        "keyframes_evaluated": len(kf_psnr_all),
        "vfi_frames_evaluated": len(vfi_psnr_all),
        "lpips_frames_sampled": len(lpips_vals),
        "rife_frames_pct": round(rife_pct, 1),
        "realtime_x": round((cnt / exp_fps) / elapsed, 2) if elapsed > 0 else 0,
        "used_rife": vfi in ("rife", "adaptive", "mcar"),
        "output_video": str(output_path) if output_path else None,
        "quality_level": experiment.get("quality_level", "default"),
        "target_fps": exp_fps,
        "target_resolution": f"{out_w}x{out_h}",
        "vfi_method": vfi,
        "sr_method": sr_method,
        "edge_strength": edge,
        "quality_aware": quality_aware,
        "blend_thresh_effective": round(motion_thresh, 3) if vfi == "adaptive" else None,
        "vfimamba_frames_pct": (
            round(100.0 * expert_counts["vfimamba"] / max(len(rife_used_all), 1), 1)
            if vfi == "adaptive" else None),
        "expert_mix": expert_counts if vfi == "adaptive" else None,
        "device_batched": True,
    }
