"""Calibrate the adaptive router's quality gate on held-out scenes (port of
``scripts/calibrate_router.py``).

The reference routes by thresholds that assume each expert's quality; this
measures them for the experts in ``weights/`` and writes a gate file with
the keys of ``weights/router_gate.json``:

1. ``experts``: held-out midpoint PSNR of rife and vfimamba on synthetic
   scenes (``gate_checkpoint.heldout_psnr``, another seed than training's);
2. ``blend_vs_rife_crossover_px`` and ``rows``: the sweep's operating point
   over the held-out clips (each keyframe area-resized to 960x540, Lanczos4
   to the quality resolution; motion = ``calc_motion`` of the 480x270
   grays), blend against RIFE at t = 0.5 scored against the true midpoint;
   the crossover is the motion at the prefix-sum argmax of blend's gain;
3. ``expert_bins`` and ``native_rows``: per motion bin, each expert's mean
   PSNR in the sweep's regime and in the native one (full-resolution
   consecutive keyframes, the motion the adaptive router's full-res
   Farneback measures);
4. ``scene_gate``: the flow-compensated SSIM threshold of the scene-cut
   gate, from pairs of rendered worlds whose cuts are known
   (``data/synthetic_clip.py``), through both of its runtime paths.

Clips are read with ``data/video_io.py::VideoReader`` (Y4M on any machine;
a Y4M frame is decoded on the device); the worlds go through Y4M in a
temporary directory that is removed after.
The experts, Farneback and the warps run on ``--device`` (``cuda`` by
default), TF32 off. An expert whose weights file is absent is left out with
a line naming the file; any other failure raises (the reference turned every
exception into a missing entry).

    python -m vfisr_tpu_torch.calibrate_router --out outputs/router_gate.json

``--out`` may not be the shipped ``weights/router_gate.json``; the sections
that ``--skip-*`` keeps come from ``--from`` (that file by default).
"""

from __future__ import annotations

import argparse
import json
import tempfile
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data.video_io import VideoReader
from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple
from vfisr_tpu_torch.harness import experiments
from vfisr_tpu_torch.methods.inline import calc_motion, linear_blend
from vfisr_tpu_torch.utils.paths import default_weights
from vfisr_tpu_torch.utils.router_gate import DEFAULT_PATH as SHIPPED_GATE

EXPERTS = ("rife", "vfimamba")
DEFAULT_CLIPS = "data/raw/synth_calib.y4m,data/raw/synth_calib_routing.y4m"
FLOW_PARAMS = (0.5, 3, 15, 3, 5, 1.2)
SCENE_SSIM_THRESHOLD = 0.65


def expert_present(name: str) -> bool:
    """Whether ``weights/<name>.npz`` exists; prints a line naming the file
    when it does not (the expert is then left out)."""
    if default_weights(name) is None:
        print(f"expert {name}: weights/{name}.npz not found, left out")
        return False
    return True


def _open(clip: str) -> VideoReader:
    if not Path(clip).is_file():
        raise SystemExit(f"cannot open {clip}")
    return VideoReader(clip)


def _measure_rows(clip: str, pairs: int, width: int, height: int, rife_scale: float = 0.5,
                  stride: int = 1, with_experts: bool = False, device: str = "cuda") -> list:
    """Blend against RIFE at the sweep's operating point: even frames are
    keyframes, odd frames the true midpoints; every ``stride``-th pair of
    consecutive keyframes is scored (and, ``with_experts``, RIFE at its
    fast scale and VFIMamba too)."""
    with_mamba = with_experts and expert_present("vfimamba")
    rows = []
    prev = prev_gray = prev_gt = None
    pair_idx = 0
    with _open(clip) as cap:
        while len(rows) < pairs:
            kf, gt = cap.read_to(device), cap.read_to(device)
            if kf is None or gt is None:
                break
            d = experiments._resize_u8(kf, (experiments.INPUT_W, experiments.INPUT_H), "area",
                                       device)
            out = experiments._resize_u8(d, (width, height), "lanczos4", device)
            gray = experiments._gray_u8(out, device)
            pair_idx += 1
            # stride samples the whole speed profile; prev stays the true
            # consecutive keyframe
            if prev is not None and pair_idx % stride == 0:
                motion = calc_motion(
                    experiments._resize_u8(prev_gray[..., None], (480, 270), "linear", device)[..., 0],
                    experiments._resize_u8(gray[..., None], (480, 270), "linear", device)[..., 0],
                    device)
                gt_up = experiments._resize_u8(prev_gt, (width, height), "lanczos4", device)
                blend = linear_blend(prev, out, 0.5, device)
                rife = experiments._rife_interpolate(prev, out, 0.5, rife_scale, device)
                row = {
                    "motion": round(float(motion), 4),
                    "psnr_blend": round(compute_psnr_simple(blend, gt_up, device), 4),
                    "psnr_rife": round(compute_psnr_simple(rife, gt_up, device), 4),
                }
                if with_experts:
                    fast = experiments._rife_interpolate(prev, out, 0.5, 0.25, device)
                    row["psnr_rife_fast"] = round(compute_psnr_simple(fast, gt_up, device), 4)
                    if with_mamba:
                        mamba = experiments._vfimamba_interpolate(prev, out, 0.5, device)
                        row["psnr_vfimamba"] = round(compute_psnr_simple(mamba, gt_up, device), 4)
                rows.append(row)
            prev, prev_gray, prev_gt = out, gray, gt
    return rows


def _bins_from_rows(rows: list, experts: tuple, n_bins: int = 5, min_count: int = 5) -> list:
    """Quantile motion bins (equal occupancy) with each measured expert's
    mean PSNR; read by ``utils/router_gate.py::bin_winner``."""
    rows = sorted(rows, key=lambda r: r["motion"])
    n = len(rows)
    n_bins = max(1, min(n_bins, n // max(min_count, 1)))
    bins = []
    for b in range(n_bins):
        lo_i = b * n // n_bins
        hi_i = (b + 1) * n // n_bins
        chunk = rows[lo_i:hi_i]
        if not chunk:
            continue
        entry = {
            "motion_lo": 0.0 if b == 0 else float(rows[lo_i]["motion"]),
            "motion_hi": 1e9 if b == n_bins - 1 else float(rows[hi_i]["motion"]),
            "count": len(chunk),
        }
        for e in experts:
            vals = [r.get(f"psnr_{e}") for r in chunk if r.get(f"psnr_{e}") is not None]
            if vals:
                entry[e] = round(float(np.mean(vals)), 4)
        bins.append(entry)
    return bins


def _motion_full(f0, f1, device: str) -> float:
    """The adaptive router's motion: mean magnitude of the full-res
    Farneback flow of the two frames' grays."""
    from vfisr_tpu_torch.ops.flow import farneback_flow

    g0 = rgb_to_gray(to_device(f0, device).float())
    g1 = rgb_to_gray(to_device(f1, device).float())
    fl = farneback_flow(g0[None], g1[None], *FLOW_PARAMS)
    return float(torch.mean(torch.sqrt(fl[..., 0] ** 2 + fl[..., 1] ** 2)))


def measure_native_rows(clips: str, pairs: int, stride: int = 2, device: str = "cuda") -> list:
    """Expert quality at the triplet benchmark's operating point: full-res
    consecutive keyframes, scored at t = 0.5 against the true midpoint,
    keyed by the router's full-res motion."""
    with_mamba = expert_present("vfimamba")
    rows = []
    for clip in clips.split(","):
        prev = prev_gt = None
        pair_idx = taken = 0
        with _open(clip.strip()) as cap:
            while taken < pairs:
                kf, gt = cap.read_to(device), cap.read_to(device)
                if kf is None or gt is None:
                    break
                pair_idx += 1
                if prev is not None and pair_idx % stride == 0:
                    rife = experiments._rife_interpolate(prev, kf, 0.5, 0.5, device)
                    row = {
                        "motion": round(_motion_full(prev, kf, device), 4),
                        "psnr_rife": round(compute_psnr_simple(rife, prev_gt, device), 4),
                    }
                    if with_mamba:
                        mamba = experiments._vfimamba_interpolate(prev, kf, 0.5, device)
                        row["psnr_vfimamba"] = round(compute_psnr_simple(mamba, prev_gt, device), 4)
                    rows.append(row)
                    taken += 1
                prev, prev_gt = kf, gt
    return rows


def _signals_small(f0: torch.Tensor, f1: torch.Tensor, ssim_thr: float):
    """The flagship's path: grays and flow at the 480x270 analysis size.
    f0, f1: [N, H, W, 3] uint8 on the device; returns (ssim, warped_ssim)."""
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import scene_cut_signals
    from vfisr_tpu_torch.ops.flow import farneback_flow

    g0 = rgb_to_gray(resize(f0.float(), (270, 480), "linear"))
    g1 = rgb_to_gray(resize(f1.float(), (270, 480), "linear"))
    flow = farneback_flow(g0, g1, *FLOW_PARAMS)
    _, s, w = scene_cut_signals(g0, g1, flow, ssim_thr, 1.0)
    return s, w


def _signals_full(f0: torch.Tensor, f1: torch.Tensor, ssim_thr: float):
    """The adaptive router's path: full-res flow, grays and flow resized to
    a quarter."""
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import scene_cut_signals
    from vfisr_tpu_torch.ops.flow import farneback_flow

    g0 = rgb_to_gray(f0.float())
    g1 = rgb_to_gray(f1.float())
    h, w = g0.shape[-2:]
    sh, sw = h // 4, w // 4
    flow = farneback_flow(g0, g1, *FLOW_PARAMS)
    s0 = resize(g0[..., None], (sh, sw), "linear")[..., 0]
    s1 = resize(g1[..., None], (sh, sw), "linear")[..., 0]
    fl_small = resize(flow, (sh, sw), "linear") * torch.tensor(
        [sw / w, sh / h], dtype=flow.dtype, device=flow.device)
    _, s, wr = scene_cut_signals(s0, s1, fl_small, ssim_thr, 1.0)
    return s, wr


def _gate_threshold(rows: list, ssim_thr: float) -> dict:
    """The largest warped-SSIM threshold with no false hold on an ordinary
    pair that the plain SSIM confuses, moved a quarter of the way toward
    the cuts when the classes separate."""
    noncut_confusable = [r["warped_ssim"] for r in rows if not r["cut"] and r["ssim"] < ssim_thr]
    cut_w = [r["warped_ssim"] for r in rows if r["cut"]]
    w_noncut_min = min(noncut_confusable) if noncut_confusable else 1.0
    w_cut_max = max(cut_w) if cut_w else 0.0
    if w_cut_max < w_noncut_min:
        thr = w_cut_max + 0.25 * (w_noncut_min - w_cut_max)
    else:
        thr = w_noncut_min  # zero false holds; some cuts may be missed
    false_holds = sum(1 for r in rows if not r["cut"] and r["ssim"] < ssim_thr
                      and r["warped_ssim"] < thr)
    missed = sum(1 for r in rows if r["cut"]
                 and not (r["ssim"] < ssim_thr and r["warped_ssim"] < thr))
    return {
        "ssim_threshold": ssim_thr,
        "warped_ssim_threshold": round(float(thr), 4),
        "cut_pairs": sum(1 for r in rows if r["cut"]),
        "noncut_pairs": sum(1 for r in rows if not r["cut"]),
        "noncut_confusable_pairs": len(noncut_confusable),
        "cut_warped_ssim_max": round(w_cut_max, 4),
        "noncut_confusable_warped_ssim_min": round(w_noncut_min, 4),
        "false_holds": false_holds,
        "missed_cuts": missed,
    }


def _labeled_pairs(worlds: list, device: str) -> list:
    """(is_cut, frame0, frame1): pairs of keyframes two frames apart, every
    fourth frame, labelled by the worlds' known cuts; every ordered pair of
    different worlds' first frames is a cut. Frames are decoded on device
    and stay there."""
    labeled, first_frames = [], []
    for path, fracs, n_frames in worlds:
        cuts = [int(n_frames * f) for f in fracs]
        with VideoReader(str(path)) as cap:
            frames = list(iter(lambda: cap.read_to(device), None))
        first_frames.append(frames[0])
        for i in range(2, len(frames) - 1, 4):
            a, b = i - 2, i
            labeled.append((sum(c <= a for c in cuts) != sum(c <= b for c in cuts),
                            frames[a], frames[b]))
    for i, fi in enumerate(first_frames):
        for j, fj in enumerate(first_frames):
            if i != j:
                labeled.append((True, fi, fj))
    return labeled


def measure_scene_gate(extra_worlds: int = 2, seconds: float = 6.0,
                       ssim_thr: float = SCENE_SSIM_THRESHOLD, device: str = "cuda") -> dict:
    """The flow-compensated scene-cut gate on labelled pairs: ``extra_worlds``
    hard worlds (seeds 520.., v1 and routing in turn, cuts at 45%/80%) and
    a smooth one (seed 530, cut at 62%), rendered at 1920x1080, 60 fps; each
    pair's two signals through both runtime paths (``_signals_small``,
    ``_signals_full``), pooled into ``_gate_threshold``."""
    from vfisr_tpu_torch.data import synthetic_clip as sc

    with tempfile.TemporaryDirectory(prefix="scene_gate_") as tmp:
        worlds = []  # (path, cut fractions, frames)
        for k in range(extra_worlds):
            p = Path(tmp) / f"world_hard_{k}.y4m"
            n = sc.render_hard_clip(str(p), seconds=seconds, seed=520 + k,
                                    profile="routing" if k % 2 else "v1", device=device)
            worlds.append((p, sc.HARD_CUTS, n))
        p = Path(tmp) / "world_smooth.y4m"
        worlds.append((p, (sc.SMOOTH_CUT,), sc.render_clip(str(p), seconds=seconds, seed=530,
                                                           device=device)))
        labeled = _labeled_pairs(worlds, device)

    rows = []
    for is_cut, f0, f1 in labeled:
        x0, x1 = to_device(f0, device)[None], to_device(f1, device)[None]
        for fn, path_name in ((_signals_small, "flagship"), (_signals_full, "router")):
            s, w = fn(x0, x1, ssim_thr)
            rows.append({"cut": bool(is_cut), "path": path_name,
                         "ssim": round(float(s[0]), 4), "warped_ssim": round(float(w[0]), 4)})
    return _gate_threshold(rows, ssim_thr)


def crossover(rows: list) -> float:
    """The motion at the prefix-sum argmax of blend's gain over RIFE along
    motion-sorted rows (0 when blend never helps). rows: sorted by motion."""
    best = 0.0
    gain_sum = best_sum = 0.0
    for r in rows:
        gain_sum += r["psnr_blend"] - r["psnr_rife"]
        if gain_sum > best_sum:
            best_sum = gain_sum
            best = r["motion"]
    return best


def measure_crossover(clips: str, pairs: int, width: int, height: int, rife_scale: float = 0.5,
                      stride: int = 1, with_experts: bool = False, device: str = "cuda") -> dict:
    """The rows of every clip of the comma list, pooled (the gate must see
    textured hard pairs and frozen-world static ones), and their crossover."""
    rows = []
    for clip in clips.split(","):
        rows.extend(_measure_rows(clip.strip(), pairs, width, height, rife_scale, stride,
                                  with_experts, device))
    if not rows:
        raise SystemExit("no pairs measured")
    rows.sort(key=lambda r: r["motion"])
    return {
        "blend_vs_rife_crossover_px": round(crossover(rows), 4),
        "pairs_measured": len(rows),
        "blend_win_pairs": sum(1 for r in rows if r["psnr_blend"] > r["psnr_rife"]),
        "motion_range": [rows[0]["motion"], rows[-1]["motion"]],
        "rows": rows,
    }


def main(argv=None) -> dict:
    """Run the CLI; returns the record it wrote."""
    ap = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.calibrate_router",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", default=DEFAULT_CLIPS,
                    help="comma list of held-out clips; pairs are pooled so the gate sees "
                    "textured-hard and frozen-static regimes")
    ap.add_argument("--pairs", type=int, default=60)
    ap.add_argument("--samples", type=int, default=24,
                    help="held-out synthetic scenes for the expert PSNRs")
    ap.add_argument("--crop", type=int, default=192)
    ap.add_argument("--seed", type=int, default=417,
                    help="held-out seed (training gates use other seeds)")
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--out", default="outputs/router_gate.json",
                    help="the gate file to write (not the shipped weights/router_gate.json)")
    ap.add_argument("--from", dest="from_path", default=str(SHIPPED_GATE),
                    help="the gate file whose sections --skip-* keeps")
    ap.add_argument("--skip-experts", action="store_true")
    ap.add_argument("--skip-crossover", action="store_true")
    ap.add_argument("--skip-scene-gate", action="store_true")
    ap.add_argument("--skip-bins", action="store_true",
                    help="skip the per-motion-bin expert calibration (sweep + native regimes)")
    ap.add_argument("--stride", type=int, default=4,
                    help="evaluate every Nth pair so every speed stratum is sampled")
    ap.add_argument("--native-clips", default=DEFAULT_CLIPS,
                    help="held-out clips for the native (triplet benchmark) regime's bins")
    ap.add_argument("--native-pairs", type=int, default=40)
    ap.add_argument("--scene-worlds", type=int, default=2)
    ap.add_argument("--scene-seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu (small runs)")
    args = ap.parse_args(argv)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out_path = Path(args.out)
    if out_path.resolve() == SHIPPED_GATE.resolve():
        raise SystemExit(f"--out {args.out} is the shipped gate file; write the calibration "
                         "elsewhere and compare it with the shipped one before replacing it")
    from vfisr_tpu_torch.gate_checkpoint import heldout_psnr

    dev = args.device
    record: dict = {
        "calibrated_at": datetime.now(timezone.utc).isoformat(),
        "clip": args.clip,
        "quality_resolution": f"{args.width}x{args.height}",
    }
    skips = (args.skip_experts, args.skip_crossover, args.skip_bins, args.skip_scene_gate)
    prev = json.loads(Path(args.from_path).read_text()) if any(skips) else {}

    if args.skip_experts:
        record["experts"] = prev.get("experts", {})
    else:
        experts = {}
        for name in EXPERTS:
            if expert_present(name):
                experts[name] = round(heldout_psnr(name, args.samples, args.crop, args.seed,
                                                   device=dev), 3)
                print(f"expert {name}: {experts[name]} dB held-out")
        record["experts"] = experts

    if args.skip_crossover:
        for k in ("blend_vs_rife_crossover_px", "pairs_measured", "blend_win_pairs",
                  "motion_range", "rows"):
            if k in prev:
                record[k] = prev[k]
    else:
        record.update(measure_crossover(args.clip, args.pairs, args.width, args.height,
                                        stride=args.stride, with_experts=not args.skip_bins,
                                        device=dev))
        print(f"blend-vs-rife crossover: {record['blend_vs_rife_crossover_px']} px "
              f"({record['blend_win_pairs']}/{record['pairs_measured']} blend wins)")

    if args.skip_bins:
        if "expert_bins" in prev:
            record["expert_bins"] = prev["expert_bins"]
    else:
        sweep_rows = record.get("rows") or prev.get("rows") or []
        sweep_bins = _bins_from_rows(sweep_rows, ("blend", "rife", "rife_fast", "vfimamba"))
        print(f"measuring native-regime expert rows ({args.native_clips}, "
              f"{args.native_pairs}/clip)...")
        native_rows = measure_native_rows(args.native_clips, args.native_pairs, 2, dev)
        native_bins = _bins_from_rows(native_rows, EXPERTS)
        record["expert_bins"] = {
            "units": {
                "sweep": "calc_motion px @480x270 (degraded-SR grays)",
                "native": "AdaptiveRouter full-res Farneback motion_mean px",
            },
            "sweep": sweep_bins,
            "native": native_bins,
        }
        record["native_rows"] = native_rows
        for regime, bins in (("sweep", sweep_bins), ("native", native_bins)):
            for b in bins:
                experts = {k: v for k, v in b.items() if k not in ("motion_lo", "motion_hi", "count")}
                print(f"  [{regime}] motion {b['motion_lo']:.3f}..{b['motion_hi']:.3f} "
                      f"(n={b['count']}): {experts}")

    if args.skip_scene_gate:
        if "scene_gate" in prev:
            record["scene_gate"] = prev["scene_gate"]
    else:
        print("calibrating scene-cut gate on labeled worlds...")
        record["scene_gate"] = measure_scene_gate(args.scene_worlds, args.scene_seconds,
                                                  device=dev)
        sg = record["scene_gate"]
        print(f"scene gate: warped_ssim_threshold {sg['warped_ssim_threshold']} (cuts "
              f"{sg['cut_pairs']}, non-cuts {sg['noncut_pairs']}, false holds "
              f"{sg['false_holds']}, missed {sg['missed_cuts']})")

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=2))
    print(f"wrote {out_path}")
    return record


if __name__ == "__main__":
    main()
