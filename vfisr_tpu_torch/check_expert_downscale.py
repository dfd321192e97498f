"""The PSNR cost of VFIMamba's internal-area cap (port of
``scripts/check_expert_downscale.py``):

    python -m vfisr_tpu_torch.check_expert_downscale
        [--clips data/raw/synth_calib.mp4,data/raw/synth_calib_routing.mp4]
        [--pairs 12] [--stride 4] [--motion-min 0.9] [--width 2560] [--height 1440]
        [--out outputs/train_r5/expert_downscale_check.json] [--device cuda]

The same pairs three ways, at the sweep's operating point (keyframes
area-resized to 960x540 and Lanczos4-upscaled to the output size, the true
midpoint Lanczos4-upscaled): VFIMamba with its 1920x1080 cap
(``MAX_INTERNAL_AREA``), VFIMamba native (cap off), and RIFE at rife_scale
0.5, the fast expert it displaces. Only pairs whose 480x270 Farneback
motion reaches ``--motion-min`` count (the region the router sends to
VFIMamba). On a CUDA device it also prints, and records, the native
trunk's peak memory (``torch.cuda.max_memory_allocated`` over its calls,
and the peak's excess over what was allocated before each call) beside the
card's name and power limit. A clip that does not exist is
skipped with a line saying so, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data.video_io import VideoReader


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or the torch
    name alone where nvidia-smi is not there."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        return out
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.check_expert_downscale",
                                 description="VFIMamba capped against native and RIFE")
    ap.add_argument("--clips", default="data/raw/synth_calib.mp4,data/raw/synth_calib_routing.mp4")
    ap.add_argument("--pairs", type=int, default=12, help="qualifying pairs per clip")
    ap.add_argument("--stride", type=int, default=4, help="score every Nth pair")
    ap.add_argument("--motion-min", type=float, default=0.9,
                    help="the sweep-regime motion floor, where the router sends VFIMamba")
    ap.add_argument("--width", type=int, default=2560)
    ap.add_argument("--height", type=int, default=1440)
    ap.add_argument("--out", default="outputs/train_r5/expert_downscale_check.json")
    ap.add_argument("--device", default="cuda", help="torch device of the frames and models")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple
    from vfisr_tpu_torch.gui.benchmark_proper import motion_gray
    from vfisr_tpu_torch.harness.experiments import INPUT_H, INPUT_W, _rife_interpolate
    from vfisr_tpu_torch.methods.inline import calc_motion
    from vfisr_tpu_torch.models.registry import get_model

    dev = args.device
    cuda = torch.device(dev).type == "cuda"
    mamba = get_model("vfimamba", load=True, device=dev)
    width, height = args.width, args.height
    native_peak = native_over = 0.0  # MB: the peak, and its excess over what was resident

    def degrade_sr(frame):
        return resize(resize(frame, (INPUT_H, INPUT_W), "area"), (height, width), "lanczos4")

    def mamba_mid(prev, curr, cap):
        nonlocal native_peak, native_over
        old = mamba.max_internal_area
        mamba.max_internal_area = cap
        if cuda and cap is None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
        try:
            return mamba.interpolate(prev, curr, num_frames=1, timestamps=[0.5])[0]
        finally:
            mamba.max_internal_area = old
            if cuda and cap is None:
                peak = torch.cuda.max_memory_allocated()
                native_peak = max(native_peak, peak / 1e6)
                native_over = max(native_over, (peak - resident) / 1e6)

    rows = []
    for clip in args.clips.split(","):
        if not Path(clip).is_file():
            print(f"  cannot open {clip} — skipped")
            continue
        with VideoReader(clip) as cap_v:
            prev = prev_gray = prev_gt = None
            pair_idx = taken = 0
            while taken < args.pairs:
                kf, gt = cap_v.read_to(dev), cap_v.read_to(dev)
                if kf is None or gt is None:
                    break
                out = degrade_sr(kf)
                gray = motion_gray(out)
                pair_idx += 1
                if prev is not None and pair_idx % args.stride == 0:
                    motion = float(calc_motion(prev_gray, gray, dev))
                    if motion >= args.motion_min:
                        gt_up = resize(prev_gt, (height, width), "lanczos4")
                        capped = mamba_mid(prev, out, 1920 * 1080)
                        native = mamba_mid(prev, out, None)
                        rife = _rife_interpolate(prev, out, 0.5, 0.5, dev)
                        rows.append({
                            "clip": clip,
                            "motion": round(motion, 4),
                            "psnr_capped": round(compute_psnr_simple(capped, gt_up, dev), 4),
                            "psnr_native": round(compute_psnr_simple(native, gt_up, dev), 4),
                            "psnr_rife": round(compute_psnr_simple(rife, gt_up, dev), 4),
                        })
                        taken += 1
                        print(f"  {clip} pair {pair_idx} motion {motion:.3f}: capped "
                              f"{rows[-1]['psnr_capped']} native {rows[-1]['psnr_native']} "
                              f"rife {rows[-1]['psnr_rife']}")
                prev, prev_gray, prev_gt = out, gray, gt

    if not rows:
        print("no qualifying pairs measured")
        return 1

    def mean(k):
        return float(np.mean([r[k] for r in rows]))

    result = {
        "created": datetime.now(timezone.utc).isoformat(),
        "clips": args.clips,
        "motion_min": args.motion_min,
        "pairs": len(rows),
        "mean_psnr_capped": round(mean("psnr_capped"), 4),
        "mean_psnr_native": round(mean("psnr_native"), 4),
        "mean_psnr_rife": round(mean("psnr_rife"), 4),
        "capped_minus_native_db": round(mean("psnr_capped") - mean("psnr_native"), 4),
        "capped_minus_rife_db": round(mean("psnr_capped") - mean("psnr_rife"), 4),
        "rows": rows,
    }
    if cuda:
        card = card_line()
        result["native_peak_mb"] = round(native_peak, 1)
        result["native_over_resident_mb"] = round(native_over, 1)
        result["card"] = card
        print(f"native trunk at {width}x{height}: peak {native_peak:.1f} MB "
              f"(torch.cuda.max_memory_allocated), {native_over:.1f} MB over what was resident "
              f"before the call, on {card}")
    else:
        print(f"native trunk at {width}x{height}: peak memory not measured (device {dev})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=2))
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}, indent=2))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
