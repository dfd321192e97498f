"""Blend against RIFE under LPIPS on two content families (port of
``scripts/lpips_ordering_study.py``):

    python -m vfisr_tpu_torch.lpips_ordering_study [--pairs 40] [--stride 5]
        [--hard-clip data/raw/synth_calib.mp4] [--smooth-clip data/raw/synth_001.mp4]
        [--out outputs/lpips_ordering.json] [--device cuda]

Per family, at the sweep's operating point (a keyframe area-resized to
960x540, then Lanczos4 to 2560x1440; the midpoint between two such
keyframes by the linear blend and by RIFE at rife_scale 0.5, scored against
the true midpoint Lanczos4-upscaled): LPIPS and PSNR of both, and the
480x270 Farneback motion of the pair. The families: a texture-dense hard
clip, a smooth clip, and the hard clip under ``capture_degrade`` (a
horizontal 9-px box smear and a JPEG round trip at quality 28, the
capture conditions the reference's footage had). Every frame op, RIFE,
LPIPS and the JPEG transforms run on ``--device``; the clips are read with
``data/video_io.py`` (Y4M, or another container through cv2 where it is
installed). Writes the record JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import torch

from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import jpeg
from vfisr_tpu_torch.data.video_io import VideoReader
from vfisr_tpu_torch.ops.conv import filter2d


def capture_degrade(frame, blur_len: int = 9, jpeg_q: int = 28, device="cuda") -> torch.Tensor:
    """The capture pipeline's smear and recompression: cv2.filter2D of a
    horizontal 1 x blur_len box (BORDER_REFLECT_101, rounded to uint8), then
    a JPEG round trip at jpeg_q (``data/jpeg.py``). uint8 [H, W, 3] in, out
    on ``device``."""
    x = to_device(frame, device).float()[None]
    k = np.full((1, blur_len), 1.0 / blur_len, np.float32)
    blurred = torch.clamp(torch.round(filter2d(x, k)[0]), 0, 255).to(torch.uint8)
    return jpeg.decode(jpeg.encode(blurred, jpeg_q, device), device)


def study_family(clip: str, pairs: int, lp, rife_scale: float = 0.5,
                 width: int = 2560, height: int = 1440,
                 stride: int = 1, degrade_fn=None, device="cuda") -> dict:
    """The sweep's operating point on pairs of a clip's frames: keyframes
    are the even frames, the ground truth of a pair (k_{i-1}, k_i) the odd
    frame between them; every stride-th pair is scored."""
    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple
    from vfisr_tpu_torch.gui.benchmark_proper import motion_gray
    from vfisr_tpu_torch.harness.experiments import INPUT_H, INPUT_W, _rife_interpolate
    from vfisr_tpu_torch.methods.inline import calc_motion, linear_blend

    if not Path(clip).is_file():
        raise SystemExit(f"cannot open {clip}")
    rows = []
    with VideoReader(clip) as cap:
        def read_rgb():
            f = cap.read_to(device)
            if f is None:
                return None
            return degrade_fn(f) if degrade_fn is not None else f

        prev = prev_gt = None
        pair_idx = 0
        while len(rows) < pairs:
            kf, gt = read_rgb(), read_rgb()
            if kf is None or gt is None:
                break
            out = resize(resize(kf, (INPUT_H, INPUT_W), "area"), (height, width), "lanczos4")
            pair_idx += 1
            if prev is not None and pair_idx % stride == 0:
                gt_up = resize(prev_gt, (height, width), "lanczos4")
                blend = linear_blend(prev, out, 0.5, device)
                rife = _rife_interpolate(prev, out, 0.5, rife_scale, device)
                motion = calc_motion(motion_gray(prev), motion_gray(out), device)
                rows.append({
                    "motion": round(float(motion), 4),
                    "lpips_blend": round(float(lp(blend, gt_up)[0]), 4),
                    "lpips_rife": round(float(lp(rife, gt_up)[0]), 4),
                    "psnr_blend": round(compute_psnr_simple(blend, gt_up, device), 3),
                    "psnr_rife": round(compute_psnr_simple(rife, gt_up, device), 3),
                })
            prev, prev_gt = out, gt
    if not rows:
        raise SystemExit(f"no pairs from {clip}")

    def mean(k):
        return round(float(np.mean([r[k] for r in rows])), 4)

    return {
        "clip": clip,
        "pairs": len(rows),
        "lpips_blend_mean": mean("lpips_blend"),
        "lpips_rife_mean": mean("lpips_rife"),
        "psnr_blend_mean": mean("psnr_blend"),
        "psnr_rife_mean": mean("psnr_rife"),
        "lpips_blend_wins": sum(1 for r in rows if r["lpips_blend"] < r["lpips_rife"]),
        "rows": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.lpips_ordering_study",
                                 description="Blend against RIFE under LPIPS, per family")
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--stride", type=int, default=5,
                    help="score every Nth consecutive pair, so the whole speed profile is sampled")
    ap.add_argument("--hard-clip", default="data/raw/synth_calib.mp4")
    ap.add_argument("--smooth-clip", default="data/raw/synth_001.mp4")
    ap.add_argument("--out", default="outputs/lpips_ordering.json")
    ap.add_argument("--device", default="cuda", help="torch device of the frames and models")
    args = ap.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from vfisr_tpu_torch.evaluation.lpips import default_lpips

    lp = default_lpips(args.device)
    dev = args.device
    record = {
        "measured_at": datetime.now(timezone.utc).isoformat(),
        "lpips_mode": lp.mode,
        "reference_ordering": {
            "note": "reference analysis_report.md:60-67 (captured footage): "
                    "bicubic_blend_edge 0.0943 < degraded 0.1005 < "
                    "rife_default 0.1226 — LPIPS prefers blends",
        },
        "families": {
            "texture_dense_hard": study_family(args.hard_clip, args.pairs, lp,
                                               stride=args.stride, device=dev),
            "smooth": study_family(args.smooth_clip, args.pairs, lp, stride=args.stride,
                                   device=dev),
            # the hard world under the capture conditions
            "hard_capture_degraded": study_family(
                args.hard_clip, args.pairs, lp, stride=args.stride,
                degrade_fn=lambda f: capture_degrade(f, device=dev), device=dev),
        },
    }
    for name, fam in record["families"].items():
        print(f"{name}: blend LPIPS {fam['lpips_blend_mean']} vs rife "
              f"{fam['lpips_rife_mean']} (blend wins {fam['lpips_blend_wins']}/{fam['pairs']})")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
