"""Blind-study clip generator (port of ``gui/generate_clips.py``).

    python -m vfisr_tpu_torch.gui.generate_clips --clip CLIP [--preset all]
        [--interval 0] [--data-dir data] [--output-dir outputs/benchmark]
        [--fps 120] [--aspect scale|crop|letterbox] [--workers 1]
        [--max-frames N] [--device cuda]

The presets of the reference's generate_* scripts: ``all`` (every method,
2560x1440), ``fast`` (1920x1080), ``scientific`` (540p to 3840x2160) and
``sota`` (RIFE only). Each method's video is written from the interval's
keyframes as ``benchmark_proper`` writes it (area to the preset's
degradation size, then Lanczos4 or cubic up; control through ``_aspect_fit``
of the source), every resize, blend, gray conversion, motion and RIFE on
``--device``. With ``--workers > 1`` the CPU-class methods (``CPU_METHODS``)
run in a pool of that many processes started with ``spawn``, each on
``--device``; the others run in this process after them. Videos are
``{method}.mp4`` where ffmpeg or cv2 can write mp4, else ``{method}.y4m``.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from vfisr_tpu_torch.data import video_io
from vfisr_tpu_torch.gui.benchmark_proper import (MOTION_THRESHOLD, linear_mid, model_mid,
                                                   motion_gray, resize_u8)
from vfisr_tpu_torch.methods.inline import calc_motion
from vfisr_tpu_torch.models.registry import get_model

PRESETS = {
    "all": {
        "methods": ["control", "degraded", "lanczos", "bicubic", "rife_lanczos",
                    "rife_bicubic", "adaptive_vfi"],
        "resolution": (2560, 1440),
    },
    "fast": {
        "methods": ["control", "lanczos", "rife_lanczos"],
        "resolution": (1920, 1080),
    },
    "scientific": {
        "methods": ["control", "degraded", "lanczos", "rife_lanczos", "adaptive_vfi"],
        "resolution": (3840, 2160),
        "degrade": (960, 540),
    },
    "sota": {
        "methods": ["rife_lanczos"],
        "resolution": (2560, 1440),
    },
}

CPU_METHODS = {"control", "degraded", "lanczos", "bicubic", "lanczos_edge"}


def _aspect_fit(frame: torch.Tensor, out_w: int, out_h: int, mode: str) -> torch.Tensor:
    """scale / crop / letterbox of a uint8 [H, W, 3] tensor to out_w x out_h
    (Lanczos4), on its device."""
    h, w = frame.shape[:2]
    if mode == "scale":
        return resize_u8(frame, (out_w, out_h), "lanczos4")
    src_ar, dst_ar = w / h, out_w / out_h
    if mode == "crop":
        if src_ar > dst_ar:
            nw = int(h * dst_ar)
            frame = frame[:, (w - nw) // 2:(w + nw) // 2]
        else:
            nh = int(w / dst_ar)
            frame = frame[(h - nh) // 2:(h + nh) // 2]
        return resize_u8(frame, (out_w, out_h), "lanczos4")
    scale = min(out_w / w, out_h / h)
    nw, nh = int(w * scale), int(h * scale)
    canvas = torch.zeros((out_h, out_w, 3), dtype=frame.dtype, device=frame.device)
    y0, x0 = (out_h - nh) // 2, (out_w - nw) // 2
    canvas[y0:y0 + nh, x0:x0 + nw] = resize_u8(frame, (nw, nh), "lanczos4")
    return canvas


def generate_method(method, keyframes, out_path, out_w, out_h, fps, degrade=(960, 540),
                    aspect="scale", device: str = "cuda") -> None:
    """Write one method's video of the keyframes (uint8 HWC RGB numpy)."""
    rife = None
    if "rife" in method or method == "adaptive_vfi":
        rife = get_model("rife", load=True, device=device)
    sr_interp = "cubic" if "bicubic" in method else "lanczos4"
    prev = None
    with video_io.VideoWriter(str(out_path), out_w, out_h, fps) as writer:
        for frame in keyframes:
            src = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
            if method == "control":
                out = _aspect_fit(src, out_w, out_h, aspect)
            else:
                out = resize_u8(resize_u8(src, degrade, "area"), (out_w, out_h), sr_interp)
            if prev is not None:
                use_rife = "rife" in method
                if method == "adaptive_vfi":
                    use_rife = (calc_motion(motion_gray(prev), motion_gray(out), device)
                                > MOTION_THRESHOLD)
                for i in range(1, 4):
                    if method in ("control", "degraded"):
                        mid = prev
                    elif use_rife:
                        mid = model_mid(rife, prev, out, i / 4)
                    else:
                        mid = linear_mid(prev, out, i / 4)
                    writer.write(mid)
            writer.write(out)
            prev = out


def _run_one(job):
    method, clip, interval, data_dir, out_path, res, fps, degrade, aspect, max_frames, device = job
    from vfisr_tpu_torch.data.extract_intervals import load_interval

    keyframes, _, _ = load_interval(clip, interval, data_dir, max_frames=max_frames)
    t0 = time.time()
    generate_method(method, keyframes, out_path, res[0], res[1], fps, degrade, aspect, device)
    return method, time.time() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.gui.generate_clips")
    parser.add_argument("--preset", default="all", choices=sorted(PRESETS))
    parser.add_argument("--clip", required=True)
    parser.add_argument("--interval", type=int, default=0)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--output-dir", default="outputs/benchmark")
    parser.add_argument("--fps", type=float, default=120.0)
    parser.add_argument("--aspect", default="scale", choices=["scale", "crop", "letterbox"])
    parser.add_argument("--workers", type=int, default=1,
                        help="processes for the CPU-class methods (spawned, each on --device)")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device of the frames and RIFE")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    preset = PRESETS[args.preset]
    res = preset["resolution"]
    degrade = preset.get("degrade", (960, 540))
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = video_io.writable_suffix()

    jobs = [(m, args.clip, args.interval, args.data_dir, out_dir / f"{m}{suffix}", res, args.fps,
             degrade, args.aspect, args.max_frames, args.device)
            for m in preset["methods"]]
    cpu_jobs = [j for j in jobs if j[0] in CPU_METHODS]
    gpu_jobs = [j for j in jobs if j[0] not in CPU_METHODS]
    results = []
    if args.workers > 1 and len(cpu_jobs) > 1:
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=mp.get_context("spawn")) as pool:
            results += list(pool.map(_run_one, cpu_jobs))
    else:
        results += [_run_one(j) for j in cpu_jobs]
    results += [_run_one(j) for j in gpu_jobs]  # the model methods, in this process
    for method, dt in results:
        print(f"  {method}: {dt:.1f}s")
    print(f"Wrote {len(results)} videos to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
