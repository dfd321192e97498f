"""Video-producing benchmark for the blind study (port of
``gui/benchmark_proper.py``).

    python -m vfisr_tpu_torch.gui.benchmark_proper --clip CLIP [--interval 0]
        [--data-dir data] [--output-dir outputs/benchmark] [--methods ...]
        [--resolution 2560x1440] [--fps 120] [--max-frames N]
        [--source-video RAW] [--device cuda]

One video per method from a registered clip's keyframes (``load_interval``),
in the reference's order control, degraded, lanczos, rife_lanczos,
adaptive_vfi: each keyframe area-resized to 960x540 and upscaled to the
output size (Lanczos4, cubic for degraded/bicubic/rife_bicubic; control
upscales the source with Lanczos4), three frames between each pair (the
previous frame for control and degraded, RIFE for rife_*, the flow model
for optical_flow, RIFE where the 480x270 gray motion exceeds 3 px else the
linear blend for adaptive_vfi, the blend otherwise). Every resize, the gray
conversions, the motion, the blends, the edge enhancement and the models
run on ``--device`` as torch ops on uint8 frames; the frames go to the
writer as device tensors (a Y4M writer makes their I420 planes there).
PSNR and SSIM of each keyframe against the Lanczos4-upscaled source come
from ``evaluation/metrics.py``. ``clips_metadata.json`` records each
method's video, its metrics, bitrate and time.

Videos are ``{method}.mp4`` where ffmpeg or cv2 can write mp4, else
``{method}.y4m`` (``video_io.writable_suffix``); the metadata names the
file written. With ``--source-video`` and ffmpeg, the source's audio is
muxed into each video (skipped, ``audio: false``, without ffmpeg).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_gray
from vfisr_tpu_torch.core.frames import to_batched, to_uint8
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import video_io
from vfisr_tpu_torch.evaluation.metrics import calc_psnr, calc_ssim
from vfisr_tpu_torch.methods.inline import blend, calc_motion, edge_enhance_f, round_u8
from vfisr_tpu_torch.models.registry import get_model

METHODS = ["control", "degraded", "lanczos", "rife_lanczos", "adaptive_vfi"]
DURATION = 10.0  # seconds per study clip
DEGRADE = (960, 540)  # (w, h) the keyframes are area-resized to
CUBIC_METHODS = ("degraded", "bicubic", "rife_bicubic")
MOTION_HW = (270, 480)  # adaptive_vfi's gray motion resolution
MOTION_THRESHOLD = 3.0  # px of mean Farneback motion above which adaptive_vfi runs RIFE


def extract_clip(full_video, raw_video, start_time, duration, output) -> bool:
    """Cut a segment out of a generated full video (``video_io.extract_clip``:
    a Y4M source by copying its frames; audio from raw_video with ffmpeg)."""
    return video_io.extract_clip(str(full_video), str(raw_video) if raw_video else None,
                                 float(start_time), float(duration), str(output))


def get_full_video_duration(video_path) -> float:
    return video_io.get_video_duration(str(video_path))


def resize_u8(frame: torch.Tensor, size_wh, method: str) -> torch.Tensor:
    """``cv2.resize(frame, size_wh, interpolation=method)`` of a uint8
    [H, W, C] tensor, on its device."""
    w, h = size_wh
    return resize(frame, (h, w), method)


def motion_gray(frame: torch.Tensor) -> torch.Tensor:
    """cv2.resize(cvtColor(frame, RGB2GRAY), (480, 270)): uint8 [270, 480]."""
    return resize(rgb_to_gray(frame)[..., None], MOTION_HW, "linear")[..., 0]


def model_mid(model, prev: torch.Tensor, curr: torch.Tensor, t: float) -> torch.Tensor:
    """``model.interpolate(prev, curr, 1, [t])[0]`` on uint8 device frames,
    kept on the device."""
    dev = prev.device
    return to_uint8(model.interpolate_batch(to_batched(prev, dev), to_batched(curr, dev), (t,))[0, 0])


def linear_mid(prev: torch.Tensor, curr: torch.Tensor, t: float) -> torch.Tensor:
    """``linear_blend(prev, curr, t)`` on uint8 device frames."""
    return round_u8(blend(prev.float(), curr.float(), t))


def run_method(method: str, keyframes, out_path: str, out_w: int, out_h: int, fps: float,
               device: str = "cuda") -> dict:
    """Write one method's video of the keyframes (uint8 HWC RGB) to
    out_path; its keyframes' mean PSNR and SSIM, bitrate and path."""
    rife = flow_vfi = None
    if method in ("rife_lanczos", "rife_bicubic", "adaptive_vfi"):
        rife = get_model("rife", load=True, device=device)
    elif method == "optical_flow":
        flow_vfi = get_model("optical_flow", load=True, device=device)
    sr_interp = "cubic" if method in CUBIC_METHODS else "lanczos4"

    psnrs, ssims = [], []
    prev = None
    n = len(keyframes)
    with video_io.VideoWriter(out_path, out_w, out_h, fps) as writer:
        for idx, frame in enumerate(keyframes):
            src = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
            if method == "control":
                out = resize_u8(src, (out_w, out_h), "lanczos4")
            else:
                out = resize_u8(resize_u8(src, DEGRADE, "area"), (out_w, out_h), sr_interp)
                if method == "lanczos_edge":
                    out = round_u8(edge_enhance_f(out.float()[None], 1.3))[0]

            if prev is not None:
                use_rife = False
                if method == "adaptive_vfi":  # once per pair: the reference's three calls agree
                    use_rife = (calc_motion(motion_gray(prev), motion_gray(out), device)
                                > MOTION_THRESHOLD)
                for i in range(1, 4):
                    if method in ("control", "degraded"):
                        mid = prev
                    elif method in ("rife_lanczos", "rife_bicubic") or use_rife:
                        mid = model_mid(rife, prev, out, i / 4)
                    elif method == "optical_flow":
                        mid = model_mid(flow_vfi, prev, out, i / 4)
                    else:  # lanczos, bicubic, lanczos_edge, adaptive_vfi below the threshold
                        mid = linear_mid(prev, out, i / 4)
                    writer.write(mid)
            writer.write(out)
            # keyframe quality against the Lanczos4-upscaled source
            ref = resize_u8(src, (out_w, out_h), "lanczos4")
            psnrs.append(calc_psnr(out, ref, device))
            ssims.append(calc_ssim(rgb_to_gray(out), rgb_to_gray(ref), device))
            prev = out
            if idx % 10 == 0:
                print(f"  [{method}] {int(100 * (idx + 1) / n)}%", flush=True)

    finite = [p for p in psnrs if np.isfinite(p)]
    return {
        "psnr": float(np.mean(finite)) if finite else None,
        "ssim": float(np.mean(ssims)) if ssims else None,
        "bitrate_kbps": round(Path(out_path).stat().st_size * 8 / 1000
                              / max(len(keyframes) * 4 / fps, 1e-9), 1),
        "output_path": str(out_path),
    }


def make_parser(methods=METHODS, prog="benchmark_proper") -> argparse.ArgumentParser:
    """The flags benchmark_proper and benchmark_all share."""
    parser = argparse.ArgumentParser(prog=f"python -m vfisr_tpu_torch.gui.{prog}")
    parser.add_argument("--clip", required=True, help="Registered clip id")
    parser.add_argument("--interval", type=int, default=0)
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--output-dir", default="outputs/benchmark")
    parser.add_argument("--methods", default=",".join(methods))
    parser.add_argument("--resolution", default="2560x1440")
    parser.add_argument("--fps", type=float, default=120.0)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device of the frames and models")
    return parser


def open_metadata(args):
    """(keyframes, out_dir, meta_path, metadata, clip_entry) of a run."""
    from vfisr_tpu_torch.data.extract_intervals import load_interval

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    keyframes, _, _ = load_interval(args.clip, args.interval, args.data_dir,
                                    max_frames=args.max_frames)
    meta_path = out_dir / "clips_metadata.json"
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {"clips": {}}
    clip_entry = metadata["clips"].setdefault(
        args.clip, {"videos": {}, "metrics": {}, "interval": args.interval})
    return keyframes, out_dir, meta_path, metadata, clip_entry


def main(argv=None) -> int:
    parser = make_parser()
    parser.add_argument(
        "--source-video", default=None,
        help="raw source video; when set and ffmpeg exists, its audio track is muxed into "
        "each method video")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    out_w, out_h = map(int, args.resolution.split("x"))
    keyframes, out_dir, meta_path, metadata, clip_entry = open_metadata(args)
    print(f"Benchmarking {args.clip} interval {args.interval}: {len(keyframes)} keyframes")
    suffix = video_io.writable_suffix()

    for method in args.methods.split(","):
        method = method.strip()
        t0 = time.time()
        out_path = out_dir / f"{method}{suffix}"
        stats = run_method(method, keyframes, str(out_path), out_w, out_h, args.fps, args.device)
        stats["time_s"] = round(time.time() - t0, 1)
        if args.source_video:
            aac = str(out_path) + ".audio.aac"
            muxed = str(out_dir / f"{method}_audio{suffix}")
            if (video_io.extract_audio(args.source_video, aac)
                    and video_io.mux_audio(str(out_path), aac, muxed)):
                Path(aac).unlink(missing_ok=True)
                Path(muxed).replace(out_path)
                stats["audio"] = True
            else:  # no ffmpeg, or a silent source
                Path(aac).unlink(missing_ok=True)
                stats["audio"] = False
        clip_entry["videos"][method] = str(out_path)
        clip_entry["metrics"][method] = stats
        meta_path.write_text(json.dumps(metadata, indent=2))
        print(f"  [{method}] psnr={stats['psnr']} time={stats['time_s']}s 100%")
    print(f"Wrote {meta_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
