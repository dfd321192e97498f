"""Video in -> enhanced video out (port of ``process.py``):

    python -m vfisr_tpu_torch.process --input gameplay.y4m --output enhanced.y4m \\
        --method adaptive --target-fps 120 --target-resolution 1440p
    python -m vfisr_tpu_torch.process --input gameplay.y4m --output enhanced.y4m \\
        --vfi-model rife --sr-model span --target-fps 60

Streams through ``pipeline/streaming.py::process_video`` on the card
(``--device cpu`` runs on the CPU). Y4M (4:2:0) is read and written with
numpy alone; other containers need OpenCV.
"""

import argparse
import json
from pathlib import Path

RESOLUTIONS = {
    "1080p": (1920, 1080),
    "1440p": (2560, 1440),
    "4k": (3840, 2160),
    "2160p": (3840, 2160),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Process a video with VFI+SR")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--method", default=None, help="Registry model name (e.g. adaptive, rife)")
    parser.add_argument("--vfi-model", default=None, help="VFI model for two-stage mode")
    parser.add_argument("--sr-model", default=None, help="SR model for two-stage mode")
    parser.add_argument("--target-fps", type=float, default=120.0)
    parser.add_argument("--target-resolution", default="1440p",
                        help="1080p | 1440p | 4k | WxH")
    parser.add_argument("--max-frames", type=int, default=0, help="Cap input frames (0=all)")
    parser.add_argument("--stats-out", default=None,
                        help="Write the run's stage stats dict as JSON here")
    parser.add_argument("--readback", default="auto",
                        choices=["auto", "rgb", "yuv420"],
                        help="device->host frame format; yuv420 halves the "
                        "readback bytes (lossless end-to-end: the file "
                        "is 4:2:0 anyway). auto = yuv420 when dims allow")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the models run (default: the CUDA card)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.pipeline.streaming import process_video

    if args.target_resolution.lower() in RESOLUTIONS:
        target_res = RESOLUTIONS[args.target_resolution.lower()]
    else:
        w, h = map(int, args.target_resolution.lower().split("x"))
        target_res = (w, h)

    stats = process_video(
        input_path=args.input,
        output_path=args.output,
        method=args.method,
        vfi_model=args.vfi_model,
        sr_model=args.sr_model,
        target_fps=args.target_fps,
        target_resolution=target_res,
        max_frames=args.max_frames,
        readback=args.readback,
        device=args.device,
    )
    if args.stats_out:
        Path(args.stats_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.stats_out).write_text(json.dumps(stats, indent=2))
    print(
        f"Done: {stats['output_frames']} frames @ {stats['target_fps']}fps "
        f"{stats['target_resolution']} in {stats['elapsed_s']:.1f}s "
        f"({stats['realtime_x']:.2f}x realtime) -> {args.output}"
    )


if __name__ == "__main__":
    main()
