"""Preprocess a directory of videos (port of ``scripts/batch_preprocess.py``):

    python -m vfisr_tpu_torch.batch_preprocess clips/ --output-dir data/processed

Takes .y4m besides the reference's containers: Y4M is the one container
read without OpenCV. A video that fails is listed in
``<output-dir>/batch_summary.json`` and the others go on.
"""

import argparse
import json
import time
from pathlib import Path

VIDEO_EXTS = (".mp4", ".mkv", ".mov", ".avi", ".webm", ".y4m")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batch-preprocess a directory of videos")
    parser.add_argument("input_dir", help="Directory of source videos")
    parser.add_argument("--output-dir", default="data/processed")
    parser.add_argument("--input-resolution", default="1920x1080")
    parser.add_argument("--input-fps", type=float, default=30.0)
    parser.add_argument("--target-resolution", default="2560x1440")
    parser.add_argument("--target-fps", type=float, default=120.0)
    parser.add_argument("--max-frames", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.preprocess_video import VideoPreprocessor

    iw, ih = map(int, args.input_resolution.split("x"))
    tw, th = map(int, args.target_resolution.split("x"))
    pre = VideoPreprocessor(
        input_resolution=(iw, ih), input_fps=args.input_fps,
        target_resolution=(tw, th), target_fps=args.target_fps,
        output_dir=args.output_dir, device=args.device,
    )
    videos = sorted(
        p for p in Path(args.input_dir).iterdir() if p.suffix.lower() in VIDEO_EXTS
    )
    if not videos:
        raise SystemExit(f"No videos in {args.input_dir}")
    summary = {"processed": [], "failed": [], "started": time.strftime("%F %T")}
    for video in videos:
        print(f"Processing {video.name}...")
        try:
            result = pre.process(str(video), max_frames=args.max_frames)
            summary["processed"].append(result["metadata"])
            print(f"  {result['triplets']} triplets -> {result['dir']}")
        except Exception as e:  # one bad video must not stop the batch: it is listed
            summary["failed"].append({"video": str(video), "error": str(e)})
            print(f"  FAILED: {e}")
    out = Path(args.output_dir) / "batch_summary.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(summary, indent=2, default=str))
    print(f"\n{len(summary['processed'])} processed, {len(summary['failed'])} failed "
          f"-> {out}")


if __name__ == "__main__":
    main()
