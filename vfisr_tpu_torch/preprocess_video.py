"""Preprocess a video into triplet benchmark data (port of
``scripts/preprocess_video.py``):

    python -m vfisr_tpu_torch.preprocess_video clip.y4m --clip-name game1 \\
        --output-dir data/processed

Input frames at --input-resolution/--input-fps, ground truth at
--target-resolution/--target-fps, and ``triplets.json``; prints the counts
and the seconds the processing took (host clock, after the imports). The
crop and Lanczos4 run on ``--device`` (``cuda`` by default; ``cpu`` for
small runs).
"""

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Create input/GT triplet data from a clip")
    parser.add_argument("video", help="Source video (height >= target, fps >= target)")
    parser.add_argument("--clip-name", default=None)
    parser.add_argument("--input-resolution", default="1920x1080")
    parser.add_argument("--input-fps", type=float, default=30.0)
    parser.add_argument("--target-resolution", default="2560x1440")
    parser.add_argument("--target-fps", type=float, default=120.0)
    parser.add_argument("--output-dir", default="data/processed")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="Cap input frames (0 = all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.preprocess_video import VideoPreprocessor

    iw, ih = map(int, args.input_resolution.split("x"))
    tw, th = map(int, args.target_resolution.split("x"))
    pre = VideoPreprocessor(
        input_resolution=(iw, ih),
        input_fps=args.input_fps,
        target_resolution=(tw, th),
        target_fps=args.target_fps,
        output_dir=args.output_dir,
        device=args.device,
    )
    start = time.perf_counter()
    result = pre.process(args.video, clip_name=args.clip_name, max_frames=args.max_frames)
    seconds = time.perf_counter() - start
    md = result["metadata"]
    print(f"Processed {md['clip_name']}: {md['num_input_frames']} input frames, "
          f"{md['num_gt_frames']} GT frames, {md['num_triplets']} triplets -> {result['dir']} "
          f"in {seconds:.3f} s")


if __name__ == "__main__":
    main()
