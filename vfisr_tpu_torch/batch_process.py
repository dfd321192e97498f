"""Process a directory of videos (port of ``batch_process.py``):

    python -m vfisr_tpu_torch.batch_process --input-dir clips --output-dir out \\
        --method adaptive

Each output keeps its input's container (``<stem>_<method><suffix>``: a
Y4M in gives a Y4M out). Device work is serial on the one card;
``--workers`` > 1 runs the CPU models (bicubic, lanczos, optical_flow)
with ``--device cpu`` in a process pool, as the reference runs its CPU
models.
"""

import argparse
import json
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

VIDEO_EXTS = (".mp4", ".mkv", ".mov", ".avi", ".webm", ".y4m")
CPU_MODELS = {"bicubic", "lanczos", "optical_flow"}


def _process_one(args_tuple):
    video, out_path, method, target_fps, target_res, device = args_tuple
    from vfisr_tpu_torch.pipeline.streaming import process_video

    return process_video(
        input_path=str(video), output_path=str(out_path), method=method,
        target_fps=target_fps, target_resolution=target_res, device=device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="Batch video processing")
    parser.add_argument("--input-dir", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--method", default="adaptive")
    parser.add_argument("--target-fps", type=float, default=120.0)
    parser.add_argument("--target-resolution", default="2560x1440")
    parser.add_argument("--workers", type=int, default=1,
                        help="Process pool size (CPU models with --device cpu only)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the models run (default: the CUDA card)")
    args = parser.parse_args(argv)

    tw, th = map(int, args.target_resolution.split("x"))
    videos = sorted(
        p for p in Path(args.input_dir).iterdir() if p.suffix.lower() in VIDEO_EXTS
    )
    if not videos:
        raise SystemExit(f"No videos in {args.input_dir}")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    jobs = [
        (v, out_dir / f"{v.stem}_{args.method}{v.suffix}", args.method,
         args.target_fps, (tw, th), args.device)
        for v in videos
    ]
    t0 = time.time()
    results = []
    if args.workers > 1 and args.method in CPU_MODELS and args.device == "cpu":
        with ProcessPoolExecutor(max_workers=args.workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            results = list(pool.map(_process_one, jobs))
    else:
        for job in jobs:
            print(f"Processing {job[0].name}...")
            results.append(_process_one(job))
    summary = {"videos": len(results), "elapsed_s": time.time() - t0,
               "results": results}
    (out_dir / "batch_process_summary.json").write_text(
        json.dumps(summary, indent=2, default=str))
    print(f"{len(results)} videos in {summary['elapsed_s']:.1f}s -> {out_dir}")


if __name__ == "__main__":
    main()
