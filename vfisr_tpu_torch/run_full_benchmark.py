"""The full benchmark (port of ``scripts/run_full_benchmark.py``): the
experiment sweep over every registered clip and all its intervals,

    python -m vfisr_tpu_torch.run_full_benchmark --data-dir data --output-dir outputs

one ``python -m vfisr_tpu_torch.run_experiments`` subprocess per clip with
the same flags. Exits 1 if any of them failed.
"""

import argparse
import subprocess
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run the sweep over every registered clip")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--heavy", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.registry import ClipRegistry

    clips = ClipRegistry(args.data_dir).list_clips()
    if not clips:
        raise SystemExit("No clips registered.")
    failures = 0
    for clip in clips:
        n_intervals = clip.get("intervals_count", 0)
        if not n_intervals:
            print(f"[skip] {clip['clip_id']}: no intervals extracted")
            continue
        intervals = ",".join(str(i) for i in range(n_intervals))
        cmd = [
            sys.executable, "-m", "vfisr_tpu_torch.run_experiments",
            "--clip", clip["clip_id"], "--intervals", intervals,
            "--data-dir", args.data_dir, "--output-dir", args.output_dir,
            "--device", args.device,
        ]
        if args.heavy:
            cmd.append("--heavy")
        if args.resume:
            cmd.append("--resume")
        if args.max_frames:
            cmd += ["--max-frames", str(args.max_frames)]
        print(f"==> {clip['clip_id']} ({n_intervals} intervals)", flush=True)
        rc = subprocess.call(cmd)
        if rc != 0:
            failures += 1
            print(f"  run_experiments exited {rc}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
