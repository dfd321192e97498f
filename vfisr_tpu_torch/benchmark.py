"""The triplet benchmark's CLI (port of ``benchmark.py``).

    python -m vfisr_tpu_torch.benchmark --data-dir data/processed --output-dir outputs/benchmarks
    python -m vfisr_tpu_torch.benchmark -d data/processed -o out -m lanczos,rife --max-triplets 5

Each clip directory holds ``metadata.json``, ``triplets.json``,
``input_1080p30/frames/`` and ``ground_truth/frames/`` (PNG). Writes
``<output-dir>/benchmark_results.json``. Runs on ``--device`` (``cuda`` by
default; ``cpu`` for small runs) with TF32 off.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run VFI+SR benchmarks")
    parser.add_argument("--data-dir", "-d", required=True,
                        help="Directory containing preprocessed clips")
    parser.add_argument("--output-dir", "-o", required=True, help="Output directory for results")
    parser.add_argument("--models", "-m", default="all",
                        help='Comma-separated model names or "all" (default: all)')
    parser.add_argument("--clips", "-c", default="all",
                        help='Comma-separated clip names or "all" (default: all)')
    parser.add_argument("--max-triplets", type=int, default=None,
                        help="Maximum triplets per clip (for quick testing)")
    parser.add_argument("--save-outputs", action="store_true",
                        help="Save model outputs (uses more disk space)")
    parser.add_argument("--warmup", type=int, default=3,
                        help="Warmup iterations before timing (kernel builds, cuDNN plans)")
    parser.add_argument("--merge", action="store_true",
                        help="Merge the selected models' rows into an existing "
                             "benchmark_results.json (targeted re-run) instead of replacing it")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.harness.triplet import run_benchmarks

    run_benchmarks(data_dir=args.data_dir, output_dir=args.output_dir, models=args.models,
                   clips=args.clips, max_triplets=args.max_triplets,
                   save_outputs=args.save_outputs, warmup=args.warmup, merge=args.merge,
                   device=args.device)


if __name__ == "__main__":
    main()
