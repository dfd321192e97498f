"""Extract keyframe/midpoint intervals from a registered clip (port of
``scripts/extract_intervals.py``):

    python -m vfisr_tpu_torch.extract_intervals --clip-id game1 --count 10 --duration 10

Decoding's I420 -> RGB (Y4M), the crop and Lanczos4 and the per-pair
Farneback run on ``--device`` (``cuda`` by default; ``cpu`` for small runs).
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Extract intervals from a registered clip")
    parser.add_argument("--clip-id", required=True)
    parser.add_argument("--count", type=int, default=10, help="Number of intervals")
    parser.add_argument("--duration", type=float, default=10.0, help="Interval length (s)")
    parser.add_argument("--start", type=float, default=None,
                        help="Explicit start (s) for a single interval")
    parser.add_argument("--auto-difficulty", action="store_true",
                        help="Spread intervals over linspace(0.1, 0.9) of the clip")
    parser.add_argument("--resolution", default="1920x1080")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.extract_intervals import IntervalExtractor

    w, h = map(int, args.resolution.split("x"))
    results = IntervalExtractor(args.data_dir, device=args.device).extract_intervals(
        clip_id=args.clip_id,
        count=args.count,
        duration=args.duration,
        start=args.start,
        auto_difficulty=args.auto_difficulty,
        output_resolution=(w, h),
    )
    print(f"\nExtracted {len(results)} interval(s):")
    for r in results:
        print(f"  {r['interval_id']}: {r['keyframe_count']} kf / {r['midpoint_count']} gt, "
              f"difficulty={r['difficulty']}")


if __name__ == "__main__":
    main()
