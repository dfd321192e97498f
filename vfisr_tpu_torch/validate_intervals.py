"""Hold cached interval keyframes against a fresh extraction (port of
``scripts/validate_intervals.py``):

    python -m vfisr_tpu_torch.validate_intervals --clip game1 --interval 0,1 --sample 5

Each sampled keyframe's source frame is decoded again and goes through the
extraction's own device path (I420 -> RGB, 16:9 crop, Lanczos4 on
``--device``, ``cuda`` by default); any pixel that differs from the cached
PNG is a mismatch, and the exit code is then 1. ``--interval`` takes one
index or a comma-separated list.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Validate cached intervals against re-extraction")
    parser.add_argument("--clip", required=True)
    parser.add_argument("--interval", default="0",
                        help="Interval index, or comma-separated indices (default: 0)")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--sample", type=int, default=5,
                        help="Number of keyframes to re-extract and compare")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.extract_intervals import fit_frame, load_interval
    from vfisr_tpu_torch.data.registry import ClipRegistry
    from vfisr_tpu_torch.data.video_io import VideoReader

    clip = ClipRegistry(args.data_dir).get_clip(args.clip)
    if clip is None:
        raise SystemExit(f"clip {args.clip!r} not registered")
    source = clip.get("source_path") or clip.get("source")
    mismatches = 0
    for interval in (int(i) for i in args.interval.split(",")):
        keyframes, _, meta = load_interval(args.clip, interval, args.data_dir)
        w, h = map(int, meta["resolution"].split("x"))
        print(f"{meta['interval_id']}:")
        step = max(len(keyframes) // args.sample, 1)
        for kf_idx in range(0, len(keyframes), step):
            frame_idx = meta["start_frame"] + 2 * kf_idx  # even frames are keyframes
            with VideoReader(source, frame_idx) as reader:
                frame = reader.read_to(args.device)
            if frame is None:
                print(f"  kf_{kf_idx:04d}: source read failed at frame {frame_idx}")
                mismatches += 1
                continue
            fresh = fit_frame(frame, (w, h)).cpu().numpy()
            diff = np.abs(fresh.astype(int) - keyframes[kf_idx].astype(int))
            if diff.max() > 0:
                mismatches += 1
                status = f"MISMATCH max={diff.max()} mean={diff.mean():.3f}"
            else:
                status = "OK"
            print(f"  kf_{kf_idx:04d}: {status}")
    print(f"\n{'VALID' if mismatches == 0 else f'{mismatches} mismatch(es)'}")
    sys.exit(1 if mismatches else 0)


if __name__ == "__main__":
    main()
