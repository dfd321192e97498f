"""List registered clips and their cached intervals (port of
``scripts/list_intervals.py``):

    python -m vfisr_tpu_torch.list_intervals --data-dir data [--clip game1]
"""

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="List clips and cached intervals")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--clip", default=None, help="Limit to one clip id")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.registry import ClipRegistry

    reg = ClipRegistry(args.data_dir)
    clips = reg.list_clips()
    if args.clip:
        clips = [c for c in clips if c["clip_id"] == args.clip]
    if not clips:
        print("No clips registered.")
        return
    for clip in clips:
        print(f"{clip['clip_id']}: {clip['width']}x{clip['height']}@{clip['fps']}fps, "
              f"{clip['duration_s']:.1f}s")
        intervals_dir = reg.clips_dir / clip["clip_id"] / "intervals"
        if not intervals_dir.exists():
            continue
        for idir in sorted(intervals_dir.glob("interval_*")):
            meta_path = idir / "meta.json"
            if not meta_path.exists():
                print(f"  {idir.name}: (no meta)")
                continue
            meta = json.loads(meta_path.read_text())
            ms = meta.get("motion_stats", {})
            print(f"  {meta['interval_id']}: {meta['start_s']:.1f}-{meta['end_s']:.1f}s, "
                  f"{meta['keyframe_count']} kf / {meta['midpoint_count']} gt, "
                  f"{meta['difficulty']} (mean flow {ms.get('mean_flow', 0):.2f}px)")


if __name__ == "__main__":
    main()
