"""Register a source clip (port of ``scripts/register_clip.py``):

    python -m vfisr_tpu_torch.register_clip clip.y4m --clip-id game1 --data-dir data

The source must be at least 1080 px high and 60 fps. Without OpenCV only
Y4M is probed (``data/video_io.py``).
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Register a source gameplay clip")
    parser.add_argument("video", help="Path to the source video (>=1080p, >=60fps)")
    parser.add_argument("--clip-id", required=True, help="Unique clip identifier")
    parser.add_argument("--data-dir", default="data", help="Dataset root (default: data)")
    parser.add_argument("--force", action="store_true", help="Overwrite existing entry")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.registry import ClipRegistry

    entry = ClipRegistry(args.data_dir).register(args.video, args.clip_id, force=args.force)
    print(f"Registered {entry['clip_id']}: {entry['width']}x{entry['height']}@{entry['fps']}fps, "
          f"{entry['duration_s']:.1f}s ({entry['frame_count']} frames)")


if __name__ == "__main__":
    main()
