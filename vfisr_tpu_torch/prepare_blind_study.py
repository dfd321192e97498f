"""Side-by-side blind-study videos (port of ``scripts/prepare_blind_study.py``).

    python -m vfisr_tpu_torch.prepare_blind_study [--benchmark-dir outputs/benchmark]
        [--reference control] [--output-dir outputs/blind_study] [--seed S]
        [--max-frames N] [--device cuda]

Pairs each method's video in the benchmark directory against the reference
method's, the method on the left or the right at random (``--seed``),
hstacks the frames with 'A' and 'B' burnt in (black at thickness 8, then
white at 3, as ``cv2.putText`` draws them: ``data/draw.py::put_label``) and
writes ``answer_key.json``. The directory's videos are ``.mp4`` or ``.y4m``
(``gui/benchmark_proper.py`` writes Y4M where mp4 cannot be written); the
pairs are written as ``pair_NN.mp4`` where an mp4 can be written, else
``pair_NN.y4m``. Frames are decoded to ``--device`` and resized there
(bilinear, to the smaller of the two sizes); a label is drawn on the host
on the frame's top-left corner, which holds both labels' rasters.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data.draw import put_label
from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter, writable_suffix

VIDEO_SUFFIXES = (".mp4", ".y4m")
LABEL_ORG = (30, 60)
LABEL_BOX = (64, 80)  # (rows, cols) from the top-left corner that hold the labels' rasters


def label(frame: torch.Tensor, text: str) -> torch.Tensor:
    """The label burnt into a uint8 [H, W, 3] frame's top-left corner, in
    place: that corner goes to the host and back."""
    rows, cols = LABEL_BOX
    corner = frame[:rows, :cols].cpu().numpy()
    put_label(corner, text, LABEL_ORG, 2, (0, 0, 0), 8)
    put_label(corner, text, LABEL_ORG, 2, (255, 255, 255), 3)
    frame[:rows, :cols] = torch.from_numpy(corner).to(frame.device)
    return frame


def hstack_pair(left_path, right_path, out_path, label_left="A", label_right="B",
                max_frames=None, device: str = "cuda") -> int:
    """Write the two videos side by side, labelled, until the shorter ends
    (or ``max_frames``); returns the frames written."""
    with VideoReader(str(left_path)) as lr, VideoReader(str(right_path)) as rr:
        fps = lr.fps
        l0, r0 = lr.read_to(device), rr.read_to(device)
        if l0 is None or r0 is None:
            raise RuntimeError("empty input video")
        h = min(l0.shape[0], r0.shape[0])
        w = min(l0.shape[1], r0.shape[1])
        n = 0
        with VideoWriter(str(out_path), 2 * w, h, fps) as writer:
            while l0 is not None and r0 is not None:
                lf = label(resize(l0, (h, w), "linear"), label_left)
                rf = label(resize(r0, (h, w), "linear"), label_right)
                writer.write(torch.cat([lf, rf], dim=1))
                n += 1
                if max_frames and n >= max_frames:
                    break
                l0, r0 = lr.read_to(device), rr.read_to(device)
    return n


def find_videos(bench: Path) -> dict:
    """stem -> path of the directory's videos (.mp4 or .y4m); a stem with
    both raises ValueError."""
    videos = {}
    for p in sorted(bench.iterdir()):
        if p.suffix in VIDEO_SUFFIXES:
            if p.stem in videos:
                raise ValueError(f"{bench}: both {videos[p.stem].name} and {p.name}")
            videos[p.stem] = p
    return videos


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.prepare_blind_study")
    parser.add_argument("--benchmark-dir", default="outputs/benchmark")
    parser.add_argument("--reference", default="control")
    parser.add_argument("--output-dir", default="outputs/blind_study")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device of the frames")
    args = parser.parse_args(argv)

    bench = Path(args.benchmark_dir)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = random.Random(args.seed)

    videos = find_videos(bench)
    ref_video = videos.pop(args.reference, None)
    if ref_video is None:
        raise SystemExit(f"reference video missing: {bench / args.reference}"
                         f"{{{','.join(VIDEO_SUFFIXES)}}}")
    suffix = writable_suffix()
    answer_key = {}
    for i, method in enumerate(sorted(videos)):
        method_left = rng.random() < 0.5
        left = videos[method] if method_left else ref_video
        right = ref_video if method_left else videos[method]
        pair_name = f"pair_{i:02d}{suffix}"
        n = hstack_pair(left, right, out / pair_name, max_frames=args.max_frames,
                        device=args.device)
        answer_key[pair_name] = {
            "A": method if method_left else args.reference,
            "B": args.reference if method_left else method,
            "frames": n,
        }
        print(f"  {pair_name}: {n} frames ({'A' if method_left else 'B'} = {method})")
    (out / "answer_key.json").write_text(json.dumps(answer_key, indent=2))
    print(f"Wrote {len(answer_key)} pair videos + answer_key.json to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
