"""Render a synthetic gaming-like clip (port of ``scripts/make_synthetic_clip.py``):

    python -m vfisr_tpu_torch.make_synthetic_clip data/raw/synth_calib.y4m \\
        --preset hard --seconds 12 --seed 417

Presets (``data/synthetic_clip.py``): ``smooth`` (the default, seed 7),
``hard`` and ``routing`` (seed 11 unless another is given). The clip is
written as Y4M (4:2:0) for a ``.y4m`` path; another extension needs OpenCV
(cv2), which the card's machine does not have, and the writer says so by
name. Textures and composites run on ``--device`` (``cuda`` by default;
``cpu`` for small runs). Prints the host seconds of the textures and the ms
per frame of the composites (on the device, read back, shapes drawn on the
host) and of the writes.
"""

import argparse


def main(argv=None) -> dict:
    """Run the CLI; returns the frame count and the host seconds of the
    textures, the composites and the writes."""
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.make_synthetic_clip",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("out", help="output video path (e.g. data/raw/synth_calib.y4m)")
    parser.add_argument("--seconds", type=float, default=12.0)
    parser.add_argument("--fps", type=int, default=60)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument(
        "--preset", default="smooth", choices=["smooth", "hard", "routing"],
        help="'smooth': blurred-noise worlds; 'hard': high-frequency worlds, occluding "
        "textured sprites, two cuts, ~13 px mean pair flow; 'routing': the same worlds in "
        "interleaved speed strata with frozen-world static blocks")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.data.synthetic_clip import render_clip, render_hard_clip

    stats = {"textures": 0.0, "composite": 0.0, "write": 0.0}
    if args.preset == "smooth":
        n = render_clip(args.out, args.seconds, args.fps, args.width, args.height, args.seed,
                        device=args.device, stats=stats)
    else:
        seed = 11 if args.seed == 7 else args.seed  # the hard presets' own default world
        n = render_hard_clip(args.out, args.seconds, args.fps, args.width, args.height, seed,
                             profile="routing" if args.preset == "routing" else "v1",
                             device=args.device, stats=stats)
    per = {k: stats[k] * 1e3 / max(n, 1) for k in ("composite", "write")}
    print(f"Wrote {n} frames to {args.out} (host clock: textures {stats['textures']:.3f} s, "
          f"composite {per['composite']:.3f} ms/frame, write {per['write']:.3f} ms/frame)")
    return {"frames": n, **stats}


if __name__ == "__main__":
    main()
