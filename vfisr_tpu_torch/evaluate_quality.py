"""Evaluate predicted frames against ground truth (port of
``scripts/evaluate_quality.py``):

    python -m vfisr_tpu_torch.evaluate_quality --pred-dir pred/ --gt-dir gt/ \\
        [--comprehensive] [--output q.json]

Frames are the directories' PNGs in name order (``data/png.py``) or,
where a directory has none, its ``*.jpg`` in name order, decoded by
``data/jpeg.py`` to ``cv2.imread``'s pixels, as the reference reads them.
A JPEG layout the decoder lacks (progressive, arithmetic coded, ...)
raises ``jpeg.UnsupportedJPEG``. The JPEG block transforms and the
metrics run on ``--device`` (``cuda`` by default; ``cpu`` for small runs);
only the Huffman decoding stays on the host.
"""

import argparse
import json
from pathlib import Path


def load_dir(d, device="cpu") -> list:
    """The directory's PNG frames, or failing those its JPEG frames
    (``*.jpg``, their block transforms on ``device``), as HWC uint8 RGB
    numpy arrays in name order."""
    from vfisr_tpu_torch.data import jpeg
    from vfisr_tpu_torch.data.png import read_png

    paths = sorted(Path(d).glob("*.png"))
    if paths:
        return [read_png(p) for p in paths]
    return [jpeg.decode(p.read_bytes(), device=device).cpu().numpy()
            for p in sorted(Path(d).glob("*.jpg"))]


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate predicted frames against ground truth")
    parser.add_argument("--pred-dir", required=True, help="Directory of predicted frames")
    parser.add_argument("--gt-dir", required=True, help="Directory of GT frames")
    parser.add_argument("--output", default=None, help="JSON output path")
    parser.add_argument("--comprehensive", action="store_true",
                        help="Also run temporal/gaming/stratified metrics")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    pred = load_dir(args.pred_dir, args.device)
    gt = load_dir(args.gt_dir, args.device)
    if not pred or not gt:
        raise SystemExit("no frames found")
    n = min(len(pred), len(gt))
    pred, gt = pred[:n], gt[:n]

    from vfisr_tpu_torch.evaluation import QualityEvaluator, run_comprehensive_benchmark

    ev = QualityEvaluator(args.device)
    res = ev.evaluate(pred, gt)
    out = {"psnr": res.psnr, "ssim": res.ssim, "lpips": res.lpips,
           "lpips_mode": ev.lpips_mode, "frames": n}
    print(f"PSNR {res.psnr:.2f} dB | SSIM {res.ssim:.4f} | LPIPS {res.lpips:.4f} "
          f"({ev.lpips_mode}) over {n} frames")
    if args.comprehensive:
        comp = run_comprehensive_benchmark(pred, gt, verbose=True, device=args.device)
        out["comprehensive"] = comp.to_dict()
    if args.output:
        Path(args.output).write_text(json.dumps(out, indent=2, default=float))
        print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
