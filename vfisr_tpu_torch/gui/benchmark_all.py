"""Seven-method video benchmark (port of ``gui/benchmark_all.py``).

    python -m vfisr_tpu_torch.gui.benchmark_all --clip CLIP [--interval 0]
        [--data-dir data] [--output-dir outputs/benchmark] [--methods ...]
        [--resolution 2560x1440] [--fps 120] [--max-frames N] [--device cuda]

``benchmark_proper.run_method`` over bicubic, lanczos, optical_flow,
rife_bicubic, rife_lanczos, lanczos_edge and adaptive_vfi, the videos and
metrics recorded in the shared ``clips_metadata.json``, then the methods
sorted by quality (PSNR, SSIM) and by time. A method that fails stops the
run with an error that names it (the reference prints the failure, goes on
and exits 0); the metadata keeps the methods finished before it.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from vfisr_tpu_torch.data import video_io
from vfisr_tpu_torch.gui import benchmark_proper
from vfisr_tpu_torch.gui.benchmark_proper import make_parser, open_metadata

METHODS = [
    "bicubic",        # traditional SR + linear VFI
    "lanczos",
    "optical_flow",   # flow VFI
    "rife_bicubic",   # neural VFI
    "rife_lanczos",
    "lanczos_edge",   # edge-enhanced SR
    "adaptive_vfi",   # motion-aware RIFE routing
]


def main(argv=None) -> int:
    args = make_parser(METHODS, "benchmark_all").parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    out_w, out_h = map(int, args.resolution.split("x"))
    keyframes, out_dir, meta_path, metadata, clip_entry = open_metadata(args)
    print(f"VFI+SR comprehensive benchmark: {args.clip} interval {args.interval}, "
          f"{len(keyframes)} keyframes -> {out_w}x{out_h}@{args.fps:g}")
    suffix = video_io.writable_suffix()

    results = []
    for method in args.methods.split(","):
        method = method.strip()
        t0 = time.time()
        out_path = out_dir / f"{method}{suffix}"
        try:
            stats = benchmark_proper.run_method(method, keyframes, str(out_path), out_w, out_h,
                                                args.fps, args.device)
        except Exception as e:
            raise RuntimeError(f"benchmark_all: method {method!r} failed: {e}") from e
        stats["time_s"] = round(time.time() - t0, 1)
        clip_entry["videos"][method] = str(out_path)
        clip_entry["metrics"][method] = stats
        meta_path.write_text(json.dumps(metadata, indent=2))
        results.append({"method": method, **stats})
        print(f"  [{method}] psnr={stats['psnr']} time={stats['time_s']}s")

    print("\nBy quality (psnr, ssim):")
    for r in sorted(results, key=lambda x: (x["psnr"] or 0, x["ssim"] or 0), reverse=True):
        # psnr/ssim are None when every frame matched exactly (control)
        psnr = "inf " if r["psnr"] is None else f"{r['psnr']:.2f}"
        ssim = "1.0000" if r["ssim"] is None else f"{r['ssim']:.4f}"
        print(f"  {r['method']:<14} {psnr} dB  {ssim}")
    print("By speed:")
    for r in sorted(results, key=lambda x: x["time_s"]):
        print(f"  {r['method']:<14} {r['time_s']:.1f} s")
    print(f"Wrote {meta_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
