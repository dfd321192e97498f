"""Export a model's fixed-shape interpolation program for deployment (port
of ``scripts/compile_aot.py``; ``utils/aot.py`` does the work):

    # fixed 1080p shape, bf16 compute
    python -m vfisr_tpu_torch.compile_aot --model rife --precision bf16 \\
        --output /tmp/rife_1080p.pt2

    # export time, first run, FLOPs and peak memory, no artifact
    python -m vfisr_tpu_torch.compile_aot --model rife_lite --stats-only

    # run an artifact once
    python -m vfisr_tpu_torch.compile_aot --load /tmp/rife_1080p.pt2 \\
        --height 1080 --width 1920

The artifact is ``torch.export``'s ``.pt2``; it holds the program for the
device it was exported on (``--device``, cuda by default). Without
``--output`` it goes to ``outputs/<model>_<height>p.pt2``, never under
weights/. Each command prints one JSON line.
"""

import argparse
import json
import time
from pathlib import Path


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.compile_aot",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="rife")
    p.add_argument("--precision", default="f32", choices=["f32", "bf16"])
    p.add_argument("--output", default=None, help="artifact path (.pt2)")
    p.add_argument("--load", default=None, help="run an existing artifact once")
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--pairs", type=int, default=1)
    p.add_argument("--timesteps", default="0.25,0.5,0.75")
    p.add_argument("--weights", default=None)
    p.add_argument("--stats-only", action="store_true",
                   help="print the export's stats, write no artifact")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from vfisr_tpu_torch.utils import aot

    # the models' f32 configs keep f32 convolutions and matmuls (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card; pass --device cpu to export for the CPU")

    if args.load:
        blob = Path(args.load).read_bytes()
        t0 = time.perf_counter()
        shape = aot.smoke_run(blob, args.height, args.width, args.pairs, args.device)
        record = {"artifact": args.load, "bytes": len(blob), "output_shape": list(shape),
                  "run_s": round(time.perf_counter() - t0, 3)}
        print(json.dumps(record))
        return record

    ts = tuple(float(t) for t in args.timesteps.split(","))
    if args.stats_only:
        fn, _ = aot.build_interpolate_fn(args.model, ts, args.precision, args.weights,
                                         args.device)
        x = torch.zeros((args.pairs, args.height, args.width, 3), device=args.device)
        record = {"model": args.model, "precision": args.precision,
                  **aot.compile_stats(fn, x, x.clone())}
        print(json.dumps(record))
        return record

    out = Path(args.output or Path("outputs") / f"{args.model}_{args.height}p.pt2")
    blob = aot.export_interpolate(args.model, args.height, args.width, args.pairs, ts,
                                  args.precision, args.weights, args.device)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(blob)
    record = {"model": args.model, "precision": args.precision, "artifact": str(out),
              "bytes": len(blob)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
