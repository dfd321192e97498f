"""Device time of the windowed warp's kernels, the forward (K1) and its
flow gradient (K2), at the launch shapes of the port's paths, for comparing
two checkouts on one card.

    python vfisr_tpu_torch/time_k1.py --tree DIR [--label NAME]

imports ``vfisr_tpu_torch.ops.cuda.warp`` from the checkout DIR (its own
nvcc build), and for each shape of ``SHAPES`` (K1: the flagship's, the
training's, the adaptive model's, SAFA's and SAFA training's launches)
and ``GRAD_SHAPES`` (K2: the RIFE train step's four launches, and SAFA
training's feature warp) times GRAPH launches captured in a CUDA graph and
replayed REPLAYS times after a warm-up: ms per launch, device time, the
window origin included. Prints one JSON line per shape ("kernel": "K1" or
"K2") with the checkout's plan of the launch (``plan``: CTAs, and for a
launch in channel groups its chunks, groups per CTA and ring slots where
the checkout reports them); a shape the checkout's kernel refuses prints
its error. Needs a CUDA card and nvcc. Run two checkouts in turns in one
process each (A, B, B, A) to compare them.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

# (name, img [N,H,W,C], img dtype, window dtype, r)
SHAPES = (
    ("flagship ifnet s4", (2, 272, 480, 3), "bf16", "bf16", (2, 2)),
    ("flagship ifnet s2", (2, 544, 960, 3), "bf16", "bf16", (2, 2)),
    ("flagship ifnet final", (2, 1088, 1920, 3), "bf16", "bf16", (3, 4)),
    ("flagship shared flow", (4, 1088, 1920, 3), "bf16", "bf16", (3, 4)),
    ("flagship farneback l0", (1, 270, 480, 5), "f32", "f32", 8),
    ("train data", (48, 192, 192, 4), "f32", "f32", 2),
    ("train final", (16, 192, 192, 3), "f32", "bf16", (4, 6)),
    ("adaptive farneback l0", (1, 1080, 1920, 5), "f32", "f32", 8),
    ("adaptive rife final", (6, 1088, 1920, 3), "f32", "bf16", (4, 6)),
    ("adaptive vfimamba full", (3, 1088, 1920, 3), "f32", "f32", 8),
    ("safa frame", (3, 456, 576, 3), "f32", "f32", 8),
    ("safa feature", (3, 114, 144, 176), "f32", "f32", 8),
    ("safa train feature", (16, 48, 48, 176), "f32", "f32", 8),
)
# K2: the RIFE train step's launches (levels 1-3 at 1/4, 1/2, 1/2 of the
# 192 crop, both images in one call, and the final warp), and SAFA
# training's feature warp (channel groups)
GRAD_SHAPES = (
    ("rife train level s4", (32, 48, 48, 3), "f32", "bf16", (2, 4)),
    ("rife train level s2", (32, 96, 96, 3), "f32", "bf16", (2, 4)),
    ("rife train final", (32, 192, 192, 3), "f32", "bf16", (4, 6)),
    ("safa train feature", (16, 48, 48, 176), "f32", "f32", 8),
)
GRAPH, REPLAYS = 20, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose vfisr_tpu_torch to time")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, args.tree)
    import torch

    from vfisr_tpu_torch.ops.cuda import warp as kw

    if not torch.cuda.is_available():
        print("time_k1: needs a CUDA card", file=sys.stderr)
        return 2
    kw.build()
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cpu").manual_seed(0)
    for kernel, (name, shape, img_dt, win_dt, r) in ([("K1", v) for v in SHAPES]
                                                     + [("K2", v) for v in GRAD_SHAPES]):
        n, h, w, c = shape
        img = torch.rand(shape, generator=gen).to("cuda", dtypes[img_dt])
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        flow = torch.stack([4.0 * torch.sin(xx / 17.0 + yy / 23.0),
                            2.0 * torch.cos(yy / 9.0) - 0.5], -1)
        flow = (flow + 0.5 * torch.randn((n, h, w, 2), generator=gen)).to("cuda", dtypes[img_dt])
        out = torch.empty_like(img)
        ct = torch.randn(shape, generator=gen).to("cuda", dtypes[img_dt])
        gflow, cg = torch.empty_like(flow), torch.empty(flow.shape, device="cuda")
        row = dict(tree=args.label or args.tree, kernel=kernel, name=name, shape=list(shape),
                   img=img_dt, window=win_dt, r=r,
                   plan=kw.plan(img, r, dtypes[win_dt], grad=kernel == "K2"))
        if row["plan"] and row["plan"]["grouped"] and "chunks" in row["plan"]:
            row["plan"]["groups_per_cta"] = -(-row["plan"]["groups"] // row["plan"]["chunks"])
        def launch(kernel=kernel, img=img, flow=flow, out=out, ct=ct, gflow=gflow, cg=cg, r=r,
                   cd=dtypes[win_dt]):
            if kernel == "K1":
                kw.launch(img, flow, 1.0, out, r, "replicate", cd)
            else:
                kw.launch_grad(img, flow, 1.0, ct, gflow, cg, r, "replicate", cd)

        try:
            launch()
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(GRAPH):
                    launch()
            graph.replay()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPLAYS):
                graph.replay()
            end.record()
            end.synchronize()
            row["ms"] = start.elapsed_time(end) / (REPLAYS * GRAPH)
        except Exception as e:  # the checkout's kernel refuses the launch
            row["error"] = str(e).splitlines()[0]
        row["ms"] = row.get("ms", math.nan)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
