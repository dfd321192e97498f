"""The control of the check that decides ``correct``: the reference put in
the program's place, one precision step below what the configuration
states (``reference/precision.py``), judged by the same numbers.

    python3 -m portbench.control --workload <cell> --seeds 11 12 13

For each seed it makes the cell's frames and weights, takes the steps a
run's check would (the first ``check_steps`` after the warm-up and the
first scene cut after them), and prints one JSON line of the numbers.
Those readings are the upper ends the limits were set below (PERF.md).
The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness, streams as streams_mod, weights as weights_mod
from portbench.reference import ops
from portbench.reference.precision import CONTROL


def control_steps(cell, streams) -> list:
    wl = cell.workload
    first = int(wl["warmup_steps"])
    steps = list(range(first, first + int(wl["check_steps"])))
    cut = next(g for g in range(first, first + 4 * streams.pool) if streams.is_cut(g))
    return sorted(set(steps) | {cut})


def readings(cell_name: str, seed: int, device: str = "cuda", root=harness.ROOT) -> dict:
    cell = harness.find_cell(cell_name, root)
    dev = torch.device(device)
    streams = streams_mod.Streams(cell.traffic, seed, cell.config["in_hw"], dev)
    params = {grp: weights_mod.make(shapes, seed, dev)
              for grp, shapes in cell.driver.weight_shapes(cell.config).items()}
    steps = control_steps(cell, streams)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        torch.backends.cuda.matmul.allow_tf32 = False
        lowered = {g: ops.rgb_to_i420(cell.driver.reference(cell.config, params, streams, g,
                                                            CONTROL)) for g in steps}
    return {"cell": cell_name, "seed": seed, "steps": steps,
            **harness.compare(cell, params, streams, lowered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(args.workload, seed)
        out["seconds"] = time.perf_counter() - t
        out["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
