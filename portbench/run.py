"""Run one cell of the benchmark once, on the CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds`` and prints one JSON object as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; last, ``check``: each number compared with its limit, also
printed as the last lines of standard error. Exits non-zero, printing no
result, without a card (or with fewer than the cell asks for), and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    torch.set_num_threads(1)  # the host's work is dispatch; no CPU thread pool spins beside it

    cell = harness.find_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import vfisr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not here ({e})", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                         T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
