"""The program's spans (``vfisr_tpu_torch/utils/spans.py``) as the benchmark
reads them.

Two readings:

- ``host_ms_per_step(rec, name)``: the host time of the program's ``name``
  spans per traced step that ran one, from the span log the program keeps
  while a profiler runs (``LOG``). The span metrics' readers
  (``metrics/analysis_host_ms.py``, ``metrics/sync_wait_ms.py``) take it.
  A program without spans, as before they existed, gives None.
- ``attribute(events)``: the traced window's device work and idle gaps
  attributed to the spans of a ``--trace 1`` run's kineto events. Each
  kernel, copy and set is placed at the host call that launched it: the
  CPU op its ``linked_correlation_id`` names (the innermost profiler range
  open at the launch, a ``vfisr.`` span where no op encloses it), else the
  ``cuda*`` or ``cu*`` launch call that shares its ``correlation_id``. It
  counts toward every program span open on that thread at that instant.
  ``trace.py::summarize`` does not call it; ``python3 -m portbench.spans``
  prints it beside a run's result.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>
    python3 -m portbench.spans --workload <cell> --seed <n> --sync-steps <k>

The first makes one traced run and prints, as its last line, one JSON
object: the run's per-layer metrics, then ``spans`` (per span name over the
window's ``portbench.dispatch`` ranges: calls, steps, host_s,
self_host_s, device_s, launches), ``attributed_s``, ``unattributed_s``,
``idle_s`` (the window's idle time by gap label: the phase, then
``/<span>`` where the gap's midpoint falls inside a program span on the
dispatching thread) and ``links`` (how many device events each link
placed). The second runs k steps after the warm-up with
``torch.cuda.set_sync_debug_mode("warn")`` and prints each call that made
the host wait for the device, with the program's frames that led to it and
its count per step.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Dict, List, Optional, Tuple

PREFIX = "vfisr."
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def host_ms_per_step(rec, name: str) -> Optional[float]:
    """Mean host ms in the program's ``name`` spans per traced step that
    ran one (a span belongs to the step whose dispatch it starts in)."""
    try:
        from vfisr_tpu_torch.utils.spans import LOG
    except ImportError:  # a program without spans
        return None
    windows = [(s.t_disp, s.t_disp + s.dispatch_s) for s in rec.steps if s.traced]
    spans = [(a, b) for n, _, a, b in list(LOG) if n == name]
    per_step = []
    for w0, w1 in windows:
        inside = [b - a for a, b in spans if w0 <= a < w1]
        if inside:
            per_step.append(sum(inside))
    return 1e3 * sum(per_step) / len(per_step) if per_step else None


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{which}_us")() * 1000)


def _field(e, name: str) -> int:
    fn = getattr(e, name, None)
    return int(fn()) if fn is not None else 0


def _is_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def _merge(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of the intervals clipped to [lo, hi], in order."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _open_at(ranges: List[Tuple[int, int, str]], times: List[int]) -> List[List[str]]:
    """For each of the ascending times, the names of the ranges open at it,
    outermost first. ``ranges`` are one thread's, which nest, sorted by
    (start, -end)."""
    stack: List[Tuple[int, int, str]] = []
    out, i = [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append([n for _, _, n in stack])
    return out


def attribute(events) -> dict:
    """Device time, launches, host time and idle gaps by program span over
    the traced window (module docstring). Events without correlation or
    thread fields still summarise: their device time goes unattributed."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    win = None
    dispatch: List[Tuple[int, int, int]] = []
    phases: Dict[int, list] = {}  # thread -> the benchmark's ranges
    prog: Dict[int, list] = {}  # thread -> the program's spans
    ops: Dict[int, Tuple[int, int]] = {}  # CPU op correlation id -> (thread, start)
    runtime: Dict[int, Tuple[int, int]] = {}  # CUDA call correlation id -> (thread, start)
    dev = []
    ranges_on_device = [0, 0]  # the program's ranges projected on the device; of them annotated
    for e in events:
        name, start = e.name(), _ns(e, "start")
        end = start + int(e.duration_ns())
        if e.device_type() == cuda:
            if name.startswith(PREFIX):
                ranges_on_device[0] += 1
                ranges_on_device[1] += _is_annotation(e)
            if not (_is_annotation(e) or name.startswith(("portbench.", PREFIX))):
                dev.append((start, end, _field(e, "linked_correlation_id"),
                            _field(e, "correlation_id"), name))
            continue
        thread = _field(e, "start_thread_id")
        corr = _field(e, "correlation_id")
        if name == "portbench.window":
            win = (start, end)
        elif name.startswith("portbench."):
            phases.setdefault(thread, []).append((start, end, name[len("portbench."):]))
            if name == "portbench.dispatch":
                dispatch.append((start, end, thread))
        elif name.startswith(PREFIX):
            prog.setdefault(thread, []).append((start, end, name[len(PREFIX):]))
        if corr:
            (runtime if _RUNTIME.match(name) else ops)[corr] = (thread, start)
    if win is None:
        return {"spans": {}, "attributed_s": None, "unattributed_s": None,
                "unattributed_ops": [], "idle_s": {}, "links": {}}
    w0, w1 = win
    for ranges in (*phases.values(), *prog.values()):
        ranges.sort(key=lambda r: (r[0], -r[1]))

    # host time: each span that starts in a dispatch range of the window
    spans: Dict[str, dict] = {}
    for thread, ranges in prog.items():
        for i, (a, b, n) in enumerate(ranges):
            step = next((k for k, (d0, d1, t) in enumerate(dispatch)
                         if t == thread and d0 <= a < d1 and w0 <= a < w1), None)
            if step is None:
                continue
            kids = _merge([(c, d) for c, d, _ in ranges[i + 1:] if a <= c and d <= b], a, b)
            s = spans.setdefault(n, {"calls": 0, "steps": set(), "host_s": 0.0,
                                     "self_host_s": 0.0, "device_s": 0.0, "launches": 0})
            s["calls"] += 1
            s["steps"].add(step)
            s["host_s"] += (b - a) * 1e-9
            s["self_host_s"] += (b - a - sum(d - c for c, d in kids)) * 1e-9

    # device time: each event inside the window, at its launch
    links = {"linked_op": 0, "runtime": 0, "none": 0, "ranges_on_device": ranges_on_device}
    launched: Dict[int, list] = {}  # thread -> [(launch time, device ns, name)]
    outside: Dict[str, float] = {}  # device s of the events no span holds, by name
    for a, b, linked, corr, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        at = ops.get(linked) or runtime.get(corr)
        links["linked_op" if linked in ops else "runtime" if at else "none"] += 1
        if at is None or at[0] not in prog:
            outside[name] = outside.get(name, 0.0) + (b - a) * 1e-9
        else:
            launched.setdefault(at[0], []).append((at[1], b - a, name))
    attributed = 0
    for thread, items in launched.items():
        items.sort()
        for (_, ns, name), names in zip(items, _open_at(prog[thread], [t for t, _, _ in items])):
            for n in set(names):
                if n in spans:
                    spans[n]["device_s"] += ns * 1e-9
                    spans[n]["launches"] += 1
            if names:
                attributed += ns
            else:
                outside[name] = outside.get(name, 0.0) + ns * 1e-9

    # idle gaps, labelled by the benchmark's phase and the innermost span
    busy = _merge([(a, b) for a, b, *_ in dev], w0, w1)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[::2], edges[1::2]) if g1 > g0]
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    labels = ["other"] * len(gaps)
    for thread, ranges in phases.items():
        inner = _open_at(prog.get(thread, []), mids)
        for k, open_ in enumerate(_open_at(ranges, mids)):
            if open_ and labels[k] == "other":
                labels[k] = open_[-1] + ("/" + inner[k][-1] if inner[k] else "")
    idle: Dict[str, float] = {}
    for (g0, g1), label in zip(gaps, labels):
        idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    for s in spans.values():
        s["steps"] = len(s["steps"])
    return {"spans": spans, "attributed_s": attributed * 1e-9,
            "unattributed_s": sum(outside.values()),
            "unattributed_ops": [[n[:80], v] for n, v in
                                 sorted(outside.items(), key=lambda kv: -kv[1])[:8]],
            "idle_s": dict(sorted(idle.items(), key=lambda kv: -kv[1])), "links": links}


def _traced(cell: str, seed: int, seconds: float) -> dict:
    from portbench import harness
    from portbench import trace as trace_mod

    kept = []
    stop = trace_mod.stop

    def stop_and_keep(tracing):
        out = stop(tracing)
        kept.append(attribute(tracing.prof.profiler.kineto_results.events()))
        return out

    trace_mod.stop = stop_and_keep
    try:
        result = harness.run(cell, seed, seconds, True, "cuda")
    finally:
        trace_mod.stop = stop
    return {"correct": result["correct"], "metrics": result["metrics"],
            "device": result["device"], **(kept[0] if kept else {})}


def _sync_sites(cell: str, seed: int, steps: int) -> dict:
    import traceback
    import warnings

    import torch
    from vfisr_tpu_torch.pipeline.streaming import pack_i420

    from portbench import harness
    from portbench import streams as streams_mod
    from portbench import weights as weights_mod

    c = harness.find_cell(cell)
    dev = torch.device("cuda")
    streams = streams_mod.Streams(c.traffic, seed, c.config["in_hw"], dev)
    params = {grp: weights_mod.make(shapes, seed, dev)
              for grp, shapes in c.driver.weight_shapes(c.config).items()}
    program = c.driver.Program(c.config, params, streams, dev)
    g = 0
    for _ in range(int(c.workload["warmup_steps"])):
        program.step(g)
        g += 1
    torch.cuda.synchronize()
    sites: Dict[str, int] = {}

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if "vfisr_tpu_torch" in f.filename
                  or "portbench" in f.filename]
        key = " <- ".join(f"{f.filename.split('/repo/')[-1]}:{f.lineno} {f.name}"
                          for f in reversed(frames[-4:]))
        sites[key] = sites.get(key, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(steps):
                pack_i420(program.step(g)[0])
                g += 1
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return {"steps": steps, "sites": {k: v / steps for k, v in sites.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--sync-steps", type=int, default=0)
    args = ap.parse_args(argv)
    if args.sync_steps:
        out = _sync_sites(args.workload, args.seed, args.sync_steps)
    else:
        out = _traced(args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
