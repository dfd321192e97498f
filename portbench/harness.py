"""The benchmark's harness: one run of one cell.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``, whose ``driver`` names ``drivers/<driver>.py``)
and a traffic mix (``traffic/<mix>.json``). Per-layer metrics are the
readers in ``metrics/``, each a module with ``UNIT`` and ``read(record)``
that returns a number or None. The harness finds every file by name, so a
later change adds a configuration, a mix, a cell or a metric by adding
files.

The loop is closed and dispatched one step ahead, as the program's
``process_video`` runs: step g is dispatched before step g-1's frames are
read back, and a step waits for the readback of step g-2. Each step's
uint8 frames are packed to I420 on the device by the program's
``pack_i420`` and copied into pinned host memory behind the compute; a
sink thread waits for each copy, stamps its time and drops the frames,
keeping only the steps the check samples.
"""

from __future__ import annotations

import importlib.util
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import streams as streams_mod
from portbench import trace as trace_mod
from portbench import weights as weights_mod
from portbench.reference import ops as ref_ops
from portbench.reference.precision import FULL
from portbench.reference.warp import recording

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vfisr_tpu")  # top-level module names, compared whole
IN_FLIGHT = 2  # steps dispatched and not yet read back


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                       f"(looked for {path})")
    return json.loads(path.read_text())


def _module(path: Path, label: str):
    if not path.is_file():
        raise KeyError(f"no {label} (looked for {path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{label.replace(' ', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: object


def find_cell(name: str, root: Path = ROOT) -> Cell:
    wl = load_json("workloads", name, root)
    cfg = load_json("configs", wl["config"], root)
    mix = load_json("traffic", wl["traffic"], root)
    driver = _module(root / "drivers" / f"{cfg['driver']}.py", f"driver {cfg['driver']}")
    return Cell(name, wl, cfg, mix, driver)


def metric_readers(root: Path = ROOT) -> Dict[str, object]:
    """Every per-layer metric's reader, by name."""
    return {p.stem: _module(p, f"metric {p.stem}")
            for p in sorted((root / "metrics").glob("*.py")) if not p.stem.startswith("_")}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Step:
    g: int
    route: Optional[str]
    frames: int
    t_disp: float
    dispatch_s: float
    traced: bool
    t_done: Optional[float] = None


@dataclass
class Record:
    """What one run measured: what the metric readers read."""

    cell: str
    config: dict
    steps: List[Step]
    counts: Dict[str, dict]
    peaks: dict
    trace: Optional[dict] = None

    def completed(self) -> List[Step]:
        return [s for s in self.steps if s.t_done is not None]


def count_steps(cell: Cell) -> Dict[str, dict]:
    """FLOPs (matrix products and convolutions) and warp bytes of one step
    of each route, from the reference on the meta device in the dtypes the
    configuration states."""
    from torch.utils.flop_counter import FlopCounterMode

    out = {}
    for route in cell.driver.ROUTES:
        with FlopCounterMode(display=False) as fc, recording() as calls:
            cell.driver.step_on_meta(cell.config, int(cell.traffic["streams"]), route)
        out[route] = {"flops": int(fc.get_total_flops()),
                      "warp_bytes": int(sum(c[3] for c in calls)), "warps": len(calls)}
    return out


class _Sink(threading.Thread):
    """Waits for each step's copy, stamps it, keeps the sampled steps."""

    def __init__(self, q: "queue.Queue", slots: threading.Semaphore, keep):
        super().__init__(daemon=True)
        self.q, self.slots, self.keep = q, slots, keep
        self.kept: Dict[int, torch.Tensor] = {}
        self.error: Optional[BaseException] = None

    def run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            step, host, done = item
            try:
                if done is not None:
                    done.synchronize()
                step.t_done = time.perf_counter()
                if self.keep(step):
                    self.kept[step.g] = host
                    wanted = set(self.keep.steps())
                    for g in [g for g in self.kept if g not in wanted]:
                        del self.kept[g]
            except BaseException as e:  # surfaced by the main thread after join
                self.error = e
            finally:
                self.slots.release()


class _Sample:
    """The steps the check compares, drawn from the seed: a reservoir of
    ``k`` of the window's steps, and the first step that holds a scene
    cut."""

    def __init__(self, k: int, seed: int, cut_of):
        self.k, self.cut_of = k, cut_of
        self.rng = np.random.default_rng(weights_mod.seed_of(seed, 7))
        self.seen = 0
        self.chosen: List[int] = []
        self.cut: Optional[int] = None

    def __call__(self, step: Step) -> bool:
        keep = False
        if self.cut is None and self.cut_of(step.g):
            self.cut, keep = step.g, True
        self.seen += 1
        if len(self.chosen) < self.k:
            self.chosen.append(step.g)
            keep = True
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.chosen[j] = step.g
                keep = True
        return keep

    def steps(self) -> List[int]:
        return sorted(set(self.chosen) | ({self.cut} if self.cut is not None else set()))


def _copy_to_host(packed: torch.Tensor):
    if packed.device.type != "cuda":
        return packed.clone(), None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    # a blocking event: the sink sleeps on it instead of spinning on a core
    # that the dispatching thread may share
    done = torch.cuda.Event(blocking=True)
    done.record()
    return host, done


def run(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: Optional[float] = None, root: Path = ROOT) -> dict:
    """One run; returns the result (``result_line`` prints it)."""
    from vfisr_tpu_torch.pipeline.streaming import pack_i420

    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(cell_name, root)
    cfg, mix, wl = cell.config, cell.traffic, cell.workload
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    readers = metric_readers(root)
    peaks = json.loads((ROOT / "data" / "peaks.json").read_text())
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    # set-up: frames, weights, the program, the counts, the warm-up
    marks = [("start", time.perf_counter())]
    streams = streams_mod.Streams(mix, seed, cfg["in_hw"], dev)
    marks.append(("frames", time.perf_counter()))
    params = {grp: weights_mod.make(shapes, seed, dev)
              for grp, shapes in cell.driver.weight_shapes(cfg).items()}
    marks.append(("weights", time.perf_counter()))
    program = cell.driver.Program(cfg, params, streams, dev)
    marks.append(("program", time.perf_counter()))
    counts = count_steps(cell) if trace else {}  # read by the per-layer metrics only
    marks.append(("counts", time.perf_counter()))

    def dispatch(g):
        frames, route = program.step(g)
        t_step = time.perf_counter()
        host, done = _copy_to_host(pack_i420(frames))
        return host, done, int(frames.shape[0]), route, t_step

    g = 0
    for _ in range(int(wl["warmup_steps"])):
        host, done, _, _, _ = dispatch(g)
        if done is not None:
            done.synchronize()
        g += 1
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("warm-up", time.perf_counter()))
    print("portbench set-up s: imports %.3f, " % (marks[0][1] - t_start)
          + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:])),
          file=sys.stderr, flush=True)

    # the window
    sample = _Sample(int(wl["check_steps"]), seed, streams.is_cut)
    slots = threading.Semaphore(IN_FLIGHT)
    q: "queue.Queue" = queue.Queue()
    sink = _Sink(q, slots, sample)
    sink.start()
    steps: List[Step] = []
    tracing = summary = None  # the open trace; what it read once stopped
    trace_from, trace_max = seconds * float(wl["trace_from"]), int(wl["trace_steps"])
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    try:
        while True:
            with trace_mod.phase(tracing, "wait"):
                slots.acquire()
            t_disp = time.perf_counter()
            if t_disp >= t_end:
                slots.release()
                break
            if trace and tracing is None and summary is None and t_disp - t0 >= trace_from:
                tracing = trace_mod.start(dev)
                t_disp = time.perf_counter()
            with trace_mod.phase(tracing, "dispatch"):
                host, done, nframes, route, t_step = dispatch(g)
            step = Step(g, route, nframes, t_disp, t_step - t_disp, tracing is not None)
            steps.append(step)
            q.put((step, host, done))
            g += 1
            if tracing is not None and (sum(s.traced for s in steps) >= trace_max
                                        or time.perf_counter() - t0 >= 0.9 * seconds):
                summary, tracing = trace_mod.stop(tracing), None
    finally:
        q.put(None)
        sink.join()
    if sink.error is not None:
        raise sink.error
    if tracing is not None:  # the window closed while tracing
        summary = trace_mod.stop(tracing)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # the window: from the first dispatch until the last step dispatched
    # before ``seconds`` had passed has reached host memory
    done_steps = [s for s in steps if s.t_done is not None]
    window_s = max(s.t_done for s in done_steps) - t0
    record = Record(cell_name, cfg, steps, counts, peaks.get(kind, {}), summary)
    result = {"metrics": {}}
    if trace:
        for name, reader in readers.items():
            value = reader.read(record)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": reader.UNIT}
    else:
        lat = [(s.t_done - s.t_disp) * 1e3 for s in done_steps]
        e2e = {"output_fps": (sum(s.frames for s in done_steps) / window_s, "frames/s"),
               "latency_p95_ms": (float(np.percentile(lat, 95)) if lat else None, "ms"),
               "peak_mem_gb": (peak / 1e9, "GB"),
               "setup_s": (setup_s, "s")}
        for name in wl["end_to_end"]:
            value, unit = e2e[name]
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}

    # the check, once the window has closed and the program's state is freed
    kept = {k: sink.kept[k] for k in sample.steps() if k in sink.kept}
    program.close()
    del program
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(cell, params, streams, kept)
    limits = wl["limits"]
    correct = bool(kept) and all(numbers[k] <= lim for k, lim in limits.items())
    result = {"correct": correct, "attempted": len(steps),
              "failed": len(steps) - sum(s.t_done is not None for s in steps),
              **result,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": peak}}
    if summary is not None and summary["busy_s"] is not None:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["compared_steps"] = sorted(kept)
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result


def compare(cell: Cell, params: dict, streams, kept: Dict[int, torch.Tensor]) -> Dict[str, float]:
    """The check's numbers: each kept step's I420 bytes against the
    reference's, recomputed from the same frames, weights and HUD history.

    frame_mad: the largest mean |difference| of any frame, in levels;
    frame_off_pct: the largest share of a frame's bytes off by more than 8
    levels, in %."""
    mad, off = 0.0, 0.0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        for g, host in sorted(kept.items()):
            ref = ref_ops.rgb_to_i420(cell.driver.reference(cell.config, params, streams, g, FULL))
            got = host.to(ref.device)
            if got.shape != ref.shape:
                return {"frame_mad": float("inf"), "frame_off_pct": float("inf")}
            d = (got.int() - ref.int()).abs()
            mad = max(mad, float(d.float().mean(dim=(1, 2)).max()))
            off = max(off, float((d > 8).float().mean(dim=(1, 2)).max()) * 100.0)
    return {"frame_mad": mad, "frame_off_pct": off}


def result_line(result: dict) -> str:
    return json.dumps(result)
