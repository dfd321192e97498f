"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
whole steps inside the window, and what the metric readers take from it.

The trace starts and stops on step boundaries with the device drained, so
it holds exactly the traced steps' device work. The benchmark's own host
phases are ``record_function`` ranges: ``portbench.window`` around the
traced part, ``portbench.dispatch`` around a step's dispatch (the
program's step, the I420 pack and the host copy's launch) and
``portbench.wait`` around the wait for a step's readback.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@dataclass
class Tracing:
    prof: object
    window: object
    device: torch.device


def start(device: torch.device) -> Tracing:
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.start()
    window = record_function("portbench.window")
    window.__enter__()
    return Tracing(prof, window, device)


def phase(tracing: Optional[Tracing], name: str):
    return record_function(f"portbench.{name}") if tracing is not None else contextlib.nullcontext()


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{which}_us")() * 1000)


def _is_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


def stop(tracing: Tracing) -> dict:
    """Stop the trace and read it: {"window_s", "busy_s" (None where the
    trace holds no device time), "kernel_s" {name: s}, "breakdown"}."""
    if tracing.device.type == "cuda":
        torch.cuda.synchronize(tracing.device)
    tracing.window.__exit__(None, None, None)
    tracing.prof.stop()
    return summarize(tracing.prof.profiler.kineto_results.events())


def summarize(events) -> dict:
    host, dev = [], []
    win = None
    for e in events:
        kind = e.device_type()
        start = _ns(e, "start")
        span = (start, start + int(e.duration_ns()), e.name())
        if kind == torch.autograd.DeviceType.CUDA:
            # kernels, copies and sets; a host range's projection onto the
            # device timeline (a user annotation) is no device work
            if not (_is_annotation(e) or e.name().startswith("portbench.")):
                dev.append(span)
        elif e.name() == "portbench.window":
            win = span
        elif e.name().startswith("portbench."):
            host.append(span)
    if win is None:
        return {"window_s": None, "busy_s": None, "kernel_s": {}, "breakdown": None}
    w0, w1 = win[0], win[1]
    kernel_s = {}
    for a, b, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-9
    busy, gaps, cur = 0, [], None
    for a, b, _ in sorted(dev):
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            else:
                gaps.append((w0, a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is None:
        return {"window_s": (w1 - w0) * 1e-9, "busy_s": None, "kernel_s": kernel_s,
                "breakdown": None}
    busy += cur[1] - cur[0]
    gaps.append((cur[1], w1))

    def label(a, b):
        mid = (a + b) // 2
        hit = [n for s, t, n in host if s <= mid < t]
        return hit[-1][len("portbench."):] if hit else "other"

    longest = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:10]
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9, "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in ops],
                          "idle_gaps": [[label(a, b), (b - a) * 1e-9] for a, b in longest]}}
