"""Named ranges around the port's layers, for a profiler trace.

``span(name)`` is ``torch.profiler.record_function("vfisr." + name)`` while
a profiler runs, and one shared ``contextlib.nullcontext()`` otherwise: with
no profiler a span costs one check of the profiler's state, allocates
nothing and makes no dispatcher call. Under ``torch.profiler.profile`` the
ranges land in the trace beside the device's kernels, on its clock; to get
NVTX ranges, run the program inside ``torch.autograd.profiler.emit_nvtx()``.
A span never changes what runs: it neither synchronises nor reads a tensor,
and ``torch.export`` traces with no profiler running, so an exported
program holds no profiler op.

The spans, at the layer boundaries of the flagship step and the adaptive
pipeline: ``analysis``, ``ifnet``, ``vfimamba``, ``scan`` (one per
``selective_scan`` call), ``composite``, ``sr``, ``pack_i420``, and
``sync`` around each call in which the host waits for the device.

While a profiler runs, each span also appends ``(name, thread id, start,
end)`` (``time.perf_counter`` seconds, the name without its prefix) to
``LOG``, which keeps the last ``LOG.maxlen``: a reader in the process takes
host times from it without the trace (the benchmark's span metrics do).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.profiler import record_function

PREFIX = "vfisr."
LOG: collections.deque = collections.deque(maxlen=1 << 16)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name
        self.range = record_function(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        LOG.append((self.name, threading.get_ident(), self.start, time.perf_counter()))
        self.range.__exit__(*exc)


def span(name: str):
    """A range named ``vfisr.<name>`` while a profiler runs, else a null context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _Span(name)
