"""The trace reader: device time is the union of kernels, copies and sets
inside the traced window; the benchmark's own ranges, projected onto the
device timeline as user annotations, are no device work."""

from __future__ import annotations

import pytest
import torch

from portbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Ev:
    def __init__(self, name, kind, start, dur, annotation=False):
        self._n, self._k, self._s, self._d, self._a = name, kind, start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def is_user_annotation(self):
        return self._a


def test_union_gaps_and_annotations():
    events = [
        _Ev("portbench.window", CPU, 0, 1000),
        _Ev("portbench.window", CUDA, 0, 1000, annotation=True),
        _Ev("portbench.dispatch", CPU, 0, 400),
        _Ev("portbench.wait", CPU, 400, 600),
        _Ev("k1", CUDA, 100, 200),     # 100-300
        _Ev("k2", CUDA, 250, 100),     # 250-350, overlaps k1
        _Ev("memcpy", CUDA, 700, 100),  # 700-800
        _Ev("late", CUDA, 990, 50),    # clipped to 990-1000
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((250 + 100 + 10) * 1e-9)
    assert "portbench.window" not in s["kernel_s"]
    assert s["kernel_s"]["k1"] == pytest.approx(200e-9)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["wait", pytest.approx(350e-9)]  # 350-700 while the host waited
    assert ["dispatch", pytest.approx(100e-9)] in gaps  # 0-100
    assert s["breakdown"]["device_ops"][0] == ["k1", pytest.approx(200e-9)]


def test_no_device_time_reads_nothing():
    s = trace.summarize([_Ev("portbench.window", CPU, 0, 1000), _Ev("a", CPU, 0, 5)])
    assert s["busy_s"] is None and s["breakdown"] is None
