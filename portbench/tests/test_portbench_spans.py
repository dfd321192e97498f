"""The program's spans as the benchmark reads them (``portbench/spans.py``):
device work placed at its launch by correlation id, nested spans and self
time, threads kept apart, steps counted, the program's ranges kept out of
device time, idle gaps labelled by span; and the span metrics' readers."""

from __future__ import annotations

import collections

import pytest
import torch

from portbench import harness, spans, trace
from portbench.tests.test_portbench_trace import _Ev as _BareEv

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Ev(_BareEv):
    def __init__(self, name, kind, start, dur, annotation=False, corr=0, linked=0, thread=1):
        super().__init__(name, kind, start, dur, annotation)
        self._c, self._l, self._t = corr, linked, thread

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


def _window(*events, end=10_000):
    return [_Ev("portbench.window", CPU, 0, end), *events]


def test_launches_by_linked_op_and_by_runtime_call():
    events = _window(
        _Ev("portbench.dispatch", CPU, 0, 1000),
        _Ev("vfisr.analysis", CPU, 100, 300, corr=1),
        _Ev("aten::add", CPU, 120, 10, corr=2),
        _Ev("cudaLaunchKernel", CPU, 125, 3, corr=2),  # a runtime id may equal an op's
        _Ev("vfisr.sr", CPU, 500, 300, corr=3),
        _Ev("cuLaunchKernel", CPU, 510, 4, corr=40),  # launched with no op around it
        _Ev("add_kernel", CUDA, 2000, 50, corr=2, linked=2),
        _Ev("k1_kernel", CUDA, 2100, 70, corr=40, linked=0),
        _Ev("Memcpy DtoH", CUDA, 2200, 30, corr=77, linked=0),  # the harness's copy
    )
    out = spans.attribute(events)
    s = out["spans"]
    assert s["analysis"]["device_s"] == pytest.approx(50e-9) and s["analysis"]["launches"] == 1
    assert s["sr"]["device_s"] == pytest.approx(70e-9) and s["sr"]["launches"] == 1
    assert out["attributed_s"] == pytest.approx(120e-9)
    assert out["unattributed_s"] == pytest.approx(30e-9)
    assert out["unattributed_ops"] == [["Memcpy DtoH", pytest.approx(30e-9)]]
    assert out["links"]["linked_op"] == 1 and out["links"]["runtime"] == 1
    assert out["links"]["none"] == 1


def test_nested_spans_self_time_and_every_enclosing_span():
    events = _window(
        _Ev("portbench.dispatch", CPU, 0, 1000),
        _Ev("vfisr.vfimamba", CPU, 100, 400, corr=1),
        _Ev("vfisr.sync", CPU, 110, 20, corr=2),
        _Ev("vfisr.scan", CPU, 150, 100, corr=3),
        _Ev("aten::addcmul", CPU, 160, 5, corr=4),
        _Ev("vfisr.scan", CPU, 300, 50, corr=5),
        _Ev("addcmul_kernel", CUDA, 1500, 40, linked=4, corr=9),
    )
    s = spans.attribute(events)["spans"]
    assert s["vfimamba"]["host_s"] == pytest.approx(400e-9)
    assert s["vfimamba"]["self_host_s"] == pytest.approx((400 - 20 - 100 - 50) * 1e-9)
    assert s["scan"]["calls"] == 2 and s["scan"]["host_s"] == pytest.approx(150e-9)
    assert s["scan"]["self_host_s"] == pytest.approx(150e-9)
    for name in ("scan", "vfimamba"):  # the kernel counts toward both
        assert s[name]["device_s"] == pytest.approx(40e-9) and s[name]["launches"] == 1
    assert s["sync"]["device_s"] == 0.0


def test_threads_kept_apart():
    events = _window(
        _Ev("portbench.dispatch", CPU, 0, 1000, thread=1),
        _Ev("vfisr.analysis", CPU, 100, 300, corr=1, thread=1),
        _Ev("vfisr.pack_i420", CPU, 100, 300, corr=2, thread=2),  # another thread, same time
        _Ev("aten::mul", CPU, 150, 5, corr=3, thread=1),
        _Ev("mul_kernel", CUDA, 500, 10, linked=3),
    )
    s = spans.attribute(events)["spans"]
    assert s["analysis"]["launches"] == 1
    assert "pack_i420" not in s  # in no dispatch range of its thread


def test_steps_counted_per_dispatch_range_inside_the_window():
    events = [
        _Ev("vfisr.analysis", CPU, 10, 20, corr=9),  # before the window: not counted
        _Ev("portbench.window", CPU, 50, 5000),
        _Ev("portbench.dispatch", CPU, 100, 900),
        _Ev("vfisr.analysis", CPU, 150, 100, corr=1),
        _Ev("vfisr.sync", CPU, 300, 10, corr=2),
        _Ev("vfisr.sync", CPU, 400, 30, corr=3),
        _Ev("portbench.wait", CPU, 1000, 100),
        _Ev("portbench.dispatch", CPU, 1100, 900),
        _Ev("vfisr.analysis", CPU, 1150, 300, corr=4),
        _Ev("k", CUDA, 60, 10),
    ]
    s = spans.attribute(events)["spans"]
    assert (s["analysis"]["calls"], s["analysis"]["steps"]) == (2, 2)
    assert s["analysis"]["host_s"] == pytest.approx(400e-9)
    assert (s["sync"]["calls"], s["sync"]["steps"]) == (2, 1)


def test_program_ranges_are_no_device_time():
    base = [_Ev("portbench.window", CPU, 0, 1000),
            _Ev("portbench.dispatch", CPU, 0, 1000),
            _Ev("vfisr.ifnet", CPU, 0, 900, corr=1),
            _Ev("aten::conv", CPU, 10, 5, corr=2),
            _Ev("conv_kernel", CUDA, 100, 100, linked=2)]
    projected = base + [_Ev("vfisr.ifnet", CUDA, 100, 800, annotation=True)]
    assert trace.summarize(projected)["busy_s"] == trace.summarize(base)["busy_s"] \
        == pytest.approx(100e-9)
    assert "vfisr.ifnet" not in trace.summarize(projected)["kernel_s"]
    a = spans.attribute(projected)
    assert a["attributed_s"] == pytest.approx(100e-9) and a["unattributed_s"] == 0
    assert a["links"]["ranges_on_device"] == [1, 1]


def test_gap_labels_with_and_without_program_spans():
    events = _window(
        _Ev("portbench.dispatch", CPU, 0, 400),
        _Ev("vfisr.analysis", CPU, 0, 200, corr=1),
        _Ev("portbench.wait", CPU, 400, 600),
        _Ev("k", CUDA, 100, 50),    # idle 0-100 in the analysis
        _Ev("k", CUDA, 380, 20),    # idle 150-380, its midpoint after the analysis
        _Ev("k", CUDA, 990, 9010),  # idle 400-990 while the host waits
    )
    idle = spans.attribute(events)["idle_s"]
    assert idle == {"wait": pytest.approx(590e-9), "dispatch": pytest.approx(230e-9),
                    "dispatch/analysis": pytest.approx(100e-9)}
    # the benchmark's own labels are today's, with or without the program's ranges
    bare = [e for e in events if not e.name().startswith("vfisr.")]
    assert trace.summarize(events)["breakdown"] == trace.summarize(bare)["breakdown"]


def test_events_without_links_still_summarise():
    events = [_BareEv("portbench.window", CPU, 0, 1000), _BareEv("portbench.dispatch", CPU, 0, 500),
              _BareEv("vfisr.sr", CPU, 0, 400), _BareEv("k", CUDA, 100, 200)]
    out = spans.attribute(events)
    assert out["attributed_s"] == 0 and out["unattributed_s"] == pytest.approx(200e-9)
    assert out["links"]["none"] == 1
    assert spans.attribute([_BareEv("k", CUDA, 0, 5)])["attributed_s"] is None


def _record(steps):
    return harness.Record("adaptive.easy", {}, steps, {}, {}, None)


@pytest.fixture
def log(monkeypatch):
    from vfisr_tpu_torch.utils import spans as program_spans

    fresh = collections.deque(maxlen=16)
    monkeypatch.setattr(program_spans, "LOG", fresh)
    return fresh


READERS = harness.metric_readers()


@pytest.mark.parametrize("metric,name", [("analysis_host_ms", "analysis"),
                                         ("sync_wait_ms", "sync")])
def test_span_readers(metric, name, log):
    reader = READERS[metric]
    steps = [harness.Step(0, "rife", 4, 10.0, 0.5, False),
             harness.Step(1, "rife", 4, 11.0, 0.5, True),
             harness.Step(2, "rife", 4, 12.0, 0.5, True),
             harness.Step(3, "rife", 4, 13.0, 0.5, True)]
    assert reader.read(_record(steps)) is None  # no span logged
    log.extend([(name, 1, 10.1, 10.3),           # an untraced step
                (name, 1, 11.1, 11.12), (name, 1, 11.2, 11.26),  # step 1: 80 ms
                ("other", 1, 12.0, 12.4),
                (name, 1, 13.1, 13.14)])         # step 3: 40 ms; step 2 ran none
    assert reader.read(_record(steps)) == pytest.approx(60.0)
    assert reader.UNIT == "ms"


def test_span_readers_without_the_programs_spans(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "vfisr_tpu_torch.utils.spans", None)  # as the parent has
    steps = [harness.Step(0, "rife", 4, 10.0, 0.5, True)]
    for metric in ("analysis_host_ms", "sync_wait_ms"):
        assert READERS[metric].read(_record(steps)) is None
