"""The port's spans (``vfisr_tpu_torch/utils/spans.py``) at tiny sizes on the CPU.

With no profiler running a span is one shared null context: a flagship step
and an adaptive step open no profiler range and log nothing. Under
``torch.profiler.profile`` the same steps record their layers' ranges in
order (``vfisr.scan`` inside ``vfisr.vfimamba``, each host wait inside a
``vfisr.sync``), log each one, and give the same bits as without a profiler.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import game_frames, one_torch_thread  # noqa: F401
from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.models.sota import vfimamba as tvm
from vfisr_tpu_torch.pipeline import flagship as tflag
from vfisr_tpu_torch.pipeline.streaming import pack_i420
from vfisr_tpu_torch.utils import spans

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 64, 96
TS = (0.25, 0.5, 0.75)
RIFE_NARROW = dict(channels=(16, 16, 16, 16), num_convs=2, warp_dtype=torch.float32,
                   level_warp_radius=(2, 2), final_warp_radius=(3, 4))
MAMBA_NARROW = dict(d_model=32, d_state=4, dt_rank=4, layers=2, refine_levels=2)


def _frames(n: int = 2):
    f = torch.from_numpy(game_frames(n, H, W)).float() / 255.0
    return f[:-1], f[1:]


def _flagship():
    torch.manual_seed(0)
    module = trife.IFNet(trife.RIFEConfig(**RIFE_NARROW)).eval()
    step = tflag.make_flagship_step(module, tflag.FlagshipConfig(out_hw=(80, 128),
                                                                 analysis_hw=(32, 48)))
    x0, x1 = _frames()

    def run():
        hist, cnt = tflag.init_history(1, "cpu")
        up = step(x0, x1, hist, cnt)[0]
        return up, pack_i420(up)

    return run


def _adaptive(route: str):
    torch.manual_seed(1)
    rife = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(**RIFE_NARROW))
    rife.module = trife.IFNet(rife.CONFIG).eval()
    mamba = tvm.VFIMambaModel(device="cpu")
    mamba.module = tvm.VFIMambaNet(tvm.MambaConfig(**MAMBA_NARROW)).eval()
    pipe = AdaptivePipeline(device="cpu")
    pipe._rife, pipe._vfimamba = rife, mamba
    rife._loaded = mamba._loaded = pipe._loaded = True
    pipe.router._bin_winner_native = lambda motion: route
    x0, x1 = _frames()

    def run():
        pipe.router.reset_history()
        mids = pipe.interpolate_batch(x0, x1, TS)
        return mids, pipe.upscale_batch(mids[0], 1.333)

    return run


STEPS = {"flagship": _flagship, "rife": lambda: _adaptive("rife"),
         "vfimamba": lambda: _adaptive("vfimamba")}


def _ranges(prof):
    """The program's ranges on the host: (start, end, name), by start."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(spans.PREFIX):])
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(spans.PREFIX)
           and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def _top_level(ranges):
    top, end = [], None
    for a, b, n in ranges:
        if end is None or a >= end:
            top.append(n)
            end = b
    return top


def _inside(ranges, inner: str, outer: str) -> int:
    """How many ``inner`` ranges lie inside an ``outer`` one."""
    outers = [(a, b) for a, b, n in ranges if n == outer]
    return sum(any(a <= c and d <= b for a, b in outers) for c, d, n in ranges if n == inner)


def test_span_without_a_profiler_is_one_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert spans.span("analysis") is spans.span("sr")
    assert isinstance(spans.span("sync"), contextlib.nullcontext)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_no_range_and_no_log_without_a_profiler(kind, monkeypatch):
    run = STEPS[kind]()

    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} with no profiler running")

    monkeypatch.setattr(spans, "record_function", refuse)
    before = list(spans.LOG)
    run()
    assert list(spans.LOG) == before


EXPECTED = {
    "flagship": ["analysis", "ifnet", "composite", "sr", "pack_i420"],
    "rife": ["analysis", "sync", "sync", "sync", "ifnet", "composite", "sr"],
    "vfimamba": ["analysis", "sync", "sync", "sync", "vfimamba", "composite", "sr"],
}


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_ranges_in_order_and_the_same_bits(kind):
    run = STEPS[kind]()
    off = run()
    spans.LOG.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    ranges = _ranges(prof)
    assert _top_level(ranges) == EXPECTED[kind]
    logged = sorted(((a, b, n) for n, _, a, b in spans.LOG), key=lambda r: (r[0], -r[1]))
    assert [n for _, _, n in logged] == [n for _, _, n in ranges]
    assert all(b >= a for a, b, _ in logged)
    names = [n for _, _, n in ranges]
    if kind == "flagship":
        assert "sync" not in names
    else:
        # the flow scale's upload, the motion_mean readback, the route
        # upload, the mask readback, the expert's timestamp upload
        assert names.count("sync") == 5
        assert _inside(ranges, "sync", "analysis") == 1
        assert _inside(ranges, "sync", "vfimamba" if kind == "vfimamba" else "ifnet") == 1
    if kind == "vfimamba":
        scans = 2 * MAMBA_NARROW["layers"]  # one per layer and direction
        assert names.count("scan") == _inside(ranges, "scan", "vfimamba") == scans


def test_log_keeps_the_last_spans():
    assert spans.LOG.maxlen == 1 << 16
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("sr") as s:
            assert isinstance(s, spans._Span)
    name, thread, a, b = spans.LOG[-1]
    assert name == "sr" and 0 <= b - a < 1.0
    assert np.isfinite([a, b]).all() and thread
