"""vfisr_tpu_torch/evaluation/speed.py against vfisr_tpu/evaluation/speed.py,
and the port's bench (vfisr_tpu_torch/bench.py) on the CPU at a small size.

``_stats`` is held against the JAX package's on the same samples (equal:
the same numpy on the same floats); ``measure`` on the CPU times each call
with the injected timer; the bench's ``measure`` takes a few pairs of the
flagship step (full-width RIFE from weights/rife.npz) at 64x96 on the CPU,
returns bench.py's keys with value = 3000 / the median ms per pair, and
refuses to run on a CUDA device that is not there.
"""

import json
import subprocess
import sys
from importlib import import_module
from pathlib import Path

import numpy as np
import pytest
import torch

from vfisr_tpu_torch import bench
from vfisr_tpu_torch.evaluation import speed as tspeed
from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

jspeed = import_module("vfisr_tpu.evaluation.speed")
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("frames_per_call", [1, 3])
def test_stats_match_jax(frames_per_call):
    samples = list(np.random.default_rng(0).gamma(4.0, 2.5, 37))
    ref = jspeed._stats(samples, frames_per_call, 37, 5, "host_wall_clock")
    out = tspeed._stats(samples, frames_per_call, 37, 5, "host_wall_clock")
    assert out.to_dict() == ref.to_dict() and out.samples_ms == ref.samples_ms


def test_measure_on_cpu_with_injected_timer():
    """A clock that advances 2 ms per read and 5 ms more inside each call."""
    now, calls = [0.0], []

    def timer():
        now[0] += 0.002
        return now[0]

    def fn(x):
        calls.append(x)
        now[0] += 0.005

    stats = tspeed.measure(fn, 7, iterations=10, warmup=3, frames_per_call=2, device="cpu",
                           timer=timer)
    assert len(calls) == 13 and stats.method == "host_wall_clock"
    assert stats.n_iterations == 10 and stats.warmup_iterations == 3
    assert np.allclose(stats.samples_ms, 7.0) and abs(stats.p50_ms - 7.0) < 1e-9
    assert abs(stats.throughput_fps - 2000.0 / 7.0) < 1e-6
    assert set(stats.to_dict()) == set(jspeed.SpeedStats(0, 0, 0, 0, 0, 0, 0, 0, 0, 0).to_dict())


@pytest.fixture
def tf32_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_bench_measure_on_cpu(tf32_flags):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    record = bench.measure("cpu", h=64, w=96, pairs=3, warmup=1)
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
    assert {"metric", "value", "unit", "vs_baseline"} <= record.keys()
    assert record["metric"] == "adaptive_vfi_interpolated_fps_1080p_to_1440p_single_chip"
    assert record["unit"] == "fps" and record["pairs"] == 3
    assert record["ms_per_pair_p10"] <= record["ms_per_pair_p50"] <= record["ms_per_pair_p90"]
    assert record["value"] == pytest.approx(3000.0 / record["ms_per_pair_p50"], rel=1e-12)
    assert record["vs_baseline"] == pytest.approx(record["value"] / (441.0 / 70.1), rel=1e-12)
    json.dumps(record)


def test_bench_frames_are_distinct_uint8():
    frames = bench._frames("cpu", 32, 48)
    assert len(frames) == bench.FRAMES and all(f.dtype == torch.uint8 for f in frames)
    assert all(not torch.equal(a, b) for a, b in zip(frames, frames[1:]))


def test_bench_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure()


def test_bench_cli_fails_without_a_card():
    """python -m vfisr_tpu_torch.bench prints no record and exits non-zero
    where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run")
    res = subprocess.run([sys.executable, "-m", "vfisr_tpu_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"metric"' not in res.stdout
