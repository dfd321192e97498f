"""The reference against the program's output at a small size on the CPU
(the only test that imports both), and the routes of the adaptive mixes'
pan speeds at 1080p."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, streams as streams_mod, weights as weights_mod
from portbench.reference import pipeline
from portbench.tests._tiny import tiny_root, windowed_on_cpu


def _steps(c, seed, steps, dtype=None):
    from vfisr_tpu_torch.pipeline.streaming import pack_i420

    if dtype:
        c.config["ifnet"]["dtype"] = dtype
    streams = streams_mod.Streams(c.traffic, seed, c.config["in_hw"], "cpu")
    params = {g: weights_mod.make(s, seed, "cpu") for g, s in c.driver.weight_shapes(c.config).items()}
    program = c.driver.Program(c.config, params, streams, "cpu")
    kept, routes = {}, {}
    for g in range(max(steps) + 1):
        frames, routes[g] = program.step(g)
        if g in steps:
            kept[g] = pack_i420(frames)
    return harness.compare(c, params, streams, kept), routes


@pytest.mark.parametrize("cell,steps", [("flagship.streams4", [0, 4, 5, 7]),
                                        ("flagship.stream1", [6, 7]),
                                        ("adaptive.easy", [5, 6]), ("adaptive.hard", [5, 6])])
def test_float32_program_equals_reference(tmp_path, monkeypatch, cell, steps):
    """In float32 the program and the reference give the same bytes: the
    HUD ring (steps past 5), a scene cut (step 5, scenes of 6 frames), the routes."""
    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    c = harness.find_cell(cell, tiny_root(tmp_path))
    numbers, routes = _steps(c, 31337, steps, "float32" if "ifnet" in c.config else None)
    assert numbers == {"frame_mad": 0.0, "frame_off_pct": 0.0}
    if cell.startswith("adaptive"):
        assert routes[6] == ("rife" if cell == "adaptive.easy" else "vfimamba")


def test_bfloat16_program_within_limits(tmp_path, monkeypatch):
    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    c = harness.find_cell("flagship.streams4", tiny_root(tmp_path))
    numbers, _ = _steps(c, 4711, [3, 6])
    assert 0.0 < numbers["frame_mad"] <= c.workload["limits"]["frame_mad"]


@pytest.mark.parametrize("mix,route", [("hard", "vfimamba"), ("easy", "rife")])
@pytest.mark.parametrize("end", [0, 1])
def test_pan_speeds_fall_in_their_bins(mix, route, end):
    """The frozen full-resolution Farneback on one 1080p pair at each end of
    the mix's speed range: motion_mean in the intended bin of the router
    gate in both scenes, no cut on a pan, a cut where the scenes change."""
    torch.set_num_threads(4)
    m = json.loads((harness.ROOT / "traffic" / f"{mix}.json").read_text())
    pan = m["pan_px"][end]
    s = streams_mod.Streams(dict(m, pan_px=[pan, pan], pool=32), 2024, (1080, 1920), "cpu")
    bins = pipeline.load_bins(harness.ROOT / "data" / "router_gate.json")
    cfg = harness.load_json("configs", "adaptive")
    hist, cnt = pipeline.history_of([], 1, "cpu")
    for g, cut in ((5, False), (31, True), (37, False), (63, True)):
        x0, x1 = s.pair(g)
        h2, c2 = pipeline.push_history(hist, cnt, x0)
        sig = pipeline.analyze_full(x0, x1, h2, c2, cfg)
        assert bool(sig["scene"][0]) == cut
        if not cut:
            motion = float(sig["motion_mean"][0])
            assert pipeline.bin_winner(bins, motion) == route
            lo, hi = {"hard": (6.104, 10.557), "easy": (1.218, 4.701)}[mix]
            assert lo < motion < hi

