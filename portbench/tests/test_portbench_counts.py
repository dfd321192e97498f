"""The FLOP and byte counters against hand counts, and against what the
program itself runs at a small size."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.reference.precision import FULL
from portbench.reference.warp import recording, windowed_warp
from portbench.tests._tiny import tiny_root, windowed_on_cpu


def test_conv_flops_hand_count():
    x = torch.empty((2, 12, 40, 64), device="meta")
    w = torch.empty((80, 12, 3, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        FULL.conv2d(x, w, None, 2, 1)
    assert fc.get_total_flops() == 2 * 2 * 80 * 12 * 9 * 20 * 32


def test_warp_bytes_hand_count():
    img = torch.rand((2, 40, 300, 3)).to(torch.bfloat16)
    flow = torch.zeros((2, 40, 300, 2), dtype=torch.bfloat16)
    with recording() as calls:
        windowed_warp(img, flow, 1.0, (2, 2), "replicate", torch.bfloat16)
    assert calls == [((2, 40, 300, 3), torch.bfloat16, torch.bfloat16,
                      2 * 2 * 40 * 300 * 3 * 2 + 2 * 40 * 300 * 2 * 2)]


@pytest.mark.parametrize("cell", ["flagship.streams4", "adaptive.easy", "adaptive.hard"])
def test_counts_match_the_program(tmp_path, monkeypatch, cell):
    """The reference on the meta device makes the warps the program makes
    (shapes and dtypes, in order) and counts the FLOPs of the program's
    step, at a small size."""
    import vfisr_tpu_torch.core.warp as core_warp

    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    c = harness.find_cell(cell, root)
    counts = harness.count_steps(c)
    route = {"flagship.streams4": "flagship", "adaptive.easy": "rife",
             "adaptive.hard": "vfimamba"}[cell]
    with recording() as ref_calls:
        c.driver.step_on_meta(c.config, int(c.traffic["streams"]), route)

    from portbench import streams as streams_mod, weights as weights_mod

    streams = streams_mod.Streams(c.traffic, 9, c.config["in_hw"], "cpu")
    params = {g: weights_mod.make(s, 9, "cpu") for g, s in c.driver.weight_shapes(c.config).items()}
    program = c.driver.Program(c.config, params, streams, "cpu")
    seen = []
    apply = core_warp._WindowedWarp.apply

    def counting(img, flow, *rest):
        seen.append((tuple(img.shape), img.dtype, flow.dtype))
        return apply(img, flow, *rest)

    monkeypatch.setattr(core_warp._WindowedWarp, "apply", counting)
    with FlopCounterMode(display=False) as fc:
        _, got_route = program.step(3)
    assert got_route == route
    assert seen == [c3[:3] for c3 in ref_calls]
    assert counts[route]["warps"] == len(seen)
    # the program also takes a Laplacian of the gray x0 for its particle
    # score, which no output reads and the reference leaves out
    h, w = c.config.get("analysis_hw", c.config["in_hw"])
    laplacian = 2 * 9 * int(c.traffic["streams"]) * h * w
    assert counts[route]["flops"] + laplacian == fc.get_total_flops()
    assert counts[route]["flops"] > 0
