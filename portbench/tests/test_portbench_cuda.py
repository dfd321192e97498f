"""On the card: a short run of each configuration proves correct, and the
control does not. Run there with

    python -m pytest portbench/tests/test_portbench_cuda.py -q -m cuda
"""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the windowed warp's kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship.streams4", "adaptive.easy"])
def test_short_run_is_correct(card, cell):
    res = harness.run(cell, 2 ** 31 + 5, 3.0, False, "cuda")
    assert res["correct"] is True, res["check"]
    assert res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship.streams4", "adaptive.easy"])
def test_control_is_not_correct(card, cell):
    readings = control.readings(cell, 2 ** 31 + 6)
    limits = harness.find_cell(cell).workload["limits"]
    assert any(readings[k] > lim for k, lim in limits.items()), readings
