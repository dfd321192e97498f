"""The check fails a run whose timed path is broken underneath, and the
control (the reference one precision step below the stated one) fails it
too. The look for a card is skipped; the rest of a run is driven on the
CPU at a small size, the flagship's IFNet in float32 (where the program's
bytes equal the reference's, so each fault shows alone)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, harness
from portbench.tests._tiny import tiny_root, windowed_on_cpu


def _broken_pack(kind: str, cell: str):
    from vfisr_tpu_torch.pipeline import streaming

    pack = streaming.pack_i420

    def broken(frames):
        frames = frames.clone()
        if kind == "half_batch":  # the second half of the pairs left out, the first's taken
            p = 4 if cell == "flagship.streams4" else 1
            per_pair = frames.reshape(frames.shape[0] // p, p, *frames.shape[1:])
            per_pair[:, p // 2:] = per_pair[:, :p // 2]
        elif kind == "answer_altered":  # one midpoint replaced by its pair's x0
            frames[-1] = frames[0]
        return pack(frames)

    return broken


FAULTS = [("flagship.streams4", "state_unchanged"), ("flagship.streams4", "half_batch"),
          ("flagship.streams4", "answer_altered"), ("adaptive.easy", "state_unchanged"),
          ("adaptive.easy", "answer_altered")]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, cell, kind):
    from vfisr_tpu_torch.models.novel import adaptive_pipeline
    from vfisr_tpu_torch.pipeline import flagship, streaming

    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    if kind == "state_unchanged":  # the HUD ring never advances
        monkeypatch.setattr(flagship, "push_history", lambda h, c, f: (h, c))
        monkeypatch.setattr(adaptive_pipeline, "_push_history", lambda h, c, f: (h, c))
    else:
        monkeypatch.setattr(streaming, "pack_i420", _broken_pack(kind, cell))
    root = tiny_root(tmp_path, float32=True)
    res = harness.run(cell, 99, 4.0, False, "cpu", root=root)
    assert len(res["compared_steps"]) >= 2
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("cell", ["flagship.streams4", "adaptive.easy"])
def test_the_unbroken_run_is_correct(tmp_path, monkeypatch, cell):
    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    res = harness.run(cell, 98, 4.0, False, "cpu", root=tiny_root(tmp_path, float32=True))
    assert res["correct"] is True, res["check"]


@pytest.mark.parametrize("cell", ["flagship.streams4", "adaptive.easy", "adaptive.hard"])
def test_the_control_is_not_correct(tmp_path, cell):
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    readings = control.readings(cell, 97, "cpu", root)
    limits = harness.find_cell(cell, root).workload["limits"]
    assert any(readings[k] > lim for k, lim in limits.items()), readings
