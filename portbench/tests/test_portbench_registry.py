"""The harness finds every configuration, mix, cell and metric by name,
refuses an unknown name, and takes a new cell from added files alone."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests._tiny import tiny_root, windowed_on_cpu

BENCH = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.find_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == entry["config"] and c.workload["traffic"] == entry["traffic"]
    assert int(c.workload["chips"]) == entry["chips"]
    assert c.config["name"] == entry["config"]
    for name in c.workload["end_to_end"]:
        metric = next(m for m in BENCH["end_to_end"] if m["name"] == name)
        assert cell in metric.get("workloads", [cell])
    assert set(c.workload["limits"]) <= {"frame_mad", "frame_off_pct"}


def test_configs_and_metrics_match_the_benchmark_file():
    for cfg in BENCH["configs"]:
        assert Path(harness.ROOT.parent / cfg["file"]).is_file()
        assert harness.load_json("configs", cfg["name"])["reduced"] == cfg["reduced"]
    readers = harness.metric_readers()
    assert sorted(readers) == sorted(m["name"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


@pytest.mark.parametrize("kind,name", [("workloads", "nosuch.cell"), ("configs", "nosuch"),
                                       ("traffic", "nosuch")])
def test_unknown_names_raise(kind, name):
    with pytest.raises(KeyError, match="nosuch"):
        harness.load_json(kind, name)


def test_unknown_cell_and_driver_raise(tmp_path):
    with pytest.raises(KeyError):
        harness.find_cell("nosuch.cell")
    root = tiny_root(tmp_path)
    cfg = json.loads((root / "configs" / "flagship.json").read_text())
    cfg["driver"] = "nosuch"
    (root / "configs" / "flagship.json").write_text(json.dumps(cfg))
    with pytest.raises(KeyError, match="driver nosuch"):
        harness.find_cell("flagship.streams4", root)


def test_a_cell_added_as_files_alone_runs(tmp_path, monkeypatch):
    """A later change adds a mix and a cell as two data files; the harness
    runs it unchanged."""
    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    mix = json.loads((root / "traffic" / "stream1.json").read_text())
    mix.update({"streams": 2, "pan_px": [1.0, 1.5]})
    (root / "traffic" / "slowpan2.json").write_text(json.dumps(mix))
    cell = json.loads((root / "workloads" / "flagship.stream1.json").read_text())
    cell.update({"traffic": "slowpan2", "check_steps": 2})
    (root / "workloads" / "flagship.slowpan2.json").write_text(json.dumps(cell))
    res = harness.run("flagship.slowpan2", 123, 1.0, False, "cpu", root=root)
    assert res["attempted"] >= 1 and res["compared_steps"]
    assert res["metrics"]["output_fps"]["value"] > 0
