"""The result line's keys, and the refusals: no card, no program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests._tiny import tiny_root, windowed_on_cpu

REPO = harness.ROOT.parent


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(tmp_path, monkeypatch, trace):
    windowed_on_cpu(monkeypatch)
    torch.set_num_threads(2)
    root = tiny_root(tmp_path)
    res = harness.run("flagship.stream1", 4242, 1.5, bool(trace), "cpu", root=root)
    line = json.loads(harness.result_line(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "check"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    wl = harness.load_json("workloads", "flagship.stream1")
    if trace:
        assert set(line["metrics"]) <= set(harness.metric_readers())
    else:
        assert set(line["metrics"]) == set(wl["end_to_end"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "flagship.streams4",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _run_cli(REPO, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run_cli(tmp_path, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
