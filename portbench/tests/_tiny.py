"""A copy of the benchmark's files at a size the CPU runs in seconds, and
the program's windowed warp on the CPU (its plain twin; the CPU's default
is the exact warp, whose semantics the reference does not state)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import harness

SIZES = {"in_hw": [108, 192], "out_hw": [144, 256], "analysis_hw": [27, 48]}


def tiny_root(tmp: Path, pool: int = 6, float32: bool = False) -> Path:
    """float32: the flagship's IFNet in float32, where the program's bytes
    equal the reference's (at this size bfloat16's window-origin flips
    touch a larger share of a frame than at 1080p)."""
    for d in ("configs", "traffic", "workloads", "drivers", "metrics", "data"):
        shutil.copytree(harness.ROOT / d, tmp / d, dirs_exist_ok=True)
    for p in (tmp / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update({k: v for k, v in SIZES.items() if k in c})
        if float32 and "ifnet" in c:
            c["ifnet"]["dtype"] = "float32"
        p.write_text(json.dumps(c))
    for p in (tmp / "traffic").glob("*.json"):
        c = json.loads(p.read_text())
        c["pool"] = pool
        p.write_text(json.dumps(c))
    return tmp


def windowed_on_cpu(monkeypatch):
    import vfisr_tpu_torch.core.warp as core_warp

    monkeypatch.setattr(core_warp, "default_warp_backend", lambda device: "windowed")
