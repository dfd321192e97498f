"""The router's calibration record (port of the parts of
``vfisr_tpu/utils/router_gate.py`` the flagship uses).

Reads ``weights/router_gate.json`` (written by
``scripts/calibrate_router.py``): here only the flow-compensated scene-cut
threshold.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

DEFAULT_PATH = Path(__file__).resolve().parents[2] / "weights" / "router_gate.json"

_cache: dict = {}


def load_gate(path: Optional[str] = None) -> Optional[dict]:
    """The calibration record; None when absent or unreadable."""
    p = Path(path) if path else DEFAULT_PATH
    key = str(p)
    if key not in _cache:
        try:
            _cache[key] = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            _cache[key] = None
    return _cache[key]


def scene_warp_threshold(path: Optional[str] = None) -> Optional[float]:
    """Calibrated warped-SSIM threshold of the scene-cut gate; None when
    uncalibrated (the gate is then the reference's SSIM-only test)."""
    gate = load_gate(path)
    if not gate:
        return None
    sg = gate.get("scene_gate")
    if not sg:
        return None
    val = sg.get("warped_ssim_threshold")
    return float(val) if val is not None else None
