"""PSNR-gain normalization (port of ``vfisr_tpu/analysis/normalize_data.py``;
numpy, on the host).

Per-interval gains vs the 'degraded' baseline, median dedup of repeated
(name, interval) cells, efficiency = gain / time_ratio →
``normalized_results.json``.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict

import numpy as np


def normalize(results: dict, baseline: str = "degraded") -> dict:
    # median-dedup repeated (name, interval) cells
    cells: Dict[tuple, list] = defaultdict(list)
    times: Dict[tuple, list] = defaultdict(list)
    for e in results.get("experiments", []):
        v = e.get("vfi_psnr_db")
        if isinstance(v, (int, float)):
            key = (e["name"], e.get("interval_idx", 0))
            cells[key].append(float(v))
            times[key].append(float(e.get("time_s", 0)))
    dedup = {k: float(np.median(v)) for k, v in cells.items()}
    dedup_t = {k: float(np.median(v)) for k, v in times.items()}

    intervals = sorted({k[1] for k in dedup})
    methods = sorted({k[0] for k in dedup})
    normalized = {}
    for method in methods:
        if method == baseline:
            continue
        gains, time_ratios = [], []
        for i in intervals:
            mv = dedup.get((method, i))
            bv = dedup.get((baseline, i))
            if mv is None or bv is None:
                continue
            gains.append(mv - bv)
            bt = dedup_t.get((baseline, i)) or 1e-9
            time_ratios.append((dedup_t.get((method, i)) or 0) / bt)
        if not gains:
            continue
        mean_gain = float(np.mean(gains))
        mean_ratio = float(np.mean(time_ratios)) if time_ratios else float("nan")
        normalized[method] = {
            "mean_gain_db": mean_gain,
            "per_interval_gains": gains,
            "time_ratio": mean_ratio,
            "efficiency": mean_gain / mean_ratio if mean_ratio and mean_ratio > 0 else None,
            "n_intervals": len(gains),
        }
    return {"baseline": baseline, "methods": normalized}


def run(results_path: str | Path, output_dir: str | Path = "outputs") -> dict:
    with open(results_path) as f:
        results = json.load(f)
    report = normalize(results)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "normalized_results.json", "w") as f:
        json.dump(report, f, indent=2)
    return report
