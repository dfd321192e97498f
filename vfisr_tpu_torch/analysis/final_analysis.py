"""Interval-grouped final analysis (port of
``vfisr_tpu/analysis/final_analysis.py``; numpy, on the host).

Groups results by interval for fair comparison → ``final_analysis.json``
with hard_content / easy_content / novel_methods views.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from vfisr_tpu_torch.analysis.statistical_analysis import NOVEL_METHODS, per_interval_table
from vfisr_tpu_torch.evaluation.statistics import interval_difficulty_from_baseline


def analyze(results: dict, baseline: str = "degraded") -> dict:
    table = per_interval_table(results)
    difficulty = interval_difficulty_from_baseline(table, baseline)

    def view(keep_intervals):
        methods = {}
        for i in keep_intervals:
            for m, v in table.get(i, {}).items():
                methods.setdefault(m, []).append(v)
        return {
            m: {"mean_vfi_psnr": float(np.mean(vs)), "n": len(vs)}
            for m, vs in sorted(methods.items(), key=lambda kv: -np.mean(kv[1]))
        }

    hard = [i for i, d in difficulty.items() if d == "hard"]
    easy = [i for i, d in difficulty.items() if d == "easy"]
    all_intervals = list(table)
    novel = {
        m: stats
        for m, stats in view(all_intervals).items()
        if m in NOVEL_METHODS
    }
    return {
        "hard_content": view(hard),
        "easy_content": view(easy),
        "all_content": view(all_intervals),
        "novel_methods": novel,
        "interval_difficulty": {str(k): v for k, v in difficulty.items()},
    }


def run(results_path: str | Path, output_dir: str | Path = "outputs") -> dict:
    with open(results_path) as f:
        results = json.load(f)
    report = analyze(results)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "final_analysis.json", "w") as f:
        json.dump(report, f, indent=2)
    return report
