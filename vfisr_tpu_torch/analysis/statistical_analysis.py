"""Statistical analysis of experiment results (port of
``vfisr_tpu/analysis/statistical_analysis.py``; numpy and scipy, on the host).

- interval difficulty from baseline PSNR (:37-79)
- paired same-interval comparisons with Cohen's d (:82-118)
- cross-interval normalization vs the 'degraded' baseline (:121-160)
- per-method mean gain with 95% t-CI (:163-210)
- novel-vs-baseline verdicts with confidence labels (:213-266)
- methodology notes (:269-306)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np

from vfisr_tpu_torch.evaluation.statistics import (
    cohens_d,
    effect_size_label,
    interval_difficulty_from_baseline,
    mean_ci,
    normalize_gains,
    paired_t_test,
)

NOVEL_METHODS = ("uafi_default", "ughi_default", "mcar_default", "mcar_aggressive",
                 "adaptive_default", "adaptive_aggressive", "adaptive_conservative")


def per_interval_table(results: dict) -> Dict[int, Dict[str, float]]:
    """{interval: {method: vfi_psnr}} from experiment_results.json data."""
    table: Dict[int, Dict[str, float]] = {}
    for e in results.get("experiments", []):
        v = e.get("vfi_psnr_db")
        if isinstance(v, (int, float)):
            table.setdefault(e.get("interval_idx", 0), {})[e["name"]] = float(v)
    return table


def analyze(results: dict, baseline: str = "degraded") -> dict:
    """Full statistical analysis → JSON-serializable report."""
    table = per_interval_table(results)
    difficulty = interval_difficulty_from_baseline(table, baseline)
    gains = normalize_gains(table, baseline)

    methods_report = {}
    base_series = {
        i: m[baseline] for i, m in table.items() if baseline in m
    }
    for method, gain_list in sorted(gains.items()):
        ci = mean_ci(gain_list)
        # paired comparison vs baseline on shared intervals
        shared = [
            (m[method], m[baseline])
            for m in table.values()
            if method in m and baseline in m
        ]
        a = [s[0] for s in shared]
        b = [s[1] for s in shared]
        d = cohens_d(a, b)
        t = paired_t_test(a, b)
        methods_report[method] = {
            "gain_db": ci,
            "cohens_d": None if np.isnan(d) else d,
            "effect_size": effect_size_label(d),
            "paired_t": t,
            "is_novel": method in NOVEL_METHODS,
        }

    # novel-vs-baseline verdicts with confidence labels (:213-266)
    verdicts = {}
    for method, rep in methods_report.items():
        if not rep["is_novel"]:
            continue
        mean_gain = rep["gain_db"]["mean"]
        p = rep["paired_t"]["p"]
        n = rep["paired_t"]["n"]
        if mean_gain is None:
            confidence = "no data"
        elif n < 3:
            confidence = "insufficient samples"
        elif p is not None and not np.isnan(p) and p < 0.05:
            confidence = "significant"
        else:
            confidence = "not significant"
        verdicts[method] = {
            "mean_gain_db": mean_gain,
            "p_value": None if p is None or np.isnan(p) else p,
            "confidence": confidence,
        }

    return {
        "baseline": baseline,
        "interval_difficulty": {str(k): v for k, v in difficulty.items()},
        "methods": methods_report,
        "novel_verdicts": verdicts,
        "methodology": (
            "Per-interval VFI PSNR gains are computed against the "
            f"'{baseline}' baseline on the same interval (paired design); "
            "means carry 95% t-distribution CIs; effect sizes are Cohen's d "
            "with pooled SD; significance via paired t-tests. Small n "
            "(intervals) limits power - verdicts are labeled accordingly."
        ),
    }


def run(results_path: str | Path, output_dir: str | Path = "outputs") -> dict:
    """Load results, analyze, write statistical_analysis.json +
    statistical_summary.md."""
    with open(results_path) as f:
        results = json.load(f)
    report = analyze(results)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "statistical_analysis.json", "w") as f:
        json.dump(report, f, indent=2, default=float)

    lines = ["# Statistical Summary", "", f"Baseline: {report['baseline']}", ""]
    lines.append("| method | gain dB (95% CI) | Cohen's d | effect | p |")
    lines.append("|---|---|---|---|---|")
    for m, r in report["methods"].items():
        g = r["gain_db"]
        if g["mean"] is None:
            continue
        p = r["paired_t"]["p"]
        lines.append(
            f"| {m} | {g['mean']:+.2f} [{g['ci_low']:.2f}, {g['ci_high']:.2f}] "
            f"| {r['cohens_d'] if r['cohens_d'] is not None else float('nan'):.2f} "
            f"| {r['effect_size']} | {p if p is not None and not np.isnan(p) else float('nan'):.3f} |"
        )
    lines += ["", "## Novel-method verdicts", ""]
    for m, v in report["novel_verdicts"].items():
        mg = v["mean_gain_db"]
        lines.append(f"- {m}: {mg:+.2f} dB ({v['confidence']})" if mg is not None
                     else f"- {m}: no data")
    lines += ["", report["methodology"], ""]
    (out / "statistical_summary.md").write_text("\n".join(lines))
    return report
