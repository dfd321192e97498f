"""Statistical analysis core (port of ``vfisr_tpu/evaluation/statistics.py``;
numpy and scipy, on the host).

The reference documents this module (README.md:88-119) and spreads its
behavior across analysis/statistical_analysis.py and
scripts/analyze_statistics.py. This module centralizes the statistics:

- Cohen's d effect size (statistical_analysis.py:82-118)
- mean gain with 95% t-CI (statistical_analysis.py:163-210)
- paired t-tests vs a baseline method (analyze_statistics.py:156-229)
- per-interval normalization vs the 'degraded' baseline
  (statistical_analysis.py:121-160)
- interval difficulty from baseline PSNR (statistical_analysis.py:37-79)
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import stats as sps


def cohens_d(a: Sequence[float], b: Sequence[float]) -> float:
    """Effect size between two samples (pooled SD)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    if len(a) < 2 or len(b) < 2:
        return float("nan")
    pooled = np.sqrt(
        ((len(a) - 1) * a.std(ddof=1) ** 2 + (len(b) - 1) * b.std(ddof=1) ** 2)
        / (len(a) + len(b) - 2)
    )
    if pooled == 0:
        return 0.0
    return float((a.mean() - b.mean()) / pooled)


def effect_size_label(d: float) -> str:
    ad = abs(d)
    if math.isnan(ad):
        return "unknown"
    if ad < 0.2:
        return "negligible"
    if ad < 0.5:
        return "small"
    if ad < 0.8:
        return "medium"
    return "large"


def mean_ci(values: Sequence[float], confidence: float = 0.95) -> Dict[str, float]:
    """Mean with a t-distribution confidence interval."""
    v = np.asarray([x for x in values if x is not None and np.isfinite(x)], float)
    if len(v) == 0:
        return {"mean": None, "ci_low": None, "ci_high": None, "n": 0}
    mean = float(v.mean())
    if len(v) < 2:
        return {"mean": mean, "ci_low": mean, "ci_high": mean, "n": 1}
    sem = v.std(ddof=1) / np.sqrt(len(v))
    t = sps.t.ppf((1 + confidence) / 2, len(v) - 1)
    return {
        "mean": mean,
        "ci_low": float(mean - t * sem),
        "ci_high": float(mean + t * sem),
        "n": int(len(v)),
        "std": float(v.std(ddof=1)),
    }


def paired_t_test(a: Sequence[float], b: Sequence[float]) -> Dict[str, float]:
    """Paired t-test a vs b (same intervals)."""
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    n = min(len(a), len(b))
    if n < 2:
        return {"t": float("nan"), "p": float("nan"), "n": n}
    t, p = sps.ttest_rel(a[:n], b[:n])
    return {"t": float(t), "p": float(p), "n": n,
            "mean_diff": float((a[:n] - b[:n]).mean())}


def normalize_gains(
    per_interval: Dict[int, Dict[str, float]], baseline: str = "degraded"
) -> Dict[str, List[float]]:
    """Per-interval PSNR gain of each method over the baseline method.

    per_interval: {interval_idx: {method: psnr}}.
    Returns {method: [gain per interval]} (intervals lacking the baseline
    are skipped) — the cross-interval normalization of
    statistical_analysis.py:121-160.
    """
    gains: Dict[str, List[float]] = {}
    for _, methods in sorted(per_interval.items()):
        base = methods.get(baseline)
        if base is None or not np.isfinite(base):
            continue
        for method, value in methods.items():
            if method == baseline or value is None or not np.isfinite(value):
                continue
            gains.setdefault(method, []).append(value - base)
    return gains


def interval_difficulty_from_baseline(
    per_interval: Dict[int, Dict[str, float]], baseline: str = "degraded"
) -> Dict[int, str]:
    """Classify intervals by baseline PSNR (statistical_analysis.py:37-79):
    higher baseline PSNR = easier content."""
    values = {
        i: m[baseline]
        for i, m in per_interval.items()
        if baseline in m and np.isfinite(m[baseline])
    }
    if not values:
        return {}
    arr = np.asarray(list(values.values()))
    lo, hi = np.percentile(arr, [33, 67])
    out = {}
    for i, v in values.items():
        out[i] = "hard" if v <= lo else ("easy" if v >= hi else "medium")
    return out


def pareto_frontier(
    points: List[Tuple[str, float, float]]
) -> List[str]:
    """Names on the (maximize quality, minimize time) Pareto frontier.

    points: [(name, quality, time_s)] (data_analysis.py:233-242 sweep).
    """
    frontier = []
    for name, q, t in points:
        dominated = any(
            (q2 >= q and t2 <= t and (q2 > q or t2 < t))
            for n2, q2, t2 in points
            if n2 != name
        )
        if not dominated:
            frontier.append(name)
    return frontier
