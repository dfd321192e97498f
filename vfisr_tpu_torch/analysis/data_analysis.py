"""Experiment-result analysis (port of ``vfisr_tpu/analysis/data_analysis.py``)
in numpy and plain Python, without pandas.

``load_results`` reads ``experiment_results.json`` into a list of row
dicts, one per experiment; ``rankings``, ``category_stats`` and
``compute_pareto`` aggregate them as the reference's pandas pipeline does:
groups in sorted key order, means that skip NaN (an infinite PSNR, stored
as the string "inf", loads as NaN), sorts that keep ties in their order and
put NaN last. ``generate_report`` writes the markdown report;
``generate_figures`` imports matplotlib when it is called, and raises by
name where it is missing.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

from vfisr_tpu_torch.evaluation.statistics import pareto_frontier

CATEGORY_RULES = [
    ("RIFE", lambda n: n.startswith("rife")),
    ("Adaptive", lambda n: n.startswith("adaptive")),
    ("MCAR", lambda n: n.startswith("mcar")),
    ("UAFI", lambda n: n.startswith("uafi")),
    ("UGHI", lambda n: n.startswith("ughi")),
    ("OpticalFlow", lambda n: n.startswith("optical_flow")),
    ("LinearBlend", lambda n: "blend" in n),
    ("Degraded", lambda n: n.startswith("degraded") or n.startswith("frame_dup")),
    ("Control", lambda n: n.startswith("control")),
]


def categorize_method(name: str) -> str:
    """Method -> category."""
    for cat, rule in CATEGORY_RULES:
        if rule(name):
            return cat
    return "Other"


def load_results(path: str | Path) -> List[dict]:
    """experiment_results.json as one row dict per experiment."""
    with open(path) as f:
        data = json.load(f)
    rows = []
    for e in data.get("experiments", []):
        rows.append({
            "name": e.get("name"),
            "category": categorize_method(e.get("name", "")),
            "interval_idx": e.get("interval_idx", 0),
            "vfi_psnr": _num(e.get("vfi_psnr_db")),
            "vfi_ssim": _num(e.get("vfi_ssim")),
            "vfi_lpips": _num(e.get("vfi_lpips")),
            "keyframe_psnr": _num(e.get("keyframe_psnr_db")),
            "overall_psnr": _num(e.get("overall_psnr_db")),
            "time_s": _num(e.get("time_s")),
            "fps_achieved": _num(e.get("fps_achieved")),
            "rife_pct": _num(e.get("rife_frames_pct")),
            "quality_level": e.get("quality_level", "default"),
        })
    return rows


def _num(v) -> float:
    if v is None or v == "inf" or v == "-inf":
        return math.nan
    return float(v)


def _mean(values) -> float:
    """The mean of the values that are not NaN; NaN where none is."""
    kept = [v for v in values if not math.isnan(v)]
    return float(np.mean(kept)) if kept else math.nan


def _groups(rows: List[dict], key: str) -> Dict[object, List[dict]]:
    """Rows by key, in sorted key order; a row without the key is dropped."""
    out: Dict[object, List[dict]] = {}
    for r in rows:
        if r.get(key) is not None:
            out.setdefault(r[key], []).append(r)
    return dict(sorted(out.items()))


def _sort(rows: List[dict], key: str, descending: bool) -> List[dict]:
    """Rows by key, ties in their order, NaN last."""
    nan = [r for r in rows if math.isnan(r[key])]
    return sorted((r for r in rows if not math.isnan(r[key])), key=lambda r: r[key],
                  reverse=descending) + nan


def _aggregate(rows: List[dict]) -> List[dict]:
    """One row per method: the means of its runs, its run count and category."""
    agg = []
    for name, g in _groups(rows, "name").items():
        row = {"name": name}
        for col in ("vfi_psnr", "vfi_ssim", "vfi_lpips", "keyframe_psnr", "time_s"):
            row[col] = _mean(r[col] for r in g)
        row["n"] = len(g)
        row["category"] = next((r["category"] for r in g if r["category"] is not None), None)
        t = row["time_s"]
        row["efficiency"] = row["vfi_psnr"] / max(t, 1e-9) if not math.isnan(t) else math.nan
        agg.append(row)
    return agg


def rankings(rows: List[dict]) -> Dict[str, List[dict]]:
    """Per-method aggregate rankings."""
    agg = _aggregate(rows)
    return {
        "by_vfi_psnr": _sort(agg, "vfi_psnr", descending=True),
        "by_lpips": _sort(agg, "vfi_lpips", descending=False),
        "by_efficiency": _sort(agg, "efficiency", descending=True),
    }


def category_stats(rows: List[dict]) -> List[dict]:
    stats = [{"category": cat, "vfi_psnr": _mean(r["vfi_psnr"] for r in g),
              "time_s": _mean(r["time_s"] for r in g), "n": len(g)}
             for cat, g in _groups(rows, "category").items()]
    return _sort(stats, "vfi_psnr", descending=True)


def compute_pareto(rows: List[dict]) -> List[str]:
    pts = [(r["name"], r["vfi_psnr"], r["time_s"]) for r in rankings(rows)["by_vfi_psnr"]
           if math.isfinite(r["vfi_psnr"]) and math.isfinite(r["time_s"])]
    return pareto_frontier(pts)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("generate_figures needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def generate_figures(rows: List[dict], out_dir: str | Path) -> List[str]:
    """Quality/speed figures (dark style, the reference's figures 1-5)."""
    plt = _pyplot()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    plt.style.use("dark_background")
    written = []

    def save(fig, name):
        fig.tight_layout()
        p = out_dir / name
        fig.savefig(p, dpi=120)
        plt.close(fig)
        written.append(str(p))

    agg = rankings(rows)["by_vfi_psnr"]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.barh([r["name"] for r in agg], [r["vfi_psnr"] for r in agg], color="#4cc9f0")
    ax.set_xlabel("VFI PSNR (dB)")
    ax.set_title("VFI quality by method")
    save(fig, "vfi_quality.png")

    fig, ax = plt.subplots(figsize=(8, 6))
    pareto = set(compute_pareto(rows))
    for r in agg:
        if not (math.isfinite(r["vfi_psnr"]) and math.isfinite(r["time_s"])):
            continue
        on = r["name"] in pareto
        ax.scatter(r["time_s"], r["vfi_psnr"], c="#f72585" if on else "#4cc9f0",
                   s=60 if on else 30)
        ax.annotate(r["name"], (r["time_s"], r["vfi_psnr"]), fontsize=7)
    ax.set_xscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("VFI PSNR (dB)")
    ax.set_title("Quality vs speed (Pareto frontier highlighted)")
    save(fig, "pareto_frontier.png")

    cs = category_stats(rows)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar([r["category"] for r in cs], [r["vfi_psnr"] for r in cs], color="#b5179e")
    ax.set_ylabel("VFI PSNR (dB)")
    ax.set_title("Category comparison")
    plt.xticks(rotation=30)
    save(fig, "category_comparison.png")

    # PSNR against SSIM: do the two quality axes agree, and where not?
    sub = [r for r in agg if math.isfinite(r["vfi_psnr"]) and math.isfinite(r["vfi_ssim"])]
    if len(sub) >= 2:
        fig, ax = plt.subplots(figsize=(7, 6))
        ps, ss = [r["vfi_psnr"] for r in sub], [r["vfi_ssim"] for r in sub]
        ax.scatter(ps, ss, c="#4cc9f0", s=40)
        for r in sub:
            ax.annotate(r["name"], (r["vfi_psnr"], r["vfi_ssim"]), fontsize=7)
        corr = float(np.corrcoef(ps, ss)[0, 1])
        ax.set_xlabel("VFI PSNR (dB)")
        ax.set_ylabel("VFI SSIM")
        ax.set_title(f"PSNR vs SSIM (r = {corr:.3f})")
        save(fig, "psnr_ssim_correlation.png")

    # the novel methods against their baselines
    inno = [dict(r, group="innovative") for r in agg
            if categorize_method(r["name"]) in ("UAFI", "MCAR", "UGHI", "Adaptive")]
    base = [dict(r, group="baseline") for r in agg
            if categorize_method(r["name"]) in ("RIFE", "LinearBlend", "Degraded")]
    if inno and base:
        both = inno + base
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
        colors = {"innovative": "#f72585", "baseline": "#4cc9f0"}
        for ax, col, label in ((ax1, "vfi_psnr", "VFI PSNR (dB)"), (ax2, "time_s", "time (s)")):
            sub2 = [r for r in both if math.isfinite(r[col])]
            ax.barh([r["name"] for r in sub2], [r[col] for r in sub2],
                    color=[colors[r["group"]] for r in sub2])
            ax.set_xlabel(label)
        ax2.set_xscale("log")
        fig.suptitle("Innovative methods vs baselines")
        save(fig, "innovative_comparison.png")
    return written


def generate_report(rows: List[dict], out_path: str | Path) -> str:
    """Markdown analysis report."""
    ranks = rankings(rows)
    pareto = compute_pareto(rows)
    names = {r["name"] for r in rows if r["name"] is not None}
    intervals = {r["interval_idx"] for r in rows if r["interval_idx"] is not None}
    lines = ["# Analysis Report", ""]
    lines.append(f"Experiments: {len(rows)} rows, {len(names)} methods, "
                 f"{len(intervals)} interval(s)")
    lines += ["", "## Ranking by VFI PSNR", ""]
    lines.append("| method | VFI PSNR | VFI SSIM | LPIPS | KF PSNR | time s |")
    lines.append("|---|---|---|---|---|---|")
    for r in ranks["by_vfi_psnr"]:
        lines.append(
            f"| {r['name']} | {r['vfi_psnr']:.2f} | {r['vfi_ssim']:.4f} | "
            f"{_fmt(r['vfi_lpips'])} | {_fmt(r['keyframe_psnr'])} | {r['time_s']:.1f} |")
    lines += ["", "## Pareto frontier (quality vs time)", ""]
    for name in pareto:
        lines.append(f"- {name}")
    lines += ["", "## Category stats", ""]
    for r in category_stats(rows):
        lines.append(f"- {r['category']}: {r['vfi_psnr']:.2f} dB mean over {r['n']} runs")
    rife = _mean(r["vfi_psnr"] for r in rows if r["category"] == "RIFE")
    rest = _mean(r["vfi_psnr"] for r in rows if r["category"] not in ("RIFE", "Control"))
    if math.isfinite(rife) and math.isfinite(rest):
        lines += ["", f"RIFE vs rest: {rife:.2f} dB vs {rest:.2f} dB ({rife - rest:+.2f} dB)"]
    report = "\n".join(lines) + "\n"
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(report)
    return report


def _fmt(v):
    return f"{v:.4f}" if v is not None and math.isfinite(v) else "—"
