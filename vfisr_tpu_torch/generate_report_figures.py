r"""Figures 1-4 and the results table of an experiment sweep (port of
``scripts/generate_report_figures.py``; host only; the figures need
matplotlib, imported on call):

    python -m vfisr_tpu_torch.generate_report_figures \
        [--results outputs/experiment_results.json] [--output-dir outputs/report_figures]

``table1_results.tex`` is the reference's table, with LaTeX's ``\_`` for an
underscore where the reference writes ``\\_`` (a line break in LaTeX).
"""

import argparse
import math
import re
from pathlib import Path


def results_table(ranked: list) -> str:
    """The ranking's finite rows as a booktabs tabular."""
    lines = [r"\begin{tabular}{lrr}", r"\toprule",
             r"Method & VFI PSNR (dB) & Time (s) \\", r"\midrule"]
    for r in ranked:
        if math.isfinite(r["vfi_psnr"]):
            name = r["name"].replace("_", r"\_")
            lines.append(f"{name} & {r['vfi_psnr']:.2f} & {r['time_s']:.1f} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.generate_report_figures",
                                     description="Figures 1-4 and the results table")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    parser.add_argument("--output-dir", default="outputs/report_figures")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.analysis.data_analysis import (_pyplot, category_stats, load_results,
                                                        rankings)

    rows = load_results(args.results)
    if not rows:
        raise SystemExit("No experiments found.")
    plt = _pyplot()
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    agg = rankings(rows)["by_vfi_psnr"]

    def save(fig, name):
        fig.tight_layout()
        fig.savefig(out / name, dpi=150)
        plt.close(fig)

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.barh([r["name"] for r in agg], [r["vfi_psnr"] for r in agg], color="steelblue")
    ax.set_xlabel("VFI PSNR (dB)")
    ax.set_title("Figure 1: VFI quality by method")
    save(fig, "fig1_vfi_quality.png")

    fig, ax = plt.subplots(figsize=(7, 5))
    ax.scatter([r["time_s"] for r in agg], [r["vfi_psnr"] for r in agg], c="darkorange")
    for r in agg:
        if math.isfinite(r["vfi_psnr"]):
            ax.annotate(r["name"], (r["time_s"], r["vfi_psnr"]), fontsize=7)
    ax.set_xscale("log")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("VFI PSNR (dB)")
    ax.set_title("Figure 2: Quality vs speed")
    save(fig, "fig2_quality_speed.png")

    cats = category_stats(rows)
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.bar([c["category"] for c in cats], [c["vfi_psnr"] for c in cats], color="seagreen")
    ax.set_ylabel("VFI PSNR (dB)")
    ax.set_title("Figure 3: Category comparison")
    plt.xticks(rotation=30)
    save(fig, "fig3_categories.png")

    routed = [r for r in rows if not math.isnan(r["rife_pct"])
              and re.search("adaptive|mcar|rife", r["name"])]
    if routed:
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.scatter([r["rife_pct"] for r in routed], [r["vfi_psnr"] for r in routed], c="crimson")
        for r in routed:
            ax.annotate(r["name"], (r["rife_pct"], r["vfi_psnr"]), fontsize=7)
        ax.set_xlabel("RIFE usage (%)")
        ax.set_ylabel("VFI PSNR (dB)")
        ax.set_title("Figure 4: RIFE-usage impact")
        save(fig, "fig4_rife_usage.png")

    (out / "table1_results.tex").write_text(results_table(agg))
    print(f"Wrote 4 figures + table1_results.tex to {out}")


if __name__ == "__main__":
    main()
