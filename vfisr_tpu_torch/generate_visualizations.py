"""Figures and a LaTeX table of experiment results (port of
``scripts/generate_visualizations.py``; the figures need matplotlib):

    python -m vfisr_tpu_torch.generate_visualizations \\
        --results outputs/experiment_results.json --output-dir outputs/figures

The table goes to ``paper_table.tex`` beside the figures' directory.
"""

import argparse
import math
from pathlib import Path


def latex_table(ranked: list) -> str:
    """The ranking as a booktabs tabular."""
    def fmt(v, d=2):
        return f"{v:.{d}f}" if v is not None and math.isfinite(v) else "--"

    lines = [r"\begin{tabular}{lrrrr}", r"\toprule",
             r"Method & VFI PSNR (dB) & VFI SSIM & KF PSNR (dB) & Time (s) \\", r"\midrule"]
    for r in ranked:
        name = r["name"].replace("_", r"\_")
        lines.append(f"{name} & {fmt(r['vfi_psnr'])} & {fmt(r['vfi_ssim'], 4)} & "
                     f"{fmt(r['keyframe_psnr'])} & {fmt(r['time_s'], 1)} \\\\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.generate_visualizations",
                                     description="Figures and a LaTeX table of results")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    parser.add_argument("--output-dir", default="outputs/figures")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.analysis.data_analysis import generate_figures, load_results, rankings

    rows = load_results(args.results)
    if not rows:
        raise SystemExit("No experiments found.")
    for p in generate_figures(rows, args.output_dir):
        print(f"  wrote {p}")
    tex = Path(args.output_dir).parent / "paper_table.tex"
    tex.write_text(latex_table(rankings(rows)["by_vfi_psnr"]))
    print(f"  wrote {tex}")


if __name__ == "__main__":
    main()
