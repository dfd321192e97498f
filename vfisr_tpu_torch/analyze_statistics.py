"""The statistical report of a sweep's results (port of
``scripts/analyze_statistics.py``):

    python -m vfisr_tpu_torch.analyze_statistics --results outputs/experiment_results.json

Writes ``statistical_analysis.json`` and ``statistical_summary.md`` to
``--output-dir`` (numpy and scipy on the host; no device).
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Statistical analysis of experiment results")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    parser.add_argument("--output-dir", default="outputs")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.analysis.statistical_analysis import run

    report = run(args.results, args.output_dir)
    print(f"Wrote statistical_analysis.json + statistical_summary.md to {args.output_dir}")
    for m, v in report["novel_verdicts"].items():
        mg = v["mean_gain_db"]
        print(f"  {m}: {mg:+.2f} dB ({v['confidence']})" if mg is not None else f"  {m}: no data")


if __name__ == "__main__":
    main()
