"""Publication figures (counterpart of ``scripts/generate_figures.py``):
runs ``python -m vfisr_tpu_torch.generate_visualizations`` and then
``python -m vfisr_tpu_torch.generate_report_figures``, each in its own
process with ``--results`` and ``--output-dir``, and exits with the first
non-zero return code (the figures need matplotlib; where it is missing the
child says so by name).

    python -m vfisr_tpu_torch.generate_figures [--results R] [--output-dir D]
"""

import argparse
import subprocess
import sys

SCRIPTS = ("vfisr_tpu_torch.generate_visualizations", "vfisr_tpu_torch.generate_report_figures")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.generate_figures",
                                     description="Generate the publication figures")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    parser.add_argument("--output-dir", default="outputs/figures")
    args = parser.parse_args(argv)
    for module in SCRIPTS:
        rc = subprocess.call([sys.executable, "-m", module, "--results", args.results,
                              "--output-dir", args.output_dir])
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
