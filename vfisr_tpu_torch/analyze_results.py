"""Console ranking of experiment results (port of ``scripts/analyze_results.py``):

    python -m vfisr_tpu_torch.analyze_results --results outputs/experiment_results.json
"""

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.analyze_results",
                                     description="Console ranking of experiment results")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    args = parser.parse_args(argv)

    from vfisr_tpu_torch.analysis.data_analysis import load_results, rankings

    rows = load_results(args.results)
    if not rows:
        print("No experiments found.")
        return
    print(f"{'method':<28}{'VFI PSNR':>10}{'SSIM':>8}{'time s':>8}{'n':>4}")
    print("-" * 58)
    for r in rankings(rows)["by_vfi_psnr"]:
        print(f"{r['name']:<28}{r['vfi_psnr']:>10.2f}{r['vfi_ssim']:>8.4f}"
              f"{r['time_s']:>8.1f}{r['n']:>4}")


if __name__ == "__main__":
    main()
