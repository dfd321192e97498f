"""Calibrate the LPIPS linear heads on synthetic ranked distortions (port of
``scripts/calibrate_lpips.py``):

    python -m vfisr_tpu_torch.calibrate_lpips --patches 48 --steps 600 \\
        --out outputs/lpips_heads.npz

Learns non-negative per-channel heads over the deterministic random-feature
AlexNet (``evaluation/lpips_calibrate.py``) on ``--device`` (``cuda`` by
default; ``cpu`` for small runs), TF32 off. Writes the heads to ``--out``
(never the shipped ``weights/lpips_heads.npz``) and the report
``LPIPS_CALIBRATION.md`` beside it; prints the report as JSON.
"""

import argparse
import json
from pathlib import Path


def report_markdown(report: dict) -> str:
    """The calibration's report: what the heads are and how they rank."""
    sp, spu = report["spearman"], report["spearman_uniform"]
    rows = "\n".join(f"| {fam} | {spu[fam]:.3f} | {sp[fam]:.3f} |" for fam in sorted(sp))
    return f"""# LPIPS head calibration (no-egress substitute)

The reference's quality tables use AlexNet-LPIPS with heads trained on
human 2AFC data. Those weights cannot be downloaded here, so the heads are
learned (``vfisr_tpu_torch/evaluation/lpips_calibrate.py``):

- features: deterministic He-init AlexNet (the random-feature LPIPS
  proxy), unchanged;
- supervision: synthetic gaming-domain patches x 7 distortion families x
  5 severities. Within-family pairs are ranked by severity; cross-family
  pairs only where PSNR and SSIM agree with margin (> 1 dB and > 0.01);
- heads: softplus-parameterised non-negative per-channel weights, trained
  with a logistic ranking loss ({report['train']['n_pairs']} train /
  {report['holdout']['n_pairs']} held-out pairs).

Heads: `{report['weights_path']}`.

## Results

2AFC ranking accuracy (held out): **{report['holdout']['accuracy_2afc']:.3f}**
(uniform heads: {report['holdout_uniform']['accuracy_2afc']:.3f}).

Within-family Spearman rank correlation of distance vs severity:

| family | uniform heads | calibrated heads |
|---|---|---|
{rows}

Absolute values are not comparable to official LPIPS; the rank orderings
are the validated claim.
"""


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.calibrate_lpips",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--patches", type=int, default=48)
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="outputs/lpips_heads.npz",
                        help="heads file to write (not the shipped weights/lpips_heads.npz)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vfisr_tpu_torch.evaluation.lpips_calibrate import calibrate

    report = calibrate(args.out, seed=args.seed, n_patches=args.patches, steps=args.steps,
                       device=args.device)
    print(json.dumps(report, indent=2, default=str))
    doc = Path(args.out).resolve().parent / "LPIPS_CALIBRATION.md"
    doc.write_text(report_markdown(report))
    print(f"wrote {doc}")
    return report


if __name__ == "__main__":
    main()
