"""Quick VFI-quality comparison on held-out synthetic gaming scenes:
trained or loaded models against classical baselines, PSNR and SSIM of
the midpoints (port of ``scripts/eval_vfi_quality.py``).

    python -m vfisr_tpu_torch.eval_vfi_quality --models rife,lanczos,optical_flow

The scenes are ``train/data.py::synthetic_batch`` from
``np.random.default_rng(--seed)``, the reference's held-out set. Models
and metrics run on ``--device`` (``cuda`` by default, ``cpu`` for small
runs), with TF32 off.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Run the CLI; returns {model: (mean finite PSNR dB, mean SSIM)}."""
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.eval_vfi_quality",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="rife,lanczos,optical_flow")
    parser.add_argument("--samples", type=int, default=16)
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    import torch

    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple, compute_ssim_simple
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.train.data import synthetic_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    batch = synthetic_batch(rng, args.samples, args.crop)
    f0s = (batch["img0"] * 255).astype(np.uint8)
    f1s = (batch["img1"] * 255).astype(np.uint8)
    gts = (batch["gt"] * 255).astype(np.uint8)
    ts = batch["t"]

    print(f"{'model':<16}{'PSNR':>8}{'SSIM':>8}")
    print("-" * 32)
    rows = {}
    for name in args.models.split(","):
        name = name.strip()
        model = get_model(name, load=True, device=args.device)
        psnrs, ssims = [], []
        for i in range(args.samples):
            mid = model.interpolate(f0s[i], f1s[i], 1, [float(ts[i])])[0]
            psnrs.append(compute_psnr_simple(mid, gts[i], args.device))
            ssims.append(compute_ssim_simple(mid, gts[i], args.device))
        finite = [p for p in psnrs if np.isfinite(p)]
        rows[name] = (float(np.mean(finite)), float(np.mean(ssims)))
        print(f"{name:<16}{rows[name][0]:>8.2f}{rows[name][1]:>8.4f}")
    return rows


if __name__ == "__main__":
    main()
