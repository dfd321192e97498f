"""Held-out SR quality comparison: trained SR models against classical
resamplers (port of ``scripts/eval_sr_quality.py``).

    python -m vfisr_tpu_torch.eval_sr_quality --models span,span_x4,lanczos,bicubic

Renders held-out synthetic gaming scenes, downscales each by the model's
factor (area, the harness's degradation, then ``+0.5`` and truncation to
uint8), upscales it back with each model, and reports PSNR and SSIM
against the original. ``--scene smooth`` takes ``train/data.py::
synthetic_batch`` from ``np.random.default_rng(--seed)``, the reference's
scenes. ``--scene detail`` takes ``train/device_data.py::device_sr_batch``
on a ``torch.Generator`` seeded with ``--seed``: the port's own draws (the
reference's come from ``jax.random``, which has no counterpart here), so
its detail scenes are other scenes of the same family. Runs on
``--device`` (``cuda`` by default, ``cpu`` for small runs), TF32 off.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    """Run the CLI; returns {model: (mean finite PSNR dB, mean SSIM)}."""
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.eval_sr_quality",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default="span,span_x4,lanczos,bicubic")
    parser.add_argument("--samples", type=int, default=12)
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--seed", type=int, default=321)
    parser.add_argument(
        "--scene", default="smooth", choices=["smooth", "detail"],
        help="held-out scene family: 'smooth' = host synthetic_batch VFI scenes "
        "(bilinear-warped, little aliased energy: classical resamplers are near-optimal "
        "there); 'detail' = unwarped device_sr_batch scenes (pixel checkers, panel seams, "
        "speckle) where x2 area decimation actually destroys information")
    parser.add_argument("--detail", type=float, default=0.6,
                        help="structure weight for --scene detail")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    import torch

    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple, compute_ssim_simple
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.train.data import synthetic_batch
    from vfisr_tpu_torch.train.device_data import device_sr_batch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.scene == "detail":
        gen = torch.Generator(device=args.device).manual_seed(args.seed)
        gt = device_sr_batch(gen, args.samples, args.crop, detail=args.detail)["gt"]
        hr = np.asarray(np.clip(gt.cpu().numpy() * 255 + 0.5, 0, 255), np.uint8)
    else:
        batch = synthetic_batch(np.random.default_rng(args.seed), args.samples, args.crop)
        hr = (batch["gt"] * 255).astype(np.uint8)

    print(f"scene={args.scene}")
    print(f"{'model':<12}{'scale':>6}{'PSNR':>8}{'SSIM':>8}")
    print("-" * 34)
    rows = {}
    for name in args.models.split(","):
        name = name.strip()
        scale = 4 if name.endswith("_x4") else 2
        # "_x4" selects the 4x variant; classical resamplers take any scale,
        # so the suffix is stripped for their registry lookup too
        reg = "span" if name.startswith("span") else name.removesuffix("_x4")
        kw = {"scale": 4} if name == "span_x4" else {}
        model = get_model(reg, load=True, device=args.device, **kw)
        lo_hw = (args.crop // scale, args.crop // scale)
        psnrs, ssims = [], []
        for i in range(args.samples):
            hr_i = torch.from_numpy(hr[i].astype(np.float32)).to(args.device)
            lo = resize(hr_i, lo_hw, "area").cpu().numpy()
            lo_u8 = np.clip(lo + 0.5, 0, 255).astype(np.uint8)
            up = model.upscale(lo_u8, scale=float(scale))
            psnrs.append(compute_psnr_simple(up, hr[i], args.device))
            ssims.append(compute_ssim_simple(up, hr[i], args.device))
        finite = [p for p in psnrs if np.isfinite(p)]
        rows[name] = (float(np.mean(finite)), float(np.mean(ssims)))
        print(f"{name:<12}{scale:>5}x{rows[name][0]:>8.2f}{rows[name][1]:>8.4f}")
    return rows


if __name__ == "__main__":
    main()
