"""Gate a freshly trained checkpoint against an incumbent model (port of
``scripts/gate_checkpoint.py``).

A checkpoint on disk may be an early, undertrained cut of a run that was
stopped, and the models load ``weights/<name>.npz`` whenever it exists, so
a weak checkpoint would silently degrade every consumer (most of all the
adaptive pipeline, which routes the hardest pairs to its heavy expert).
This CLI scores the candidate's checkpoint (``--weights``) against an
incumbent on held-out synthetic scenes (``train/data.py::synthetic_batch``
from ``np.random.default_rng(--seed)``, mean finite PSNR of the
midpoints) and decides:

- no file at ``--weights``: skip;
- candidate >= incumbent - ``--margin``: keep;
- else demote: move the checkpoint to ``--demote-to``. With
  ``--incumbent-weights`` (the same model at another checkpoint, scored
  as the candidate's model with that file) the incumbent's file is first
  copied beside ``--weights``, then the candidate is moved aside and the
  copy takes its place, so the path always holds the better checkpoint.

The decision is printed as JSON and written to ``--record``. Models run on
``--device`` (``cuda`` by default, ``cpu`` for small runs), TF32 off.

    python -m vfisr_tpu_torch.gate_checkpoint --candidate rife --incumbent rife \\
        --incumbent-weights weights/rife_8k.npz --weights weights/rife.npz \\
        --demote-to weights/rife_partial.npz --record outputs/gate_rife.json
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
from pathlib import Path
from typing import Optional

import numpy as np


def heldout_psnr(model_name: str, samples: int, crop: int, seed: int,
                 weights_path: Optional[str] = None, device: str = "cuda") -> float:
    """Mean finite PSNR (dB) of the model's midpoints on the held-out scenes;
    -inf where none is finite. With ``weights_path`` the model loads that
    file (a model whose ``load`` takes no path is refused)."""
    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.train.data import synthetic_batch

    batch = synthetic_batch(np.random.default_rng(seed), samples, crop)
    f0s = (batch["img0"] * 255).astype(np.uint8)
    f1s = (batch["img1"] * 255).astype(np.uint8)
    gts = (batch["gt"] * 255).astype(np.uint8)
    ts = batch["t"]
    if weights_path is None:
        model = get_model(model_name, load=True, device=device)
    else:
        # score the exact file (the registry's default path could name
        # another one); only the trainable models take a path
        model = get_model(model_name, device=device)
        if not inspect.signature(model.load).parameters:
            raise SystemExit(
                f"model '{model_name}' takes no weights path in load() — checkpoint gating "
                "only applies to trainable models (rife/rife_lite/span/safa/vfimamba/vfimamba_s)")
        model.load(weights_path)
    psnrs = []
    for i in range(samples):
        mid = model.interpolate(f0s[i], f1s[i], 1, [float(ts[i])])[0]
        p = compute_psnr_simple(mid, gts[i], device)
        if np.isfinite(p):
            psnrs.append(p)
    return float(np.mean(psnrs)) if psnrs else float("-inf")


def main(argv=None) -> dict:
    """Run the CLI; returns the decision record."""
    ap = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.gate_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--candidate", required=True)
    ap.add_argument("--incumbent", required=True)
    ap.add_argument("--incumbent-weights", default=None,
                    help="gate against an explicit incumbent checkpoint file (same-model "
                    "resume gating): the incumbent is evaluated as CANDIDATE's model with "
                    "these weights, and on demotion this file is restored to --weights so "
                    "auto-load keeps the better checkpoint")
    ap.add_argument("--weights", required=True,
                    help="candidate checkpoint path (auto-loaded by the registry); absent "
                    "file = nothing to gate")
    ap.add_argument("--demote-to", required=True,
                    help="rename target if the candidate underperforms")
    ap.add_argument("--margin", type=float, default=0.0,
                    help="demote when candidate < incumbent - margin (dB)")
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--record", default=None, help="write the decision as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu (small runs)")
    args = ap.parse_args(argv)

    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record: dict = {"candidate": args.candidate, "incumbent": args.incumbent,
                    "weights": args.weights}
    if not os.path.exists(args.weights):
        record["decision"] = "skip (no candidate checkpoint on disk)"
    else:
        cand = heldout_psnr(args.candidate, args.samples, args.crop, args.seed,
                            weights_path=args.weights, device=args.device)
        if args.incumbent_weights is not None:
            record["incumbent_weights"] = args.incumbent_weights
            inc = heldout_psnr(args.candidate, args.samples, args.crop, args.seed,
                               weights_path=args.incumbent_weights, device=args.device)
        else:
            inc = heldout_psnr(args.incumbent, args.samples, args.crop, args.seed,
                               device=args.device)
        record["candidate_psnr_db"] = round(cand, 2)
        record["incumbent_psnr_db"] = round(inc, 2)
        if cand < inc - args.margin:
            if args.incumbent_weights is not None:
                # stage the incumbent's copy before the candidate moves, so a
                # failed copy cannot leave the path empty
                staged = args.weights + ".gate_restore"
                shutil.copyfile(args.incumbent_weights, staged)
                os.replace(args.weights, args.demote_to)
                os.replace(staged, args.weights)
                record["decision"] = (f"demoted to {args.demote_to}; restored incumbent "
                                      f"checkpoint {args.incumbent_weights} to {args.weights}")
            else:
                os.replace(args.weights, args.demote_to)
                record["decision"] = (f"demoted to {args.demote_to} (candidate underperforms; "
                                      "auto-load falls back to the incumbent)")
        else:
            record["decision"] = "kept (candidate >= incumbent)"
    print(json.dumps(record))
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
