"""Train RIFE on synthetic gaming scenes made on the device (port of
``scripts/train.py`` for ``--model rife|rife_lite``).

    python -m vfisr_tpu_torch.train --model rife --steps 2000 --batch 16
    python -m vfisr_tpu_torch.train --model rife_lite --steps 2 --batch 2 \\
        --crop 96 --device cpu --out /tmp/rife_lite.npz

Starts from weights/<model>.npz (or --resume), writes weights/<model>.npz
(or --out) in the JAX package's layout, and refuses to overwrite an
existing default checkpoint unless --out is given or --resume names it.
Still to port (ROADMAP): the other models, triplet data (--data) and the
host-side generators.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from vfisr_tpu_torch.models.sota.rife import RIFELiteModel, RIFEModel
from vfisr_tpu_torch.train.device_data import device_synthetic_batch
from vfisr_tpu_torch.train.train import create_train_state, make_train_step
from vfisr_tpu_torch.utils.checkpoint import params_to_jax, save_npz

_WEIGHTS = Path(__file__).resolve().parents[2] / "weights"
MODELS = {"rife": RIFEModel, "rife_lite": RIFELiteModel}
NOT_PORTED = ("safa", "vfimamba", "vfimamba_s", "span", "span_x4")


def _radius(text: str) -> tuple:
    return tuple(int(v) for v in text.split(","))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.train",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="rife_lite", choices=[*MODELS, *NOT_PORTED])
    parser.add_argument("--data", default=None,
                        help="triplet data dir: not ported yet (needs cv2)")
    parser.add_argument("--data-source", default="auto", choices=["auto", "device", "host"],
                        help="synthetic scenes: 'device' (and 'auto') render them on the "
                        "training device; 'host' is not ported yet")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--crop", type=int, default=192)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="weight output (.npz)")
    parser.add_argument("--log-every", type=int, default=50)
    parser.add_argument("--save-every", type=int, default=500)
    parser.add_argument("--resume", default=None, help="start from this .npz")
    parser.add_argument("--level-radius", type=_radius, default=None,
                        help="level warp radius 'ry,rx' to train at")
    parser.add_argument("--final-radius", type=_radius, default=None,
                        help="final fusion warp radius 'ry,rx'")
    parser.add_argument("--detail", type=float, default=0.35,
                        help="high-frequency structure weight in the scenes (0 = smooth)")
    parser.add_argument("--device", default="cuda",
                        help="training device (default cuda; on cpu the warps take the exact "
                        "gather, as the JAX package does off the TPU)")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """Run the CLI; returns the last logged mean loss."""
    args = parse_args(argv)
    if args.model in NOT_PORTED:
        raise SystemExit(f"--model {args.model} is not ported to vfisr_tpu_torch yet "
                         "(ROADMAP.md); this trainer takes rife and rife_lite")
    if args.data is not None or args.data_source == "host":
        raise SystemExit("triplet data (--data) and the host-side scene generators are not "
                         "ported yet (ROADMAP.md); this trainer renders scenes on the device")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a CUDA card; pass --device cpu to train on the CPU")

    # the models' f32 config is f32: no TF32 in cuDNN's convolutions or in
    # matmuls (torch turns cuDNN's on by default), as FlagshipVFI.load sets
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cls = MODELS[args.model]
    overrides = {}
    if args.level_radius:
        overrides["level_warp_radius"] = args.level_radius
    if args.final_radius:
        overrides["final_warp_radius"] = args.final_radius
    model = cls(device=str(device), config=dataclasses.replace(cls.CONFIG, **overrides))

    out_path = Path(args.out) if args.out else _WEIGHTS / f"{args.model}.npz"
    # never silently clobber a shipped checkpoint: overwriting the default
    # needs an explicit --out, or a run that resumes from that same file
    if (args.out is None and out_path.exists()
            and not (args.resume and Path(args.resume).resolve() == out_path.resolve())):
        raise SystemExit(f"{out_path} already exists; pass --out explicitly to overwrite "
                         f"(or --resume {out_path} to continue training it)")
    model.load(weights_path=args.resume)
    module = model.trainable()
    state = create_train_state(module.parameters(), learning_rate=args.lr,
                               total_steps=args.steps)
    step_fn = make_train_step(module, state)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    print(f"Training {args.model} on synthetic gaming-motion scenes made on {device}", flush=True)

    t0 = time.time()
    window = []  # device scalars, read back at log time only
    last_loss = float("nan")
    for step in range(1, args.steps + 1):
        loss = step_fn(device_synthetic_batch(gen, args.batch, args.crop, args.detail))
        window.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            last_loss = torch.stack(window).mean().item()
            window.clear()
            rate = step * args.batch / (time.time() - t0)
            print(f"step {step}/{args.steps}  loss {last_loss:.4f}  {rate:.1f} samples/s",
                  flush=True)
        if step % args.save_every == 0 or step == args.steps:
            save_npz(str(out_path), params_to_jax(module.state_dict()))
            print(f"  saved {out_path} @ step {step}", flush=True)
    print(f"Done: final loss {last_loss:.4f} -> {out_path}")
    return last_loss


if __name__ == "__main__":
    main()
