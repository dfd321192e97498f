"""Train RIFE, SAFA or SPAN on synthetic gaming scenes made on the device
(port of ``scripts/train.py`` for ``--model rife|rife_lite|safa|span|span_x4``).

    python -m vfisr_tpu_torch.train --model rife --steps 2000 --batch 16
    python -m vfisr_tpu_torch.train --model safa --steps 2000 --batch 16
    python -m vfisr_tpu_torch.train --model span_x4 --steps 1 --batch 1 \\
        --crop 32 --device cpu --out /tmp/span_x4.npz

The VFI models (rife, rife_lite) train on scenes at --crop with remat.
SAFA, the joint VFI+SR net, renders its scenes at 2x --crop, takes the
endpoints area-resized to --crop and is supervised on the midpoint at 2x
(remat). SPAN (x2; span_x4: x4) trains on crisp unwarped scenes at --crop
(detail at least 0.5), its input area-resized to --crop / scale, with the
SR step (no remat). Starts from the model's shipped checkpoint (or
--resume), writes weights/<model>.npz (weights/span_x2.npz for span, or
--out) in the JAX package's layout, and refuses to overwrite an existing
default checkpoint unless --out is given or --resume names it. Still to
port (ROADMAP): VFIMamba, triplet data (--data) and the host-side
generators.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.models.sota.rife import RIFELiteModel, RIFEModel
from vfisr_tpu_torch.models.sota.safa import SAFAModel
from vfisr_tpu_torch.models.sota.span import SPANModel
from vfisr_tpu_torch.train.device_data import device_sr_batch, device_synthetic_batch
from vfisr_tpu_torch.train.train import create_train_state, make_sr_train_step, make_train_step
from vfisr_tpu_torch.utils.checkpoint import params_to_jax, save_npz

_WEIGHTS = Path(__file__).resolve().parents[2] / "weights"
MODELS = ("rife", "rife_lite", "safa", "span", "span_x4")
NOT_PORTED = ("vfimamba", "vfimamba_s")
SR_SCALE = {"span": 2, "span_x4": 4}


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
                        help="rife models: level warp radius 'ry,rx' to train at")
    parser.add_argument("--final-radius", type=_radius, default=None,
                        help="rife models: final fusion warp radius 'ry,rx'")
    parser.add_argument("--detail", type=float, default=0.35,
                        help="high-frequency structure weight in the scenes (0 = smooth)")
    parser.add_argument("--device", default="cuda",
                        help="training device (default cuda; on cpu the warps take the exact "
                        "gather, as the JAX package does off the TPU)")
    return parser.parse_args(argv)


def _model(name: str, device: torch.device, args: argparse.Namespace):
    """The model the CLI trains, before its load."""
    if name == "safa":
        return SAFAModel(device=str(device))
    if name in SR_SCALE:
        return SPANModel(scale=SR_SCALE[name], device=str(device))
    cls = RIFEModel if name == "rife" else RIFELiteModel
    overrides = {}
    if args.level_radius:
        overrides["level_warp_radius"] = args.level_radius
    if args.final_radius:
        overrides["final_warp_radius"] = args.final_radius
    return cls(device=str(device), config=dataclasses.replace(cls.CONFIG, **overrides))


def batch_maker(model: str, gen: torch.Generator, batch: int, crop: int, detail: float):
    """A function that makes the model's next training batch on ``gen``'s
    device (scripts/train.py:150-198, device generator)."""
    if model in SR_SCALE:
        s = SR_SCALE[model]

        def sr_batch() -> dict:
            # crisp unwarped scenes: the VFI scenes' subpixel warp low-passes
            # away the aliased detail SR learns from
            hr = device_sr_batch(gen, batch, crop, detail=max(detail, 0.5))["gt"]
            return {"lr": resize(hr, (crop // s, crop // s), "area"), "hr": hr}

        return sr_batch
    if model == "safa":
        def joint_batch() -> dict:
            # the scene at 2x crop: the endpoints degraded to crop, the
            # midpoint supervised at the scene's resolution
            b = device_synthetic_batch(gen, batch, 2 * crop, detail)
            return dict(b, img0=resize(b["img0"], (crop, crop), "area"),
                        img1=resize(b["img1"], (crop, crop), "area"))

        return joint_batch
    return lambda: device_synthetic_batch(gen, batch, crop, detail)


def main(argv=None) -> float:
    """Run the CLI; returns the last logged mean loss."""
    args = parse_args(argv)
    if args.model in NOT_PORTED:
        raise SystemExit(f"--model {args.model} is not ported to vfisr_tpu_torch yet "
                         f"(ROADMAP.md); this trainer takes {', '.join(MODELS)}")
    if args.data is not None and args.model == "safa":
        raise SystemExit("safa joint training needs GT at 2x the input resolution; triplet "
                         "data has same-res midpoints: train on synthetic scenes (omit --data)")
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

    model = _model(args.model, device, args)
    default_name = f"span_x{SR_SCALE[args.model]}" if args.model in SR_SCALE else args.model
    out_path = Path(args.out) if args.out else _WEIGHTS / f"{default_name}.npz"
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
    step_fn = (make_sr_train_step if args.model in SR_SCALE else make_train_step)(module, state)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    batch = batch_maker(args.model, gen, args.batch, args.crop, args.detail)
    print(f"Training {args.model} on synthetic gaming scenes made on {device}", flush=True)

    t0 = time.time()
    window = []  # device scalars, read back at log time only
    last_loss = float("nan")
    for step in range(1, args.steps + 1):
        loss = step_fn(batch())
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
