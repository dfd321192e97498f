"""Train RIFE, VFIMamba, SAFA or SPAN on synthetic gaming scenes or on
preprocessed triplets (port of ``scripts/train.py``).

    python -m vfisr_tpu_torch.train --model rife --steps 2000 --batch 16
    python -m vfisr_tpu_torch.train --model rife --data data/processed --steps 20000
    python -m vfisr_tpu_torch.train --model safa --data-source host --steps 2000
    python -m vfisr_tpu_torch.train --model vfimamba_s --out /tmp/vfimamba_s.npz
    python -m vfisr_tpu_torch.train --model span_x4 --steps 1 --batch 1 \\
        --crop 32 --device cpu --out /tmp/span_x4.npz

The VFI models (rife, rife_lite) train on scenes at --crop with remat.
VFIMamba (vfimamba, vfimamba_s) trains on the same batches with its
BiMambaBlocks recomputed one at a time in the backward pass
(``MambaConfig.remat``) and no whole-forward remat, as the reference does.
SAFA, the joint VFI+SR net, renders its scenes at 2x --crop, takes the
endpoints area-resized to --crop and is supervised on the midpoint at 2x
(remat). SPAN (x2; span_x4: x4) trains on crisp unwarped scenes at --crop
(detail at least 0.5), its input area-resized to --crop / scale, with the
SR step (no remat). Starts from the model's shipped checkpoint (or
--resume), writes weights/<model>.npz (weights/span_x2.npz for span, or
--out) in the JAX package's layout, and refuses to overwrite an existing
default checkpoint unless --out is given or --resume names it.

Where the batches come from:
- ``--data DIR``: random crops of the preprocessed triplets under DIR
  (``train/data.py::TripletCropDataset``), read and cropped by one producer
  thread, the VFI models only (rife, rife_lite, vfimamba, vfimamba_s). SAFA needs ground truth at twice the
  input's size and SPAN's batches are LR/HR pairs, which triplets do not
  give: both are refused (the reference trains SPAN on synthetic scenes
  instead, without a word).
- ``--data-source device`` and ``auto``: scenes rendered on the training
  device (``train/device_data.py``). The card is the port's counterpart of
  the reference's TPU, where ``auto`` picks the device generator.
- ``--data-source host``: the reference's host generators
  (``train/data.py``) on one producer thread: SPAN takes
  ``synthetic_sr_batch``, SAFA ``synthetic_pool_iter`` at 2x --crop with
  the endpoints area-resized to --crop, RIFE and VFIMamba
  ``synthetic_pool_iter``.
A producer keeps a queue of 4 batches; an exception in it is raised again
in the step loop, so the run fails (the reference's producer prints it and
ends the queue, and its run ends early with "Done").
"""

from __future__ import annotations

import argparse
import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.models.sota.rife import RIFELiteModel, RIFEModel
from vfisr_tpu_torch.models.sota.safa import SAFAModel
from vfisr_tpu_torch.models.sota.span import SPANModel
from vfisr_tpu_torch.models.sota.vfimamba import VFIMambaModel
from vfisr_tpu_torch.train.data import TripletCropDataset, synthetic_pool_iter, synthetic_sr_batch
from vfisr_tpu_torch.train.device_data import device_sr_batch, device_synthetic_batch
from vfisr_tpu_torch.train.train import create_train_state, make_sr_train_step, make_train_step
from vfisr_tpu_torch.utils.checkpoint import params_to_jax, save_npz

_WEIGHTS = Path(__file__).resolve().parents[2] / "weights"
MODELS = ("rife", "rife_lite", "vfimamba", "vfimamba_s", "safa", "span", "span_x4")
MAMBA = {"vfimamba": "full", "vfimamba_s": "small"}
SR_SCALE = {"span": 2, "span_x4": 4}
QUEUE_DEPTH = 4  # batches a producer thread keeps ready, as the reference's


def _radius(text: str) -> tuple:
    return tuple(int(v) for v in text.split(","))


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.train",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="rife_lite", choices=MODELS)
    parser.add_argument("--data", default=None,
                        help="preprocessed triplet dir (the VFI models; default: synthetic "
                        "scenes)")
    parser.add_argument("--data-source", default="auto", choices=["auto", "device", "host"],
                        help="synthetic scenes: 'device' (and 'auto') render them on the "
                        "training device, 'host' on the CPU in a producer thread. Ignored "
                        "with --data")
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
    if name in MAMBA:
        model = VFIMambaModel(variant=MAMBA[name], device=str(device))
        # per-block remat (scripts/train.py:94-102): the scan's backward
        # temporaries are per block, so only the blocks' boundaries are kept
        model.cfg = dataclasses.replace(model.cfg, remat=True)
        return model
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


def host_batches(model: str, rng: np.random.Generator, batch: int, crop: int,
                 steps: int) -> Iterator[dict]:
    """The model's training batches from the host generators
    (scripts/train.py:186-214), as numpy arrays."""
    if model in SR_SCALE:
        for _ in range(steps):
            yield synthetic_sr_batch(rng, batch, crop, SR_SCALE[model])
    elif model == "safa":
        # the scene at 2x crop: the endpoints degraded to crop, the midpoint
        # supervised at the scene's resolution
        for b in synthetic_pool_iter(rng, batch, 2 * crop, steps):
            yield dict(b, **{k: resize(torch.from_numpy(b[k]), (crop, crop), "area").numpy()
                             for k in ("img0", "img1")})
    else:
        yield from synthetic_pool_iter(rng, batch, crop, steps)


def prefetch(batches: Iterator[dict]) -> Iterator[dict]:
    """Yields ``batches`` as one producer thread makes them, up to
    QUEUE_DEPTH ahead. An exception in the producer is raised again here, in
    the consumer; a consumer that stops early stops the producer at its next
    batch."""
    q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce() -> None:
        try:
            for b in batches:
                if not put(b):
                    return
            put(done)
        except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
            put(e)

    threading.Thread(target=produce, name="batch-producer", daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def _on(batch: dict, device: torch.device) -> dict:
    """The batch's arrays as tensors on the device."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def run(argv=None) -> dict:
    """Run the CLI; returns {loss: the last logged mean loss, out: the
    checkpoint's path, step_s: host seconds of each step (a step that logs
    waits for the card to read its loss back), wait_s: each step's wait for
    its batch}."""
    args = parse_args(argv)
    if args.data is not None and args.model == "safa":
        raise SystemExit("safa joint training needs GT at 2x the input resolution; triplet "
                         "data has same-res midpoints: train on synthetic scenes (omit --data)")
    if args.data is not None and args.model in SR_SCALE:
        raise SystemExit(f"--model {args.model} trains on LR/HR pairs, which triplet data does "
                         "not give: train SPAN on synthetic scenes (omit --data)")
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
    if args.model in SR_SCALE:
        step_fn = make_sr_train_step(module, state)
    else:  # VFIMamba recomputes per block instead of the whole forward
        step_fn = make_train_step(module, state, use_remat=args.model not in MAMBA)
    if args.data is not None:
        ds = TripletCropDataset(args.data, crop=args.crop, seed=args.seed, device=str(device))
        print(f"Training {args.model} on {len(ds)} triplet crops from {args.data}", flush=True)
        batches = prefetch(ds.batches(args.batch, args.steps))
    elif args.data_source == "host":
        print(f"Training {args.model} on synthetic gaming scenes made on the host", flush=True)
        batches = prefetch(host_batches(args.model, np.random.default_rng(args.seed),
                                        args.batch, args.crop, args.steps))
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        make = batch_maker(args.model, gen, args.batch, args.crop, args.detail)
        batches = (make() for _ in range(args.steps))
        print(f"Training {args.model} on synthetic gaming scenes made on {device}", flush=True)

    t0 = time.time()
    window = []  # device scalars, read back at log time only
    last_loss = float("nan")
    step_s, wait_s = [], []
    for step in range(1, args.steps + 1):
        start = time.perf_counter()
        batch = next(batches, None)
        if batch is None:
            raise RuntimeError(f"the batch source ended after {step - 1} of {args.steps} steps")
        wait_s.append(time.perf_counter() - start)
        loss = step_fn(_on(batch, device))
        window.append(loss)
        if step % args.log_every == 0 or step == args.steps:
            last_loss = torch.stack(window).mean().item()
            window.clear()
            rate = step * args.batch / (time.time() - t0)
            print(f"step {step}/{args.steps}  loss {last_loss:.4f}  {rate:.1f} samples/s",
                  flush=True)
        step_s.append(time.perf_counter() - start)
        if step % args.save_every == 0 or step == args.steps:
            save_npz(str(out_path), params_to_jax(module.state_dict()))
            print(f"  saved {out_path} @ step {step}", flush=True)
    print(f"Done: final loss {last_loss:.4f} -> {out_path}")
    return {"loss": last_loss, "out": out_path, "step_s": step_s, "wait_s": wait_s}


def main(argv=None) -> float:
    """Run the CLI; returns the last logged mean loss."""
    return run(argv)["loss"]


if __name__ == "__main__":
    main()
