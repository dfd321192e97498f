"""Training data for the native VFI and SR models (port of
``vfisr_tpu/train/data.py``), without OpenCV.

Two sources:
- ``TripletCropDataset``: random crops of preprocessed triplets
  (``<processed>/<clip>/{input_1080p30,ground_truth}/frames/*.png`` and
  ``triplets.json``, what ``data/preprocess_video.py`` writes): real
  frames, real motion, true in-between frames.
- ``synthetic_batch`` and the generators built on it: two textured layers
  in affine motion and an optional static HUD, made on the host from a
  numpy ``Generator``, with the reference's draws in its order and count.
  Its cv2 calls are ``data/draw.py``'s numpy counterparts and
  ``core/resize.py``'s cubic and area resizes (on the CPU).
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Iterator, List

import numpy as np
import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import draw
from vfisr_tpu_torch.data.png import read_png


class TripletCropDataset:
    """Random (frame0, frame1, gt, t) crops from triplet directories.

    The entries and the ``random.Random(seed)`` draws (an entry, then the
    crop's y, then its x) are the reference's. Frames are read with
    ``read_png``; a ground truth larger than the input is area-resized to
    the input's size (OpenCV's INTER_AREA) on ``device`` before the crop.
    Batches are float32 tensors on ``device`` in [0, 1], with ``t`` per
    sample."""

    def __init__(self, processed_dir: str | Path = "data/processed", crop: int = 192,
                 seed: int = 0, device: str = "cuda"):
        self.crop = crop
        self.rng = random.Random(seed)
        self.device = torch.device(device)
        self.entries: List[dict] = []
        processed = Path(processed_dir)
        if processed.exists():
            for clip_dir in sorted(processed.iterdir()):
                tpath = clip_dir / "triplets.json"
                if not tpath.exists():
                    continue
                for t in json.loads(tpath.read_text()):
                    frames = clip_dir / "input_1080p30" / "frames"
                    for gt_name, pos in zip(t["gt_intermediate"], t["temporal_positions"]):
                        self.entries.append({
                            "f0": frames / t["input_frame_0"],
                            "f1": frames / t["input_frame_1"],
                            "gt": clip_dir / "ground_truth" / "frames" / gt_name,
                            "t": pos,
                        })

    def __len__(self) -> int:
        return len(self.entries)

    def batches(self, batch_size: int, steps: int) -> Iterator[dict]:
        if not self.entries:
            raise RuntimeError("no triplet data found")
        c = self.crop
        for _ in range(steps):
            crops, ts = [], []
            for _ in range(batch_size):
                e = self.rng.choice(self.entries)
                f0, f1, gt = (torch.from_numpy(read_png(e[k])).to(self.device)
                              for k in ("f0", "f1", "gt"))
                if gt.shape[:2] != f0.shape[:2]:  # ground truth at a higher resolution
                    gt = resize(gt, tuple(f0.shape[:2]), "area")
                h, w = f0.shape[:2]
                y = self.rng.randint(0, max(h - c, 0))
                x = self.rng.randint(0, max(w - c, 0))
                crops.append(torch.stack([f[y:y + c, x:x + c] for f in (f0, f1, gt)]))
                ts.append(e["t"])
            frames = torch.stack(crops, 1).float() / 255.0
            yield {"img0": frames[0], "img1": frames[1], "gt": frames[2],
                   "t": torch.tensor(ts, dtype=torch.float32, device=self.device)}


def _texture(rng: np.random.Generator, size: int, scale: int) -> np.ndarray:
    base = rng.integers(0, 256, (size // scale, size // scale, 3), np.uint8)
    return resize(torch.from_numpy(base), (size, size), "cubic").numpy()


def synthetic_batch(rng: np.random.Generator, batch_size: int, crop: int = 192,
                    hud_prob: float = 0.5) -> dict:
    """Two-layer affine-motion scenes with optional static HUD overlays:
    {img0, img1, gt: [N, crop, crop, 3] float32 in [0, 1], t: [N] float32}."""
    c = crop
    f0s, f1s, gts, ts = [], [], [], []
    for _ in range(batch_size):
        canvas = _texture(rng, 2 * c, int(rng.integers(4, 32)))
        fg = _texture(rng, c, int(rng.integers(4, 16)))
        fg_mask = np.zeros((c, c), np.uint8)
        draw.circle(fg_mask, (c // 2, c // 2), int(rng.integers(c // 8, c // 3)), 1, -1)
        t = float(rng.uniform(0.1, 0.9))
        bgd = rng.uniform(-12, 12, 2)  # background displacement (subpixel)
        fgd = rng.uniform(-20, 20, 2)  # foreground displacement (subpixel)
        brot = float(rng.uniform(-2.0, 2.0))  # camera roll, degrees over the pair
        bzoom = float(rng.uniform(-0.03, 0.03))  # camera zoom over the pair

        def render(pos):
            # background: rotation/zoom about the window centre + subpixel
            # translation, sampled bilinearly from the 2c x 2c canvas
            bx, by = c // 2 + bgd * pos
            m = draw.rotation_matrix_2d((c / 2 + bx, c / 2 + by), brot * pos, 1.0 + bzoom * pos)
            m[:, 2] -= (bx, by)
            frame = draw.warp_affine(canvas, m, (c, c), "reflect")
            # foreground: subpixel translation, soft-edged composite
            fx, fy = fgd * pos
            mf = np.float32([[1, 0, fx], [0, 1, fy]])
            fgw = draw.warp_affine(fg, mf, (c, c), "constant")
            mw = draw.warp_affine(fg_mask.astype(np.float32), mf, (c, c), "constant")[..., None]
            return (frame * (1.0 - mw) + fgw * mw).astype(np.uint8)

        a, b_, g = render(0.0), render(1.0), render(t)
        if rng.random() < hud_prob:  # static HUD that must NOT move
            x0, y0 = int(rng.integers(0, c - 60)), int(rng.integers(0, c - 24))
            for fr in (a, b_, g):
                draw.put_hud_label(fr, x0, y0)
        f0s.append(a)
        f1s.append(b_)
        gts.append(g)
        ts.append(t)
    return {
        "img0": np.stack(f0s).astype(np.float32) / 255.0,
        "img1": np.stack(f1s).astype(np.float32) / 255.0,
        "gt": np.stack(gts).astype(np.float32) / 255.0,
        "t": np.asarray(ts, np.float32),
    }


def synthetic_sr_batch(rng: np.random.Generator, batch_size: int, crop: int = 192,
                       scale: int = 2) -> dict:
    """LR/HR pairs for SR training from the synthetic scenes: HR frames from
    ``synthetic_batch`` (3 distinct frames per scene), LR the HR area-decimated
    by ``scale`` (the harness's degradation): {lr, hr} float32."""
    c = crop - (crop % scale)
    vb = synthetic_batch(rng, max(batch_size // 3 + 1, 1), c)
    hrs = np.concatenate([vb["img0"], vb["img1"], vb["gt"]])[:batch_size]
    lrs = resize(torch.from_numpy(hrs), (c // scale, c // scale), "area").numpy()
    return {"lr": lrs.astype(np.float32), "hr": hrs.astype(np.float32)}


def augment_vfi_batch(rng: np.random.Generator, batch: dict) -> dict:
    """Label-consistent augmentation of a VFI batch: spatial flips /
    transpose (square crops), channel permutation, and time reversal
    (img0 <-> img1 with t -> 1-t). All O(copy) numpy ops."""
    img0, img1, gt, t = batch["img0"], batch["img1"], batch["gt"], batch["t"]
    frames = [img0, img1, gt]
    if rng.random() < 0.5:
        frames = [f[:, :, ::-1] for f in frames]
    if rng.random() < 0.5:
        frames = [f[:, ::-1] for f in frames]
    # the draw is made only for square crops (the reference's short circuit)
    if frames[0].shape[1] == frames[0].shape[2] and rng.random() < 0.5:
        frames = [np.swapaxes(f, 1, 2) for f in frames]
    if rng.random() < 0.5:
        perm = rng.permutation(3)
        frames = [f[..., perm] for f in frames]
    if rng.random() < 0.5:  # time reversal
        frames = [frames[1], frames[0], frames[2]]
        t = 1.0 - t
    return {
        "img0": np.ascontiguousarray(frames[0]),
        "img1": np.ascontiguousarray(frames[1]),
        "gt": np.ascontiguousarray(frames[2]),
        "t": np.asarray(t, np.float32),
    }


def synthetic_pool_iter(rng: np.random.Generator, batch_size: int, crop: int, steps: int,
                        fresh_every: int = 8, pool_max: int = 512) -> Iterator[dict]:
    """Amortized synthetic-batch stream: a pool of generated batches serves
    cheap augmented samples (``augment_vfi_batch``), with a fresh batch every
    ``fresh_every`` steps (evicting a random entry once the pool is full)."""
    pool: List[dict] = [synthetic_batch(rng, batch_size, crop)]
    for step in range(steps):
        if step % fresh_every == 0:
            fresh = synthetic_batch(rng, batch_size, crop)
            if len(pool) >= pool_max:
                pool[int(rng.integers(len(pool)))] = fresh
            else:
                pool.append(fresh)
            yield fresh
        else:
            yield augment_vfi_batch(rng, pool[int(rng.integers(len(pool)))])
