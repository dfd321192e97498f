"""Calibrate LPIPS linear heads without the official weights (port of
``vfisr_tpu/evaluation/lpips_calibrate.py``).

The official LPIPS v0.1 heads are trained on human 2AFC judgments and
cannot be downloaded here; these heads are learned on synthetic supervision
over the deterministic random-feature AlexNet (``evaluation/lpips.py``):

1. Base patches from the synthetic gaming world (textures, hard-edged
   panels with a glyph, speckle over gradients, band-limited noise).
2. Seven distortion families at five severities: Gaussian blur, Gaussian
   noise, down-up resampling, ghost blending (the VFI failure mode),
   elastic warp error, quantisation, contrast shift.
3. Ranking pairs: within a family the stronger severity is farther from
   the reference; across families only where PSNR and SSIM agree with
   margin (> 1 dB and > 0.01).
4. Heads w_i = softplus(theta_i) minimise a logistic ranking loss on
   D(ref, far) - D(ref, near), with Adam (lr 0.05, betas 0.9/0.999, eps
   1e-8, as optax's ``adam``).

Patches and distortions are numpy on the host with ``data/draw.py``'s
OpenCV calls; their resizes and blurs, the LPIPS features, PSNR/SSIM and
the heads' training run on ``device`` (``cuda`` by default).
``calibrate`` writes the heads to the ``out_path`` it is given, never to
the shipped ``weights/lpips_heads.npz``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import draw
from vfisr_tpu_torch.evaluation.lpips import HEADS_PATH, LPIPS, _init_params
from vfisr_tpu_torch.ops.conv import gaussian_blur

PATCH = 64
FAMILIES = ("blur", "noise", "downup", "ghost", "warp", "quant", "contrast")
SEVERITIES = (1, 2, 3, 4, 5)
N_TAPS = 5


def _resize_f32(x: np.ndarray, size_hw: Tuple[int, int], method: str, device: str) -> np.ndarray:
    """``cv2.resize`` of a float32 HWC image to (h, w) on device."""
    return resize(torch.from_numpy(np.ascontiguousarray(x)).to(device), size_hw, method).cpu().numpy()


def random_features(device: str = "cuda") -> LPIPS:
    """The random-feature LPIPS (seed 0, uniform heads) the heads are fit to."""
    return LPIPS(seed=0, load_calibrated=False, device=device, load_official=False)


def make_base_patches(rng: np.random.Generator, n: int, device: str = "cuda") -> np.ndarray:
    """[n, PATCH, PATCH, 3] float32 in [0, 1]: textures, edges, gradients."""
    out = np.empty((n, PATCH, PATCH, 3), np.float32)
    for i in range(n):
        kind = i % 4
        if kind == 0:  # smooth multi-scale texture
            small = rng.random((PATCH // 8, PATCH // 8, 3)).astype(np.float32)
            img = _resize_f32(small, (PATCH, PATCH), "cubic", device)
        elif kind == 1:  # hard-edged panels + glyph (game HUD / signage)
            img = np.full((PATCH, PATCH, 3), rng.random(3), np.float32)
            u8 = (img * 255).astype(np.uint8)
            for _ in range(4):
                p0 = rng.integers(0, PATCH, 2)
                p1 = rng.integers(0, PATCH, 2)
                col = tuple(int(c) for c in rng.integers(0, 255, 3))
                draw.rectangle(u8, p0, p1, col, -1)
            draw.put_label(u8, "A7", (8, PATCH - 8), 0.8, (255, 255, 255), 1)
            img = u8.astype(np.float32) / 255.0
        elif kind == 2:  # fine detail: speckle over gradient
            gy = np.linspace(0, 1, PATCH, dtype=np.float32)
            img = np.stack([np.tile(gy[:, None], (1, PATCH))] * 3, axis=-1)
            img = img * rng.random(3)[None, None]
            speck = rng.random((PATCH, PATCH)) > 0.95
            img[speck] = rng.random((int(speck.sum()), 3))
        else:  # band-limited noise (mid frequency)
            small = rng.random((PATCH // 2, PATCH // 2, 3)).astype(np.float32)
            img = _resize_f32(small, (PATCH, PATCH), "linear", device)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


def distort(img: np.ndarray, family: str, severity: int, rng: np.random.Generator,
            device: str = "cuda") -> np.ndarray:
    """One distortion family at integer severity 1..5. [H, W, 3] -> same."""
    s = float(severity)
    x = img.astype(np.float32)
    if family == "blur":
        t = torch.from_numpy(np.ascontiguousarray(x)).to(device)[None]
        return gaussian_blur(t, 0, 0.4 + 0.5 * s)[0].cpu().numpy()
    if family == "noise":
        return np.clip(x + rng.normal(0, 0.015 * s, x.shape).astype(np.float32), 0, 1)
    if family == "downup":
        f = 1.0 + 0.35 * s
        h, w = x.shape[:2]
        small = _resize_f32(x, (max(int(h / f), 4), max(int(w / f), 4)), "area", device)
        return _resize_f32(small, (h, w), "linear", device)
    if family == "ghost":
        # blend with a shifted copy: the linear-blend VFI failure mode
        d = int(round(s * 2))
        shifted = np.roll(x, (d, d), axis=(0, 1))
        return 0.5 * x + 0.5 * shifted
    if family == "warp":
        h, w = x.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        amp = 0.6 * s
        map_x = xx + amp * np.sin(2 * np.pi * yy / 16.0)
        map_y = yy + amp * np.cos(2 * np.pi * xx / 16.0)
        return draw.remap(x, map_x, map_y, "reflect")
    if family == "quant":
        levels = max(int(48 / s), 3)
        return np.round(x * levels) / levels
    if family == "contrast":
        g = 1.0 + 0.10 * s
        return np.clip((x - 0.5) * g + 0.5 + 0.02 * s, 0, 1)
    raise ValueError(family)


def build_pairs(rng: np.random.Generator, n_patches: int = 48, cross_per_patch: int = 10,
                device: str = "cuda"):
    """(refs, near, far): aligned ranking triplets."""
    from vfisr_tpu_torch.evaluation.metrics import compute_psnr_simple, compute_ssim_simple

    def u8(v):
        return (v * 255).astype(np.uint8)

    bases = make_base_patches(rng, n_patches, device)
    refs: List[np.ndarray] = []
    near: List[np.ndarray] = []
    far: List[np.ndarray] = []
    for b in bases:
        dist: Dict[Tuple[str, int], np.ndarray] = {}
        for fam in FAMILIES:
            for sev in SEVERITIES:
                dist[(fam, sev)] = distort(b, fam, sev, rng, device)
        # within-family: adjacent + extreme severity pairs
        for fam in FAMILIES:
            for lo, hi in ((1, 3), (2, 4), (3, 5), (1, 5)):
                refs.append(b)
                near.append(dist[(fam, lo)])
                far.append(dist[(fam, hi)])
        # cross-family: PSNR + SSIM consensus with margin
        keys = list(dist.keys())
        for _ in range(cross_per_patch):
            ia, ib = rng.choice(len(keys), 2, replace=False)
            ka, kb = keys[int(ia)], keys[int(ib)]
            if ka[0] == kb[0]:
                continue  # same family is covered above
            da, db = dist[ka], dist[kb]
            psnr_a = compute_psnr_simple(u8(da), u8(b), device)
            psnr_b = compute_psnr_simple(u8(db), u8(b), device)
            ssim_a = compute_ssim_simple(u8(da), u8(b), device)
            ssim_b = compute_ssim_simple(u8(db), u8(b), device)
            if psnr_a - psnr_b > 1.0 and ssim_a - ssim_b > 0.01:
                refs.append(b)
                near.append(da)
                far.append(db)
            elif psnr_b - psnr_a > 1.0 and ssim_b - ssim_a > 0.01:
                refs.append(b)
                near.append(db)
                far.append(da)
    return np.stack(refs), np.stack(near), np.stack(far)


@torch.no_grad()
def _tap_distances(lp: LPIPS, a: np.ndarray, b: np.ndarray) -> List[np.ndarray]:
    """Per tap, [N, C_i]: the spatial mean of (unit(a) - unit(b))^2, the
    quantity the linear heads weight (so training the heads re-runs no
    conv)."""
    fa = lp._features(lp._prep(a))
    fb = lp._features(lp._prep(b))
    out = []
    for ya, yb in zip(fa, fb):
        na = ya * torch.rsqrt(torch.sum(ya * ya, dim=1, keepdim=True) + 1e-10)
        nb = yb * torch.rsqrt(torch.sum(yb * yb, dim=1, keepdim=True) + 1e-10)
        out.append(torch.mean((na - nb) ** 2, dim=(2, 3)).cpu().numpy())
    return out


def init_theta(seed: int, dims) -> List[np.ndarray]:
    """The heads' logits before training: -2 plus 0.01 x a standard normal
    (numpy, ``default_rng(seed)``), one array per tap."""
    rng = np.random.default_rng(seed)
    return [np.float32(-2.0) + np.float32(0.01) * rng.standard_normal(d).astype(np.float32)
            for d in dims]


def train_heads(refs: np.ndarray, near: np.ndarray, far: np.ndarray, steps: int = 600,
                lr: float = 0.05, seed: int = 0, batch: int = 256, device: str = "cuda",
                theta0: Optional[List[np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """Softplus heads fit with a logistic ranking loss (Adam, full batch);
    ``theta0`` (else ``init_theta(seed, ...)``) is where they start."""
    lp = random_features(device)
    tn, tf = [], []
    for i in range(0, len(refs), batch):
        sl = slice(i, i + batch)
        tn.append(_tap_distances(lp, near[sl], refs[sl]))
        tf.append(_tap_distances(lp, far[sl], refs[sl]))
    tnear = [torch.as_tensor(np.concatenate([c[i] for c in tn]), device=device)
             for i in range(N_TAPS)]
    tfar = [torch.as_tensor(np.concatenate([c[i] for c in tf]), device=device)
            for i in range(N_TAPS)]
    dims = [t.shape[1] for t in tnear]
    theta = [torch.tensor(np.asarray(t, np.float32), device=device, requires_grad=True)
             for t in (theta0 if theta0 is not None else init_theta(seed, dims))]
    opt = torch.optim.Adam(theta, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn():
        d_near = sum(torch.sum(t * F.softplus(th), dim=1) for t, th in zip(tnear, theta))
        d_far = sum(torch.sum(t * F.softplus(th), dim=1) for t, th in zip(tfar, theta))
        margin = (d_far - d_near) / 0.05  # logistic ranking: want d_far > d_near
        return torch.mean(F.softplus(-margin))

    last = None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        last = loss_fn()
        last.backward()
        opt.step()
    heads = {f"lin{i}_w": F.softplus(t).detach().cpu().numpy().astype(np.float32)
             for i, t in enumerate(theta)}
    heads["final_loss"] = np.asarray(np.nan if last is None else float(last.detach()), np.float32)
    return heads


def _head_distance(heads: Dict[str, np.ndarray], taps: List[np.ndarray]) -> np.ndarray:
    return sum((t * heads[f"lin{i}_w"]).sum(axis=1) for i, t in enumerate(taps))


def evaluate_heads(heads: Dict[str, np.ndarray], refs, near, far, lp: Optional[LPIPS] = None,
                   device: str = "cuda") -> dict:
    """2AFC accuracy of a head set on ranking triplets."""
    lp = lp or random_features(device)
    d_near = _head_distance(heads, _tap_distances(lp, near, refs))
    d_far = _head_distance(heads, _tap_distances(lp, far, refs))
    return {"accuracy_2afc": float(np.mean(d_far > d_near)), "n_pairs": int(len(refs))}


def severity_spearman(heads: Dict[str, np.ndarray], rng=None, n_patches: int = 8,
                      device: str = "cuda") -> Dict[str, float]:
    """Per family, the mean over patches of the Spearman rank correlation of
    distance against severity (ranks by double argsort, in numpy)."""
    rng = rng or np.random.default_rng(123)
    lp = random_features(device)
    bases = make_base_patches(rng, n_patches, device)
    ideal = np.arange(len(SEVERITIES))
    n = len(ideal)
    out = {}
    for fam in FAMILIES:
        rhos = []
        for b in bases:
            ds = []
            for sev in SEVERITIES:
                d = distort(b, fam, sev, rng, device)
                ds.append(float(_head_distance(heads, _tap_distances(lp, d[None], b[None]))[0]))
            ranks = np.argsort(np.argsort(ds))
            rhos.append(1 - 6 * np.sum((ranks - ideal) ** 2) / (n * (n ** 2 - 1)))
        out[fam] = float(np.mean(rhos))
    return out


def uniform_heads() -> Dict[str, np.ndarray]:
    """The uncalibrated (random_features mode) baseline heads."""
    params = _init_params(0)
    return {f"lin{i}_w": params[f"lin{i}_w"] for i in range(N_TAPS)}


def calibrate(out_path: str, seed: int = 0, n_patches: int = 48, steps: int = 600,
              device: str = "cuda") -> dict:
    """Build pairs, train on 80%, evaluate on the held-out 20% and the
    severity ladders, save the heads to ``out_path``. Returns the report."""
    if Path(out_path).resolve() == Path(HEADS_PATH).resolve():
        raise SystemExit(f"{out_path} is the shipped heads file; calibrate into another path "
                         "and compare before replacing it")
    rng = np.random.default_rng(seed)
    refs, near, far = build_pairs(rng, n_patches=n_patches, device=device)
    n_hold = max(len(refs) // 5, 1)
    perm = rng.permutation(len(refs))
    tr, ho = perm[n_hold:], perm[:n_hold]
    heads = train_heads(refs[tr], near[tr], far[tr], steps=steps, seed=seed, device=device)
    lp = random_features(device)
    report = {
        "train": evaluate_heads(heads, refs[tr], near[tr], far[tr], lp),
        "holdout": evaluate_heads(heads, refs[ho], near[ho], far[ho], lp),
        "holdout_uniform": evaluate_heads(uniform_heads(), refs[ho], near[ho], far[ho], lp),
        "spearman": severity_spearman(heads, device=device),
        "spearman_uniform": severity_spearman(uniform_heads(), device=device),
        "final_loss": float(heads["final_loss"]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **{k: v for k, v in heads.items() if k.startswith("lin")})
    report["weights_path"] = str(out_path)
    return report
