"""The port's headline benchmark: the flagship fused step, 1080p -> 1440p,
in interpolated fps on one GPU (counterpart of the repository's
``bench.py``).

    python -m vfisr_tpu_torch.bench

Loads ``FlagshipVFI`` strictly from ``weights/rife.npz`` and
``weights/router_gate.json`` (a missing file raises), and times
``fused_stream_step`` at timestamps 0.25/0.5/0.75 over WARMUP + PAIRS
frame pairs in this process: each pair is bracketed by CUDA events, and
its frames are uint8 frames uploaded once and taken in turn, so the HUD
history advances as it does in a stream. Prints p10, p50 and p90 ms per
pair, the peak ``max_memory_allocated`` and the card's name and power
limit, then, as its last line, one JSON object with ``bench.py``'s keys:
``{"metric", "value" (3000 / median ms per pair, interpolated fps), "unit",
"vs_baseline"}`` and the percentiles. Without a CUDA card it fails.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from vfisr_tpu_torch.utils.paths import REPO_ROOT

BASELINE_INTERP_FPS = 441.0 / 70.1  # the source's rife_default run on an RTX 3090
METRIC = "adaptive_vfi_interpolated_fps_1080p_to_1440p_single_chip"
H, W = 1080, 1920
SCALE = 1440 / 1080
TIMESTAMPS = (0.25, 0.5, 0.75)
PAIRS, WARMUP = 50, 5
FRAMES = 8  # distinct frames, uploaded once and taken in turn
PAN_PX = 4  # the scene's motion per frame


def _frames(device, h: int, w: int) -> list:
    """FRAMES uint8 [h,w,3] frames made on device: 16 plane waves (seeded
    wavelengths 8-64 px, directions and phases) panning PAN_PX px per
    frame, under a static HUD box."""
    rng = np.random.default_rng(0)
    k = 2 * np.pi / rng.uniform(8.0, 64.0, 16)
    ang = rng.uniform(0, 2 * np.pi, 16)
    kx, ky = (k * np.cos(ang)).tolist(), (k * np.sin(ang)).tolist()
    phase = rng.uniform(0, 2 * np.pi, (16, 3)).tolist()
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    out = []
    for i in range(FRAMES):
        f = torch.full((h, w, 3), 0.5, device=device)
        for j in range(16):
            arg = kx[j] * (xx - PAN_PX * i) + ky[j] * yy
            for c in range(3):
                f[..., c] += 0.08 * torch.sin(arg + phase[j][c])
        f[: h // 6, : w // 5] = torch.tensor([0.9, 0.9, 0.1], device=device)
        out.append(torch.clamp(torch.floor(f * 255.0 + 0.5), 0, 255).to(torch.uint8))
    return out


def measure(device: str = "cuda", h: int = H, w: int = W, pairs: int = PAIRS,
            warmup: int = WARMUP) -> dict:
    """Time ``warmup`` then ``pairs`` pairs of ``fused_stream_step``; return
    the JSON record. On a CUDA device the pairs are timed with CUDA events,
    on the CPU with the host clock (for tests: not a device figure)."""
    from vfisr_tpu_torch.pipeline.flagship import FlagshipVFI

    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights, gate = REPO_ROOT / "weights" / "rife.npz", REPO_ROOT / "weights" / "router_gate.json"
    vfi = FlagshipVFI(device=device)
    # explicit paths make the load strict: a missing file raises
    vfi.load(weights_path=str(weights), gate_path=str(gate))
    frames = _frames(device, h, w)

    def pair(i):
        return vfi.fused_stream_step(frames[i % FRAMES], frames[(i + 1) % FRAMES], SCALE,
                                     TIMESTAMPS)

    for i in range(warmup):
        pair(i)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ms = []
    for i in range(warmup, warmup + pairs):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pair(i)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            pair(i)
            ms.append((time.perf_counter() - t0) * 1e3)
    p10, p50, p90 = (float(v) for v in np.percentile(ms, (10, 50, 90)))
    where = torch.cuda.get_device_name(device) if cuda else "the CPU (host clock)"
    peak = f"{torch.cuda.max_memory_allocated(device) / 1e6:.1f} MB" if cuda else "not measured"
    print(f"bench: fused_stream_step {w}x{h} -> {int(w * SCALE)}x{int(h * SCALE)}, "
          f"{len(TIMESTAMPS)} midpoints, {pairs} pairs after {warmup} on {where}: ms per pair "
          f"p10 {p10:.3f} p50 {p50:.3f} p90 {p90:.3f}; max_memory_allocated {peak}", flush=True)
    value = len(TIMESTAMPS) * 1000.0 / p50
    return {"metric": METRIC, "value": value, "unit": "fps",
            "vs_baseline": value / BASELINE_INTERP_FPS, "ms_per_pair_p50": p50,
            "ms_per_pair_p10": p10, "ms_per_pair_p90": p90, "pairs": pairs}


def main() -> int:
    record = measure()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    if not (math.isfinite(record["value"]) and record["value"] > 0):
        raise RuntimeError(f"bench value {record['value']}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
