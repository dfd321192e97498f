"""Smoke run of the PyTorch port (vfisr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or PATH) and the repository's
vfisr_tpu_torch/ and weights/ beside this file; no network. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the windowed-warp kernel (csrc/warp_windowed.cu) with nvcc;
3. loads FlagshipVFI(device="cuda") with weights/rife.npz (full-width RIFE,
   bf16 deploy config) and weights/router_gate.json;
4. drives the flagship fused step (fused_stream_step) over a stream of
   synthetic 1920x1080 gameplay frames (gradient, moving textured
   rectangle, static HUD box) to 2560x1440 uint8, with the kernel's launch
   count set to 0 before and read after (18 launches per pair);
5. checks the outputs: shapes and dtypes, the endpoint frame against its
   own upscale, the midpoints beating frame duplication against the
   synthetic scene's true in-between frames, and one pair against the same
   step with the kernel's plain PyTorch twin substituted;
6. holds the kernel against its plain twin at every launch of a pair of the
   main path (the inputs recorded as the path made them) and at synthetic
   cases of each launch shape, a constant border and a flow that leaves
   the window (tolerance 1e-5 in f32 windows, 2/255 in bf16 windows, both
   relative to the largest magnitude when it exceeds 1);
7. times the step (CUDA events, after warm-up), each of its stages alone,
   and, per launch shape, the kernel alone and the wrapper's origin table
   alone (CUDA-graph replay: device time), the wrapper as the path calls
   it, the plain twin and torch's grid_sample (a yardstick only).

Any failure raises and the exit code is not 0. The line before the last is
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PAIRS = 6  # timed pairs of the main path
TS = (0.25, 0.5, 0.75)
SCALE = 1440 / 1080  # the streaming pipeline's target_h / height
H, W = 1080, 1920
STEP_PX = 8  # rectangle motion per frame: quarter-frame positions are integers
LAUNCHES_PER_PAIR = 18
GRAPH_LAUNCHES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # non-tensor-core f32


def require(ok: bool, what: str) -> None:
    """A check of this run (not an assert: it must also hold under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.3f} s", flush=True)
    return now


def game_frame(t: float, device, h: int = H, w: int = W, step: int = STEP_PX) -> torch.Tensor:
    """[h,w,3] uint8 synthetic gameplay frame at time t (frame units):
    gradient background, a textured rectangle moving ``step`` px per frame
    to the right, a static HUD box top left."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    f = torch.stack([xx / w, yy / h, 0.5 + 0.25 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)], -1)
    rh, rw = h // 3, w // 4
    x0, y0 = w // 8 + int(round(t * step)), h // 3
    ly, lx = yy[:rh, :rw], xx[:rh, :rw]
    tex = 0.5 + 0.4 * (torch.sin(lx / 3.0) * torch.cos(ly / 4.0))[..., None]
    f[y0:y0 + rh, x0:x0 + rw] = tex * torch.tensor([1.0, 0.6, 0.2], device=device)
    f[: h // 6, : w // 5] = torch.tensor([0.9, 0.9, 0.1], device=device)
    return torch.clamp(torch.floor(f * 255.0 + 0.5), 0, 255).to(torch.uint8)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = ((a.float() - b.float()) ** 2).mean().item()
    return float("inf") if mse == 0 else 10.0 * torch.log10(torch.tensor(255.0 ** 2 / mse)).item()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_tolerance(ref: torch.Tensor, compute_dtype: torch.dtype) -> float:
    base = 2.0 / 255.0 if compute_dtype == torch.bfloat16 else 1e-5
    return base * max(1.0, ref.float().abs().max().item())


def launch_bound(a: dict) -> tuple:
    """(bound ms, 'bytes'|'operations') of one launch: img, flow and t read
    once, out written once, over HBM bandwidth; ~26 flops per pixel for
    coordinates and weights plus 9 per channel, over the f32 peak."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size() + 4 * n
    ops = n * h * w * (26 + 9 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grid_sample_call(a: dict):
    """torch's bilinear grid_sample (border padding, align_corners=True) on
    the same warp: the library yardstick. Inputs are prepared outside the
    returned call."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    t = torch.as_tensor(a["t"], dtype=torch.float32, device=img.device).reshape(-1, 1, 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                            torch.arange(w, device=img.device, dtype=torch.float32), indexing="ij")
    f = flow.float()
    gx = (xs + f[..., 0] * t) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + f[..., 1] * t) * (2.0 / max(h - 1, 1)) - 1.0
    grid = torch.stack([gx, gy], -1).to(img.dtype)
    inp = img.permute(0, 3, 1, 2).contiguous()
    return lambda: torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                                   padding_mode="border", align_corners=True)


def time_launch(kw, a: dict) -> dict:
    """Times of one recorded launch: the kernel alone and the wrapper's
    origin table alone (GRAPH_LAUNCHES calls of each captured in a CUDA
    graph and replayed, so device time without host overhead), the wrapper
    as the main path calls it (origin table + launch), the plain twin,
    grid_sample, and the bound."""
    img, flow, r, cd = a["img"], a["flow"], a["r"], a["compute_dtype"]
    ry, rx = (r, r) if isinstance(r, int) else r
    t_arr = torch.as_tensor(a["t"], dtype=torch.float32, device=img.device)
    t_arr = t_arr.reshape(-1).expand(img.shape[0]).contiguous()
    bf16 = cd == torch.bfloat16
    origin = kw.window_origins(flow, t_arr, ry, rx, bf16)
    out = torch.empty_like(img)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.launch(img, flow, t_arr, origin, out, r, a["border"], cd)
    origin_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(origin_graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.window_origins(flow, t_arr, ry, rx, bf16)
    args = (img, flow, a["t"], r, a["border"], cd)
    bound, by = launch_bound(a)
    return dict(kernel=time_ms(graph.replay, 5) / GRAPH_LAUNCHES, bound=bound, by=by,
                origin=time_ms(origin_graph.replay, 5) / GRAPH_LAUNCHES,
                wrapper=time_ms(lambda: kw.warp_windowed(*args), 20),
                plain=time_ms(lambda: kw.warp_windowed_plain(*args), 5),
                library=time_ms(grid_sample_call(a), 20))


def synthetic_cases(device):
    """Kernel-vs-plain cases at each launch shape of a 1080p pair (random
    smooth inputs), plus a constant border and a flow past the radius."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def case(name, shape, dt, r, amp=4.0, noise=0.5, border="replicate"):
        n, h, w, c = shape
        img = torch.rand(shape, generator=gen).to(device=device, dtype=dt)
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        base = torch.stack([amp * torch.sin(xx / 17.0 + yy / 23.0),
                            0.5 * amp * torch.cos(yy / 9.0) - 0.5], -1)
        flow = (base + noise * torch.randn((n, h, w, 2), generator=gen)).to(device=device, dtype=dt)
        return dict(name=name, img=img, flow=flow, t=1.0, r=r, border=border, compute_dtype=dt)

    bf, f32 = torch.bfloat16, torch.float32
    return [
        case("ifnet_level_s4", (2, 272, 480, 3), bf, (2, 2)),
        case("ifnet_level_s2", (2, 544, 960, 3), bf, (2, 2)),
        case("ifnet_final", (2, 1088, 1920, 3), bf, (3, 4)),
        case("shared_flow", (4, 1088, 1920, 3), bf, (3, 4)),
        case("scene_gate", (1, 270, 480, 1), f32, 8),
        case("farneback_l0", (1, 270, 480, 5), f32, 8),
        case("farneback_l1", (1, 135, 240, 5), f32, 8),
        case("farneback_l2", (1, 68, 120, 5), f32, 8),
        case("farneback_l3", (1, 34, 60, 5), f32, 8),
        case("constant_border_bf16", (2, 544, 960, 3), bf, (2, 2), amp=12.0, border="constant"),
        case("constant_border_f32", (1, 270, 480, 5), f32, 8, amp=12.0, border="constant"),
        case("past_radius_bf16", (2, 272, 480, 3), bf, (2, 2), amp=25.0, noise=4.0),
        case("past_radius_f32", (1, 270, 480, 1), f32, 2, amp=25.0, noise=4.0),
    ]


def main() -> int:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "vfisr_tpu_torch").is_dir():
        print(f"chip_smoke: no vfisr_tpu_torch/ beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.ops.cuda import warp as kw
    from vfisr_tpu_torch.pipeline.flagship import (FlagshipVFI, analyze_small, init_history,
                                                   push_history)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    kw.build()
    t0 = _phase("build", t0)

    rife_npz, gate_json = ROOT / "weights" / "rife.npz", ROOT / "weights" / "router_gate.json"
    require(rife_npz.is_file() and gate_json.is_file(), f"{rife_npz} and {gate_json} present")
    vfi = FlagshipVFI(device="cuda")
    # explicit paths make the loads strict: a missing or mismatched
    # checkpoint raises instead of leaving a fresh init
    vfi.load(weights_path=str(rife_npz), gate_path=str(gate_json))
    require(vfi._module.config.channels == (256, 160, 112, 80), "full-width RIFE")
    require(vfi.base_config.scene_warp_ssim_threshold != 1.0, "calibrated scene gate loaded")
    frames = [game_frame(i, dev) for i in range(PAIRS + 1)]
    out_hw = (1440, 2560)
    t0 = _phase("load", t0)

    # warm-up pair, recording every kernel launch's inputs for the checks
    real_warp = kw.warp_windowed
    recorded = []

    def recording(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        recorded.append(dict(img=img.clone(), flow=flow.clone(),
                             t=t.clone() if torch.is_tensor(t) else t, r=r, border=border,
                             compute_dtype=compute_dtype))
        return real_warp(img, flow, t, r, border, compute_dtype)

    kw.warp_windowed = recording
    try:
        vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
        torch.cuda.synchronize()
    finally:
        kw.warp_windowed = real_warp
    require(len(recorded) == LAUNCHES_PER_PAIR, f"{len(recorded)} warp launches in a pair")
    t0 = _phase("warmup_record", t0)

    # the main path, counted and timed
    vfi.reset_history()
    torch.cuda.reset_peak_memory_stats()
    outs, pair_ms = [], []
    kw.launches = 0
    for i in range(PAIRS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(vfi.fused_stream_step(frames[i], frames[i + 1], SCALE, TS))
        end.record()
        end.synchronize()
        pair_ms.append(start.elapsed_time(end))
    launches = kw.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    require(launches == LAUNCHES_PER_PAIR * PAIRS, f"{launches} kernel launches in {PAIRS} pairs")
    t0 = _phase("main_path", t0)

    # outputs
    for up in outs:
        require(up.dtype == torch.uint8 and tuple(up.shape) == (1 + len(TS), *out_hw, 3),
                f"output {up.dtype} {tuple(up.shape)}")
    gain = []
    for i, up in enumerate(outs):
        x0 = frames[i].float()[None] / 255.0
        require(torch.equal(up[0], to_uint8(resize(x0, out_hw, "lanczos4"))[0]), "endpoint frame")
        for k, t in enumerate(TS):
            truth = to_uint8(resize(game_frame(i + t, dev).float()[None] / 255.0, out_hw, "lanczos4"))[0]
            p_mid, p_dup = psnr(up[1 + k], truth), psnr(up[0], truth)
            gain.append(p_mid - p_dup)
            require(p_mid > p_dup, f"pair {i} t={t}: interpolated {p_mid:.2f} dB <= duplicate {p_dup:.2f} dB")
    print(f"midpoint PSNR gain over frame duplication (dB): min {min(gain):.3f} "
          f"mean {sum(gain) / len(gain):.3f}")

    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    vfi.reset_history()
    up_kernel = vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
    vfi.reset_history()
    kw.warp_windowed = plain_warp
    try:
        up_plain = vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
    finally:
        kw.warp_windowed = real_warp
    d = (up_kernel.int() - up_plain.int()).abs()
    print(f"pair with kernel vs with plain twin: max {d.max().item()} LSB, "
          f"mean {d.float().mean().item():.6f} LSB (tolerance max 2, mean 0.05)")
    require(d.max().item() <= 2 and d.float().mean().item() <= 0.05, "kernel vs twin in the step")
    t0 = _phase("outputs", t0)

    # the kernel against its plain twin
    max_err = 0.0

    def compare(label, a):
        nonlocal max_err
        args = (a["img"], a["flow"], a["t"], a["r"], a["border"], a["compute_dtype"])
        out = kw.warp_windowed(*args)
        ref = kw.warp_windowed_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = kernel_tolerance(ref, a["compute_dtype"])
        max_err = max(max_err, err)
        ok = err <= tol
        print(f"kernel vs plain {label}: {tuple(a['img'].shape)} {str(a['img'].dtype)[6:]} "
              f"window {str(a['compute_dtype'])[6:]} r={a['r']} {a['border']}: "
              f"max_abs_err {err:.3e} tol {tol:.3e} {'ok' if ok else 'FAIL'}")
        require(ok, f"kernel vs plain {label}")

    for j, a in enumerate(recorded):
        compare(f"main-path launch {j}", a)
    for a in synthetic_cases(dev):
        compare(a["name"], a)
    t0 = _phase("kernel_checks", t0)

    # per-launch timing at the main path's shapes
    totals = dict(kernel=0.0, origin=0.0, wrapper=0.0, plain=0.0, bound=0.0, library=0.0)
    by_shape = {}
    for a in recorded:
        key = (tuple(a["img"].shape), a["img"].dtype, a["compute_dtype"], a["r"], a["border"])
        if key not in by_shape:
            by_shape[key] = dict(n=0, **time_launch(kw, a))
        by_shape[key]["n"] += 1
    for key, s in by_shape.items():
        print(f"launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} x{s['n']}/pair: "
              f"kernel {s['kernel']:.4f} ms, bound {s['bound']:.4f} ms ({s['by']}), "
              f"origin table {s['origin']:.4f} ms, wrapper {s['wrapper']:.4f} ms, plain {s['plain']:.4f} ms, grid_sample {s['library']:.4f} ms")
        for k in totals:
            totals[k] += s["n"] * s[k]
    bound_by = {s["by"] for s in by_shape.values()}
    largest = max(by_shape, key=lambda k: torch.Size(k[0]).numel())
    print(f"grid_sample at the largest launch shape {largest[0]}: {by_shape[largest]['library']:.4f} ms")
    t0 = _phase("timing", t0)

    # where a pair's time goes: each stage of the step alone, after warm-up
    x0, x1 = (f.float()[None] / 255.0 for f in frames[:2])
    hist, hcnt = init_history(1, dev)
    cfg = dataclasses.replace(vfi.base_config, out_hw=out_hw)
    four = torch.cat([x0, x1, x1, x1])
    stages = {
        "analysis (push_history + analyze_small)":
            lambda: analyze_small(x0, x1, *push_history(hist, hcnt, x0), cfg),
        "rife (interpolate_batch: pad + shared_flow_apply)":
            lambda: vfi.interpolate_batch(x0, x1, TS),
        "sr (lanczos4 to 2560x1440 + to_uint8, 4 frames)":
            lambda: to_uint8(resize(four, out_hw, "lanczos4")),
    }
    with torch.no_grad():
        for name, fn in stages.items():
            print(f"stage {name}: {time_ms(fn, 5):.3f} ms")
    t0 = _phase("breakdown", t0)

    ms = sum(pair_ms) / len(pair_ms)
    print(f"flagship step 1080p->1440p, {len(TS)} midpoints: ms/pair {ms:.3f} "
          f"(pairs: {', '.join(f'{x:.3f}' for x in pair_ms)}); interpolated fps "
          f"{len(TS) * 1000.0 / ms:.2f}; output fps {(1 + len(TS)) * 1000.0 / ms:.2f}; "
          f"max_memory_allocated {peak_mb:.1f} MB")
    print(f"warp kernel per pair: {LAUNCHES_PER_PAIR} launches, kernel {totals['kernel']:.4f} ms, "
          f"bound {totals['bound']:.4f} ms, origin table (device) {totals['origin']:.4f} ms, "
          f"wrapper {totals['wrapper']:.4f} ms, "
          f"plain {totals['plain']:.4f} ms, grid_sample {totals['library']:.4f} ms")
    print(f"wall {time.perf_counter() - wall0:.2f} s")
    print(json.dumps({"kernels": [{
        "name": "warp_windowed", "route": "cuda",
        "source": "vfisr_tpu_torch/csrc/warp_windowed.cu",
        "replaces": "vfisr_tpu/ops/pallas/warp.py:348",
        "launches": launches, "max_abs_err": max_err,
        "ms": totals["kernel"], "plain_ms": totals["plain"], "bound_ms": totals["bound"],
        "bound_by": "bytes" if bound_by == {"bytes"} else "operations",
        "library_ms": totals["library"]}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
