"""Smoke run of the PyTorch port (vfisr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or PATH) and the repository's
vfisr_tpu_torch/ and weights/ beside this file; no network. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the windowed-warp kernels (csrc/warp_windowed.cu) with nvcc;
3. loads FlagshipVFI(device="cuda") with weights/rife.npz (full-width RIFE,
   bf16 deploy config) and weights/router_gate.json;
4. drives the flagship fused step (fused_stream_step) over a stream of
   synthetic 1920x1080 gameplay frames (gradient, moving textured
   rectangle, static HUD box) to 2560x1440 uint8, with the kernel's launch
   count set to 0 before and read after (18 launches per pair), and with
   the wrapper's torch-op origin table (``window_origins``) swapped for a
   function that raises: the kernels compute their origins themselves;
5. checks the outputs: shapes and dtypes, the endpoint frame against its
   own upscale, the midpoints beating frame duplication against the
   synthetic scene's true in-between frames, and one pair against the same
   step with the kernel's plain PyTorch twin substituted;
6. holds the kernel against its plain twin at every launch of a pair of the
   main path (the inputs recorded as the path made them) and at synthetic
   cases of each launch shape, a constant border and a flow that leaves
   the window (tolerance 1e-5 in f32 windows, 2/255 in bf16 windows, both
   relative to the largest magnitude when it exceeds 1); holds the window
   origins the kernels compute (``kernel_origins``) equal to
   ``window_origins`` at each of those launches; and holds origins, K1 and
   K2 at the origin's edge cases (tile means on .5 after scaling by t,
   +-300 px flows, 1080 and 270 rows, a t per image, odd bf16 row origins,
   the constant border);
7. times the step (CUDA events, after warm-up), each of its stages alone,
   and, per launch shape, the kernel alone with its origin (CUDA-graph
   replay: device time), the wrapper's host time per call (enqueue, no
   synchronisation), the wrapper as the path calls it (CUDA events), the
   plain twin and torch's grid_sample (a yardstick only);
8. trains full-width RIFE (weights/rife.npz, taken for training) on
   synthetic scenes made on the card (batch 16, crop 192, detail 0.35, lr
   2e-4, remat), through the trainer's own entry points: one recorded
   step with both kernels' launch counts set to 0 before and read after
   (10 warp launches: 2 for the data, 4 in the forward, 4 in its
   recompute; 4 launches of the warp's flow-gradient kernel K2) and
   ``window_origins`` raising, the kernels' origins held equal to it at
   all 14 launches, K2 held
   against its plain twin at every recorded launch and at synthetic cases
   of each launch shape (constant border, flows past the radius, zero and
   integer flows), K1 at the training's launches, the whole step's loss
   and gradients with the kernels against the same step with both plain
   twins, TRAIN_STEPS timed steps with finite losses (ms/step, samples/s,
   peak memory), a save_npz/load round trip in a temporary directory, and
   per launch shape the kernels alone (CUDA-graph replay), the wrappers'
   host time, their bounds, plain twins and torch's grid_sample (forward,
   and its grid gradient for K2) as yardsticks;
9. loads the adaptive model through the registry, get_model("adaptive",
   load=True), with weights/rife.npz (full-width RIFE, f32, bf16 warp
   windows), weights/vfimamba.npz (d_model 256, 12 blocks, d_state 16, two
   refinement levels) and weights/router_gate.json by explicit path (strict;
   every parameter checked against its file; VFIMamba must stay enabled),
   and streams a 1920x1080 sequence with a static HUD through
   AdaptivePipeline.interpolate_batch (hosted), one pair per call: five 3 px
   pans fill the HUD ring, then a static pair, a 3 px pan, an 8 px pan and a
   cut, with K1's count set to 0 before and read after and
   ``window_origins`` raising. Checks: each pair's route equals bin_winner
   of its measured motion_mean (its K1 launches, 17 for RIFE, 19 for
   VFIMamba, 13 for a cut, say which expert ran), rife, vfimamba and
   scene_change all hit; HUD pixels equal their source where the composite
   applies and the cut's midpoints are its x0 elsewhere; the moving
   midpoints beat frame duplication; K1 and its origins at every launch
   against the twin and window_origins; the whole sequence with the kernel
   against it with the plain twin (2/255) and masked against hosted (1e-5),
   under deterministic cuDNN. Then process_pair once (5 frames at 2560x1440
   uint8), and the times: ms per pair and route, the analysis, RIFE and
   VFIMamba alone (the selective scan's share of VFIMamba), peak memory,
   VFIMamba's decoder conv with and without cuDNN, and K1 per launch shape
   as in step 7;
10. loads SAFA through the registry, get_model("safa", load=True)
   (weights/safa.npz, c 176, 8 decoder blocks; every parameter checked
   against the file; TF32 off after load), and runs three 1920x1080 pairs of
   step 9's scene (static, 3 px pan, 8 px pan) through
   SAFAModel.interpolate_batch with 3 midpoints: 12 tiles of 360x480 with
   48 px of context, each a batch-3 forward whose 6 feature warps
   ([3,114,144,176], K1 in channel groups) and 2 frame warps
   ([3,456,576,3]) go through K1: 96 launches per pair, counted with
   ``window_origins`` raising. Checks: finite [0, 1] frames; K1 against its
   twin and its origins at all 96 launches of a pair; the feature launches'
   plans take channel groups; the pair with the kernel against it with the
   plain twin (deterministic cuDNN, 1e-5); joint_process at 1.333 once (5
   frames at 2560x1440 uint8). Prints ms per pair, ms per tile forward and
   its conv FLOP, peak memory over resident, each distinct conv shape of a
   tile with cuDNN's heuristic plan and with cuDNN off, K1 per launch shape
   as in step 7 (for the feature warps in channel groups also a line with
   the kernel, its bound, grid_sample beside it and the plan), and the
   midpoints' PSNR against the scene's true frames and against frame
   duplication (printed only);
11. SPAN: get_model("span", load=True) (x2, weights/span_x2.npz, every
   parameter checked) upscales 4 frames of the scene 1920x1080 -> 2560x1440
   (ms, PSNR against Lanczos4, its conv shapes as in step 10);
   SPANModel(scale=4) once from 960x540; get_model("rife_span",
   load=True).process_pair once on a 1080p pair; and
   AdaptivePipeline(sr_model_name="span") runs interpolate_batch and
   upscale_batch on one pair (its SR equal to SPAN's);
12. holds K1 in channel groups against its twin at C in GROUPED_C, f32 and
   bf16 windows, both borders, at SAFA's feature shape (in step 6's phase),
   and shows that every K1 launch of steps 4, 8 and 9, and every K2 launch
   of step 8, keeps the whole-C layout (one channel group);
13. trains full-width SAFA (weights/safa.npz, taken for training; TF32 off)
   as ``python -m vfisr_tpu_torch.train --model safa`` does at its defaults:
   batch 16, crop 192 (scenes made on the card at 384, the endpoints
   area-resized to 192, the midpoint supervised at 384; the trainer's own
   ``batch_maker``), lr 2e-4, remat. One recorded step with both kernels'
   counts set to 0 before and read after and ``window_origins`` raising:
   18 K1 launches (12 feature warps [16,48,48,176] in channel groups, 4
   frame warps and 2 data warps whole-C), 6 K2 launches (4 feature warps in
   channel groups at 176 channels, 2 frame warps whole-C), 6 shifted
   adjoints (the features' gradient). Checks: origins at all 24 launches;
   K2 against its twin at every launch and at synthetic cases of each
   shape (1e-5 of the largest |cg| with f32 windows); K1 against its twin
   at every launch; each grouped K2 launch twice, bit-identical, and in
   one chunk per tile (one launch per call, no scratch); the whole
   step with the kernels against the same step with both plain twins
   (deterministic cuDNN; loss 1e-5 relative, gradients 1e-4 of each
   tensor's largest). Then SAFA_TRAIN_STEPS timed steps, counted (ms/step,
   samples/s, peak memory), the shifted adjoint per call at the step's own
   inputs and its share of a step, the adjoint and the step again with
   every offset of the radius instead of the offsets that the
   displacements' range (read back to the host) lets reach (the same
   values; timed steps with the read-back, every offset, the read-back
   again), every conv shape of a step forward and
   backward with cuDNN's plan and without (the path's forward choice
   printed), and per launch shape the kernels alone (CUDA-graph replay),
   their wrappers, bounds, plain twins and grid_sample (its grid gradient
   for K2), and for each launch shape in channel groups a line with the
   kernel, its bound, the library call and the plan;
14. trains SPAN x2 and x4 (weights/span_x2.npz, span_x4.npz) as the trainer
   does (``make_sr_train_step``, crisp scenes at 192, the input
   area-resized to 96 or 48; batch 16, no remat): SPAN_TRAIN_STEPS timed
   steps each (ms/step, samples/s, peak memory, no warp launched) and the
   conv table as in step 13;
15. streams a video through the port's entry point, process_video
   (pipeline/streaming.py), with the flagship: 13 frames of step 4's
   scene at 1920x1080 written to a 30 fps Y4M (the port's writer, in a
   temporary directory), process_video(method="flagship", target_fps=120,
   target_resolution=(2560, 1440)) with K1's count set to 0 before and
   read after and ``window_origins`` raising. Checks: the model the
   registry built holds every parameter of weights/rife.npz and the
   calibrated gate; the fused writer thread, yuv420 readback, 49 frames
   out, 18 K1 launches per pair; each pair's four frames read back from
   the output Y4M bit-equal to pack_i420(fused_stream_step(...)) computed
   directly on the decoded frames with the HUD history carried (K1
   against its twin and its origins at every launch of that), the final
   endpoint likewise; every midpoint above frame duplication against the
   rendered truth (PSNR over I420 bytes). Prints interpolated fps (3 x
   pairs / elapsed), realtime_x, every stage timer, and I420 -> RGB of a
   1080p frame on the host (VideoReader.read) and on the card (the
   stream's way);
16. streams step 9's sequence (pans, a static pair, a cut) as a 30 fps
   Y4M through process_video with the default model (method=None:
   get_model("adaptive", load=True)). Checks: full-width RIFE and VFIMamba
   holding every parameter of their files, a calibrated gate; each pair
   routed to bin_winner of its motion, every route hit, K1's launches
   equal to the routes' sum; the HUD and cut composites as in step 9;
   37 frames out. Prints fps and the timers as step 15.

Any failure raises and the exit code is not 0. The line before the last is
{"kernels": [...]}: per kernel, its launches counted on every path that runs
it (K1: the flagship pairs, the flagship stream, the RIFE train steps, the
adaptive sequence, the adaptive stream, the SAFA pairs and the SAFA train
steps; K2: the RIFE and the SAFA train steps) and the device time, bound,
plain-twin and grid_sample time of exactly those launches (a stream's
launches at their shapes' times from steps 7 and 9). The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
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
# the training phase: scripts/train.py's defaults for full-width RIFE
TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL, TRAIN_LR = 16, 192, 0.35, 2e-4
TRAIN_STEPS = 10  # timed, after 2 warm-up steps
K1_PER_STEP = 10  # 2 data warps + 4 IFNet warps (levels 1-3, final) + their 4 recomputes
K2_PER_STEP = 4  # the backward of the 4 IFNet warps
ORIGIN_TABLE = None  # ops.cuda.warp.window_origins, once main() has imported it
# the adaptive phase: AdaptivePipeline (get_model("adaptive")) over a 1080p
# sequence with a static HUD. HISTORY_PAIRS 3 px pans fill the HUD ring,
# then the measured pairs: (name, x0, x1) as (pan offset px or cut scene)
HISTORY_PAIRS, PAN_PX = 5, 3
MEASURED = (("static", 15, 15), ("pan 3 px", 15, 18), ("pan 8 px", 18, 26), ("cut", 26, "cut"))
# K1 launches per pair and route: Farneback 12 + scene gate 1, then RIFE's
# 4 (s4, 2x s2, final; batch 6) or VFIMamba's 6 (two per refinement level
# and two at full res; batch 3)
K1_PER_ROUTE = {"rife": 17, "vfimamba": 19, "scene_change": 13}
K1_MASKED = 23  # both experts run on every pair
# the SAFA phase: 1920x1080 pairs of the adaptive phase's scene through
# SAFAModel.interpolate_batch (12 tiles of 360x480 + 48 px, batch 3); each
# tile's forward warps the features 6 times ([3,114,144,176]) and the frames
# twice ([3,456,576,3])
SAFA_PAIRS = (("static", 15, 15), ("pan 3 px", 15, 18), ("pan 8 px", 18, 26))
K1_PER_SAFA_PAIR = 96
GROUPED_C = (10, 16, 33, 176)  # K1 past the channels one window holds
# the SAFA training phase: scripts/train.py --model safa at its defaults
# (batch 16, crop 192: scenes at 384, the endpoints area-resized to 192, the
# midpoint supervised at 384; remat). Per step, K1: 2 data warps, then the
# 6 feature warps ([16,48,48,176], channel groups) and 2 frame warps
# ([16,192,192,3]) of the forward and of its recompute; K2: the flow
# gradients of the 4 feature warps whose flow is trained (flow stage 1 and
# the aggregation; stage 0 warps by a constant zero flow) and of the 2 frame
# warps; the features' gradient of all 6 feature warps through the shifted
# adjoint
SAFA_TRAIN_STEPS = 5  # timed, after 1 warm-up step
K1_PER_SAFA_STEP, K1_GROUPED_PER_SAFA_STEP = 18, 12
K2_PER_SAFA_STEP, K2_GROUPED_PER_SAFA_STEP = 6, 4
ADJOINTS_PER_SAFA_STEP = 6
SPAN_TRAIN_STEPS = 5  # SPAN x2 and x4 at batch 16, crop 192: timed, after 1 warm-up step


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


def scene_frame(x, device, h: int = H, w: int = W, waves: int = 24) -> torch.Tensor:
    """[h,w,3] uint8 frame of the adaptive phase's sequence: for a number x,
    a texture of seeded random plane waves (wavelengths 8-64 px) moved
    right by x px; for "cut", another scene (seeded random 2x2 px blocks at
    1920 wide, which no flow maps onto the first). A static HUD box top
    left in both."""
    if x == "cut":
        gen = torch.Generator(device="cpu").manual_seed(1)
        blk = max(1, w // 960)
        blocks = torch.rand((h // blk + 1, w // blk + 1, 3), generator=gen).to(device)
        f = blocks.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:h, :w].contiguous()
    else:
        gen = torch.Generator(device="cpu").manual_seed(0)
        k = 2 * math.pi / (8.0 + 56.0 * torch.rand((waves,), generator=gen))
        ang = torch.rand((waves,), generator=gen) * 2 * math.pi
        kx, ky = (k * torch.cos(ang)).tolist(), (k * torch.sin(ang)).tolist()
        phase = (torch.rand((waves, 3), generator=gen) * 2 * math.pi).tolist()
        amp = (0.35 / math.sqrt(waves) * (0.5 + torch.rand((waves, 3), generator=gen))).tolist()
        yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                                torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
        f = torch.full((h, w, 3), 0.5, device=device)
        for i in range(waves):
            arg = kx[i] * (xx - x) + ky[i] * yy
            for c in range(3):
                f[..., c] += amp[i][c] * torch.sin(arg + phase[i][c])
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


def grad_launch_bound(a: dict) -> tuple:
    """(bound ms, 'bytes'|'operations') of one K2 launch: img, flow, ct and
    t read once, grad_flow and cg written once, over HBM bandwidth; ~30
    flops per pixel for coordinates, weights and masks plus ~20 per
    channel, over the f32 peak."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    nbytes = (2 * img.numel() * img.element_size() + 2 * flow.numel() * flow.element_size()
              + 4 * flow.numel() + 4 * n)
    ops = n * h * w * (30 + 20 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grid(a: dict) -> torch.Tensor:
    """grid_sample's normalised grid for the warp of a (align_corners=True)."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    t = torch.as_tensor(a["t"], dtype=torch.float32, device=img.device).reshape(-1, 1, 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                            torch.arange(w, device=img.device, dtype=torch.float32), indexing="ij")
    f = flow.float()
    gx = (xs + f[..., 0] * t) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + f[..., 1] * t) * (2.0 / max(h - 1, 1)) - 1.0
    return torch.stack([gx, gy], -1).to(img.dtype)


def grid_sample_grad_call(a: dict):
    """The grid gradient of torch's grid_sample (bilinear, border,
    align_corners=True) at the shape of a K2 launch: the library yardstick.
    The forward is built once outside the returned call, which runs the
    backward alone."""
    img = a["img"].permute(0, 3, 1, 2).contiguous()
    grid = _grid(a).requires_grad_(True)
    out = torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                          align_corners=True)
    ct = a["ct"].permute(0, 3, 1, 2).contiguous()
    return lambda: torch.autograd.grad(out, grid, ct, retain_graph=True)


def grid_sample_call(a: dict):
    """torch's bilinear grid_sample (border padding, align_corners=True) on
    the same warp: the library yardstick. Inputs are prepared outside the
    returned call."""
    grid = _grid(a)
    inp = a["img"].permute(0, 3, 1, 2).contiguous()
    return lambda: torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                                   padding_mode="border", align_corners=True)


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one call of fn (what the caller's thread spends to
    enqueue it; no synchronisation inside the timed loop), after warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def time_launch(kw, a: dict) -> dict:
    """Times of one recorded launch: the kernel alone, its origin included
    (GRAPH_LAUNCHES launches captured in a CUDA graph and replayed, so
    device time without host overhead), the wrapper's host time per call
    and the wrapper as the main path calls it (CUDA events), the plain
    twin, grid_sample, and the bound."""
    img, flow, r, cd = a["img"], a["flow"], a["r"], a["compute_dtype"]
    out = torch.empty_like(img)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.launch(img, flow, a["t"], out, r, a["border"], cd)
    args = (img, flow, a["t"], r, a["border"], cd)
    bound, by = launch_bound(a)
    return dict(kernel=time_ms(graph.replay, 5) / GRAPH_LAUNCHES, bound=bound, by=by,
                host=host_ms(lambda: kw.warp_windowed(*args)),
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


def adversarial_cases(device) -> list:
    """The window origin's edge cases, at shapes of the path's launches:
    tile means that land exactly on .5 after scaling by t (t = 0.5, odd
    integer tile flows plus a zero-sum +-6 checkerboard), uniform +-300 px
    flows (the order of the f32 sums decides the mean's last bits), 1080
    and 270 rows (edge-padded tiles), a t per image, integer tile flows
    that give odd row origins before bf16 rounds them to even, and the
    constant border. Each carries a random cotangent for K2."""
    gen = torch.Generator(device="cpu").manual_seed(2)

    def case(name, kind, shape, img_dt, window_dt, r, border="replicate"):
        n, h, w, c = shape
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        ty, tx = yy // 32, xx // 256
        t = 1.0
        if kind == "tie":
            t = 0.5
            k = torch.randint(-4, 5, (n, 2, 1, 1), generator=gen) + torch.stack(
                [3 * ty - tx, tx - 2 * ty])
            flow = (2 * k + 1) + torch.where(yy % 2 == xx % 2, 6, -6)
        elif kind == "large":
            flow = torch.rand((n, 2, h, w), generator=gen) * 600.0 - 300.0
        elif kind == "odd_row":
            k = torch.randint(0, 6, (n, 2, 1, 1), generator=gen) + torch.stack([tx + ty, ty])
            flow = k + 0.2 * torch.randn((n, 2, h, w), generator=gen)
        else:  # smooth, with ragged shapes and a t per image
            flow = torch.stack([6.0 * torch.sin(xx / 17.0 + yy / 23.0),
                                3.0 * torch.cos(yy / 9.0) - 0.5])[None]
            flow = flow + torch.randn((n, 2, h, w), generator=gen)
            if kind == "per_batch_t":
                t = torch.linspace(0.3, 1.7, n, device=device)
        flow = flow.permute(0, 2, 3, 1).float().contiguous()
        return dict(name=name, img=torch.rand(shape, generator=gen).to(device, img_dt),
                    ct=torch.randn(shape, generator=gen).to(device, img_dt),
                    flow=flow.to(device, img_dt), t=t, r=r, border=border,
                    compute_dtype=window_dt)

    bf, f32 = torch.bfloat16, torch.float32
    return [
        case("tie_final", "tie", (2, 1088, 1920, 3), bf, bf, (3, 4)),
        case("tie_level", "tie", (32, 96, 96, 3), f32, bf, (2, 4)),
        case("large_farneback", "large", (1, 270, 480, 5), f32, f32, 8),
        case("large_train_final", "large", (32, 192, 192, 3), f32, bf, (4, 6)),
        case("ragged_1080", "ragged", (2, 1080, 1920, 3), bf, bf, (3, 4)),
        case("ragged_270_constant", "ragged", (1, 270, 480, 1), f32, f32, 8, "constant"),
        case("per_batch_t_level", "per_batch_t", (32, 48, 48, 3), f32, bf, (2, 4)),
        case("per_batch_t_data", "per_batch_t", (48, 192, 192, 4), f32, f32, 2, "constant"),
        case("odd_row_s2", "odd_row", (2, 544, 960, 3), bf, bf, (2, 2)),
        case("odd_row_constant", "odd_row", (2, 272, 480, 3), bf, bf, (2, 2), "constant"),
    ]


def check_origins(kw, label: str, a: dict) -> None:
    """The window origins the kernels compute equal window_origins', int
    for int (the output alone can hide an origin one pixel off)."""
    flow, r, cd = a["flow"], a["r"], a["compute_dtype"]
    ry, rx = (r, r) if isinstance(r, int) else r
    t_arr = torch.as_tensor(a["t"], dtype=torch.float32, device=flow.device)
    t_arr = t_arr.reshape(-1).expand(flow.shape[0]).contiguous()
    got = kw.kernel_origins(flow, a["t"], r, cd)
    ref = ORIGIN_TABLE(flow, t_arr, ry, rx, cd == torch.bfloat16)
    same = got.shape == ref.shape and torch.equal(got, ref)
    print(f"origins kernel vs window_origins {label}: {tuple(ref.shape[:3])} tiles "
          f"{'equal' if same else 'DIFFER'}")
    require(same, f"kernel origins vs window_origins {label}")


@contextlib.contextmanager
def origin_table_raises(kw):
    """Swaps the wrapper module's window_origins for a function that
    raises: a run inside shows that the kernels' path never reaches it."""
    def raising(*args, **kwargs):
        raise RuntimeError("window_origins reached on the kernels' path")

    kw.window_origins = raising
    try:
        yield
    finally:
        kw.window_origins = ORIGIN_TABLE


def _label(a: dict) -> str:
    return (f"{tuple(a['img'].shape)} {str(a['img'].dtype)[6:]} window "
            f"{str(a['compute_dtype'])[6:]} r={a['r']} {a['border']}")


def check_warp(kw, label: str, a: dict) -> float:
    """K1 against its plain twin on the inputs of a; returns the error."""
    args = (a["img"], a["flow"], a["t"], a["r"], a["border"], a["compute_dtype"])
    out = kw.warp_windowed(*args)
    ref = kw.warp_windowed_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref, a["compute_dtype"])
    print(f"kernel vs plain {label}: {_label(a)}: max_abs_err {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"kernel vs plain {label}")
    return err


def check_warp_grad(kw, label: str, a: dict) -> float:
    """K2 against its plain twin on the inputs of a (grad_flow and cg),
    within 1e-5 (f32 windows) or 2/255 (bf16) of the largest |cg|; returns
    the error."""
    args = (a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"], a["compute_dtype"])
    gflow, cg = kw.warp_windowed_grad(*args)
    ref_gflow, ref_cg = kw.warp_windowed_grad_plain(*args)
    torch.cuda.synchronize()
    err = max((gflow.float() - ref_gflow.float()).abs().max().item(),
              (cg - ref_cg).abs().max().item())
    # relative to the largest magnitude, not to max(1, it): the training's
    # cotangents are ~1e-7, so a floor of 1 would pass anything
    scale = ref_cg.abs().max().item()
    tol = (2.0 / 255.0 if a["compute_dtype"] == torch.bfloat16 else 1e-5) * scale
    require(scale > 0, f"{label} has a gradient to check")
    print(f"grad kernel vs plain {label}: {_label(a)}: max_abs_err {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"grad kernel vs plain {label}")
    return err


def grad_cases(recorded: list) -> list:
    """K2-vs-plain cases at each recorded launch shape: a constant border,
    flows past the radius, zero and integer flows (random img and ct)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    cases, seen = [], set()
    for a in recorded:
        key = (tuple(a["img"].shape), a["r"], a["compute_dtype"])
        if key in seen:
            continue
        seen.add(key)
        n, h, w, c = a["img"].shape
        dev = a["img"].device

        def case(name, flow, border="replicate"):
            img = torch.rand((n, h, w, c), generator=gen).to(dev, a["img"].dtype)
            ct = torch.randn((n, h, w, c), generator=gen).to(dev, a["img"].dtype)
            return dict(a, name=f"{name} {key[0]}", img=img, ct=ct, border=border,
                        flow=flow.to(dev, a["flow"].dtype))

        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        smooth = torch.stack([torch.sin(xx / 17.0 + yy / 23.0), torch.cos(yy / 9.0)], -1)
        cases += [
            case("constant_border", 12.0 * smooth + 0.5 * torch.randn((n, h, w, 2), generator=gen),
                 border="constant"),
            case("past_radius", 25.0 * smooth + 4.0 * torch.randn((n, h, w, 2), generator=gen)),
            case("zero_flow", torch.zeros((n, h, w, 2))),
            case("integer_flow", torch.randint(-3, 4, (n, h, w, 2), generator=gen).float()),
        ]
    return cases


def time_grad_launch(kw, a: dict) -> dict:
    """Times of one recorded K2 launch: the kernel alone, its origin
    included (GRAPH_LAUNCHES launches captured in a CUDA graph and
    replayed: device time), the wrapper's host time per call and the
    wrapper as the backward calls it, the plain twin, grid_sample's grid
    gradient, and the bound."""
    img, flow, r, cd = a["img"], a["flow"], a["r"], a["compute_dtype"]
    ct = a["ct"].contiguous()
    gflow = torch.empty_like(flow)
    cg = torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.launch_grad(img, flow, a["t"], ct, gflow, cg, r, a["border"], cd)
    args = (img, flow, a["t"], ct, r, a["border"], cd)
    bound, by = grad_launch_bound(a)
    return dict(kernel=time_ms(graph.replay, 5) / GRAPH_LAUNCHES, bound=bound, by=by,
                host=host_ms(lambda: kw.warp_windowed_grad(*args)),
                wrapper=time_ms(lambda: kw.warp_windowed_grad(*args), 20),
                plain=time_ms(lambda: kw.warp_windowed_grad_plain(*args), 5),
                library=time_ms(grid_sample_grad_call(a), 20))


def path_numbers(launches: int, err: float, per_unit: dict, units: int) -> dict:
    """A path's numbers for the kernels JSON: its counted launches, the
    largest kernel-vs-plain error, and the device times of those launches
    (the per-pair or per-step totals times the pairs or steps counted)."""
    return dict(launches=launches, err=err, by=per_unit["by"],
                **{k: per_unit[k] * units for k in ("kernel", "plain", "bound", "library")})


def kernel_entry(name: str, paths: list) -> dict:
    """One kernel's object of the kernels JSON, summed over the paths that
    launch it."""
    by = {p["by"] for p in paths}
    return {"name": name, "route": "cuda", "source": "vfisr_tpu_torch/csrc/warp_windowed.cu",
            "replaces": "vfisr_tpu/ops/pallas/warp.py:348",
            "launches": sum(p["launches"] for p in paths),
            "max_abs_err": max(p["err"] for p in paths),
            "ms": sum(p["kernel"] for p in paths), "plain_ms": sum(p["plain"] for p in paths),
            "bound_ms": sum(p["bound"] for p in paths),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": sum(p["library"] for p in paths)}


def shape_times(kw, recs: list, timer) -> dict:
    """Per distinct launch shape of recs: its count and the timer's numbers."""
    by_shape = {}
    for a in recs:
        key = shape_key(a)
        if key not in by_shape:
            by_shape[key] = dict(n=0, **timer(kw, a))
        by_shape[key]["n"] += 1
    return by_shape


def shape_key(a: dict) -> tuple:
    return (tuple(a["img"].shape), a["img"].dtype, a["compute_dtype"], a["r"], a["border"])


def plan_text(pl: dict) -> str:
    """A launch's plan (``ops/cuda/warp.py::plan``) in words."""
    if not pl["grouped"]:
        return f"whole-C, {pl['split']} row slice(s) of {pl['rows']} rows, {pl['ctas']} CTAs"
    return (f"channel groups, {pl['ctas']} CTAs: {pl['split']} block(s) of {pl['pixels']} "
            f"pixels per tile x {pl['chunks']} chunk(s) of {-(-pl['groups'] // pl['chunks'])} "
            f"groups of {pl['cg']} channels, {pl['stages']} ring slots, {pl['smem']} B shared")


def print_grouped(kw, label: str, unit: str, key: tuple, a: dict, v: dict, grad: bool) -> None:
    """One line per launch shape in channel groups: the kernel, its bound,
    the library call timed beside it, and the plan."""
    pl = kw.plan(a["img"], a["r"], a["compute_dtype"], grad)
    if not pl["grouped"]:
        return
    lib = "grid_sample grad" if grad else "grid_sample"
    print(f"grouped {'K2' if grad else 'K1'} {label} {key[0]} x{v['n']}/{unit}: kernel "
          f"{v['kernel']:.4f} ms, bound {v['bound']:.4f} ms ({v['kernel'] / v['bound']:.2f}x), "
          f"{lib} {v['library']:.4f} ms ({'faster' if v['kernel'] < v['library'] else 'SLOWER'}: "
          f"{v['library'] / v['kernel']:.2f}x); {plan_text(pl)}")


def _recording(kw, recs: list):
    """K1's wrapper, recording each launch's inputs (cloned) in recs."""
    real = kw.warp_windowed

    def recording(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        recs.append(dict(img=img.clone(), flow=flow.clone(),
                         t=t.clone() if torch.is_tensor(t) else t, r=r, border=border,
                         compute_dtype=compute_dtype))
        return real(img, flow, t, r, border, compute_dtype)

    return recording


def _recording_grad(kw, recs: list):
    """K2's wrapper, recording each launch's inputs (cloned) in recs."""
    real = kw.warp_windowed_grad

    def recording(img, flow, t, ct, r=8, border="replicate", compute_dtype=torch.float32):
        recs.append(dict(img=img.clone(), flow=flow.clone(),
                         t=t.clone() if torch.is_tensor(t) else t, ct=ct.contiguous().clone(),
                         r=r, border=border, compute_dtype=compute_dtype))
        return real(img, flow, t, ct, r, border, compute_dtype)

    return recording


def compare_step_with_twins(kw, module, fixed: dict, make_step, label: str) -> None:
    """The whole train step with the kernels against the same step with both
    plain twins: same batch, same params (an optimizer with lr 0 leaves
    them; the gradients compared are the step's, after its clip). cuDNN is
    made deterministic for it: its algorithms may vary run to run, and the
    warps can turn that into large gradient differences (the kernels' own
    run-to-run difference is printed with default and with deterministic
    cuDNN). Loss within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest."""
    from vfisr_tpu_torch.train.train import TrainState

    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    probe = make_step(module, TrainState(torch.optim.AdamW(module.parameters(), lr=0.0),
                                         lambda k: 0.0))

    def loss_and_grads():
        value = probe(fixed).item()
        return value, {n: p.grad.clone() for n, p in module.named_parameters()}

    def rel_err(a, b):
        return max((a[n] - b[n]).abs().max().item() / max(b[n].abs().max().item(), 1e-30)
                   for n in b)

    loss_a, grads_a = loss_and_grads()
    loss_b, grads_b = loss_and_grads()
    print(f"{label} with kernels, twice, default cuDNN: loss {loss_a:.9f} vs {loss_b:.9f}, "
          f"gradients {rel_err(grads_a, grads_b):.3e} of each tensor's largest")
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, grads_k = loss_and_grads()
        loss_k2, grads_k2 = loss_and_grads()
        kw.warp_windowed = lambda img, flow, t=1.0, r=8, border="replicate", \
            compute_dtype=torch.float32: kw.warp_windowed_plain(img, flow, t, r, border,
                                                                compute_dtype)
        kw.warp_windowed_grad = kw.warp_windowed_grad_plain
        try:
            loss_p, grads_p = loss_and_grads()
        finally:
            kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
    finally:
        torch.backends.cudnn.deterministic = False
    grad_err = rel_err(grads_k, grads_p)
    print(f"{label} with kernels vs with plain twins (deterministic cuDNN): loss "
          f"{loss_k:.9f} vs {loss_p:.9f}, gradients max error {grad_err:.3e} of each tensor's "
          f"largest (tolerance: loss 1e-5 relative, gradients 1e-4); kernels vs kernels: loss "
          f"{loss_k2:.9f}, gradients {rel_err(grads_k, grads_k2):.3e}")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"{label} loss, kernels vs twins")
    require(grad_err <= 1e-4, f"{label} gradients, kernels vs twins")


def train_phase(kw, rife_npz: Path) -> tuple:
    """Step 8 of the module docstring. Returns K1's and K2's numbers over
    the counted train steps (``path_numbers``)."""
    from vfisr_tpu_torch.models.sota.rife import RIFEModel
    from vfisr_tpu_torch.train.device_data import device_synthetic_batch
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax, params_to_jax, save_npz

    t0 = time.perf_counter()
    # f32 activations, as RIFEConfig says: no TF32 (as the trainer CLI sets)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = RIFEModel(device="cuda")
    model.load(weights_path=str(rife_npz))  # explicit path: strict
    module = model.trainable()
    require(module.config.channels == (256, 160, 112, 80) and module.config.scales == (8, 4, 2, 1),
            "full-width RIFE")
    state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                               total_steps=TRAIN_STEPS + 2)
    step = make_train_step(module, state)  # remat on, as scripts/train.py
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        return device_synthetic_batch(gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)

    t0 = _phase("train_load", t0)

    # one step, every launch of both kernels recorded and counted
    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    rec1, rec2 = [], []
    kw.warp_windowed, kw.warp_windowed_grad = _recording(kw, rec1), _recording_grad(kw, rec2)
    try:
        with origin_table_raises(kw):
            kw.launches = kw.grad_launches = 0
            loss = step(batch()).item()
            k1, k2 = kw.launches, kw.grad_launches
    finally:
        kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
    print(f"one train step (batch {TRAIN_BATCH}, crop {TRAIN_CROP}): {k1} warp launches, "
          f"{k2} warp-gradient launches, loss {loss:.6f}")
    require(k1 == K1_PER_STEP and len(rec1) == k1, f"{k1} warp launches in a train step")
    require(k2 == K2_PER_STEP and len(rec2) == k2, f"{k2} warp-gradient launches in a train step")
    require(loss == loss and abs(loss) < float("inf"), "finite loss")
    require_whole_c(kw, "train step", rec1)
    require_whole_c(kw, "train step", rec2, grad=True)
    t0 = _phase("train_record", t0)

    # the kernels' origins, and the kernels against their plain twins, at
    # the step's launches
    for j, a in enumerate(rec1 + rec2):
        check_origins(kw, f"train-step launch {j}", a)
    max_err2 = 0.0
    for j, a in enumerate(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"train-step launch {j}", a))
    for a in grad_cases(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, a["name"], a))
    max_err1 = 0.0
    for j, a in enumerate(rec1):
        max_err1 = max(max_err1, check_warp(kw, f"train-step launch {j}", a))

    compare_step_with_twins(kw, module, batch(), make_train_step, "train step")
    t0 = _phase("train_checks", t0)

    # the training path, counted and timed
    step_ms, losses, k1_run, k2_run, peak_mb = timed_steps(kw, step, batch, TRAIN_STEPS)
    require(k1_run == K1_PER_STEP * TRAIN_STEPS, f"{k1_run} warp launches in {TRAIN_STEPS} steps")
    require(k2_run == K2_PER_STEP * TRAIN_STEPS,
            f"{k2_run} warp-gradient launches in {TRAIN_STEPS} steps")
    data_ms = time_ms(batch, 5)
    ms = sum(step_ms) / len(step_ms)
    print(f"train full-width RIFE, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, remat: ms/step {ms:.3f} "
          f"(data + step; steps: {', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
          f"{TRAIN_BATCH * 1000.0 / ms:.2f}; data alone {data_ms:.3f} ms; max_memory_allocated "
          f"{peak_mb:.1f} MB; losses {', '.join(f'{v:.5f}' for v in losses)}")
    t0 = _phase("train_main", t0)

    # the trained params through save_npz and back
    trained = module.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rife_trained.npz"
        save_npz(str(path), params_to_jax(trained))
        back = params_from_jax(load_npz(str(path)))
    require(set(back) == set(trained)
            and all(torch.equal(back[k], trained[k].cpu()) for k in trained), "save_npz round trip")
    shipped = params_from_jax(load_npz(str(rife_npz)))
    require(any(not torch.equal(shipped[k], trained[k].cpu()) for k in trained),
            "training moved the weights")
    print(f"save_npz round trip: {len(back)} arrays equal after load")

    # per launch shape: K2 then K1 at the training's shapes
    tot2 = per_shape_totals(kw, "train warp_windowed_grad", "step", rec2, time_grad_launch)
    tot1 = per_shape_totals(kw, "train warp_windowed", "step", rec1, time_launch)
    _phase("train_timing", t0)
    return (path_numbers(k1_run, max_err1, tot1, TRAIN_STEPS),
            path_numbers(k2_run, max_err2, tot2, TRAIN_STEPS))


def adaptive_phase(kw) -> tuple:
    """Step 9 of the module docstring. Returns K1's numbers over the counted
    sequence (``path_numbers``), and K1's numbers per pair of each route."""
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import scale_size
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.models.sota import vfimamba as tvm
    from vfisr_tpu_torch.models.sota.rife import RIFEConfig
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax
    from vfisr_tpu_torch.utils.router_gate import bin_winner, expert_bins

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    files = {"rife_weights": ROOT / "weights" / "rife.npz",
             "vfimamba_weights": ROOT / "weights" / "vfimamba.npz",
             "gate_path": ROOT / "weights" / "router_gate.json"}
    require(all(p.is_file() for p in files.values()), f"{list(files.values())} present")
    # the registry's entry point; explicit paths make every load strict
    model = get_model("adaptive", load=True, **{k: str(p) for k, p in files.items()})
    gate = str(files["gate_path"])
    require(model.enable_vfimamba, "VFIMamba enabled after load")
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after load")
    require(model._rife.CONFIG == RIFEConfig() and model._rife.CONFIG.channels == (256, 160, 112, 80),
            "full-width RIFE in RIFEModel's default config")
    require(model._vfimamba.variant == "full" and model._vfimamba.cfg == tvm.MambaConfig()
            and model._vfimamba.cfg.d_model == 256, "full VFIMamba")
    for expert, path in ((model._rife, files["rife_weights"]),
                         (model._vfimamba, files["vfimamba_weights"])):
        state, want = expert.module.state_dict(), params_from_jax(load_npz(str(path)))
        require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
                f"every parameter of {path.name} loaded")
    require(model.router.scene_warp_ssim_threshold != 1.0 and expert_bins("native", gate),
            "calibrated scene gate and expert bins")
    print(f"adaptive: get_model('adaptive', load=True): RIFE {model._rife.info.parameters} and "
          f"VFIMamba {model._vfimamba.info.parameters} parameters, scene gate "
          f"{model.router.scene_warp_ssim_threshold}")

    seq = [(f"history {i}", PAN_PX * i, PAN_PX * (i + 1)) for i in range(HISTORY_PAIRS)]
    seq += list(MEASURED)
    u8 = {x: scene_frame(x, dev) for _, a, b in seq for x in (a, b)}

    def batched(x):
        return u8[x].float()[None] / 255.0

    sigs = []
    real_analyze = model.router.analyze_device

    def capture(x0, x1):
        sig = real_analyze(x0, x1)
        sigs.append(sig)
        return sig

    model.router.analyze_device = capture

    def run(pair_ms=None):
        """The sequence as a stream (one pair per call, the HUD ring
        carried); returns the outputs and each pair's K1 launches."""
        model.router.reset_history()
        model.reset_stats()
        sigs.clear()
        outs, counts = [], []
        for _, a, b in seq:
            k = kw.launches
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(model.interpolate_batch(batched(a), batched(b), TS))
            end.record()
            end.synchronize()
            if pair_ms is not None:
                pair_ms.append(start.elapsed_time(end))
            counts.append(kw.launches - k)
        return outs, counts

    t0 = _phase("adaptive_load", t0)

    # warm-up run, recording every launch's inputs for the checks
    recorded = []
    real_warp = kw.warp_windowed
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            run()
    finally:
        kw.warp_windowed = real_warp
    t0 = _phase("adaptive_record", t0)

    # the path, counted and timed
    pair_ms = []
    torch.cuda.reset_peak_memory_stats()
    with origin_table_raises(kw):
        kw.launches = 0
        outs, counts = run(pair_ms)
        launches = kw.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    require(len(recorded) == launches == sum(counts), f"{launches} K1 launches in the sequence")
    require_whole_c(kw, "adaptive", recorded)
    t0 = _phase("adaptive_main", t0)

    # routes: each pair's equals bin_winner of its measured motion, and its
    # K1 launches say which expert ran
    routes = []
    for (name, a, b), sig, n in zip(seq, sigs, counts):
        mm = float(sig["motion_mean"][0])
        scene = bool(sig["is_scene_change"][0])
        route = "scene_change" if scene else bin_winner("native", mm, path=gate)
        routes.append(route)
        print(f"adaptive pair {name}: motion_mean {mm:.4f} px, motion_max "
              f"{float(sig['motion_max'][0]):.3f}, ssim {float(sig['ssim'][0]):.4f}, warped_ssim "
              f"{float(sig['warped_ssim'][0]):.4f}, hud_coverage {float(sig['hud_coverage'][0]):.4f}"
              f" -> {route}, {n} K1 launches")
        require(n == K1_PER_ROUTE[route], f"pair {name}: {n} K1 launches for route {route}")
    measured = routes[HISTORY_PAIRS:]
    require(measured[-1] == "scene_change" and set(measured) == set(K1_PER_ROUTE),
            f"the measured pairs hit every route: {measured}")
    stats = model.get_stats()
    require([stats["rife"], stats["vfimamba"], stats["scene_change"]]
            == [routes.count(r) for r in ("rife", "vfimamba", "scene_change")], f"stats {stats}")

    # outputs: finite frames in [0, 1]; HUD pixels their source where the
    # composite applies; the cut pair's midpoints x0 but there; the moving
    # midpoints above frame duplication against the true in-between frames
    gain = []
    for i, ((name, a, b), sig, out) in enumerate(zip(seq, sigs, outs)):
        require(tuple(out.shape) == (1, len(TS), H, W, 3) and bool(torch.isfinite(out).all())
                and float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"pair {name} output")
        x0, x1 = batched(a)[0], batched(b)[0]
        hud = sig["hud_mask"][0] & bool(sig["hud_coverage"][0] > 0.01)
        if i >= HISTORY_PAIRS:
            require(bool(hud.any()), f"pair {name}: the HUD composite engaged")
        for k, t in enumerate(TS):
            mid, src = out[0, k], (x0 if t < 0.5 else x1)
            require(torch.equal(mid[hud], src[hud]), f"pair {name} t={t}: HUD pixels")
            if routes[i] == "scene_change":
                require(torch.equal(mid[~hud], x0[~hud]), f"pair {name} t={t}: the cut holds x0")
            elif a != b:
                truth = scene_frame(a + t * (b - a), dev)
                p_mid, p_dup = psnr(to_uint8(mid), truth), psnr(u8[a], truth)
                gain.append(p_mid - p_dup)
                require(p_mid > p_dup, f"pair {name} t={t}: interpolated {p_mid:.2f} dB <= "
                                       f"duplicate {p_dup:.2f} dB")
    print(f"adaptive midpoint PSNR gain over frame duplication (dB): min {min(gain):.3f} "
          f"mean {sum(gain) / len(gain):.3f}")

    # K1 against its twin, and the kernels' origins, at every launch
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"adaptive launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"adaptive launch {j}", a))
    t0 = _phase("adaptive_checks", t0)

    # the whole sequence with the kernel against it with the plain twin, and
    # masked against hosted (deterministic cuDNN for all three runs)
    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    torch.backends.cudnn.deterministic = True
    try:
        outs_k, _ = run()
        kw.warp_windowed = plain_warp
        try:
            outs_p, _ = run()
        finally:
            kw.warp_windowed = real_warp
        model.route_mode = "masked"
        try:
            outs_m, counts_m = run()
        finally:
            model.route_mode = "hosted"
    finally:
        torch.backends.cudnn.deterministic = False
    d_twin = max((o - p).abs().max().item() for o, p in zip(outs_k, outs_p))
    d_mask = max((o - m).abs().max().item() for o, m in zip(outs_k, outs_m))
    print(f"adaptive sequence with kernel vs with plain twin: max {d_twin:.3e} (tolerance 2/255, "
          f"K1's bound in bf16 windows); masked vs hosted: max {d_mask:.3e} (tolerance 1e-5), "
          f"{counts_m} K1 launches per pair masked")
    require(d_twin <= 2.0 / 255.0, "adaptive sequence, kernel vs twin")
    require(d_mask <= 1e-5, "adaptive masked vs hosted")
    require(all(n == K1_MASKED for n in counts_m), "masked mode runs both experts on every pair")

    # the per-pair numpy entry point once: 5 frames at 2560x1440 uint8
    _, a, b = MEASURED[2]
    out_hw = scale_size(H, W, SCALE)
    res = model.process_pair(u8[a].cpu().numpy(), u8[b].cpu().numpy(), 3, SCALE)
    require(len(res.frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                         for f in res.frames), "process_pair frames")
    print(f"adaptive process_pair (pan 8 px, 5 frames {res.frames[0].shape} {res.frames[0].dtype}): "
          f"{res.inference_time_ms:.3f} ms host clock, route "
          f"{res.extra_info['analysis']['recommended_model']}, peak {res.vram_peak_mb:.1f} MB")
    t0 = _phase("adaptive_entry", t0)

    # where a pair's time goes, per route, each stage alone after warm-up
    # (peaks: max_memory_allocated during the stage, over what was
    # allocated before it: weights, frames and this script's recordings)
    def over_resident(resident):
        return f"peak {(torch.cuda.max_memory_allocated() - resident) / 1e6:.1f} MB over " \
               f"{resident / 1e6:.1f} MB resident"

    x = {name: (batched(a), batched(b)) for name, a, b in MEASURED}
    for name, _, _ in MEASURED:
        x0, x1 = x[name]
        model.interpolate_batch(x0, x1, TS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms = time_ms(lambda: model.interpolate_batch(x0, x1, TS), 3, warmup=0)
        print(f"adaptive stage interpolate_batch, pair {name}: {ms:.3f} ms, "
              f"{over_resident(resident)}")
    x0, x1 = x["pan 3 px"]
    print(f"adaptive stage analysis (analyze_device): {time_ms(lambda: real_analyze(x0, x1), 5):.3f} ms")
    print(f"adaptive stage rife (RIFEModel.interpolate_batch, f32): "
          f"{time_ms(lambda: model._rife.interpolate_batch(x0, x1, TS), 3):.3f} ms")
    scans, real_scan = [], tvm.selective_scan

    def timed_scan(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = real_scan(*args, **kwargs)
        end.record()
        scans.append((start, end))
        return y

    model._vfimamba.interpolate_batch(x0, x1, TS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    tvm.selective_scan = timed_scan
    try:
        fwd_ms = time_ms(lambda: model._vfimamba.interpolate_batch(x0, x1, TS), 2, warmup=0)
    finally:
        tvm.selective_scan = real_scan
    scan_ms = sum(s.elapsed_time(e) for s, e in scans) / 2
    print(f"adaptive stage vfimamba (VFIMambaModel.interpolate_batch, f32): {fwd_ms:.3f} ms, "
          f"selective_scan {scan_ms:.3f} ms in {len(scans) // 2} calls ({100 * scan_ms / fwd_ms:.1f}%),"
          f" {over_resident(resident)}")
    # why VFIMamba's decoder conv runs without cuDNN
    # (models/base.py::without_cudnn): the conv at its shape each way
    conv = model._vfimamba.module.Conv_3
    feat = torch.randn((len(TS), conv.in_channels, -(-H // 32) * 4, -(-W // 32) * 4), device=dev)
    with torch.no_grad():
        for label, cudnn_on in (("cuDNN", True), ("PyTorch's own (the path)", False)):
            torch.backends.cudnn.enabled = cudnn_on
            try:
                conv(feat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                ms = time_ms(lambda: conv(feat), 3, warmup=0)
            finally:
                torch.backends.cudnn.enabled = True
            print(f"adaptive stage vfimamba decoder conv {tuple(feat.shape)} -> {conv.out_channels}, "
                  f"f32, {label}: {ms:.3f} ms, {over_resident(resident)}")
    t0 = _phase("adaptive_breakdown", t0)

    # K1 per launch shape of the sequence, and per pair of each route
    by_shape = shape_times(kw, recorded, time_launch)
    for key, v in by_shape.items():
        print(f"adaptive launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/sequence: kernel {v['kernel']:.4f} ms, bound {v['bound']:.4f} ms "
              f"({v['by']}), wrapper host {v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, "
              f"plain {v['plain']:.4f} ms, grid_sample {v['library']:.4f} ms")
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    start = 0
    per_route = {}  # K1's numbers per pair of each route (the stream phase's launches)
    for (name, _, _), n, route in zip(seq, counts, routes):
        pair = [by_shape[shape_key(a)] for a in recorded[start:start + n]]
        start += n
        per_route.setdefault(route, dict(
            {f: sum(v[f] for v in pair) for f in fields},
            by="bytes" if {v["by"] for v in pair} == {"bytes"} else "operations"))
        if name in dict((m[0], m) for m in MEASURED):
            print(f"adaptive K1 per pair {name}: {n} launches, " + ", ".join(
                f"{f} {sum(v[f] for v in pair):.4f} ms" for f in fields))
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    ms = sum(pair_ms[HISTORY_PAIRS:]) / len(MEASURED)
    print(f"adaptive sequence {W}x{H}, {len(TS)} midpoints, hosted: ms per measured pair "
          + ", ".join(f"{m[0]} {t:.3f}" for m, t in zip(MEASURED, pair_ms[HISTORY_PAIRS:]))
          + f" (mean {ms:.3f}); history pairs {', '.join(f'{t:.3f}' for t in pair_ms[:HISTORY_PAIRS])};"
          f" {launches} K1 launches; max_memory_allocated {peak_mb:.1f} MB")
    _phase("adaptive_timing", t0)
    return path_numbers(launches, max_err, total, 1), per_route


# the stream phases: the port's video-in, video-out entry point
# (pipeline/streaming.py::process_video) on Y4M files in a temporary directory
STREAM_FRAMES = 13  # flagship: 12 pairs, 49 output frames at 2560x1440
STREAM_OUT = (2560, 1440)
# adaptive: the adaptive phase's sequence as one stream (5 history pans, a
# static pair, a 3 px pan, an 8 px pan, a cut)
STREAM_SCENE = (0, 3, 6, 9, 12, 15, 15, 18, 26, "cut")


def write_y4m(path: Path, frames) -> None:
    """Device uint8 [H,W,3] frames into a 30 fps Y4M with the port's writer."""
    from vfisr_tpu_torch.data.video_io import VideoWriter

    h, w = frames[0].shape[:2]
    with VideoWriter(str(path), w, h, 30) as wr:
        for f in frames:
            wr.write(f.cpu().numpy())


def read_y4m_planes(path: Path) -> list:
    from vfisr_tpu_torch.data.video_io import VideoReader

    with VideoReader(str(path)) as rd:
        planes = []
        while (p := rd.read_i420()) is not None:
            planes.append(torch.from_numpy(p))
    return planes


def capturing_build(streaming, hook):
    """streaming._build_model, handing each model it builds to hook first."""
    real = streaming._build_model

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        hook(model)
        return model

    return build


def print_stream(label: str, stats: dict, pairs: int, card: str) -> None:
    fps = len(TS) * pairs / stats["elapsed_s"]
    print(f"stream {label} ({card}): {pairs} pairs in {stats['elapsed_s']:.3f} s, "
          f"interpolated fps {fps:.2f}, realtime_x {stats['realtime_x']:.4f}, "
          f"{stats['output_frames']} frames out, readback {stats['readback_format']} "
          f"{stats['readback_mb']} MB, device_busy_fraction {stats['device_busy_fraction']}")
    print(f"stream {label} timers: " + ", ".join(
        f"{k} {stats[k]}" for k in ("decode_wait_s", "dispatch_s", "first_dispatch_s",
                                     "enqueue_wait_s", "main_other_s", "device_materialize_s",
                                     "encode_s")))
    print(f"stream {label} stats: {stats}")


def stream_flagship_phase(kw, rife_npz: Path, card: str, per_pair: dict) -> dict:
    """Step 15 of the module docstring. Returns K1's numbers over the
    stream's counted launches, timed per pair in step 7."""
    from vfisr_tpu_torch.core.color import i420_to_rgb, rgb_to_i420
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data.video_io import VideoReader, probe_video
    from vfisr_tpu_torch.pipeline import streaming
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    ow, oh = STREAM_OUT
    pairs = STREAM_FRAMES - 1
    built = []
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "in.y4m", Path(tmp) / "out.y4m"
        write_y4m(src, [game_frame(i, dev) for i in range(STREAM_FRAMES)])
        meta = probe_video(str(src))
        require((meta.width, meta.height, meta.fps, meta.frame_count) == (W, H, 30.0, STREAM_FRAMES),
                f"input Y4M {meta}")
        # I420 -> RGB of a 1080p frame on the host (VideoReader.read) and on
        # the card (process_video): why the stream converts on the card
        with VideoReader(str(src)) as rd:
            buf = torch.from_numpy(rd.read_i420())
        on_host = host_ms(lambda: i420_to_rgb(buf, H, W), 5)
        on_card = buf.to(dev)
        print(f"stream decode I420 -> RGB of a {W}x{H} frame: host {on_host:.3f} ms, "
              f"on the card {time_ms(lambda: i420_to_rgb(on_card, H, W), 20):.4f} ms")
        t0 = _phase("stream_flagship_write", t0)

        real_build = streaming._build_model
        streaming._build_model = capturing_build(streaming, built.append)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                stats = streaming.process_video(str(src), str(out), method="flagship",
                                                target_fps=120, target_resolution=STREAM_OUT)
                launches = kw.launches
        finally:
            streaming._build_model = real_build
        t0 = _phase("stream_flagship_run", t0)
        print_stream("flagship", stats, pairs, card)
        vfi = built[0]
        require(vfi._module.config.channels == (256, 160, 112, 80), "full-width RIFE")
        want = params_from_jax(load_npz(str(rife_npz)))
        state = vfi._module.state_dict()
        require(set(state) == set(want) and all(torch.equal(state[k].float().cpu(),
                                                            want[k].to(state[k].dtype).float())
                                                for k in want),
                f"every parameter of {rife_npz.name} loaded")
        require(vfi.base_config.scene_warp_ssim_threshold != 1.0, "calibrated scene gate loaded")
        require(stats["pipeline"] == "fused_writer_thread" and stats["readback_format"] == "yuv420"
                and stats["input_frames"] == STREAM_FRAMES
                and stats["output_frames"] == 4 * pairs + 1, f"stream stats {stats}")
        require(launches == LAUNCHES_PER_PAIR * pairs, f"{launches} K1 launches in the stream")
        planes = read_y4m_planes(out)
        require(len(planes) == 4 * pairs + 1 and probe_video(str(out)).frame_count == len(planes),
                f"{len(planes)} frames in the output Y4M")
        with VideoReader(str(src)) as rd:
            decoded = [torch.from_numpy(f).to(dev) for f in rd]

    # each pair's four frames against the fused step and the pack computed
    # directly, the HUD history carried the same way; K1 against its twin
    # and its origins at every launch of it
    vfi.reset_history()
    real_warp, max_err = kw.warp_windowed, 0.0
    gain = []
    scale = oh / H
    for i in range(pairs):
        recs = []
        kw.warp_windowed = _recording(kw, recs)
        try:
            up = vfi.fused_stream_step(decoded[i], decoded[i + 1], scale, TS)
        finally:
            kw.warp_windowed = real_warp
        want = streaming.pack_i420(up).cpu().reshape(len(TS) + 1, -1)
        got = torch.stack(planes[4 * i:4 * i + 4])
        require(torch.equal(got, want), f"stream pair {i}: the output planes are "
                                        f"pack_i420(fused_stream_step(...)) "
                                        f"(max {(got.int() - want.int()).abs().max().item()} LSB)")
        require(len(recs) == LAUNCHES_PER_PAIR, f"stream pair {i}: {len(recs)} K1 launches")
        for j, a in enumerate(recs):
            check_origins(kw, f"stream pair {i} launch {j}", a)
            max_err = max(max_err, check_warp(kw, f"stream pair {i} launch {j}", a))
        for k, t in enumerate(TS):
            truth = rgb_to_i420(to_uint8(resize(game_frame(i + t, dev).float()[None] / 255.0,
                                                (oh, ow), "lanczos4")))[0].cpu()
            p_mid, p_dup = psnr(got[1 + k], truth), psnr(got[0], truth)
            gain.append(p_mid - p_dup)
            require(p_mid > p_dup, f"stream pair {i} t={t}: interpolated {p_mid:.2f} dB <= "
                                   f"duplicate {p_dup:.2f} dB")
    last = rgb_to_i420(torch.from_numpy(vfi.upscale(decoded[-1].cpu().numpy(), scale))).cpu()
    require(torch.equal(planes[-1], last), "the final endpoint")
    print(f"stream flagship: every pair's planes equal pack_i420(fused_stream_step(...)); "
          f"midpoint PSNR gain over frame duplication (dB, I420 bytes against the rendered "
          f"truth): min {min(gain):.3f} mean {sum(gain) / len(gain):.3f}; K1 vs twin max_abs_err "
          f"{max_err:.3e} over {LAUNCHES_PER_PAIR * pairs} launches")
    _phase("stream_flagship_checks", t0)
    return path_numbers(launches, max_err, per_pair, pairs)


def stream_adaptive_phase(kw, card: str, per_route: dict, err: float) -> dict:
    """Step 16 of the module docstring. Returns K1's numbers over the
    stream's counted launches, timed per pair and route in step 9."""
    from vfisr_tpu_torch.models.sota import vfimamba as tvm
    from vfisr_tpu_torch.models.sota.rife import RIFEConfig
    from vfisr_tpu_torch.pipeline import streaming
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax
    from vfisr_tpu_torch.utils.router_gate import bin_winner, expert_bins

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    pairs = len(STREAM_SCENE) - 1
    built, calls = [], []

    def hook(model):
        """Record each pair's inputs, signals and midpoints."""
        real_analyze, real_interp = model.router.analyze_device, model.interpolate_batch

        def analyze(x0, x1):
            start = kw.launches
            sig = real_analyze(x0, x1)
            calls.append(dict(x0=x0, x1=x1, sig=sig, start=start))
            return sig

        def interpolate(x0, x1, timestamps):
            out = real_interp(x0, x1, timestamps)
            calls[-1].update(out=out, launches=kw.launches - calls[-1]["start"])
            return out

        model.router.analyze_device, model.interpolate_batch = analyze, interpolate
        built.append(model)

    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "in.y4m", Path(tmp) / "out.y4m"
        write_y4m(src, [scene_frame(x, dev) for x in STREAM_SCENE])
        t0 = _phase("stream_adaptive_write", t0)
        real_build = streaming._build_model
        streaming._build_model = capturing_build(streaming, hook)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                stats = streaming.process_video(str(src), str(out), target_fps=120,
                                                target_resolution=STREAM_OUT)
                launches = kw.launches
        finally:
            streaming._build_model = real_build
        t0 = _phase("stream_adaptive_run", t0)
        print_stream("adaptive", stats, pairs, card)
        n_out = len(read_y4m_planes(out))
    model = built[0]
    gate = model.gate_path
    require(stats["pipeline"] == "writer_thread" and stats["readback_format"] == "yuv420"
            and stats["output_frames"] == n_out == 4 * pairs + 1, f"stream stats {stats}")
    require(model.enable_vfimamba and model._rife.CONFIG == RIFEConfig()
            and model._rife.CONFIG.channels == (256, 160, 112, 80)
            and model._vfimamba.variant == "full" and model._vfimamba.cfg == tvm.MambaConfig(),
            "the default model: full-width RIFE and VFIMamba")
    for expert, name in ((model._rife, "rife.npz"), (model._vfimamba, "vfimamba.npz")):
        state, want = expert.module.state_dict(), params_from_jax(load_npz(str(ROOT / "weights" / name)))
        require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
                f"every parameter of {name} loaded")
    require(model.router.scene_warp_ssim_threshold != 1.0 and expert_bins("native", gate),
            "calibrated scene gate and expert bins")
    require(len(calls) == pairs, f"{len(calls)} pairs routed")
    routes = []
    for i, c in enumerate(calls):
        sig = c["sig"]
        mm = float(sig["motion_mean"][0])
        route = "scene_change" if bool(sig["is_scene_change"][0]) else bin_winner(
            "native", mm, path=gate)
        routes.append(route)
        print(f"stream adaptive pair {i} ({STREAM_SCENE[i]} -> {STREAM_SCENE[i + 1]}): "
              f"motion_mean {mm:.4f} px -> {route}, {c['launches']} K1 launches")
        require(c["launches"] == K1_PER_ROUTE[route], f"stream pair {i}: {c['launches']} K1 "
                                                      f"launches for route {route}")
        hud = sig["hud_mask"][0] & bool(sig["hud_coverage"][0] > 0.01)
        if i >= HISTORY_PAIRS:
            require(bool(hud.any()), f"stream pair {i}: the HUD composite engaged")
        x0, x1 = c["x0"][0], c["x1"][0]
        for k, t in enumerate(TS):
            mid, src_ = c["out"][0, k], (x0 if t < 0.5 else x1)
            require(torch.equal(mid[hud], src_[hud]), f"stream pair {i} t={t}: HUD pixels")
            if route == "scene_change":
                require(torch.equal(mid[~hud], x0[~hud]), f"stream pair {i} t={t}: the cut holds x0")
    require(routes[-1] == "scene_change" and set(routes) == set(K1_PER_ROUTE),
            f"the stream hits every route: {routes}")
    stats_routes = model.get_stats()
    require([stats_routes[r] for r in ("rife", "vfimamba", "scene_change")]
            == [routes.count(r) for r in ("rife", "vfimamba", "scene_change")],
            f"routing stats {stats_routes}")
    require(launches == sum(K1_PER_ROUTE[r] for r in routes),
            f"{launches} K1 launches, the routes' sum {sum(K1_PER_ROUTE[r] for r in routes)}")
    _phase("stream_adaptive_checks", t0)
    fields = ("kernel", "plain", "bound", "library")
    total = {f: sum(per_route[r][f] for r in routes) for f in fields}
    total["by"] = "bytes" if {per_route[r]["by"] for r in routes} == {"bytes"} else "operations"
    return path_numbers(launches, err, total, 1)


def require_whole_c(kw, label: str, recs: list, grad: bool = False) -> None:
    """Every K1 (grad: K2) launch of recs takes the whole-C layout (one
    channel group): the kernel's instantiation without channel groups."""
    name = "K2" if grad else "K1"
    plans = {shape_key(a): kw.plan(a["img"], a["r"], a["compute_dtype"], grad) for a in recs}
    require(all(p is not None and p["grouped"] == 0 and p["groups"] == 1 for p in plans.values()),
            f"{label}: every {name} launch takes the whole-C layout")
    print(f"{label}: all {len(recs)} {name} launches ({len(plans)} shapes) take the whole-C "
          f"layout (one channel group)")


def grouped_cases(device) -> list:
    """K1 past the channels one window holds: C in GROUPED_C at the shape of
    SAFA's feature warps, f32 and bf16 windows, both borders; flows as
    SAFA's (clamped to +-8) plus noise past the radius."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    n, h, w = 3, 114, 144
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    base = torch.stack([6.0 * torch.sin(xx / 17.0 + yy / 23.0), 3.0 * torch.cos(yy / 9.0)], -1)
    cases = []
    for c in GROUPED_C:
        for dt in (torch.float32, torch.bfloat16):
            for border in ("replicate", "constant"):
                flow = torch.clamp(base + 3.0 * torch.randn((n, h, w, 2), generator=gen), -8, 8)
                cases.append(dict(name=f"grouped C={c}", img=torch.rand((n, h, w, c), generator=gen)
                                  .to(device), flow=flow.to(device), t=1.0, r=8, border=border,
                                  compute_dtype=dt))
    return cases


def conv_calls(module, run) -> list:
    """(name, conv, input shape, cuDNN on) of every Conv2d call while run()
    runs, in call order (forward hooks; the last: whether the path ran that
    call's forward with cuDNN)."""
    calls, hooks = [], []
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: calls.append(
                    (name, mod, tuple(inp[0].shape), torch.backends.cudnn.enabled))))
    try:
        run()
    finally:
        for hk in hooks:
            hk.remove()
    return calls


def conv_flop(conv, shape) -> int:
    """Multiply-adds x 2 of one Conv2d call on an input of shape."""
    n, _, h, w = shape
    ho = (h + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
    wo = (w + 2 * conv.padding[1] - conv.kernel_size[1]) // conv.stride[1] + 1
    return 2 * n * ho * wo * conv.out_channels * conv.in_channels * conv.kernel_size[0] * \
        conv.kernel_size[1]


def time_convs(label: str, calls: list, backward: bool = False) -> dict:
    """Each distinct conv shape of calls, timed with cuDNN's heuristic plan
    and with cuDNN off (PyTorch's own convolution), with the peak memory of
    each over what was resident; f32, TF32 off. backward: also the
    backward (input, weight and bias gradients of the same call), each
    with cuDNN on and off. Prints the path's own forward choice. Returns
    {name: (cudnn ms, own ms)} (forward) for the first call of each shape."""
    seen, out = {}, {}
    dev = torch.device("cuda")
    for name, conv, shape, path_cudnn in calls:
        key = (conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, shape)
        if key in seen:
            seen[key].append(name)
            continue
        seen[key] = [name]
        feat = torch.rand(shape, device=dev, requires_grad=backward)
        weight, bias = (v.detach().requires_grad_(backward) for v in (conv.weight, conv.bias))

        def fwd():
            return torch.nn.functional.conv2d(feat, weight, bias, conv.stride, conv.padding)

        res = []
        with torch.set_grad_enabled(backward):
            for cudnn_on in (True, False):
                torch.backends.cudnn.enabled = cudnn_on
                try:
                    y = fwd()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    resident = torch.cuda.memory_allocated()
                    ms = time_ms(fwd, 3, warmup=0)
                    bwd_ms = math.nan
                    if backward:
                        ct = torch.randn_like(y)
                        bwd_ms = time_ms(lambda: torch.autograd.grad(
                            y, (feat, weight, bias), ct, retain_graph=True), 3)
                    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
                    del y
                finally:
                    torch.backends.cudnn.enabled = True
                res.append((ms, bwd_ms, peak))
        del feat
        out[name] = (res[0][0], res[1][0])
        gflop = conv_flop(conv, shape) / 1e9
        bwd = (f", backward {res[0][1]:.3f} ms / {res[1][1]:.3f} ms ({2 * gflop:.2f} GFLOP, f32 "
               f"bound {2 * gflop / F32_FLOP_PER_S * 1e12:.3f} ms)") if backward else ""
        print(f"{label} conv {name} {tuple(shape)} {conv.in_channels}->{conv.out_channels} "
              f"k{conv.kernel_size[0]} s{conv.stride[0]}, f32, {gflop:.2f} GFLOP: cuDNN "
              f"{res[0][0]:.3f} ms (peak {res[0][2]:.1f} MB over resident), cuDNN off "
              f"{res[1][0]:.3f} ms (peak {res[1][2]:.1f} MB); f32 bound "
              f"{gflop / F32_FLOP_PER_S * 1e12:.3f} ms{bwd}; the path's forward: "
              f"{'cuDNN' if path_cudnn else 'cuDNN off'} (the "
              f"{'faster' if (res[0][0] <= res[1][0]) == path_cudnn else 'slower'} here)")
    for key, names in seen.items():
        if len(names) > 1:
            print(f"{label} conv shape of {names[0]} also: {', '.join(names[1:])}")
    return out


def safa_phase(kw) -> dict:
    """Step 10 of the module docstring. Returns K1's numbers over the
    counted pairs (``path_numbers``)."""
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize, scale_size
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    npz = ROOT / "weights" / "safa.npz"
    require(npz.is_file(), f"{npz} present")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = get_model("safa", load=True)
    require(model.device.type == "cuda", "SAFA on the card")
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SAFAModel.load")
    state, want = model.module.state_dict(), params_from_jax(load_npz(str(npz)))
    require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
            f"every parameter of {npz.name} loaded")
    require(model.module.c == 176 and model.module.num_dec_blocks == 8, "full-width SAFA")
    print(f"safa: get_model('safa', load=True): {model.info.parameters} parameters, c "
          f"{model.module.c}, {model.module.num_dec_blocks} decoder blocks, tiles "
          f"{model.TILE_HW} + {model.OVERLAP} px, budget {model.tile_px_budget} px")
    u8 = {x: scene_frame(x, dev) for _, a, b in SAFA_PAIRS for x in (a, b)}

    def batched(x):
        return u8[x].float()[None] / 255.0

    t0 = _phase("safa_load", t0)

    # one pair recorded (warm-up): every K1 launch's inputs
    recorded = []
    real_warp = kw.warp_windowed
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            model.interpolate_batch(batched(SAFA_PAIRS[2][1]), batched(SAFA_PAIRS[2][2]), TS)
            torch.cuda.synchronize()
    finally:
        kw.warp_windowed = real_warp
    require(len(recorded) == K1_PER_SAFA_PAIR, f"{len(recorded)} K1 launches in a SAFA pair")
    t0 = _phase("safa_record", t0)

    # the path, counted and timed
    pair_ms, outs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with origin_table_raises(kw):
        kw.launches = 0
        for _, a, b in SAFA_PAIRS:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(model.interpolate_batch(batched(a), batched(b), TS))
            end.record()
            end.synchronize()
            pair_ms.append(start.elapsed_time(end))
        launches = kw.launches
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 1e6
    require(launches == K1_PER_SAFA_PAIR * len(SAFA_PAIRS),
            f"{launches} K1 launches in {len(SAFA_PAIRS)} SAFA pairs")
    t0 = _phase("safa_main", t0)

    # outputs: finite [0, 1] frames of the input's size; midpoint PSNR
    # against the scene's true in-between frames and against duplication
    # (printed only: the weights' quality is measured on their own data)
    for (name, a, b), out in zip(SAFA_PAIRS, outs):
        # the net's 2x frames are clipped to [0, 1]; Lanczos4 back to the
        # input's size may overshoot that a little, as in the reference
        require(tuple(out.shape) == (1, len(TS), H, W, 3) and bool(torch.isfinite(out).all())
                and float(out.min()) >= -0.25 and float(out.max()) <= 1.25,
                f"SAFA pair {name} output: {tuple(out.shape)}, {float(out.min())} to "
                f"{float(out.max())}")
        line = [f"range {float(out.min()):.4f} to {float(out.max()):.4f}"]
        for k, t in enumerate(TS):
            truth = scene_frame(a + t * (b - a), dev)
            line.append(f"t={t} {psnr(to_uint8(out[0, k]), truth):.3f} dB "
                        f"(duplicate {psnr(u8[a], truth):.3f})")
        print(f"safa pair {name}: midpoint PSNR against the true frame " + ", ".join(line))

    # K1 against its twin and the kernels' origins at every launch of the
    # recorded pair; the feature launches take channel groups
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"safa launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"safa launch {j}", a))
    for key in {shape_key(a): a for a in recorded}.values():
        p = kw.plan(key["img"], key["r"], key["compute_dtype"])
        print(f"safa K1 plan {_label(key)}: {p}")
        require(p["grouped"] == (key["img"].shape[-1] > 3), f"SAFA plan {_label(key)}")
    # the pair with the kernel against the pair with the plain twin
    # (deterministic cuDNN for both)
    x0, x1 = batched(SAFA_PAIRS[2][1]), batched(SAFA_PAIRS[2][2])

    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    torch.backends.cudnn.deterministic = True
    try:
        out_k = model.interpolate_batch(x0, x1, TS)
        kw.warp_windowed = plain_warp
        try:
            out_p = model.interpolate_batch(x0, x1, TS)
        finally:
            kw.warp_windowed = real_warp
    finally:
        torch.backends.cudnn.deterministic = False
    d_twin = (out_k - out_p).abs().max().item()
    print(f"safa pair with kernel vs with plain twin (deterministic cuDNN): max {d_twin:.3e} "
          f"(tolerance 1e-5)")
    require(d_twin <= 1e-5, "SAFA pair, kernel vs twin")
    t0 = _phase("safa_checks", t0)

    # the joint entry point once: 5 frames at 2560x1440 uint8
    out_hw = scale_size(H, W, SCALE)
    start = time.perf_counter()
    frames = model.joint_process(u8[SAFA_PAIRS[2][1]].cpu().numpy(),
                                 u8[SAFA_PAIRS[2][2]].cpu().numpy(), 3, SCALE)
    jp_ms = (time.perf_counter() - start) * 1e3
    require(len(frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                     for f in frames), "SAFA joint_process frames")
    end_ref = to_uint8(resize(x0, out_hw, "lanczos4"))[0].cpu().numpy()
    print(f"safa joint_process (pan 8 px, 5 frames {frames[0].shape} {frames[0].dtype}, scale "
          f"{SCALE:.4f}): {jp_ms:.3f} ms host clock; endpoint t=0 vs Lanczos4 of x0: "
          f"{psnr(torch.from_numpy(frames[0]), torch.from_numpy(end_ref)):.3f} dB")
    t0 = _phase("safa_entry", t0)

    # where a pair's time goes: one tile's forward (batch 3), its convs
    th, tw = model.TILE_HW
    tile = (1, th + 2 * model.OVERLAP, tw + 2 * model.OVERLAP)
    a3 = x0[:, :tile[1], :tile[2]].repeat_interleave(len(TS), 0).contiguous()
    b3 = x1[:, :tile[1], :tile[2]].repeat_interleave(len(TS), 0).contiguous()
    ts3 = torch.tensor(TS, device=dev)
    model.net(a3, b3, ts3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    tile_ms = time_ms(lambda: model.net(a3, b3, ts3), 3, warmup=0)
    tile_peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    calls = conv_calls(model.module, lambda: model.net(a3, b3, ts3))
    tile_flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    n_tiles = -(-H // th) * -(-W // tw)
    print(f"safa tile forward {tuple(a3.shape)} x2 frames, batch {len(TS)}: {tile_ms:.3f} ms, peak "
          f"{tile_peak:.1f} MB over {resident / 1e6:.1f} MB resident; its {len(calls)} convs "
          f"{tile_flop / 1e12:.4f} TFLOP (f32 bound {tile_flop / F32_FLOP_PER_S * 1e3:.3f} ms); "
          f"{n_tiles} tiles per pair: {n_tiles * tile_flop / 1e12:.4f} TFLOP, f32 bound "
          f"{n_tiles * tile_flop / F32_FLOP_PER_S * 1e3:.3f} ms")
    time_convs("safa", calls)
    del a3, b3
    t0 = _phase("safa_breakdown", t0)

    # K1 per launch shape of a pair
    by_shape = shape_times(kw, recorded, time_launch)
    for key, v in by_shape.items():
        print(f"safa launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/pair: kernel {v['kernel']:.4f} ms, bound {v['bound']:.4f} ms "
              f"({v['by']}), wrapper host {v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, "
              f"plain {v['plain']:.4f} ms, grid_sample {v['library']:.4f} ms")
        print_grouped(kw, "safa", "pair", key, next(a for a in recorded if shape_key(a) == key),
                      v, False)
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"safa K1 per pair: {K1_PER_SAFA_PAIR} launches, " + ", ".join(
        f"{f} {total[f]:.4f} ms" for f in fields))
    print(f"safa {W}x{H} pairs, {len(TS)} midpoints (interpolate_batch, {n_tiles} tiles): ms per "
          f"pair " + ", ".join(f"{p[0]} {t:.3f}" for p, t in zip(SAFA_PAIRS, pair_ms))
          + f" (mean {sum(pair_ms) / len(pair_ms):.3f}); peak {peak_mb:.1f} MB over resident; "
          f"{launches} K1 launches")
    _phase("safa_timing", t0)
    return path_numbers(launches, max_err, total, len(SAFA_PAIRS))


def span_phase(kw) -> None:
    """Step 11 of the module docstring."""
    from vfisr_tpu_torch.core.resize import resize, scale_size
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.models.sota.span import SPANModel
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    span = get_model("span", load=True)
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SPANModel.load")
    npz = ROOT / "weights" / "span_x2.npz"
    state, want = span.module.state_dict(), params_from_jax(load_npz(str(npz)))
    require(span.scale == 2 and set(state) == set(want)
            and all(torch.equal(state[k].cpu(), want[k]) for k in want),
            f"every parameter of {npz.name} loaded")
    out_hw = scale_size(H, W, SCALE)
    four = torch.stack([scene_frame(x, dev) for x in (15, 18, 21, 26)]).float() / 255.0
    up = span.upscale_batch(four, SCALE)
    require(tuple(up.shape) == (4, *out_hw, 3) and bool(torch.isfinite(up).all())
            and float(up.min()) >= 0.0 and float(up.max()) <= 1.0, "SPAN x2 output")
    lanczos = resize(four, out_hw, "lanczos4").clamp(0.0, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms = time_ms(lambda: span.upscale_batch(four, SCALE), 3)
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    net_ms = time_ms(lambda: span.module(four), 3)
    calls = conv_calls(span.module, lambda: span.module(four))
    flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    print(f"span x2: 4 frames {W}x{H} -> {out_hw[1]}x{out_hw[0]} (upscale_batch: net, Lanczos4, "
          f"clip): {ms:.3f} ms ({ms / 4:.3f} per frame), the net alone {net_ms:.3f} ms, peak "
          f"{peak:.1f} MB over resident; convs {flop / 1e12:.4f} TFLOP (f32 bound "
          f"{flop / F32_FLOP_PER_S * 1e3:.3f} ms); PSNR against Lanczos4 "
          f"{psnr(up * 255.0, lanczos * 255.0):.3f} dB")
    time_convs("span x2", calls)
    t0 = _phase("span_x2", t0)

    x4 = SPANModel(scale=4, device="cuda")
    x4.load()
    small = resize(four[:1], (H // 2, W // 2), "area")
    up4 = x4.upscale_batch(small, H * SCALE / (H // 2))
    require(tuple(up4.shape) == (1, *out_hw, 3) and bool(torch.isfinite(up4).all()),
            "SPAN x4 output")
    ms4 = time_ms(lambda: x4.upscale_batch(small, H * SCALE / (H // 2)), 3)
    print(f"span x4: 1 frame {W // 2}x{H // 2} -> {out_hw[1]}x{out_hw[0]}: {ms4:.3f} ms; PSNR "
          f"against the 1440p Lanczos4 of the full frame "
          f"{psnr(up4[0] * 255.0, lanczos[0] * 255.0):.3f} dB")
    del x4, up4
    t0 = _phase("span_x4", t0)

    u8 = {x: scene_frame(x, dev).cpu().numpy() for x in (18, 26)}
    rs = get_model("rife_span", load=True)
    res = rs.process_pair(u8[18], u8[26], 3, SCALE)
    require(len(res.frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                         for f in res.frames), "rife_span process_pair frames")
    print(f"rife_span process_pair (pan 8 px, 5 frames {res.frames[0].shape}): "
          f"{res.inference_time_ms:.3f} ms host clock (VFI {res.extra_info['vfi_time_ms']:.3f}, "
          f"SR {res.extra_info['sr_time_ms']:.3f}), model {res.model_used}")
    del rs
    t0 = _phase("rife_span", t0)

    files = {"rife_weights": ROOT / "weights" / "rife.npz",
             "vfimamba_weights": ROOT / "weights" / "vfimamba.npz",
             "gate_path": ROOT / "weights" / "router_gate.json"}
    pipe = AdaptivePipeline(sr_model_name="span", **{k: str(p) for k, p in files.items()})
    pipe.load()
    require(isinstance(pipe._sr, SPANModel) and pipe._sr.scale == 2, "adaptive SPAN SR loaded")
    x0, x1 = (torch.from_numpy(u8[x]).to(dev).float()[None] / 255.0 for x in (18, 26))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mids = pipe.interpolate_batch(x0, x1, TS)
    ups = pipe.upscale_batch(torch.cat([x0, mids[0]]), SCALE)
    end.record()
    end.synchronize()
    require(tuple(ups.shape) == (4, *out_hw, 3) and bool(torch.isfinite(ups).all())
            and (ups - span.upscale_batch(torch.cat([x0, mids[0]]), SCALE)).abs().max() <= 1e-5,
            "adaptive SPAN upscale_batch is SPAN's")
    print(f"adaptive (sr_model_name='span') pan 8 px: interpolate_batch + upscale_batch of 4 "
          f"frames to {out_hw[1]}x{out_hw[0]}: {start.elapsed_time(end):.3f} ms (first call), route "
          f"{pipe.get_stats()}")
    _phase("adaptive_span", t0)


def timed_steps(kw, step, batch, steps: int) -> tuple:
    """steps train steps after one warm-up, each timed with CUDA events
    (data and step), K1 and K2 counted from 0 with ``window_origins``
    raising: (ms per step, losses, K1 launches, K2 launches, peak MB)."""
    step(batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    with origin_table_raises(kw):
        kw.launches = kw.grad_launches = 0
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(batch())
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(loss.item())
        k1, k2 = kw.launches, kw.grad_launches
    require(all(v == v and abs(v) < float("inf") for v in losses), "finite losses")
    return step_ms, losses, k1, k2, torch.cuda.max_memory_allocated() / 1e6


def per_shape_totals(kw, label: str, unit: str, recs: list, timer) -> dict:
    """Per launch shape of recs: prints the timer's numbers, and returns
    their totals over recs (each shape's numbers times its launches)."""
    by_shape = shape_times(kw, recs, timer)
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    for key, v in by_shape.items():
        a = next(r for r in recs if shape_key(r) == key)
        pl = kw.plan(a["img"], a["r"], a["compute_dtype"], timer is time_grad_launch)
        print(f"{label} shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/{unit} ({'grouped' if pl['grouped'] else 'whole-C'}, "
              f"{pl['groups']} group(s) of {pl['cg']}, {pl['ctas']} CTAs): kernel "
              f"{v['kernel']:.4f} ms, bound {v['bound']:.4f} ms ({v['by']}), wrapper host "
              f"{v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, plain {v['plain']:.4f} ms, "
              f"grid_sample{' grad' if timer is time_grad_launch else ''} {v['library']:.4f} ms")
        print_grouped(kw, label, unit, key, a, v, timer is time_grad_launch)
    tot = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    tot["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"{label} per {unit}: {len(recs)} launches, " + ", ".join(
        f"{f} {tot[f]:.4f} ms" for f in fields))
    return tot


def train_safa_phase(kw) -> tuple:
    """Step 13 of the module docstring. Returns K1's and K2's numbers over
    the counted train steps (``path_numbers``)."""
    from vfisr_tpu_torch.core import warp as core_warp
    from vfisr_tpu_torch.models.sota.safa import SAFAModel
    from vfisr_tpu_torch.train.__main__ import batch_maker
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step

    t0 = time.perf_counter()
    npz = ROOT / "weights" / "safa.npz"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = SAFAModel(device="cuda")
    model.load(weights_path=str(npz))  # explicit path: strict
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SAFAModel.load")
    module = model.trainable()
    require(module.c == 176 and module.num_dec_blocks == 8 and module.training
            and all(p.requires_grad for p in module.parameters()), "full-width SAFA, trainable")
    state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                               total_steps=SAFA_TRAIN_STEPS + 1)
    step = make_train_step(module, state)  # remat on, as scripts/train.py
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = batch_maker("safa", gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
    b = batch()
    require(tuple(b["img0"].shape) == (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3)
            and tuple(b["gt"].shape) == (TRAIN_BATCH, 2 * TRAIN_CROP, 2 * TRAIN_CROP, 3),
            "SAFA batch: endpoints at the crop, the midpoint at 2x")
    print(f"train safa: {sum(p.numel() for p in module.parameters())} parameters, batch "
          f"{TRAIN_BATCH}, crop {TRAIN_CROP} (scenes and gt at {2 * TRAIN_CROP}), remat")
    t0 = _phase("train_safa_load", t0)

    # one step, every launch of both kernels and every shifted adjoint
    # recorded and counted
    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    real_adj = core_warp.warp_transpose_shifted
    rec1, rec2, rec_adj = [], [], []

    def rec_adjoint(ct, flow, t=1.0, border="replicate", max_disp=8):
        rec_adj.append(dict(ct=ct.clone(), flow=flow.clone(), t=t, border=border,
                            max_disp=max_disp))
        return real_adj(ct, flow, t, border, max_disp)

    kw.warp_windowed, kw.warp_windowed_grad = _recording(kw, rec1), _recording_grad(kw, rec2)
    core_warp.warp_transpose_shifted = rec_adjoint
    try:
        with origin_table_raises(kw):
            kw.launches = kw.grad_launches = 0
            loss = step(batch()).item()
            k1, k2 = kw.launches, kw.grad_launches
    finally:
        kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
        core_warp.warp_transpose_shifted = real_adj
    grouped1 = [a for a in rec1 if kw.plan(a["img"], a["r"], a["compute_dtype"])["grouped"]]
    grouped2 = [a for a in rec2
                if kw.plan(a["img"], a["r"], a["compute_dtype"], grad=True)["grouped"]]
    print(f"one safa train step: K1 {k1} launches ({len(grouped1)} in channel groups, "
          f"{k1 - len(grouped1)} whole-C), K2 {k2} launches ({len(grouped2)} in channel groups at "
          f"C = {sorted({a['img'].shape[-1] for a in grouped2})}, {k2 - len(grouped2)} whole-C), "
          f"{len(rec_adj)} shifted adjoints, loss {loss:.6f}")
    require(k1 == K1_PER_SAFA_STEP and len(rec1) == k1, f"{k1} K1 launches in a SAFA train step")
    require(k2 == K2_PER_SAFA_STEP and len(rec2) == k2, f"{k2} K2 launches in a SAFA train step")
    require(len(grouped1) == K1_GROUPED_PER_SAFA_STEP and len(grouped2) == K2_GROUPED_PER_SAFA_STEP
            and all(a["img"].shape[-1] == 176 for a in grouped1 + grouped2),
            "SAFA's feature warps take channel groups at 176 channels, in K1 and K2")
    require(len(rec_adj) == ADJOINTS_PER_SAFA_STEP, f"{len(rec_adj)} shifted adjoints")
    # grouped K2 in one chunk per tile: one launch per call, no scratch
    for a in grouped2:
        pl = kw.plan(a["img"], a["r"], a["compute_dtype"], grad=True)
        require(pl["chunks"] == 1, f"grouped K2 {_label(a)}: one chunk per tile ({plan_text(pl)})")
    require(loss == loss and abs(loss) < float("inf"), "finite loss")
    t0 = _phase("train_safa_record", t0)

    # origins, K2 and K1 against their twins at every launch of the step;
    # K2 at synthetic cases of each of its shapes; grouped K2 twice, the
    # same bits
    for j, a in enumerate(rec1 + rec2):
        check_origins(kw, f"safa train launch {j}", a)
    max_err2 = 0.0
    for j, a in enumerate(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"safa train launch {j}", a))
    for a in grad_cases(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"safa train {a['name']}", a))
    max_err1 = 0.0
    for j, a in enumerate(rec1):
        max_err1 = max(max_err1, check_warp(kw, f"safa train launch {j}", a))
    for j, a in enumerate(grouped2):
        args = (a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"], a["compute_dtype"])
        x, y = kw.warp_windowed_grad(*args), kw.warp_windowed_grad(*args)
        torch.cuda.synchronize()
        same = torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        print(f"grouped K2 twice, safa train launch {j} {_label(a)}: "
              f"{'bit-identical' if same else 'DIFFER'}")
        require(same, "grouped K2 deterministic")
    compare_step_with_twins(kw, module, batch(), make_train_step, "safa train step")
    t0 = _phase("train_safa_checks", t0)

    # the training path, counted and timed
    step_ms, losses, k1_run, k2_run, peak_mb = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)
    require(k1_run == K1_PER_SAFA_STEP * SAFA_TRAIN_STEPS,
            f"{k1_run} K1 launches in {SAFA_TRAIN_STEPS} SAFA steps")
    require(k2_run == K2_PER_SAFA_STEP * SAFA_TRAIN_STEPS,
            f"{k2_run} K2 launches in {SAFA_TRAIN_STEPS} SAFA steps")
    ms = sum(step_ms) / len(step_ms)
    data_ms = time_ms(batch, 3)
    print(f"train safa, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, remat: ms/step {ms:.3f} (data + "
          f"step; steps: {', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
          f"{TRAIN_BATCH * 1000.0 / ms:.2f}; data alone {data_ms:.3f} ms; max_memory_allocated "
          f"{peak_mb:.1f} MB; {k1_run} K1 and {k2_run} K2 launches; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    t0 = _phase("train_safa_main", t0)

    # the shifted adjoint per call, at the recorded step's inputs
    adj_ms = []
    for a in rec_adj:
        adj_ms.append(time_ms(lambda: real_adj(**a), 3))
        fl = a["flow"].float()
        print(f"safa train shifted adjoint {tuple(a['ct'].shape)} max_disp {a['max_disp']}, flow "
              f"{fl.min().item():.3f} to {fl.max().item():.3f}: {adj_ms[-1]:.3f} ms")
    print(f"safa train shifted adjoint per step: {len(adj_ms)} calls, {sum(adj_ms):.3f} ms "
          f"({100.0 * sum(adj_ms) / ms:.1f}% of the {ms:.3f} ms step)")

    # the adjoint's offsets bounded by the displacements' range, read back
    # to the host once per call (the path), against every offset of
    # max_disp with no read-back: the same values, per call, and the step
    # end to end (read-back, every offset, read-back)
    read_back = [real_adj(**a) for a in rec_adj]
    real_reach = core_warp._shift_reach
    core_warp._shift_reach = lambda dy, dx, big_r: [range(big_r, -big_r - 1, -1)] * 2
    try:
        every_ms = []
        for j, a in enumerate(rec_adj):
            require(torch.equal(real_adj(**a), read_back[j]),
                    f"safa train shifted adjoint {j}: every offset gives the read-back's values")
            every_ms.append(time_ms(lambda: real_adj(**a), 3))
        del read_back
        every_step_ms = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)[0]
    finally:
        core_warp._shift_reach = real_reach
    again_ms = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)[0]
    print(f"safa train shifted adjoint, offsets from the read-back range against every offset "
          f"(no read-back): per call {', '.join(f'{x:.3f}' for x in adj_ms)} against "
          f"{', '.join(f'{x:.3f}' for x in every_ms)} ms; per step {sum(adj_ms):.3f} against "
          f"{sum(every_ms):.3f} ms; ms/step read-back {ms:.3f}, every offset "
          f"{sum(every_step_ms) / len(every_step_ms):.3f}, read-back again "
          f"{sum(again_ms) / len(again_ms):.3f}")

    # where a step's time goes: each conv shape forward and backward, with
    # cuDNN and without (the path's forward choice printed)
    fixed = batch()
    with torch.no_grad():
        calls = conv_calls(module, lambda: module(fixed["img0"], fixed["img1"], fixed["t"]))
    flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    print(f"train safa forward: {len(calls)} convs, {flop / 1e12:.4f} TFLOP (f32 bound "
          f"{flop / F32_FLOP_PER_S * 1e3:.3f} ms); a step with remat runs them twice and their "
          f"backward: about {4 * flop / 1e12:.4f} TFLOP, f32 bound "
          f"{4 * flop / F32_FLOP_PER_S * 1e3:.3f} ms")
    time_convs("train safa", calls, backward=True)
    t0 = _phase("train_safa_breakdown", t0)

    tot2 = per_shape_totals(kw, "train safa K2", "step", rec2, time_grad_launch)
    tot1 = per_shape_totals(kw, "train safa K1", "step", rec1, time_launch)
    _phase("train_safa_timing", t0)
    return (path_numbers(k1_run, max_err1, tot1, SAFA_TRAIN_STEPS),
            path_numbers(k2_run, max_err2, tot2, SAFA_TRAIN_STEPS))


def train_span_phase(kw) -> None:
    """Step 14 of the module docstring."""
    from vfisr_tpu_torch.models.sota.span import SPANModel
    from vfisr_tpu_torch.train.__main__ import SR_SCALE, batch_maker
    from vfisr_tpu_torch.train.train import create_train_state, make_sr_train_step

    for name, scale in SR_SCALE.items():
        t0 = time.perf_counter()
        model = SPANModel(scale=scale, device="cuda")
        model.load(weights_path=str(ROOT / "weights" / f"span_x{scale}.npz"))  # strict
        module = model.trainable()
        state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                                   total_steps=SPAN_TRAIN_STEPS + 1)
        step = make_sr_train_step(module, state)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = batch_maker(name, gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
        b = batch()
        lr_hw = TRAIN_CROP // scale
        require(tuple(b["lr"].shape) == (TRAIN_BATCH, lr_hw, lr_hw, 3)
                and tuple(b["hr"].shape) == (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                f"{name} batch shapes")
        step_ms, losses, k1, k2, peak_mb = timed_steps(kw, step, batch, SPAN_TRAIN_STEPS)
        require(k1 == 0 and k2 == 0, f"{name} training launches no warp ({k1}, {k2})")
        ms = sum(step_ms) / len(step_ms)
        with torch.no_grad():
            calls = conv_calls(module, lambda: module(b["lr"]))
        flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
        print(f"train {name} (x{scale}), batch {TRAIN_BATCH}, crop {TRAIN_CROP} (lr {lr_hw}), no "
              f"remat: ms/step {ms:.3f} (data + step; steps: "
              f"{', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
              f"{TRAIN_BATCH * 1000.0 / ms:.2f}; max_memory_allocated {peak_mb:.1f} MB; forward "
              f"{flop / 1e12:.4f} TFLOP, a step about {3 * flop / 1e12:.4f} TFLOP (f32 bound "
              f"{3 * flop / F32_FLOP_PER_S * 1e3:.3f} ms); losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}")
        time_convs(f"train {name}", calls, backward=True)
        del model, module, state, step
        _phase(f"train_{name}", t0)


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

    global ORIGIN_TABLE
    ORIGIN_TABLE = kw.window_origins

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
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
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
    with origin_table_raises(kw):
        kw.launches = 0
        for i in range(PAIRS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
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

    # the kernels' origins, and the kernel against its plain twin
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"main-path launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"main-path launch {j}", a))
    for a in synthetic_cases(dev):
        check_origins(kw, a["name"], a)
        max_err = max(max_err, check_warp(kw, a["name"], a))
    require_whole_c(kw, "flagship", recorded)
    # channel groups: K1 at C in GROUPED_C (an f32 image at r = 8 takes
    # groups past 9 channels)
    for a in grouped_cases(dev):
        p = kw.plan(a["img"], a["r"], a["compute_dtype"])
        require(p is not None and p["grouped"] == 1, f"plan of {_label(a)}: {p}")
        print(f"plan {_label(a)}: {p}")
        max_err = max(max_err, check_warp(kw, a["name"], a))
    # the origin's edge cases: origins, K1 and K2 (K2's line takes its
    # max_abs_err from the training's launches; these only gate)
    for a in adversarial_cases(dev):
        check_origins(kw, a["name"], a)
        max_err = max(max_err, check_warp(kw, a["name"], a))
        check_warp_grad(kw, a["name"], a)
    t0 = _phase("kernel_checks", t0)

    # per-launch timing at the main path's shapes
    totals = dict(kernel=0.0, host=0.0, wrapper=0.0, plain=0.0, bound=0.0, library=0.0)
    by_shape = shape_times(kw, recorded, time_launch)
    for key, s in by_shape.items():
        print(f"launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} x{s['n']}/pair: "
              f"kernel {s['kernel']:.4f} ms, bound {s['bound']:.4f} ms ({s['by']}), "
              f"wrapper host {s['host']:.4f} ms, wrapper {s['wrapper']:.4f} ms, "
              f"plain {s['plain']:.4f} ms, grid_sample {s['library']:.4f} ms")
        for k in totals:
            totals[k] += s["n"] * s[k]
    totals["by"] = "bytes" if {s["by"] for s in by_shape.values()} == {"bytes"} else "operations"
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
          f"bound {totals['bound']:.4f} ms, wrapper host {totals['host']:.4f} ms, "
          f"wrapper {totals['wrapper']:.4f} ms, "
          f"plain {totals['plain']:.4f} ms, grid_sample {totals['library']:.4f} ms")
    k1_flagship = path_numbers(launches, max_err, totals, PAIRS)
    k1_stream_flagship = stream_flagship_phase(kw, rife_npz, card, totals)
    k1_train, k2_train = train_phase(kw, rife_npz)
    k1_adaptive, per_route = adaptive_phase(kw)
    k1_stream_adaptive = stream_adaptive_phase(kw, card, per_route, k1_adaptive["err"])
    k1_safa = safa_phase(kw)
    span_phase(kw)
    k1_safa_train, k2_safa_train = train_safa_phase(kw)
    train_span_phase(kw)
    print(f"wall {time.perf_counter() - wall0:.2f} s")
    # each kernel's launches counted on every path that runs it, and the
    # device time of exactly those launches
    print(json.dumps({"kernels": [
        kernel_entry("warp_windowed", [k1_flagship, k1_stream_flagship, k1_train, k1_adaptive,
                                       k1_stream_adaptive, k1_safa, k1_safa_train]),
        kernel_entry("warp_windowed_grad", [k2_train, k2_safa_train])]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
