"""Streaming video processing (port of ``vfisr_tpu/pipeline/streaming.py``,
the engine of ``python -m vfisr_tpu_torch.process``).

Host decode -> device VFI+SR -> host encode, overlapped:

- a **decode thread** fills a bounded frame queue (backpressure when the
  device sets the pace, no unbounded host memory) with frames as the file
  stores them: a Y4M frame's I420 bytes, another container's RGB;
- the main loop uploads each frame once (through pinned memory, so the
  copy does not wait for the device), turns I420 into RGB there (half the
  upload bytes, and no colour arithmetic beside the dispatching thread:
  26-53 ms of host CPU per 1080p frame against 0.31-0.43 ms on an H100
  80GB HBM3 at 700 W, chip_smoke.py's "stream decode" line) and
  **dispatches pair i+1 before pair i is read back**: PyTorch's CUDA
  calls return before the device finishes, so the device computes while
  the host reads back and writes;
- each pair's frames are resized to the target on the device where the
  model's size differs (``fit``, Lanczos4), packed to I420 there where the
  size allows (``pack_i420``: half the readback bytes, and what a 4:2:0
  file holds anyway) and copied into pinned host memory behind the
  compute; a **writer thread** waits for the copy and writes the frames.

Models with a fused per-pair step (``fused_stream_step``: the flagship)
stream through it; the others through ``interpolate_batch`` /
``upscale_batch``; a model with neither takes the per-pair host path
(``process_pair``). The stats are the reference's: the main thread's stage
timers sum to the wall time with ``main_other_s``, the writer's overlap
them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vfisr_tpu_torch.core.color import i420_to_rgb, rgb_to_i420
from vfisr_tpu_torch.core.frames import to_uint8
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter, probe_video
from vfisr_tpu_torch.utils.spans import span


def pack_i420(rgb_u8: torch.Tensor) -> torch.Tensor:
    """[F,H,W,3] uint8 RGB -> [F, 3H/2, W] uint8 I420 on rgb_u8's device:
    the Y plane (H rows of W), then U and V (H/2 x W/2 each, H/4 rows of W
    each), ITU-R BT.601 video range, chroma the 2x2 mean (the reference's
    ``_get_pack_i420``; ``core/color.py::rgb_to_i420``). Needs H % 4 == 0
    and W % 2 == 0."""
    f, h, w, _ = rgb_u8.shape
    if h % 4 or w % 2:
        raise ValueError(f"I420 packing needs H % 4 == 0 and W % 2 == 0, got {w}x{h}")
    with span("pack_i420"):
        return rgb_to_i420(rgb_u8).reshape(f, h * 3 // 2, w)


def _start_host_copy(dev: torch.Tensor):
    """Start the device -> host copy of a pair's frames, so that the
    readback of pair i overlaps the compute of pair i+1: (host tensor, the
    copy's CUDA event, None for a tensor on the CPU). The copy goes into a
    new pinned tensor on the compute stream, behind the kernels that made
    dev, so dev's memory is not reused before the copy reads it; torch's
    pinned-memory cache hands the host block out again only after the
    copy has ended and the writer has dropped the tensor."""
    if dev.device.type != "cuda":
        return dev, None
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _build_model(method: Optional[str], vfi_model: Optional[str], sr_model: Optional[str],
                 device: str = "cuda"):
    from vfisr_tpu_torch.models.base import TwoStageModel
    from vfisr_tpu_torch.models.registry import get_model

    if method:
        return get_model(method, load=True, device=device)
    if vfi_model and sr_model:
        model = TwoStageModel(get_model(vfi_model, device=device),
                              get_model(sr_model, device=device), device=device)
        model.load()
        return model
    if vfi_model:
        return get_model(vfi_model, load=True, device=device)
    # default: the adaptive pipeline
    return get_model("adaptive", load=True, device=device)


def _decode_worker(reader: VideoReader, q: "queue.Queue", max_frames: int,
                   stop: threading.Event):
    # a Y4M frame goes as stored (process_video turns its I420 bytes into
    # RGB on the device), another container's as RGB
    read = reader.read if reader.header is None else reader.read_i420
    n = 0
    try:
        while not stop.is_set():
            frame = read()
            if frame is None or (max_frames and n >= max_frames):
                break
            q.put(frame)
            n += 1
    finally:
        # the EOF sentinel reaches the consumer even if read() raises (a
        # corrupt stream), or the main thread would block on q.get()
        q.put(None)
        # the worker owns the reader's close: the main thread's join can
        # time out while this thread is still inside read(), and a close
        # from there would race it
        reader.close()


def process_video(
    input_path: str,
    output_path: str,
    method: Optional[str] = None,
    vfi_model: Optional[str] = None,
    sr_model: Optional[str] = None,
    target_fps: float = 120.0,
    target_resolution: Tuple[int, int] = (2560, 1440),
    max_frames: int = 0,
    queue_depth: int = 8,
    readback: str = "auto",
    device: str = "cuda",
) -> dict:
    """Run the full streaming pipeline on ``device``; returns throughput +
    stage stats."""
    if readback not in ("auto", "rgb", "yuv420"):
        raise ValueError(f"readback {readback!r}: pick auto, rgb or yuv420")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("process_video(device='cuda') needs a CUDA card; "
                           "device='cpu' runs on the CPU")
    meta = probe_video(input_path)
    src_fps = meta.fps or 30.0
    factor = max(int(round(target_fps / src_fps)), 1)
    num_intermediate = factor - 1
    target_w, target_h = target_resolution
    scale = target_h / meta.height

    model = _build_model(method, vfi_model, sr_model, device)
    timestamps = tuple(
        (i + 1) / (num_intermediate + 1) for i in range(num_intermediate)
    )
    batched = hasattr(model, "interpolate_batch") and hasattr(model, "upscale_batch")
    # models with a fused per-pair step (flagship: analysis + scene/HUD
    # composite + VFI + SR) stream through it instead of the generic
    # two-phase path
    fused = (getattr(model, "fused_stream_step", None)
             if num_intermediate else None)

    def fit(frames_u8: torch.Tensor) -> torch.Tensor:
        """[F,h,w,3] uint8 at the target size (Lanczos4 on frames' device)."""
        if tuple(frames_u8.shape[1:3]) != (target_h, target_w):
            return resize(frames_u8, (target_h, target_w), "lanczos4")
        return frames_u8

    def fit_host(frame_u8: np.ndarray) -> np.ndarray:
        frame = torch.as_tensor(np.ascontiguousarray(frame_u8), device=dev)
        return fit(frame[None])[0].cpu().numpy()

    def upload(frame: np.ndarray) -> torch.Tensor:
        """One decoded frame (flat I420 bytes or [H,W,3] RGB) as [H,W,3]
        uint8 RGB on the device, uploaded once; through pinned memory the
        copy is queued behind the compute instead of waiting for it."""
        t = torch.from_numpy(frame)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return i420_to_rgb(t, meta.height, meta.width) if t.ndim == 1 else t

    @torch.no_grad()
    def device_step(prev: torch.Tensor, curr: torch.Tensor) -> torch.Tensor:
        """Dispatch VFI+SR for one pair: [1+T, target_h, target_w, 3] uint8
        on the device (asynchronous)."""
        if fused is not None:
            return fit(fused(prev, curr, scale, timestamps))
        x0 = prev.float()[None] / 255.0
        x1 = curr.float()[None] / 255.0
        if num_intermediate:
            mids = model.interpolate_batch(x0, x1, timestamps)  # [1,T,h,w,3]
            frames = torch.cat([x0[:, None], mids], dim=1)[0]
        else:
            frames = x0
        # to_uint8 rounds as the reference's floor(up * 255 + 0.5)
        return fit(to_uint8(model.upscale_batch(frames, scale)))

    t0 = time.time()
    decode_wait_s = dispatch_s = enqueue_wait_s = 0.0
    first_dispatch_s = 0.0
    in_frames = 0
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=queue_depth)

    # readback format: 'yuv420' halves the readback bytes (and the file is
    # 4:2:0 anyway); decided at the first device output, when the frame
    # dims are known (I420 packing needs H%4 == 0 and W%2 == 0)
    use_yuv: Optional[bool] = None if readback == "auto" else (
        readback == "yuv420")

    def emit_host_frames(host: np.ndarray, writer, yuv: bool) -> int:
        """Write materialized frames (RGB [F,H,W,3] or I420 [F,3H/2,W])."""
        for f in host:
            if yuv:
                writer.write_i420(f)
            else:
                writer.write(f)
        return len(host)

    # Writer thread: wait for each pair's copy (device_materialize_s) and
    # write its frames, both overlapping the main thread's dispatch
    wstats = {"materialize_s": 0.0, "encode_s": 0.0, "bytes": 0, "frames": 0}
    werrors: list = []
    out_q: "queue.Queue" = queue.Queue(maxsize=3)

    def _writer_worker(writer):
        while True:
            item = out_q.get()
            if item is None:
                return
            if werrors:  # after a failure, drain so the main thread's put() returns
                continue
            host, done, yuv = item
            try:
                tm = time.time()
                if done is not None:
                    done.synchronize()
                frames = host.numpy()
                wstats["materialize_s"] += time.time() - tm
                wstats["bytes"] += frames.nbytes
                tm = time.time()
                wstats["frames"] += emit_host_frames(frames, writer, yuv)
                wstats["encode_s"] += time.time() - tm
            except Exception as e:  # surface on the main thread
                werrors.append(e)

    reader = VideoReader(input_path)
    decoder = None
    try:
        writer_cm = VideoWriter(output_path, target_w, target_h, target_fps)
    except Exception:
        # the reader's close normally happens on the decode thread; a
        # writer-open failure must not leak it
        reader.close()
        raise
    with writer_cm as writer:
        decoder = threading.Thread(
            target=_decode_worker, args=(reader, q, max_frames, stop), daemon=True
        )
        wthread = threading.Thread(target=_writer_worker, args=(writer,),
                                   daemon=True)
        wthread_started = False
        try:
            decoder.start()
            tq = time.time()
            raw = q.get()
            decode_wait_s += time.time() - tq
            if raw is None:
                raise RuntimeError(f"no frames in {input_path}")
            in_frames += 1
            prev = upload(raw)
            n_dispatched = 0

            while True:
                tq = time.time()
                raw = q.get()
                decode_wait_s += time.time() - tq
                if raw is None:
                    break
                in_frames += 1
                if werrors:
                    raise werrors[0]
                td = time.time()
                curr = upload(raw)
                if batched:
                    # dispatch pair i (async) and hand its host copy to the
                    # writer thread: readback + encode of pair i overlap
                    # compute of pair i+1
                    this_dev = device_step(prev, curr)
                    if use_yuv is None:
                        h_out, w_out = this_dev.shape[1:3]
                        use_yuv = (h_out % 4 == 0) and (w_out % 2 == 0)
                    if use_yuv:
                        this_dev = pack_i420(this_dev)
                    host, done = _start_host_copy(this_dev)
                    step_s = time.time() - td
                    dispatch_s += step_s
                    if n_dispatched == 0:
                        # the first dispatch builds the kernels (nvcc on a
                        # fresh tree) and fills the caches: attribute it
                        first_dispatch_s = step_s
                    n_dispatched += 1
                    if not wthread_started:
                        wthread.start()
                        wthread_started = True
                    te = time.time()
                    out_q.put((host, done, bool(use_yuv)))
                    enqueue_wait_s += time.time() - te
                else:
                    result = model.process_pair(
                        prev.cpu().numpy(), curr.cpu().numpy(),
                        num_intermediate=num_intermediate, target_scale=scale,
                    )
                    tw = time.time()
                    for frame in result.frames[:-1]:
                        writer.write(fit_host(frame))
                        wstats["frames"] += 1
                    wstats["encode_s"] += time.time() - tw
                prev = curr

            if wthread_started:
                out_q.put(None)
                wthread.join()
                if werrors:
                    raise werrors[0]
            # final endpoint
            last = model.upscale(prev.cpu().numpy(), scale)
            writer.write(fit_host(last))
            wstats["frames"] += 1
        finally:
            stop.set()
            # drain so the decoder's blocked put() can finish
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            if decoder.ident is None:  # start() itself failed
                reader.close()
            else:
                # the worker closes the reader on its way out; a timed-out
                # join leaves the daemon thread to die with the process
                # rather than racing its read()
                decoder.join(timeout=10)
            if wthread_started and wthread.is_alive():
                out_q.put(None)
                wthread.join(timeout=10)

    elapsed = time.time() - t0
    out_frames = wstats["frames"]
    # main-thread accounting: everything not decode-wait / dispatch /
    # writer-backpressure is setup (model load, video probe) + loop
    # overhead, so the stages sum to elapsed
    main_other_s = max(
        elapsed - decode_wait_s - dispatch_s - enqueue_wait_s, 0.0)
    return {
        "input_frames": in_frames,
        "output_frames": out_frames,
        "target_fps": target_fps,
        "target_resolution": f"{target_w}x{target_h}",
        "elapsed_s": elapsed,
        "realtime_x": (out_frames / target_fps) / elapsed if elapsed > 0 else 0,
        "model": model.info.name,
        "pipeline": ("fused_writer_thread" if fused is not None
                     else "writer_thread" if batched else "host_fallback"),
        # --- main thread (sums to elapsed with main_other_s) ---
        "decode_wait_s": round(decode_wait_s, 3),
        "dispatch_s": round(dispatch_s, 3),
        "first_dispatch_s": round(first_dispatch_s, 3),  # the first step's warm-up
        "enqueue_wait_s": round(enqueue_wait_s, 3),  # writer backpressure
        "main_other_s": round(main_other_s, 3),
        # --- writer thread (overlaps the above) ---
        "device_materialize_s": round(wstats["materialize_s"], 3),
        "encode_s": round(wstats["encode_s"], 3),
        "readback_format": "yuv420" if use_yuv else "rgb",
        "readback_mb": round(wstats["bytes"] / 1e6, 1),
        # fraction of wall time the device had work in flight: the main
        # thread keeps the device fed except while decode-blocked
        "device_busy_fraction": round(
            max(elapsed - decode_wait_s - main_other_s, 0.0) / elapsed, 3)
        if elapsed > 0 else 0,
    }
